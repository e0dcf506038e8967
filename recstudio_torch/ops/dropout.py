"""Dropout masks from a counter-based generator (Philox-4x32-10).

Counterpart of ``_DropRng`` in ``recstudio_tpu/ops/transformer_layer.py``.
The keep bit of an element is a pure function of ``(seed, site, index)``:

    w = philox4x32_10(counter=(index lo, index hi, site, 0),
                      key=(seed lo, seed hi))[0]
    keep  <=>  (w >> 8) >= min(ceil(p * 2**24), 2**24 - 1)

the rule of ``_DropRng.keep`` (24 high bits against a threshold), with kept
elements scaled by ``1 / (1 - p)``. ``index`` is the element's row-major
position in the tensor the site drops from, so the CUDA kernels
(``csrc/dropout.cuh``, the same function in device code) and this plain
version draw the same mask. That is what lets the forward kernel and the
backward kernel regenerate a mask instead of storing it, and what lets a
kernel be held against its plain version with dropout on. The bits differ
from the JAX package's (threefry on the CPU, the TPU's own generator on
the chip), so tests compare properties, not masks.

The products ``M * x`` of two 32-bit words are taken in int64, where they
wrap around modulo 2**64 (two's complement, on the CPU and on the card);
the low 64 bits are exact, so each word is masked after the shift.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# one site per dropout of a layer call, in the order of the JAX stream
SITE_ATTN, SITE_OUT, SITE_FFN_HIDDEN, SITE_FFN_OUT = 0, 1, 2, 3
SITE_INPUT = 4          # the dropout of an embedded sequence (SASRec, GRU4Rec, NARM)
SITE_HIDDEN = 5         # a dropout of hidden vectors (NARM's query, MLP and GRU-stack layers)
SEED_LIMIT = 1 << 62


def threshold(p: float) -> int:
    """24-bit keep threshold of a drop rate ``p`` (``_DropRng.keep``)."""
    return min(math.ceil(p * (1 << 24)), (1 << 24) - 1)


def drop_args(p: float, seed: int) -> Tuple[int, int, float]:
    """``(seed, threshold, scale)`` as the CUDA kernels take them."""
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    if not 0 <= seed < SEED_LIMIT:
        raise ValueError(f"dropout seed {seed} outside [0, 2**62)")
    return seed, threshold(p), 1.0 / (1.0 - p)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One layer call's seed, from the model's generator (the counterpart of
    ``make_rng("dropout")``, ``recstudio_tpu/models/module/layers.py:395``)."""
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    return int(torch.randint(0, SEED_LIMIT, (1,), generator=generator).item())


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit words of ``m * x``; ``x`` an int64 tensor (or int)
    holding a 32-bit word."""
    prod = x * m
    return (prod >> 32) & M32, prod & M32


def philox4x32_10(counter: Sequence, key: Sequence[int]):
    """The four output words of Philox-4x32-10 (Salmon et al., SC'11) for
    ``counter`` (four int64 tensors or ints holding 32-bit words) and
    ``key`` (two 32-bit ints)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_scale(shape: Sequence[int], p: float, seed: int, site: int,
               device) -> torch.Tensor:
    """float32 tensor of ``shape``: ``1 / (1 - p)`` where the element is
    kept, 0 where it is dropped."""
    seed, thr, scale = drop_args(p, seed)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    w0 = philox4x32_10((idx & M32, idx >> 32, site, 0), (seed & M32, seed >> 32))[0]
    keep = (w0 >> 8) >= thr
    return torch.where(keep, torch.tensor(scale, dtype=torch.float32, device=device),
                       torch.tensor(0.0, dtype=torch.float32, device=device)).reshape(shape)
