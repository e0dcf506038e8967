"""Masked multi-head attention: ``softmax(q k^T / sqrt(Dh) + masks) v``.

Counterpart of ``recstudio_tpu/ops/attention.py``. ``fused_mha`` keeps the
JAX layout ``[B, H, L, Dh]`` and mask semantics: boolean masks, True =
disallow, applied additively with ``finfo(float32).min`` and clamped there,
so a row whose keys are all masked stays finite.

- On a CUDA tensor, ``fused_mha`` launches the hand-written kernel
  ``csrc/attention.cu`` (K3, replacing the Pallas ``_mha_kernel``) or
  raises; it counts its launches in ``fused_mha.launches``.
- On a CPU tensor it computes the same function with ``mha_plain``.

The JAX package sends Lk > 512 to a tiled flash kernel; that kernel (K4) is
not ported yet, so the CUDA path refuses Lk > 512.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = torch.finfo(torch.float32).min
MAX_KEYS = 512      # ``_FLASH_THRESHOLD`` of the JAX package
MAX_HEAD_DIM = 256  # accumulator width of csrc/attention.cu


def additive_masks(key_padding_mask: Optional[torch.Tensor],
                   attn_mask: Optional[torch.Tensor]
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Boolean masks (True = disallow) -> float32 additive masks."""
    def add(mask):
        if mask is None:
            return None
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        return torch.where(mask, torch.full_like(zero, NEG), zero).contiguous()
    return add(key_padding_mask), add(attn_mask)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pad_add: Optional[torch.Tensor] = None,
              attn_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel. q, k, v: ``[B, H, L, Dh]``;
    pad_add ``[B, Lk]``, attn_add ``[Lq, Lk]`` additive."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if attn_add is not None:
        s = s + attn_add
    if pad_add is not None:
        s = s + pad_add[:, None, None, :]
    s = torch.clamp_min(s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.matmul(p, v) / p.sum(dim=-1, keepdim=True)


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected a contiguous float32 tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _mha_cuda(q, k, v, pad_add, attn_add) -> torch.Tensor:
    from . import _native
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if Lk > MAX_KEYS:
        raise NotImplementedError(
            f"Lk={Lk} > {MAX_KEYS} needs the flash-attention kernel, not ported yet")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM} is not supported")
    dev = q.device
    _check(q, "q", (B, H, Lq, Dh), dev)
    _check(k, "k", (B, H, Lk, Dh), dev)
    _check(v, "v", (B, H, Lk, Dh), dev)
    if pad_add is not None:
        _check(pad_add, "key padding mask", (B, Lk), dev)
    if attn_add is not None:
        _check(attn_add, "attention mask", (Lq, Lk), dev)
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _native.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("rs_mha_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(pad_add),
                 ptr(attn_add), out.data_ptr(), B, H, Lq, Lk, Dh, 1.0 / math.sqrt(Dh), stream)
    fused_mha.launches += 1
    return out


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused softmax attention.

    q, k, v: ``[B, H, L, Dh]``. ``key_padding_mask``: bool ``[B, Lk]``
    (True = pad). ``attn_mask``: bool ``[Lq, Lk]`` (True = disallow, e.g. the
    causal triu mask). Returns ``[B, H, Lq, Dh]``.
    """
    pad_add, attn_add = additive_masks(key_padding_mask, attn_mask)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, pad_add, attn_add)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _mha_cuda(q, k, v, pad_add, attn_add)


fused_mha.launches = 0
