"""Masked multi-head attention: ``softmax(q k^T / sqrt(Dh) + masks) v``.

Counterpart of ``recstudio_tpu/ops/attention.py``. ``fused_mha`` keeps the
JAX layout ``[B, H, L, Dh]`` and mask semantics: boolean masks, True =
disallow, applied additively with ``finfo(float32).min`` and clamped there,
so a row whose keys are all masked stays finite (the uniform average of its
Lk values). It dispatches on Lk as ``_dispatch``/``_fwd`` do
(``attention.py:357-378``):

- Lk <= 512: on a CUDA tensor the hand-written kernel ``csrc/attention.cu``
  (K3, replacing the Pallas ``_mha_kernel``; it skips the key tiles of
  ``MHA_TILE`` that the masks cover fully, ``mha_tiles``), counted in
  ``fused_mha.launches``; on a CPU tensor ``mha_plain``. Its backward
  recomputes through autograd of ``mha_plain``, as the JAX package
  differentiates the short regime through ``mha_xla``
  (``attention.py:386-389``); that is not a kernel.
- Lk > 512: ``_FlashMha``, whose forward is ``flash_mha_fwd`` (K4, replacing
  ``_flash_kernel``; it also returns each row's (max, sum)) and whose
  backward is ``flash_mha_bwd_dq`` (K5, replacing ``_flash_bwd_dq_kernel``;
  it also returns ``delta = rowsum(dO o out)``) and ``flash_mha_bwd_dkv``
  (K6, replacing ``_flash_bwd_dkv_kernel``), with P recomputed from the
  saved statistics (``csrc/flash_attention.cu``; K4, K5 and K6 skip the
  pairs of ``FLASH_TILE`` tiles that the masks cover fully, ``mha_tiles``;
  K4 makes one more pass over all Lk values for a query tile that holds a
  row with no allowed key, and K5 and K6 compute every pair of such a
  tile). Each launches its kernel
  on a CUDA tensor, or raises, and counts its launches in
  ``<function>.launches``; on a CPU tensor each computes the same function
  with its plain version (``flash_mha_plain``, ``flash_mha_bwd_dq_plain``,
  ``flash_mha_bwd_dkv_plain``; ``flash_mha_bwd_plain`` is the two together).

The JAX flash forward stores ``lse = max + log(sum)``, which rounds to
``finfo.min`` on a row whose keys are all masked, so its backward takes P =
1 for every key there. The port stores (max, sum) and recomputes P = 1 / Lk:
its gradient is autograd's of ``mha_plain`` on every row.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = torch.finfo(torch.float32).min
MAX_KEYS = 512      # ``_FLASH_THRESHOLD`` of the JAX package
MAX_HEAD_DIM = 256  # accumulator width of csrc/attention.cu and csrc/flash_attention.cu
MHA_TILE = (32, 32)  # K3's (query rows, keys) a block at every Dh: kTileRows, kTileKeys
# K4's, K5's and K6's (query rows, keys) of a pair of tiles at Dh <= 128:
# kFlashRows, kFlashKeys
FLASH_TILE = (64, 64)


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


def _raw_logits(q, k, pad_add, attn_add) -> torch.Tensor:
    """``q k^T / sqrt(Dh) + attn_add + pad_add`` before the clamp."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if attn_add is not None:
        s = s + attn_add
    if pad_add is not None:
        s = s + pad_add[:, None, None, :]
    return s


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pad_add: Optional[torch.Tensor] = None,
              attn_add: Optional[torch.Tensor] = None,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel. q, k, v: ``[B, H, L, Dh]``;
    pad_add ``[B, Lk]``, attn_add ``[Lq, Lk]`` additive; ``keep`` ``[B, H,
    Lq, Lk]``, the dropout factors of the probabilities (training)."""
    s = torch.clamp_min(_raw_logits(q, k, pad_add, attn_add), NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    weights = p if keep is None else p * keep
    return torch.matmul(weights, v) / p.sum(dim=-1, keepdim=True)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_add: Optional[torch.Tensor] = None,
                    attn_add: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``(out, stats)``, out as ``mha_plain``'s and
    stats ``[B, H, Lq, 2]`` each row's (max, sum of exp(s - max))."""
    s = torch.clamp_min(_raw_logits(q, k, pad_add, attn_add), NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    total = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v) / total, torch.cat([m, total], dim=-1)


def _probs_and_dscores(q, k, v, pad_add, attn_add, stats, g, delta):
    """P recomputed from the row statistics, and ``dS = P o (g v^T -
    delta)`` where the gradient passes the clamp (``torch.clamp_min``'s
    rule: the unclamped logit is >= finfo.min), 0 elsewhere."""
    raw = _raw_logits(q, k, pad_add, attn_add)
    p = torch.exp(torch.clamp_min(raw, NEG) - stats[..., :1]) / stats[..., 1:]
    dp = torch.matmul(g, v.transpose(-1, -2))
    return p, torch.where(raw >= NEG, p * (dp - delta[..., None]), 0.0)


def flash_mha_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pad_add: Optional[torch.Tensor], attn_add: Optional[torch.Tensor],
                           out: torch.Tensor, stats: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: ``(dq, delta)`` with ``delta = rowsum(g o out)``
    ``[B, H, Lq]`` and ``dq = dS k / sqrt(Dh)``."""
    delta = (g * out).sum(dim=-1)
    _, ds = _probs_and_dscores(q, k, v, pad_add, attn_add, stats, g, delta)
    return torch.matmul(ds, k) * (1.0 / math.sqrt(q.shape[-1])), delta


def flash_mha_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            pad_add: Optional[torch.Tensor], attn_add: Optional[torch.Tensor],
                            stats: torch.Tensor, g: torch.Tensor, delta: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: ``(dk, dv)``, ``dk = dS^T q / sqrt(Dh)`` and
    ``dv = P^T g``, from K5's ``delta``."""
    p, ds = _probs_and_dscores(q, k, v, pad_add, attn_add, stats, g, delta)
    return (torch.matmul(ds.transpose(-1, -2), q) * (1.0 / math.sqrt(q.shape[-1])),
            torch.matmul(p.transpose(-1, -2), g))


def flash_mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_add: Optional[torch.Tensor], attn_add: Optional[torch.Tensor],
                        out: torch.Tensor, stats: torch.Tensor, g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the flash backward (K5 and K6): ``(dq, dk, dv)``."""
    dq, delta = flash_mha_bwd_dq_plain(q, k, v, pad_add, attn_add, out, stats, g)
    return (dq, *flash_mha_bwd_dkv_plain(q, k, v, pad_add, attn_add, stats, g, delta))


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected a contiguous float32 tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _check_mha(q, k, v, pad_add, attn_add) -> Tuple[int, int, int, int, int]:
    """Shapes ``(B, H, Lq, Lk, Dh)`` of CUDA attention operands; raises on
    what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected [B, H, L, Dh] operands, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
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
    return B, H, Lq, Lk, Dh


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, dev, *args) -> None:
    from . import _native
    lib = _native.load()
    with torch.cuda.device(dev):
        lib.call(name, *args, torch.cuda.current_stream(dev).cuda_stream)


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pad_add: Optional[torch.Tensor] = None,
            attn_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on additive masks (Lk <= 512): ``[B, H, Lq, Dh]``, counted in
    ``fused_mha.launches``; ``mha_plain`` on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, pad_add, attn_add)
    B, H, Lq, Lk, Dh = _check_mha(q, k, v, pad_add, attn_add)
    if Lk > MAX_KEYS:
        raise ValueError(f"Lk={Lk} > {MAX_KEYS} goes to the flash kernel, not to K3")
    out = torch.empty_like(q)
    _launch("rs_mha_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad_add),
            _ptr(attn_add), out.data_ptr(), B, H, Lq, Lk, Dh, 1.0 / math.sqrt(Dh))
    fused_mha.launches += 1
    return out


def mha_tiles(key_padding_mask: Optional[torch.Tensor], attn_mask: Optional[torch.Tensor],
              Lq: int, Lk: int, tq: int, tk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's skip rule in plain torch, per example (the same for every head):
    bool ``[B, nq, nk]``, True for the (query tile, key tile) pairs it
    computes (some real row and key of the pair allowed), and bool ``[B,
    nq]``, True for the query tiles that hold a row with no allowed key
    (they make one more pass over all Lk values). Masks as ``fused_mha``'s."""
    B = 1 if key_padding_mask is None else key_padding_mask.shape[0]
    ref = key_padding_mask if key_padding_mask is not None else attn_mask
    dev = ref.device if ref is not None else torch.device("cpu")
    allowed = torch.ones((B, Lq, Lk), dtype=torch.bool, device=dev)
    if key_padding_mask is not None:
        allowed &= ~key_padding_mask[:, None, :]
    if attn_mask is not None:
        allowed &= ~attn_mask[None]
    nq, nk = -(-Lq // tq), -(-Lk // tk)
    padded = torch.zeros((B, nq * tq, nk * tk), dtype=torch.bool, device=dev)
    padded[:, :Lq, :Lk] = allowed
    tiles = padded.view(B, nq, tq, nk, tk).any(dim=4).any(dim=2)
    empty = torch.zeros((B, nq * tq), dtype=torch.bool, device=dev)
    empty[:, :Lq] = ~allowed.any(dim=-1)
    return tiles, empty.view(B, nq, tq).any(dim=-1)


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pad_add: Optional[torch.Tensor] = None,
                  attn_add: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(out [B, H, Lq, Dh], stats [B, H, Lq, 2])``."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, pad_add, attn_add)
    B, H, Lq, Lk, Dh = _check_mha(q, k, v, pad_add, attn_add)
    out = torch.empty_like(q)
    stats = torch.empty((B, H, Lq, 2), dtype=torch.float32, device=q.device)
    _launch("rs_flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(pad_add),
            _ptr(attn_add), out.data_ptr(), stats.data_ptr(), B, H, Lq, Lk, Dh,
            1.0 / math.sqrt(Dh))
    flash_mha_fwd.launches += 1
    return out, stats


def flash_mha_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pad_add: Optional[torch.Tensor], attn_add: Optional[torch.Tensor],
                     out: torch.Tensor, stats: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(dq [B, H, Lq, Dh], delta [B, H, Lq])`` from K4's out and stats
    and the output's gradient g."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_plain(q, k, v, pad_add, attn_add, out, stats, g)
    B, H, Lq, Lk, Dh = _check_mha(q, k, v, pad_add, attn_add)
    _check(out, "out", (B, H, Lq, Dh), q.device)
    _check(g, "output gradient", (B, H, Lq, Dh), q.device)
    _check(stats, "row statistics", (B, H, Lq, 2), q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _launch("rs_flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(pad_add), _ptr(attn_add), out.data_ptr(), g.data_ptr(), stats.data_ptr(),
            dq.data_ptr(), delta.data_ptr(), B, H, Lq, Lk, Dh, 1.0 / math.sqrt(Dh))
    flash_mha_bwd_dq.launches += 1
    return dq, delta


def flash_mha_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pad_add: Optional[torch.Tensor], attn_add: Optional[torch.Tensor],
                      stats: torch.Tensor, g: torch.Tensor, delta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(dk, dv)``, each ``[B, H, Lk, Dh]``, from K4's stats, K5's delta
    and the output's gradient g."""
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_plain(q, k, v, pad_add, attn_add, stats, g, delta)
    B, H, Lq, Lk, Dh = _check_mha(q, k, v, pad_add, attn_add)
    _check(g, "output gradient", (B, H, Lq, Dh), q.device)
    _check(stats, "row statistics", (B, H, Lq, 2), q.device)
    _check(delta, "delta", (B, H, Lq), q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("rs_flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(pad_add), _ptr(attn_add), g.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Lq, Lk, Dh, 1.0 / math.sqrt(Dh))
    flash_mha_bwd_dkv.launches += 1
    return dk, dv


class _Mha(torch.autograd.Function):
    """K3 forward; backward by autograd of ``mha_plain`` on the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, pad_add, attn_add):
        ctx.save_for_backward(q, k, v)
        ctx.masks = (pad_add, attn_add)
        return mha_fwd(q, k, v, pad_add, attn_add)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            grads = torch.autograd.grad(mha_plain(*qkv, *ctx.masks), qkv, g)
        return (*grads, None, None)


class _FlashMha(torch.autograd.Function):
    """K4 forward; K5 and K6 backward from the saved row statistics
    (``_fwd``/``_bwd`` at ``attention.py:373-385``)."""

    @staticmethod
    def forward(ctx, q, k, v, pad_add, attn_add):
        out, stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.masks = (pad_add, attn_add)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, stats = ctx.saved_tensors
        g = g.contiguous()
        dq, delta = flash_mha_bwd_dq(q, k, v, *ctx.masks, out, stats, g)
        dk, dv = flash_mha_bwd_dkv(q, k, v, *ctx.masks, stats, g, delta)
        return dq, dk, dv, None, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused softmax attention.

    q, k, v: ``[B, H, L, Dh]``. ``key_padding_mask``: bool ``[B, Lk]``
    (True = pad). ``attn_mask``: bool ``[Lq, Lk]`` (True = disallow, e.g. the
    causal triu mask). Returns ``[B, H, Lq, Dh]``.
    """
    pad_add, attn_add = additive_masks(key_padding_mask, attn_mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if k.shape[2] > MAX_KEYS:
        return _FlashMha.apply(q, k, v, pad_add, attn_add)
    if q.device.type == "cpu":
        return mha_plain(q, k, v, pad_add, attn_add)
    return _Mha.apply(q, k, v, pad_add, attn_add)


fused_mha.launches = 0
flash_mha_fwd.launches = 0
flash_mha_bwd_dq.launches = 0
flash_mha_bwd_dkv.launches = 0
