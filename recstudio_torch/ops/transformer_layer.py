"""Fused post-LN transformer encoder layer: forward (K1) and backward (K2).

Counterpart of ``recstudio_tpu/ops/transformer_layer.py``:

    qkv = x Wqkv^T + b
    per head: A = drop(softmax(max(Q K^T / sqrt(Dh) + masks, finfo.min))) V
    x1 = LN1(x + drop(A Wo^T + bo))
    out = LN2(x1 + drop(drop(act(x1 W1^T + b1)) W2^T + b2))

with the four dropouts in training mode only, their masks drawn from the
layer call's seed (``ops/dropout.py``).

- On a CUDA tensor, ``fused_transformer_layer`` launches the hand-written
  kernel chain ``csrc/transformer_layer.cu`` (K1, replacing the Pallas
  ``_fwd_kernel``) or raises; it counts its launches in
  ``fused_transformer_layer.launches``. K1's four products run on
  ``csrc/sgemm_tile.cuh`` with their bias, activation, dropout and
  LayerNorm epilogues fused (tiles ``K1_GEMM_TILE`` at the widest, sized
  to the shapes, the mode and the card: ``forward_tiles``); its attention
  step is K3. In training mode it is an autograd
  function whose backward is ``csrc/transformer_layer_bwd.cu`` (K2,
  replacing ``_bwd_kernel``), counted in
  ``fused_transformer_layer_bwd.launches``. K2's products run on
  ``csrc/sgemm_tile.cuh`` (tiles ``K2_GEMM_TILE``; its weight gradients'
  row ranges are sized to the card, ``weight_grad_splits``) and its
  attention steps on the flash backward kernels of
  ``csrc/flash_attention.cu`` at ``K2_ATTN_TILE``, skipping the tile
  pairs the masks cover fully (``ops.attention.mha_tiles``).
- On a CPU tensor it computes the same function with
  ``transformer_layer_plain``, and autograd through it is the plain
  version of K2 (``transformer_layer_bwd_plain``).

Weights follow PyTorch's ``[out, in]`` layout (``utils/convert.py`` maps
the JAX package's ``[in, out]`` kernels); so do the gradients.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .attention import _check, additive_masks, mha_plain
from .dropout import (SITE_ATTN, SITE_FFN_HIDDEN, SITE_FFN_OUT, SITE_OUT, drop_args,
                      keep_scale)

# K1's products: output tile rows and columns a block and k-slice at the
# widest (csrc/sgemm_tile.cuh GemmTile<8, 8>; its LayerNorm products take
# 64 x 256 at 128 < d <= 256)
K1_GEMM_TILE = (128, 128, 16)
# K2's products: output tile rows and columns a block and k-slice at the
# widest (csrc/sgemm_tile.cuh GemmTile<8, 8>: 16 TM x 16 TN, BK), and its
# attention steps' (query rows, keys) a pair of tiles at Dh <= 128
# (csrc/flash_attention.cu kLayerRows, kLayerKeys)
K2_GEMM_TILE = (128, 128, 16)
K2_ATTN_TILE = (32, 32)
# the weight gradients K2 sums over the B L rows, in the order of its chain
WEIGHT_GRADS = ("linear2_weight", "linear1_weight", "out_proj_weight", "in_proj_weight")

PARAM_NAMES = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias",
               "norm1_weight", "norm1_bias", "linear1_weight", "linear1_bias",
               "linear2_weight", "linear2_bias", "norm2_weight", "norm2_bias")
_ACT_CODES = {"relu": 1, "gelu": 2}


def param_shapes(d: int, F: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the layer's parameters, ``[out, in]`` for the weights."""
    return {"in_proj_weight": (3 * d, d), "in_proj_bias": (3 * d,),
            "out_proj_weight": (d, d), "out_proj_bias": (d,),
            "norm1_weight": (d,), "norm1_bias": (d,),
            "linear1_weight": (F, d), "linear1_bias": (F,),
            "linear2_weight": (d, F), "linear2_bias": (d,),
            "norm2_weight": (d,), "norm2_bias": (d,)}


def supports_fused_layer(d_model: int, seq_len: int, n_head: int,
                         dim_feedforward: int, activation: str) -> bool:
    """The fused layer's gate, as ``transformer_layer.py:86-95``."""
    if d_model % n_head:
        return False
    if activation not in _ACT_CODES:
        return False
    return d_model <= 256 and dim_feedforward <= 1024 and seq_len <= 256


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation), not torch's erf default."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Two-pass LayerNorm: mean, then mean of squared deviations."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


def qkv_heads(x: torch.Tensor, params: Dict[str, torch.Tensor], n_head: int):
    """The fused projection split into contiguous ``[B, H, L, Dh]`` q, k, v."""
    B, L, D = x.shape
    qkv = torch.matmul(x, params["in_proj_weight"].t()) + params["in_proj_bias"]
    heads = lambda t: t.reshape(B, L, n_head, D // n_head).transpose(1, 2).contiguous()
    return tuple(heads(t) for t in qkv.split(D, dim=-1))


def layer_tail(x: torch.Tensor, attn: torch.Tensor, params: Dict[str, torch.Tensor],
               activation: str, eps: float, dropout: float = 0.0,
               seed: int = 0) -> torch.Tensor:
    """Everything after attention: output projection, LN1, FFN, LN2, with
    the o, hact and f dropouts when ``dropout > 0``. attn: ``[B, H, L, Dh]``."""
    B, L, D = x.shape

    def drop(t, site):
        return t * keep_scale(t.shape, dropout, seed, site, t.device) if dropout > 0 else t

    a = attn.transpose(1, 2).reshape(B, L, D)
    o = drop(torch.matmul(a, params["out_proj_weight"].t()) + params["out_proj_bias"], SITE_OUT)
    x1 = layer_norm(x + o, params["norm1_weight"], params["norm1_bias"], eps)
    h = torch.matmul(x1, params["linear1_weight"].t()) + params["linear1_bias"]
    h = drop(gelu_tanh(h) if activation == "gelu" else torch.relu(h), SITE_FFN_HIDDEN)
    f = drop(torch.matmul(h, params["linear2_weight"].t()) + params["linear2_bias"], SITE_FFN_OUT)
    return layer_norm(x1 + f, params["norm2_weight"], params["norm2_bias"], eps)


def transformer_layer_plain(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            key_padding_mask: Optional[torch.Tensor],
                            attn_mask: Optional[torch.Tensor], n_head: int,
                            activation: str, layer_norm_eps: float, dropout: float = 0.0,
                            seed: int = 0, training: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1. x: ``[B, L, D]``; the dropout masks of a
    training call are ``ops/dropout.py``'s for ``seed``."""
    B, L, _ = x.shape
    p = dropout if training else 0.0
    q, k, v = qkv_heads(x, params, n_head)
    keep = keep_scale((B, n_head, L, L), p, seed, SITE_ATTN, x.device) if p > 0 else None
    a = mha_plain(q, k, v, *additive_masks(key_padding_mask, attn_mask), keep)
    return layer_tail(x, a, params, activation, layer_norm_eps, p, seed)


def transformer_layer_bwd_plain(g: torch.Tensor, x: torch.Tensor,
                                params: Dict[str, torch.Tensor],
                                key_padding_mask: Optional[torch.Tensor],
                                attn_mask: Optional[torch.Tensor], n_head: int, dropout: float,
                                activation: str, layer_norm_eps: float, seed: int
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of K2: ``(dx, {name: grad})`` of a training call of
    the layer, by autograd through ``transformer_layer_plain`` with the
    same masks."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        ps = {n: params[n].detach().requires_grad_() for n in PARAM_NAMES}
        out = transformer_layer_plain(xs, ps, key_padding_mask, attn_mask, n_head, activation,
                                      layer_norm_eps, dropout, seed, True)
        grads = torch.autograd.grad(out, [xs, *(ps[n] for n in PARAM_NAMES)], g)
    return grads[0], dict(zip(PARAM_NAMES, grads[1:]))


# ---------------------------------------------------------------------------
def _check_layer(x, params, pad_add, attn_add) -> None:
    B, L, D = x.shape
    dev = x.device
    _check(x, "x", (B, L, D), dev)
    for name, shape in param_shapes(D, params["linear1_weight"].shape[0]).items():
        _check(params[name], name, shape, dev)
    if pad_add is not None:
        _check(pad_add, "key padding mask", (B, L), dev)
    if attn_add is not None:
        _check(attn_add, "attention mask", (L, L), dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _drop_call_args(dropout: float, seed: int):
    """(seed, threshold, scale, active) of the kernels' dropout."""
    if dropout > 0:
        return (*drop_args(dropout, seed), 1)
    return 0, 0, 1.0, 0


def _layer_cuda(x, params, pad_add, attn_add, n_head, activation, eps) -> torch.Tensor:
    """K1, eval mode."""
    from . import _native
    _check_layer(x, params, pad_add, attn_add)
    B, L, D = x.shape
    F = params["linear1_weight"].shape[0]
    dev = x.device
    M = B * L
    qkv = torch.empty((M, 3 * D), dtype=torch.float32, device=dev)
    attn = torch.empty((M, D), dtype=torch.float32, device=dev)
    x1 = torch.empty((M, D), dtype=torch.float32, device=dev)
    h = torch.empty((M, F), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _native.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("rs_transformer_layer_fwd", x.data_ptr(), _ptr(pad_add), _ptr(attn_add),
                 *(params[name].data_ptr() for name in PARAM_NAMES),
                 qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), h.data_ptr(),
                 out.data_ptr(), B, L, D, F, n_head, _ACT_CODES[activation],
                 float(eps), 1.0 / math.sqrt(D // n_head), stream)
    fused_transformer_layer.launches += 1
    return out


def _layer_cuda_train(x, params, pad_add, attn_add, n_head, activation, eps, dropout,
                      seed) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K1, training mode: ``(out, residuals of K2)``."""
    from . import _native
    _check_layer(x, params, pad_add, attn_add)
    B, L, D = x.shape
    F = params["linear1_weight"].shape[0]
    dev = x.device
    M = B * L
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    saved = {"qkv": empty(M, 3 * D), "attn": empty(M, D), "x1": empty(M, D), "h": empty(M, F),
             "stats": empty(B, n_head, L, 2), "xhat1": empty(M, D), "rstd1": empty(M),
             "hpre": empty(M, F), "xhat2": empty(M, D), "rstd2": empty(M)}
    out = torch.empty_like(x)
    lib = _native.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("rs_transformer_layer_fwd_train", x.data_ptr(), _ptr(pad_add), _ptr(attn_add),
                 *(params[name].data_ptr() for name in PARAM_NAMES),
                 *(saved[k].data_ptr() for k in ("qkv", "attn", "x1", "h")), out.data_ptr(),
                 *(saved[k].data_ptr() for k in ("stats", "xhat1", "rstd1", "hpre", "xhat2",
                                                 "rstd2")),
                 B, L, D, F, n_head, _ACT_CODES[activation], float(eps),
                 1.0 / math.sqrt(D // n_head), *_drop_call_args(dropout, seed), stream)
    fused_transformer_layer.launches += 1
    return out, saved


def _layer_bwd_cuda(g, x, params, pad_add, attn_add, n_head, activation, eps, dropout, seed,
                    saved) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K2: ``(dx, {name: grad})`` from the residuals of ``_layer_cuda_train``."""
    from . import _native
    _check_layer(x, params, pad_add, attn_add)
    B, L, D = x.shape
    F = params["linear1_weight"].shape[0]
    dev = x.device
    M = B * L
    _check(g, "output gradient", (B, L, D), dev)
    for name, shape in (("qkv", (M, 3 * D)), ("attn", (M, D)), ("x1", (M, D)), ("h", (M, F)),
                        ("stats", (B, n_head, L, 2)), ("xhat1", (M, D)), ("rstd1", (M,)),
                        ("hpre", (M, F)), ("xhat2", (M, D)), ("rstd2", (M,))):
        _check(saved[name], name, shape, dev)
    dx = torch.empty_like(x)
    grads = {n: torch.empty_like(params[n]) for n in PARAM_NAMES}
    lib = _native.load()
    with torch.cuda.device(dev):
        # the weight gradients' row ranges, and so the scratch, depend on the card
        work = torch.empty(int(lib.lib.rs_transformer_layer_bwd_workspace(B, L, D, F, n_head)),
                           dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("rs_transformer_layer_bwd", x.data_ptr(), _ptr(pad_add), _ptr(attn_add),
                 *(params[n].data_ptr() for n in ("in_proj_weight", "out_proj_weight",
                                                  "norm1_weight", "linear1_weight",
                                                  "linear2_weight", "norm2_weight")),
                 *(saved[k].data_ptr() for k in ("qkv", "attn", "stats", "x1", "xhat1",
                                                 "rstd1", "hpre", "h", "xhat2", "rstd2")),
                 g.data_ptr(), dx.data_ptr(), *(grads[n].data_ptr() for n in PARAM_NAMES),
                 work.data_ptr(), work.numel(), B, L, D, F, n_head, _ACT_CODES[activation],
                 1.0 / math.sqrt(D // n_head), *_drop_call_args(dropout, seed), stream)
    fused_transformer_layer_bwd.launches += 1
    return dx, grads


class _FusedLayerTrain(torch.autograd.Function):
    """K1 in training mode, with K2 as its backward (``jax.custom_vjp`` at
    ``transformer_layer.py:459-473``). The masks and the configuration are
    constants; the residuals of K2 live on ``ctx`` until the backward."""

    @staticmethod
    def forward(ctx, x, pad_add, attn_add, n_head, activation, eps, dropout, seed, *weights):
        params = dict(zip(PARAM_NAMES, weights))
        out, saved = _layer_cuda_train(x, params, pad_add, attn_add, n_head, activation, eps,
                                       dropout, seed)
        ctx.save_for_backward(x, *weights)
        ctx.masks = (pad_add, attn_add)
        ctx.config = (n_head, activation, eps, dropout, seed)
        ctx.residuals = saved
        return out

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        dx, grads = _layer_bwd_cuda(g.contiguous(), x, dict(zip(PARAM_NAMES, weights)),
                                    *ctx.masks, *ctx.config, ctx.residuals)
        ctx.residuals = None
        return (dx, None, None, None, None, None, None, None,
                *(grads[n] for n in PARAM_NAMES))


def _cuda_masks(x, key_padding_mask, attn_mask, n_head, dim_feedforward, activation):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, L, D = x.shape
    if not supports_fused_layer(D, L, n_head, dim_feedforward, activation):
        raise ValueError("shape or activation outside the fused layer's gate")
    return additive_masks(key_padding_mask, attn_mask)


def fused_transformer_layer(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            key_padding_mask: Optional[torch.Tensor],
                            attn_mask: Optional[torch.Tensor], n_head: int,
                            dropout: float, activation: str, layer_norm_eps: float,
                            training: bool, seed: int = 0) -> torch.Tensor:
    """Apply the fused layer to ``x [B, L, D]``.

    ``key_padding_mask``: bool ``[B, L]`` (True = pad); ``attn_mask``: bool
    ``[L, L]`` (True = disallow). In training mode the layer drops at rate
    ``dropout`` with the masks of ``seed`` and is differentiable (K2).
    """
    if x.device.type == "cpu":
        return transformer_layer_plain(x, params, key_padding_mask, attn_mask, n_head,
                                       activation, layer_norm_eps, dropout, seed, training)
    pad_add, attn_add = _cuda_masks(x, key_padding_mask, attn_mask, n_head,
                                    params["linear1_weight"].shape[0], activation)
    if not training:
        return _layer_cuda(x, params, pad_add, attn_add, n_head, activation, layer_norm_eps)
    return _FusedLayerTrain.apply(x, pad_add, attn_add, n_head, activation,
                                  float(layer_norm_eps), float(dropout), int(seed),
                                  *(params[n] for n in PARAM_NAMES))


def fused_transformer_layer_bwd(g: torch.Tensor, x: torch.Tensor,
                                params: Dict[str, torch.Tensor],
                                key_padding_mask: Optional[torch.Tensor],
                                attn_mask: Optional[torch.Tensor], n_head: int,
                                dropout: float, activation: str, layer_norm_eps: float,
                                seed: int, residuals: Optional[Dict[str, torch.Tensor]] = None
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The backward of a training call of the layer: ``(dx, {name: grad})``
    for the output gradient ``g``. On a CUDA tensor it launches K2 on the
    ``residuals`` of that call (from ``training_residuals``); on a CPU
    tensor it recomputes the plain forward, as the Pallas ``_bwd_kernel``
    recomputes its own."""
    if x.device.type == "cpu":
        return transformer_layer_bwd_plain(g, x, params, key_padding_mask, attn_mask, n_head,
                                           dropout, activation, layer_norm_eps, seed)
    pad_add, attn_add = _cuda_masks(x, key_padding_mask, attn_mask, n_head,
                                    params["linear1_weight"].shape[0], activation)
    if residuals is None:
        raise ValueError("K2 on a CUDA tensor needs the residuals of the forward call")
    return _layer_bwd_cuda(g, x, params, pad_add, attn_add, n_head, activation, layer_norm_eps,
                           dropout, seed, residuals)


def weight_grad_splits(B: int, L: int, D: int, F: int,
                       device: Optional[torch.device] = None) -> Dict[str, Tuple[int, int]]:
    """K2's row ranges of each weight gradient on the current (or given)
    CUDA device: ``{name: (S, rows)}``, S ranges of ``rows`` rows (a
    multiple of the k-slice ``K2_GEMM_TILE[2]``, the last one possibly
    shorter) that cover the ``B L`` rows once."""
    import ctypes
    from . import _native
    lib = _native.load()
    shapes = {"linear2_weight": (D, F), "linear1_weight": (F, D),
              "out_proj_weight": (D, D), "in_proj_weight": (3 * D, D)}
    out = {}
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        for name in WEIGHT_GRADS:
            rows = ctypes.c_int(0)
            S = int(lib.lib.rs_transformer_layer_bwd_splits(B * L, *shapes[name],
                                                            ctypes.addressof(rows)))
            out[name] = (S, rows.value)
    return out


def forward_tiles(B: int, L: int, D: int, F: int, training: bool = False,
                  device: Optional[torch.device] = None) -> Dict[str, Tuple[int, int]]:
    """K1's output tile ``(rows, columns)`` of each product in eval or
    training mode on the current (or given) CUDA device: ``{"qkv",
    "out_proj", "linear1", "linear2"}``."""
    import ctypes
    from . import _native
    lib = _native.load()
    tiles = (ctypes.c_int * 8)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        lib.lib.rs_transformer_layer_fwd_tiles(B * L, D, F, int(training), tiles)
    return {name: (tiles[2 * i], tiles[2 * i + 1])
            for i, name in enumerate(("qkv", "out_proj", "linear1", "linear2"))}


def training_residuals(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       key_padding_mask: Optional[torch.Tensor],
                       attn_mask: Optional[torch.Tensor], n_head: int, dropout: float,
                       activation: str, layer_norm_eps: float, seed: int
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K1 in training mode outside autograd: ``(out, residuals)`` for
    ``fused_transformer_layer_bwd`` (CUDA tensors only)."""
    pad_add, attn_add = _cuda_masks(x, key_padding_mask, attn_mask, n_head,
                                    params["linear1_weight"].shape[0], activation)
    return _layer_cuda_train(x, params, pad_add, attn_add, n_head, activation, layer_norm_eps,
                             dropout, seed)


fused_transformer_layer.launches = 0
fused_transformer_layer_bwd.launches = 0
