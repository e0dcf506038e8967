"""Fused post-LN transformer encoder layer, forward.

Counterpart of ``recstudio_tpu/ops/transformer_layer.py``:

    qkv = x Wqkv^T + b
    per head: A = softmax(max(Q K^T / sqrt(Dh) + masks, finfo.min)) V
    x1 = LN1(x + A Wo^T + bo)
    out = LN2(x1 + act(x1 W1^T + b1) W2^T + b2)

- On a CUDA tensor, ``fused_transformer_layer`` launches the hand-written
  kernel chain ``csrc/transformer_layer.cu`` (K1, replacing the Pallas
  ``_fwd_kernel``) or raises; it counts its launches in
  ``fused_transformer_layer.launches``.
- On a CPU tensor it computes the same function with
  ``transformer_layer_plain``.

Weights follow PyTorch's ``[out, in]`` layout (``utils/convert.py`` maps
the JAX package's ``[in, out]`` kernels). Eval mode only: training-mode
dropout comes with the backward kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .attention import additive_masks, mha_plain

PARAM_NAMES = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias",
               "norm1_weight", "norm1_bias", "linear1_weight", "linear1_bias",
               "linear2_weight", "linear2_bias", "norm2_weight", "norm2_bias")
_ACT_CODES = {"relu": 1, "gelu": 2}


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


def transformer_layer_plain(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            key_padding_mask: Optional[torch.Tensor],
                            attn_mask: Optional[torch.Tensor], n_head: int,
                            activation: str, layer_norm_eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (eval mode). x: ``[B, L, D]``."""
    B, L, D = x.shape
    qkv = torch.matmul(x, params["in_proj_weight"].t()) + params["in_proj_bias"]
    heads = lambda t: t.reshape(B, L, n_head, D // n_head).transpose(1, 2)
    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    a = mha_plain(q, k, v, *additive_masks(key_padding_mask, attn_mask))
    a = a.transpose(1, 2).reshape(B, L, D)
    o = torch.matmul(a, params["out_proj_weight"].t()) + params["out_proj_bias"]
    x1 = layer_norm(x + o, params["norm1_weight"], params["norm1_bias"], layer_norm_eps)
    h = torch.matmul(x1, params["linear1_weight"].t()) + params["linear1_bias"]
    h = gelu_tanh(h) if activation == "gelu" else torch.relu(h)
    f = torch.matmul(h, params["linear2_weight"].t()) + params["linear2_bias"]
    return layer_norm(x1 + f, params["norm2_weight"], params["norm2_bias"], layer_norm_eps)


def _layer_cuda(x, params, pad_add, attn_add, n_head, activation, eps) -> torch.Tensor:
    from . import _native
    from .attention import _check
    B, L, D = x.shape
    F = params["linear1_weight"].shape[0]
    dev = x.device
    _check(x, "x", (B, L, D), dev)
    shapes = {"in_proj_weight": (3 * D, D), "in_proj_bias": (3 * D,),
              "out_proj_weight": (D, D), "out_proj_bias": (D,),
              "norm1_weight": (D,), "norm1_bias": (D,),
              "linear1_weight": (F, D), "linear1_bias": (F,),
              "linear2_weight": (D, F), "linear2_bias": (D,),
              "norm2_weight": (D,), "norm2_bias": (D,)}
    for name, shape in shapes.items():
        _check(params[name], name, shape, dev)
    if pad_add is not None:
        _check(pad_add, "key padding mask", (B, L), dev)
    if attn_add is not None:
        _check(attn_add, "attention mask", (L, L), dev)
    M = B * L
    qkv = torch.empty((M, 3 * D), dtype=torch.float32, device=dev)
    attn = torch.empty((M, D), dtype=torch.float32, device=dev)
    x1 = torch.empty((M, D), dtype=torch.float32, device=dev)
    h = torch.empty((M, F), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _native.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.call("rs_transformer_layer_fwd", x.data_ptr(), ptr(pad_add), ptr(attn_add),
                 *(params[name].data_ptr() for name in PARAM_NAMES),
                 qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), h.data_ptr(),
                 out.data_ptr(), B, L, D, F, n_head, _ACT_CODES[activation],
                 float(eps), 1.0 / math.sqrt(D // n_head), stream)
    fused_transformer_layer.launches += 1
    return out


def fused_transformer_layer(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            key_padding_mask: Optional[torch.Tensor],
                            attn_mask: Optional[torch.Tensor], n_head: int,
                            dropout: float, activation: str, layer_norm_eps: float,
                            training: bool) -> torch.Tensor:
    """Apply the fused layer to ``x [B, L, D]``.

    ``key_padding_mask``: bool ``[B, L]`` (True = pad); ``attn_mask``: bool
    ``[L, L]`` (True = disallow).
    """
    if training and dropout > 0:
        raise NotImplementedError(
            "training-mode dropout in the fused layer comes with its backward kernel")
    if x.device.type == "cpu":
        return transformer_layer_plain(x, params, key_padding_mask, attn_mask, n_head,
                                       activation, layer_norm_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, L, D = x.shape
    if not supports_fused_layer(D, L, n_head, params["linear1_weight"].shape[0], activation):
        raise ValueError("shape or activation outside the fused layer's gate")
    return _layer_cuda(x, params, *additive_masks(key_padding_mask, attn_mask),
                       n_head, activation, layer_norm_eps)


fused_transformer_layer.launches = 0
