"""Sequence building blocks: transformer encoder and sequence pooling.

Counterpart of the parts of ``recstudio_tpu/models/module/layers.py`` that
SASRec uses. ``TransformerLayer`` owns its parameters directly, in
PyTorch's ``[out, in]`` layout, so the whole layer can go to the fused
kernel (``ops/transformer_layer.py``) with the same two-way dispatch as the
JAX module (``layers.py:391-433``):

- inside the fused layer's gate (d <= 256, F <= 1024, L <= 256, gelu or
  relu, a 2-D mask): ``fused_transformer_layer`` (K1, with K2 as its
  backward in training mode);
- otherwise: the projections in PyTorch and the attention through
  ``fused_mha`` (K3), as ``_xla_layer``; with training dropout the
  attention keeps the dense plain path, as ``_xla_layer`` does.

In training mode with dropout, each layer call draws its seed from the
``torch.Generator`` passed as ``rng`` (the model's), as the JAX layer draws
it from ``make_rng("dropout")``. On CPU tensors both ops use their plain
versions. Setting ``plain = True`` on a layer sends it through the plain
versions on any device; that is how the kernels are held against them on
the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...ops.attention import fused_mha
from ...ops.dropout import draw_seed
from ...ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer, layer_tail,
                                      param_shapes, qkv_heads,
                                      supports_fused_layer, transformer_layer_plain)


class SeqPoolingLayer(nn.Module):
    """Pooling over padded sequences ``[B, L, D]`` with true lengths
    ``seq_len`` (``layers.py:210-251``): sum, mean, max or last, where last
    reads position ``max(seq_len - 1, 0)``."""

    def __init__(self, pooling_type: str = "mean"):
        super().__init__()
        if pooling_type not in ("sum", "mean", "max", "last"):
            raise ValueError(f"unsupported pooling {pooling_type}")
        self.pooling_type = pooling_type

    def forward(self, x: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
        B, L = x.shape[0], x.shape[1]
        seq_len = seq_len.to(torch.long)
        if self.pooling_type == "last":
            gather = torch.clamp_min(seq_len - 1, 0)
            return x[torch.arange(B, device=x.device), gather]
        mask = torch.arange(L, device=x.device)[None, :] < seq_len[:, None]
        if self.pooling_type == "max":
            return torch.where(mask[..., None], x, float("-inf")).amax(dim=1)
        out = (x * mask[..., None].to(x.dtype)).sum(dim=1)
        if self.pooling_type == "mean":
            out = out / torch.clamp_min(seq_len, 1)[:, None].to(x.dtype)
        return out


class TransformerLayer(nn.Module):
    """Post-LN transformer encoder block (``layers.py:352-454``)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.d_model, self.n_head, self.dim_feedforward = d_model, n_head, dim_feedforward
        self.dropout, self.activation = dropout, activation
        self.layer_norm_eps = float(layer_norm_eps)
        self.plain = False
        for name, shape in param_shapes(d_model, dim_feedforward).items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if attn_mask is not None and attn_mask.dim() != 2:
            raise NotImplementedError("per-example attention masks are not ported yet")
        p = self.dropout if self.training else 0.0
        seed = draw_seed(rng) if p > 0 else 0
        args = (x, self.params(), key_padding_mask, attn_mask, self.n_head)
        fused = supports_fused_layer(self.d_model, x.shape[1], self.n_head,
                                     self.dim_feedforward, self.activation)
        if self.plain or (not fused and p > 0):
            return transformer_layer_plain(*args, self.activation, self.layer_norm_eps, p, seed,
                                           self.training)
        if fused:
            return fused_transformer_layer(*args, self.dropout, self.activation,
                                           self.layer_norm_eps, self.training, seed)
        # projections in PyTorch, attention through fused_mha (K3)
        q, k, v = qkv_heads(x, self.params(), self.n_head)
        attn = fused_mha(q, k, v, key_padding_mask, attn_mask)
        return layer_tail(x, attn, self.params(), self.activation, self.layer_norm_eps)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.0, activation: str = "gelu", layer_norm_eps: float = 1e-5):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, n_head, dim_feedforward, dropout, activation,
                             layer_norm_eps) for _ in range(num_layers))

    def forward(self, x, key_padding_mask=None, attn_mask=None, rng=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask=key_padding_mask, attn_mask=attn_mask, rng=rng)
        return x
