"""Sequence building blocks: transformer encoder and sequence pooling.

Counterpart of the parts of ``recstudio_tpu/models/module/layers.py`` that
SASRec uses. ``TransformerLayer`` owns its parameters directly, in
PyTorch's ``[out, in]`` layout, so the whole layer can go to the fused
kernel (``ops/transformer_layer.py``) with the same two-way dispatch as the
JAX module (``layers.py:391-403``):

- inside the fused layer's gate (d <= 256, F <= 1024, L <= 256, gelu or
  relu, a 2-D mask): ``fused_transformer_layer`` (K1);
- otherwise: the projections in PyTorch and the attention through
  ``fused_mha`` (K3), as ``_xla_layer`` (``layers.py:405-433``).

On CPU tensors both ops use their plain versions. Setting ``plain = True``
on a layer sends it through the plain versions on any device; that is how
the kernels are held against them on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...ops.attention import additive_masks, fused_mha, mha_plain
from ...ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer, gelu_tanh,
                                      layer_norm, supports_fused_layer,
                                      transformer_layer_plain)


def get_act(name: str):
    """relu, or gelu in the tanh form of ``jax.nn.gelu``."""
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return gelu_tanh
    raise ValueError(f"unsupported activation: {name}")


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
    """Post-LN transformer encoder block (``layers.py:352-454``), eval mode."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.d_model, self.n_head, self.dim_feedforward = d_model, n_head, dim_feedforward
        self.dropout, self.activation = dropout, activation
        self.layer_norm_eps = float(layer_norm_eps)
        self.plain = False
        d, F = d_model, dim_feedforward
        shapes = {"in_proj_weight": (3 * d, d), "in_proj_bias": (3 * d,),
                  "out_proj_weight": (d, d), "out_proj_bias": (d,),
                  "norm1_weight": (d,), "norm1_bias": (d,),
                  "linear1_weight": (F, d), "linear1_bias": (F,),
                  "linear2_weight": (d, F), "linear2_bias": (d,),
                  "norm2_weight": (d,), "norm2_bias": (d,)}
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name])))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training and self.dropout > 0:
            raise NotImplementedError("training is not ported yet: call .eval()")
        L = x.shape[1]
        if (supports_fused_layer(self.d_model, L, self.n_head, self.dim_feedforward,
                                 self.activation)
                and (attn_mask is None or attn_mask.dim() == 2)):
            if self.plain:
                return transformer_layer_plain(x, self.params(), key_padding_mask, attn_mask,
                                               self.n_head, self.activation,
                                               self.layer_norm_eps)
            return fused_transformer_layer(x, self.params(), key_padding_mask, attn_mask,
                                           self.n_head, self.dropout, self.activation,
                                           self.layer_norm_eps, self.training)
        return self._unfused_layer(x, key_padding_mask, attn_mask)

    def _unfused_layer(self, x, key_padding_mask, attn_mask):
        """Projections in PyTorch, attention through ``fused_mha``."""
        if attn_mask is not None and attn_mask.dim() != 2:
            raise NotImplementedError("per-example attention masks are not ported yet")
        B, L, d = x.shape
        H = self.n_head
        qkv = torch.matmul(x, self.in_proj_weight.t()) + self.in_proj_bias
        heads = lambda t: t.reshape(B, L, H, d // H).transpose(1, 2).contiguous()
        q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
        if self.plain:
            attn = mha_plain(q, k, v, *additive_masks(key_padding_mask, attn_mask))
        else:
            attn = fused_mha(q, k, v, key_padding_mask, attn_mask)
        attn = attn.transpose(1, 2).reshape(B, L, d)
        attn = torch.matmul(attn, self.out_proj_weight.t()) + self.out_proj_bias
        x = layer_norm(x + attn, self.norm1_weight, self.norm1_bias, self.layer_norm_eps)
        h = get_act(self.activation)(torch.matmul(x, self.linear1_weight.t())
                                     + self.linear1_bias)
        h = torch.matmul(h, self.linear2_weight.t()) + self.linear2_bias
        return layer_norm(x + h, self.norm2_weight, self.norm2_bias, self.layer_norm_eps)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, n_head: int, dim_feedforward: int,
                 dropout: float = 0.0, activation: str = "gelu", layer_norm_eps: float = 1e-5):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, n_head, dim_feedforward, dropout, activation,
                             layer_norm_eps) for _ in range(num_layers))

    def forward(self, x, key_padding_mask=None, attn_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask=key_padding_mask, attn_mask=attn_mask)
        return x
