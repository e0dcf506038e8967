"""Sequence building blocks: transformer encoder, GRU, feedforward
attention, MLP and sequence pooling.

Counterpart of the parts of ``recstudio_tpu/models/module/layers.py`` that
SASRec, BERT4Rec, GRU4Rec, NARM and STAMP use. ``TransformerLayer`` owns its parameters directly, in
PyTorch's ``[out, in]`` layout, so the whole layer can go to the fused
kernel (``ops/transformer_layer.py``) with the same two-way dispatch as the
JAX module (``layers.py:391-433``):

- inside the fused layer's gate (d <= 256, F <= 1024, L <= 256, gelu or
  relu, a 2-D mask): ``fused_transformer_layer`` (K1, with K2 as its
  backward in training mode);
- otherwise, in eval mode or with dropout 0: the projections in PyTorch and
  the attention through ``fused_mha``, as ``_xla_layer`` does
  (``layers.py:413-421``): K3 for L <= 512 (its backward autograd of the
  plain version), the flash kernels above (K4 forward, K5 and K6 backward);
- otherwise (training with dropout > 0): the dense plain layer, which is
  what ``_xla_layer`` computes there (``layers.py:422-433``, no kernel: the
  JAX package's attention kernels have no dropout inside the softmax).

In training mode with dropout, each layer call draws its seed from the
``torch.Generator`` passed as ``rng`` (the model's), as the JAX layer draws
it from ``make_rng("dropout")``. On CPU tensors both ops use their plain
versions. Setting ``plain = True`` on a layer sends it through the plain
versions on any device; that is how the kernels are held against them on
the card.

The GRU, the feedforward attention and the MLP reach no Pallas kernel in
the JAX package (its GRU is an ``nn.scan`` that XLA compiles), so they have
no hand-written kernel here: ``GRULayer`` runs each layer through cuDNN on
the card (``gru_layer``, float32 in both passes) and through PyTorch's own
GRU on the CPU; ``gru_layer_plain``, one step a position in a Python loop,
is its reference on either device (``GRULayer.plain``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import fused_mha
from ...ops.dropout import SITE_HIDDEN, draw_seed, keep_scale
from ...ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer, layer_tail,
                                      param_shapes, qkv_heads,
                                      supports_fused_layer, transformer_layer_plain)
from ..loss_func import softplus


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ``get_act``'s table (``layers.py:83-107``): jax.nn's definitions (gelu in
# its default tanh form, leaky_relu's slope 0.01, prelu as leaky_relu)
_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "leakyrelu": F.leaky_relu, "leaky_relu": F.leaky_relu, "prelu": F.leaky_relu,
    "identity": _identity, "none": _identity,
    "gelu": lambda x: F.gelu(x, approximate="tanh"), "elu": F.elu,
    "softmax": lambda x: torch.softmax(x, dim=-1), "softplus": softplus,
}


def get_act(activation) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation by name, a callable as it is, ``None`` the identity.
    ``dice`` needs ``SimpleBatchNorm``, which is not ported yet."""
    if activation is None:
        return _identity
    if not isinstance(activation, str):
        return activation
    name = activation.lower()
    if name == "dice":
        raise NotImplementedError("the dice activation needs SimpleBatchNorm, not ported yet")
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation}")
    return _ACTIVATIONS[name]


def seeded_dropout(x: torch.Tensor, p: float, training: bool, rng: Optional[torch.Generator],
                   site: int = SITE_HIDDEN) -> torch.Tensor:
    """Dropout at rate ``p`` with a seed drawn from ``rng`` (training mode)."""
    if not training or p <= 0:
        return x
    return x * keep_scale(x.shape, p, draw_seed(rng), site, x.device)


class MLPModule(nn.Module):
    """``layers.py:110-139``: for each layer, dropout, ``Linear`` (named
    ``dense_{i}`` as the JAX package's), then the activation, which the last
    layer takes only with ``last_activation``. ``mlp_layers`` lists the
    input width first."""

    def __init__(self, mlp_layers: Sequence[int], activation_func="relu", dropout: float = 0.0,
                 bias: bool = True, batch_norm: bool = False, last_activation: bool = True):
        super().__init__()
        if batch_norm:
            raise NotImplementedError("MLPModule's batch_norm needs SimpleBatchNorm, "
                                      "not ported yet")
        sizes = list(mlp_layers)
        self.n_layers = len(sizes) - 1
        self.dropout, self.last_activation = dropout, last_activation
        self.act = get_act(activation_func)
        for i in range(self.n_layers):
            self.add_module(f"dense_{i}", nn.Linear(sizes[i], sizes[i + 1], bias=bias))

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(seeded_dropout(x, self.dropout, self.training, rng))
            if i < self.n_layers - 1 or self.last_activation:
                x = self.act(x)
        return x


def gru_layer_plain(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                    b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One GRU layer over ``x [B, L, in]`` from ``h0 = 0``: every position's
    state ``[B, L, H]``. The inputs are projected once; then one step a
    position, with PyTorch's (and ``GRUCell``'s, ``layers.py:167-179``)
    gates in ``r, z, n`` order: ``n = tanh(W_in x + b_in + r o (W_hn h +
    b_hn))``, ``h' = (1 - z) o n + z o h``."""
    gx = torch.matmul(x, w_ih.t()) + b_ih
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    out = []
    for t in range(x.shape[1]):
        xr, xz, xn = gx[:, t].chunk(3, dim=-1)
        hr, hz, hn = (torch.matmul(h, w_hh.t()) + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out, dim=1)


def _float32_cudnn():
    """cuDNN on, TF32 off, every other cuDNN setting as it stands, for the
    scope of a block. cuDNN's RNN takes TF32 for float32 by default
    (``torch.backends.cudnn.allow_tf32`` is True) and every other product
    of the port is float32; the setting is read where the forward and the
    backward build their descriptors, so both run inside this block, and
    the caller's setting is restored when the block ends."""
    c = torch.backends.cudnn
    return c.flags(enabled=True, benchmark=c.benchmark, benchmark_limit=c.benchmark_limit,
                   deterministic=c.deterministic, allow_tf32=False)


def _vf_gru(x: torch.Tensor, weights: Sequence[torch.Tensor], train: bool) -> torch.Tensor:
    h0 = x.new_zeros(1, x.shape[0], weights[1].shape[1])
    out, _ = torch._VF.gru(x, h0, list(weights), True, 1, 0.0, train, False, True)
    return out


class _CudnnGru(torch.autograd.Function):
    """One cuDNN GRU layer whose forward and backward both run in float32.
    The forward records cuDNN's own graph on detached inputs; the backward
    differentiates that graph inside the same float32 block."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b_ih, b_hh):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x, w_ih, w_hh, b_ih, b_hh), ctx.needs_input_grad)]
        with torch.enable_grad(), _float32_cudnn():
            out = _vf_gru(leaves[0], leaves[1:], train=True)
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        leaves, out = ctx.leaves, ctx.out
        ctx.leaves = ctx.out = None
        with _float32_cudnn():
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def gru_layer(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> torch.Tensor:
    """``gru_layer_plain``'s function through cuDNN on a CUDA tensor, in
    float32 in both passes (``_float32_cudnn``), counted in
    ``gru_layer.launches``; it raises where cuDNN cannot take the input and
    never falls back to the loop. On a CPU tensor, PyTorch's own GRU."""
    weights = (w_ih, w_hh, b_ih, b_hh)
    if not x.is_cuda:
        return _vf_gru(x, weights, train=torch.is_grad_enabled())
    with _float32_cudnn():
        if x.dtype != torch.float32 or not torch.backends.cudnn.is_acceptable(x):
            raise RuntimeError(f"cuDNN cannot run this GRU ({x.dtype} on {x.device})")
    gru_layer.launches += 1
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        return _CudnnGru.apply(x, *weights)
    with _float32_cudnn():
        return _vf_gru(x, weights, train=False)


gru_layer.launches = 0


class GRULayer(nn.Module):
    """A stack of ``num_layer`` GRU layers over ``[B, L, input_dim]``
    (``layers.py:182-207``): every position's state ``[B, L, output_dim]``,
    each layer from ``h0 = 0`` and followed by dropout at ``dropout``
    (training mode, seeds from ``rng``). Padded positions run through the
    recurrence as in the JAX package; pooling and masks hide them. Each
    layer's weights are an ``nn.GRU``'s (``weight_ih_l0 [3H, in]``,
    ``weight_hh_l0 [3H, H]``, ``bias_ih_l0``, ``bias_hh_l0``: the JAX
    ``ih``/``hh`` kernels transposed), so cuDNN finds them in one buffer;
    the ``nn.GRU`` modules' own forward is not used."""

    def __init__(self, input_dim: int, output_dim: int, num_layer: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.plain = False
        self.layers = nn.ModuleList(
            nn.GRU(input_dim if i == 0 else output_dim, output_dim, batch_first=True)
            for i in range(num_layer))

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for gru in self.layers:
            weights = gru.all_weights[0]
            x = gru_layer_plain(x, *weights) if self.plain else gru_layer(x, *weights)
            x = seeded_dropout(x, self.dropout, self.training, rng)
        return x


class AttentionLayer(nn.Module):
    """``layers.py:302-349``, in ``feedforward`` mode (the query broadcast
    against every key, the two concatenated, ``MLPModule([q_dim + k_dim,
    *mlp_layers])`` and ``mlp_out``, a ``Linear(., 1)`` that always has a
    bias) and ``scaled-dot-product`` mode; the weights divided by
    ``sqrt(q_dim)``, padded keys given weight 0 (``softmax=False``, NARM's
    and STAMP's) or -inf before a softmax, and ``weights @ value``
    returned. ``multi-head`` is not ported yet."""

    def __init__(self, q_dim: int, k_dim: Optional[int] = None, mlp_layers: Sequence[int] = (),
                 activation: str = "sigmoid", bias: bool = True,
                 attention_type: str = "feedforward"):
        super().__init__()
        if attention_type not in ("feedforward", "scaled-dot-product"):
            raise NotImplementedError(f"attention_type {attention_type!r} is not ported yet")
        self.attention_type = attention_type
        if attention_type == "feedforward":
            k_dim = q_dim if k_dim is None else k_dim
            self.mlp = MLPModule([q_dim + k_dim, *mlp_layers], activation, bias=bias)
            self.mlp_out = nn.Linear(([q_dim + k_dim] + list(mlp_layers))[-1], 1)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                softmax: bool = False) -> torch.Tensor:
        if self.attention_type == "feedforward":
            B, Lq, S = query.shape[0], query.shape[1], key.shape[1]
            h = torch.cat([query[:, :, None, :].expand(B, Lq, S, query.shape[-1]),
                           key[:, None, :, :].expand(B, Lq, S, key.shape[-1])], dim=-1)
            w = self.mlp_out(self.mlp(h)).squeeze(-1)                   # [B, Lq, S]
        else:
            w = torch.matmul(query, key.transpose(1, 2))
        w = w / math.sqrt(query.shape[-1])
        if key_padding_mask is not None:
            w = w.masked_fill(key_padding_mask[:, None, :], float("-inf") if softmax else 0.0)
        if softmax:
            w = torch.softmax(w, dim=-1)
        return torch.matmul(w, value)


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
        # projections in PyTorch, attention through fused_mha (K3, or K4-K6 at L > 512)
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
