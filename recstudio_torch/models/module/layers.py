"""Building blocks: transformer encoder, GRU, attention, MLP, batch norm
and sequence pooling.

Counterpart of the parts of ``recstudio_tpu/models/module/layers.py`` that
SASRec, BERT4Rec, GRU4Rec, NARM, STAMP and the rankers use. ``TransformerLayer`` owns its parameters directly, in
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

``MultiHeadAttention`` (AutoInt's) sends its heads to ``fused_mha`` under
the JAX gate: K3 in evaluation and serving, the plain softmax where
dropout acts on the weights. ``SimpleBatchNorm`` keeps calibrated
statistics in buffers (``Recommender._refresh_net_state``).

The GRU, the feedforward attention and the MLP reach no Pallas kernel in
the JAX package (its GRU is an ``nn.scan`` that XLA compiles), so they have
no hand-written kernel here: ``GRULayer`` runs each layer through cuDNN on
the card (``gru_layer``, float32 in both passes) and through PyTorch's own
GRU on the CPU; ``gru_layer_plain``, one step a position in a Python loop,
is its reference on either device (``GRULayer.plain``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

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


class SimpleBatchNorm(nn.Module):
    """Batch normalization with calibrated population statistics
    (``layers.py:18-68``). In training mode it normalizes with the batch's
    statistics (the last axis is the feature axis, every other axis a batch
    axis; the variance is the population variance). The statistics
    ``mean``, ``var`` and ``count`` are buffers, not parameters, so no
    optimizer touches them: they move only in a calibration pass
    (``calibrating`` set, by ``Recommender._refresh_net_state``), which
    keeps a cumulative average of the batch means and variances, counts
    the batches, and normalizes with the batch's statistics. In eval mode
    it normalizes with the calibrated statistics, or with the batch's
    while ``count`` is 0."""

    def __init__(self, num_features: int, epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.calibrating = False
        self.scale = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.dim() - 1))
        batch_mean = x.mean(axes)
        batch_var = x.var(axes, unbiased=False)
        if self.calibrating:
            with torch.no_grad():
                k = self.count + 1.0
                self.mean.add_((batch_mean - self.mean) / k)
                self.var.add_((batch_var - self.var) / k)
                self.count.copy_(k)
        if self.training or self.calibrating:
            mean, var = batch_mean, batch_var
        else:
            seen = self.count > 0
            mean = torch.where(seen, self.mean, batch_mean)
            var = torch.where(seen, self.var, batch_var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y


class Dice(nn.Module):
    """The data-adaptive activation of DIN (``layers.py:70-81``): ``x p +
    alpha x (1 - p)``, p the sigmoid of ``x`` batch-normalized without
    scale or bias (epsilon 1e-8)."""

    def __init__(self, emb_size: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(emb_size))
        self.bn = SimpleBatchNorm(emb_size, epsilon=1e-8, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.bn(x))
        return x * p + self.alpha * x * (1.0 - p)


def get_act(activation, dim: Optional[int] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation by name, a callable as it is, ``None`` the identity;
    ``dice`` is a new ``Dice`` module over ``dim`` features."""
    if activation is None:
        return _identity
    if not isinstance(activation, str):
        return activation
    name = activation.lower()
    if name == "dice":
        if dim is None:
            raise ValueError("the dice activation needs a dimension")
        return Dice(dim)
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
    ``dense_{i}`` as the JAX package's), ``SimpleBatchNorm`` (``bn_{i}``)
    with ``batch_norm``, then the activation. The last layer takes the
    batch norm only with ``last_bn`` and the activation only with
    ``last_activation``. ``mlp_layers`` lists the input width first. The
    ``dice`` activation is a module a layer (``Dice_{i}``, the JAX
    package's automatic names)."""

    def __init__(self, mlp_layers: Sequence[int], activation_func="relu", dropout: float = 0.0,
                 bias: bool = True, batch_norm: bool = False, last_activation: bool = True,
                 last_bn: bool = True):
        super().__init__()
        sizes = list(mlp_layers)
        self.n_layers = len(sizes) - 1
        self.dropout = dropout
        self.acts: List[Callable[[torch.Tensor], torch.Tensor]] = []
        for i in range(self.n_layers):
            is_last = i == self.n_layers - 1
            self.add_module(f"dense_{i}", nn.Linear(sizes[i], sizes[i + 1], bias=bias))
            if batch_norm and (not is_last or last_bn):
                self.add_module(f"bn_{i}", SimpleBatchNorm(sizes[i + 1]))
            act = get_act(activation_func, sizes[i + 1]) \
                if not is_last or last_activation else _identity
            if isinstance(act, nn.Module):
                self.add_module(f"Dice_{i}", act)
            self.acts.append(act)

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(seeded_dropout(x, self.dropout, self.training, rng))
            bn = getattr(self, f"bn_{i}", None)
            if bn is not None:
                x = bn(x)
            x = self.acts[i](x)
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


class GRUCell(nn.Module):
    """One GRU step ``(h, x) -> h'`` (``layers.py:167-180``), the state
    first as the JAX module takes it. ``ih`` and ``hh`` are ``Linear``s to
    ``3 d`` with biases (the JAX ``Dense`` kernels, transposed), their
    outputs in ``r, z, n`` blocks: ``n = tanh(x_n + r * h_n)``, ``h_n``
    with its bias, and ``h' = (1 - z) n + z h``. FiGNN's state update."""

    def __init__(self, input_dim: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(input_dim, 3 * hidden_size)
        self.hh = nn.Linear(hidden_size, 3 * hidden_size)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = self.ih(x).chunk(3, dim=-1)
        hr, hz, hn = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1.0 - z) * n + z * h


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


class _Float32Cudnn(torch.autograd.Function):
    """``fn(*inputs)`` through cuDNN with its forward and backward both in
    float32 (a GRU layer, Caser's convolutions). The forward records
    cuDNN's own graph on detached inputs; the backward differentiates that
    graph inside the same float32 block."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, ctx.needs_input_grad[1:])]
        with torch.enable_grad(), _float32_cudnn():
            out = fn(*leaves)
        ctx.leaves, ctx.out = leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        leaves, out = ctx.leaves, ctx.out
        ctx.leaves = ctx.out = None
        with _float32_cudnn():
            grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], g))
        return (None,) + tuple(next(grads) if t.requires_grad else None for t in leaves)


def float32_cudnn(fn, *inputs: torch.Tensor) -> torch.Tensor:
    """``fn(*inputs)`` on CUDA tensors with cuDNN in float32 in both passes
    (``_float32_cudnn``: no TF32, whatever the process setting); on CPU
    tensors ``fn`` as it is."""
    if not inputs[0].is_cuda:
        return fn(*inputs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Float32Cudnn.apply(fn, *inputs)
    with _float32_cudnn():
        return fn(*inputs)


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
    train = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights))
    return float32_cudnn(lambda x_, *w: _vf_gru(x_, w, train=train), x, *weights)


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


class MultiHeadAttention(nn.Module):
    """Projected multi-head softmax attention (``layers.py:254-300``):
    ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` ``Linear``s of
    width ``q_dim`` split into ``n_head`` heads. The route is the JAX
    gate's (``layers.py:277-279``): with no weights asked for, no dropout
    in training, and ``attn_mask`` absent or 2-D, the heads go through
    ``fused_mha`` (K3 on a CUDA tensor for Lk <= 512, which raises rather
    than fall back; its plain version on a CPU tensor); otherwise through
    the plain softmax, masked with ``finfo(float32).min``, with dropout on
    the weights from ``seeded_dropout`` (seeds from ``rng``).
    ``need_weight`` also returns the weights averaged over the heads.
    Setting ``plain = True`` takes the plain softmax on any device, which
    is how K3 is held against it on the card."""

    def __init__(self, q_dim: int, n_head: int = 1, dropout: float = 0.0, bias: bool = True,
                 k_dim: Optional[int] = None, v_dim: Optional[int] = None):
        super().__init__()
        self.q_dim, self.n_head, self.dropout = q_dim, n_head, dropout
        self.plain = False
        self.q_proj = nn.Linear(q_dim, q_dim, bias=bias)
        self.k_proj = nn.Linear(q_dim if k_dim is None else k_dim, q_dim, bias=bias)
        self.v_proj = nn.Linear(q_dim if v_dim is None else v_dim, q_dim, bias=bias)
        self.out_proj = nn.Linear(q_dim, q_dim, bias=bias)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None, need_weight: bool = False,
                rng: Optional[torch.Generator] = None):
        d, H = self.q_dim, self.n_head
        B, Lq, Lk = query.shape[0], query.shape[1], key.shape[1]

        def heads(t, L):
            return t.reshape(B, L, H, d // H).transpose(1, 2).contiguous()

        q, k, v = (heads(self.q_proj(query), Lq), heads(self.k_proj(key), Lk),
                   heads(self.v_proj(value), Lk))
        if (not self.plain and not need_weight and not (self.dropout > 0 and self.training)
                and (attn_mask is None or attn_mask.dim() == 2)):
            out = fused_mha(q, k, v, key_padding_mask, attn_mask)
            return self.out_proj(out.transpose(1, 2).reshape(B, Lq, d))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d / H)
        neg = torch.finfo(logits.dtype).min
        if attn_mask is not None:
            m = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
            logits = logits.masked_fill(m, neg)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], neg)
        w = seeded_dropout(torch.softmax(logits, dim=-1), self.dropout, self.training, rng)
        out = self.out_proj(torch.matmul(w, v).transpose(1, 2).reshape(B, Lq, d))
        return (out, w.mean(1)) if need_weight else out


class AttentionLayer(nn.Module):
    """``layers.py:302-349``: ``multi-head`` mode is a ``MultiHeadAttention``
    (``attn``); ``feedforward`` mode broadcasts the query against every
    key, concatenates the two, and scores them with ``MLPModule([q_dim +
    k_dim, *mlp_layers])`` and ``mlp_out``, a ``Linear(., 1)`` that always
    has a bias; ``scaled-dot-product`` mode scores ``query key^T``. In
    those two the weights are divided by ``sqrt(q_dim)``, padded keys get
    weight 0 (``softmax=False``, NARM's and STAMP's) or -inf before a
    softmax, and ``weights @ value`` is returned."""

    def __init__(self, q_dim: int, k_dim: Optional[int] = None, mlp_layers: Sequence[int] = (),
                 activation: str = "sigmoid", bias: bool = True,
                 attention_type: str = "feedforward", n_head: int = 1, dropout: float = 0.0,
                 v_dim: Optional[int] = None):
        super().__init__()
        if attention_type not in ("feedforward", "scaled-dot-product", "multi-head"):
            raise ValueError(f"unknown attention_type {attention_type!r}")
        self.attention_type = attention_type
        if attention_type == "multi-head":
            self.attn = MultiHeadAttention(q_dim, n_head, dropout, bias, k_dim, v_dim)
        elif attention_type == "feedforward":
            k_dim = q_dim if k_dim is None else k_dim
            self.mlp = MLPModule([q_dim + k_dim, *mlp_layers], activation, bias=bias)
            self.mlp_out = nn.Linear(([q_dim + k_dim] + list(mlp_layers))[-1], 1)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                softmax: bool = False, need_weight: bool = False,
                attn_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None):
        if self.attention_type == "multi-head":
            return self.attn(query, key, value, key_padding_mask=key_padding_mask,
                             attn_mask=attn_mask, need_weight=need_weight, rng=rng)
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
        out = torch.matmul(w, value)
        return (out, w) if need_weight else out


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
