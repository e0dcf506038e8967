"""CTR field embeddings and interaction layers.

Counterpart of ``recstudio_tpu/models/module/ctr.py``: the field specs of
a dataset (``make_field_specs``), the ``Embeddings`` feature embedder
(token and float fields stacked to ``[..., F, D]``), the first-order
``LinearLayer``, the second-order ``FMLayer``, DCN's ``CrossNetwork``,
AutoInt's ``SelfAttentionInteractingLayer`` and the interaction layers of
the fm zoo (``ctr.py:366-619``): ``CrossNetworkV2``, ``InnerProductLayer``,
``OuterProductLayer``, ``CIN``, ``AFMLayer``, ``FieldAwareFMLayer``,
``FMFMLayer``, ``SqueezeExcitation``, ``BilinearInteraction``,
``MaskBlock``, ``OperationAwareFMLayer``, ``HolographicFMLayer``,
``LogTransformLayer`` and CCPM's and FGCNN's field convolution
``FieldConv``. Field pairs are taken in ``torch.triu_indices``
order, which is ``jnp.triu_indices``'. None of these reaches a Pallas
kernel in the JAX package (XLA computes them, ``jnp.fft`` included), so
they are PyTorch here (cuBLAS, cuFFT and cuDNN on the card). Raw parameters keep
the JAX layout and their flax initializer (``raw_init``,
``models/init.py``).

The tables and their layout are the JAX package's, so weights carry
across (``utils/convert.ranker_params_from_jax``): one token field keeps
its own table ``{name}_embedding``; several token fields share one table
``token_embedding`` of ``sum(V)`` rows, field t's ids offset by the sizes
of the fields before it, and are read by one gather of all ``[..., T]``
offset ids. One float field is a ``{name}_dense`` ``Linear(1, D)``;
several share one ``dense_embedding`` kernel ``[Fd, D]``. The gather is
``F.embedding`` on the fused table: its forward reads each row exactly and
its backward sums each id's cotangents, which is the JAX package's
``_fused_gather`` (whose one-hot and scatter split is a TPU device, not a
part of the function). ``token_seq`` fields are not ported yet and raise.

Packed tables (``ctr.py:60-83``, ``:195-260``): a net built inside
``packed_tables(True)`` (``BaseRanker`` does so when its config qualifies
for the packed row-sparse CTR step) declares each fused ``token_embedding``
``[N, 3D]``, rows of (params | mu | nu). Whether a table is packed is read
from its width when it is used, so a packed model evaluates and serves
whatever the flag. Reads gather the wide rows and keep the first D
columns; the table takes no gradient. While ``probe`` is set (the packed
step sets it), each read detaches the gathered ``[..., T, D]`` rows, makes
them a leaf that requires a gradient, and keeps them with their offset ids
in ``probed``: each lookup's gradient is taken there, and no ``[N, D]``
gradient of the table is allocated.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (MultiHeadAttention, SimpleBatchNorm, float32_cudnn, get_act,
                     seeded_dropout)

FieldSpecTuple = Tuple[str, str, int]  # (name, type, num_values)


# the ``_PACKED_MOMENTS`` flag: fused token tables declared [N, 3D] while set
_PACKED = False


@contextlib.contextmanager
def packed_tables(on: bool):
    """Build nets inside this block with packed fused token tables when
    ``on`` (``BaseRanker._init_model``, from ``_ctr_sparse_config_ok``)."""
    global _PACKED
    before, _PACKED = _PACKED, bool(on)
    try:
        yield
    finally:
        _PACKED = before


def make_field_specs(fields, data) -> Tuple[FieldSpecTuple, ...]:
    """The field specs of ``fields`` in ``data`` (``ctr.py:27-39``): sorted
    by name, the rating and ``str`` fields dropped; a token field's size is
    its number of values ([PAD] included), a float field's 1."""
    ratings = data.frating if isinstance(data.frating, list) else [data.frating]
    out = []
    for f in sorted(f for f in fields if f is not None):
        if f in ratings:
            continue
        t = data.field2type.get(f)
        if t is None or t == "str":
            continue
        n = data.num_values(f) if t.startswith("token") else 1
        out.append((f, t, n))
    return tuple(out)


class DenseEmbedding(nn.Module):
    """A float scalar -> an ``embed_dim`` vector, ``Linear(1, D)`` with no
    bias (``ctr.py:42-51``; its Flax ``Dense`` is named ``weight``)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.weight = nn.Linear(1, embed_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight(x[..., None].to(self.weight.weight.dtype))


class Embeddings(nn.Module):
    """Per-field embeddings stacked to ``[..., F, D]`` in field-spec order
    (``ctr.py:182-318``). The JAX module's ``share_dense_embedding`` and
    ``dense_emb_bias`` options, which no model of the JAX package sets,
    are left out."""

    def __init__(self, field_specs: Sequence[FieldSpecTuple], embed_dim: int):
        super().__init__()
        self.field_specs = tuple(field_specs)
        self.embed_dim = embed_dim
        seq = [name for name, t, _ in self.field_specs if t == "token_seq"]
        if seq:
            raise NotImplementedError(f"token_seq fields {seq} are not ported yet")
        self.token = [(i, name) for i, (name, t, _) in enumerate(self.field_specs)
                      if t == "token"]
        self.floats = [(i, name) for i, (name, t, _) in enumerate(self.field_specs)
                       if t != "token"]
        self.sizes = tuple(int(n) for _, t, n in self.field_specs if t == "token")
        self.probe = False
        self.probed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if len(self.token) == 1:
            self.add_module(f"{self.token[0][1]}_embedding",
                            nn.Embedding(self.sizes[0], embed_dim))
        elif self.token:
            width = 3 * embed_dim if _PACKED else embed_dim
            self.token_embedding = nn.Embedding(int(sum(self.sizes)), width)
            offs = np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(np.int64)
            self.register_buffer("offsets", torch.from_numpy(offs), persistent=False)
        if len(self.floats) == 1:
            self.add_module(f"{self.floats[0][1]}_dense", DenseEmbedding(embed_dim))
        elif self.floats:
            self.dense_embedding = nn.Parameter(torch.zeros(len(self.floats), embed_dim))

    @property
    def packed(self) -> bool:
        """The fused token table holds (params | mu | nu) rows, ``[N, 3D]``."""
        return len(self.token) > 1 and \
            self.token_embedding.weight.shape[-1] == 3 * self.embed_dim

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        embs = [None] * len(self.field_specs)
        if len(self.token) == 1:
            i, name = self.token[0]
            embs[i] = getattr(self, f"{name}_embedding")(batch[name])
        elif self.token:
            ids = torch.stack([batch[name] for _, name in self.token], dim=-1)   # [..., T]
            ids = ids + self.offsets.to(ids.dtype)
            if self.packed:
                rows = F.embedding(ids, self.token_embedding.weight.detach())
                fused = rows[..., :self.embed_dim]
                if self.probe:
                    fused = fused.detach().requires_grad_()
                    self.probed = (ids, fused)
            else:
                fused = F.embedding(ids, self.token_embedding.weight)
            for k, (i, _) in enumerate(self.token):
                embs[i] = fused[..., k, :]
        if len(self.floats) == 1:
            i, name = self.floats[0]
            embs[i] = getattr(self, f"{name}_dense")(batch[name])
        elif self.floats:
            xs = torch.stack([batch[name].float() for _, name in self.floats], dim=-1)
            fused = xs[..., None] * self.dense_embedding            # [..., Fd, D]
            for k, (i, _) in enumerate(self.floats):
                embs[i] = fused[..., k, :]
        return torch.stack(embs, dim=-2)


class LinearLayer(nn.Module):
    """First-order term: the sum of 1-d field embeddings, plus a bias
    (``ctr.py:321-333``)."""

    def __init__(self, field_specs: Sequence[FieldSpecTuple]):
        super().__init__()
        self.embedding = Embeddings(field_specs, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.embedding(batch).squeeze(-1).sum(-1) + self.bias[0]


class FMLayer(nn.Module):
    """Second-order FM interaction ``0.5 ((sum v)^2 - sum v^2)`` over the
    fields, summed over D with ``reduction="sum"`` (DeepFM, FM), else
    ``[..., D]`` (``ctr.py:336-348``; its ``mean``, which no model sets,
    is left out)."""

    def __init__(self, reduction: Optional[str] = None):
        super().__init__()
        self.reduction = reduction

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        square_of_sum = torch.sum(inputs, dim=-2) ** 2
        sum_of_square = torch.sum(inputs ** 2, dim=-2)
        output = 0.5 * (square_of_sum - sum_of_square)         # [..., D]
        return output.sum(-1) if self.reduction == "sum" else output


class FieldConv(nn.Conv2d):
    """CCPM's and FGCNN's convolution over the fields of an NCHW map ``[B,
    C_in, F, D]`` (``ccpm.py:35-41``, ``fgcnn.py:36-42``): kernel ``(h,
    1)``, no bias, XLA's SAME padding (the extra row of an even height at
    the end, by ``F.pad``). On the card it runs through cuDNN in float32
    in both passes (``layers.float32_cudnn``). The weight ``[C_out, C_in,
    h, 1]`` is the JAX ``(h, 1, C_in, C_out)`` kernel with its axes
    permuted (``utils/convert``), and takes flax's ``xavier_uniform`` over
    that kernel's fans, which the JAX rule by name leaves."""

    def __init__(self, in_channels: int, out_channels: int, height: int):
        super().__init__(in_channels, out_channels, (height, 1), bias=False)
        self.raw_init = {"weight": "xavier_uniform_hwio"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        total = self.kernel_size[0] - 1
        x = F.pad(x, (0, 0, total // 2, total - total // 2))
        return float32_cudnn(F.conv2d, x, self.weight)


class CrossNetwork(nn.Module):
    """DCN's cross layers (``ctr.py:351-363``): ``x_{l+1} = x_l + x_0 (x_l .
    w_l) + b_l``, with ``w_{i}`` and ``b_{i}`` vectors of ``embed_dim``
    (``w`` drawn N(0, 1) by ``init_parameters``, ``b`` 0)."""

    def __init__(self, embed_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w_{i}", nn.Parameter(torch.zeros(embed_dim)))
            self.register_parameter(f"b_{i}", nn.Parameter(torch.zeros(embed_dim)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x + x0 * torch.matmul(x, getattr(self, f"w_{i}"))[..., None] \
                + getattr(self, f"b_{i}")
        return x


class SelfAttentionInteractingLayer(nn.Module):
    """AutoInt's block (``ctr.py:621-641``): multi-head self-attention over
    the field embeddings (``attn``), plus the input, projected by ``res``
    with ``residual_project``, an optional LayerNorm (``ln``, flax's
    epsilon 1e-6), then relu."""

    def __init__(self, embed_dim: int, n_head: int = 1, dropout: float = 0.0,
                 residual: bool = True, residual_project: bool = True,
                 layer_norm: bool = False):
        super().__init__()
        self.residual, self.residual_project = residual, residual_project
        self.attn = MultiHeadAttention(embed_dim, n_head, dropout)
        if residual and residual_project:
            self.res = nn.Linear(embed_dim, embed_dim)
        self.ln = nn.LayerNorm(embed_dim, eps=1e-6) if layer_norm else None

    def forward(self, inputs: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = self.attn(inputs, inputs, inputs, rng=rng)
        if self.residual:
            out = out + (self.res(inputs) if self.residual_project else inputs)
        if self.ln is not None:
            out = self.ln(out)
        return torch.relu(out)


def _pairs(num_fields: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The field pairs ``i < j`` in ``triu_indices`` order: ``(rows, cols)``."""
    rows, cols = torch.triu_indices(num_fields, num_fields, 1, device=device)
    return rows, cols


class CrossNetworkV2(nn.Module):
    """DCNv2's cross layers (``ctr.py:366-375``): ``x_{l+1} = x_0 (W_l x_l
    + b_l) + x_l``, ``W_l`` a ``Linear`` (``linear_{i}``)."""

    def __init__(self, embed_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"linear_{i}", nn.Linear(embed_dim, embed_dim))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"linear_{i}")(x) + x
        return x


class InnerProductLayer(nn.Module):
    """Pairwise field inner products (``ctr.py:378-389``): ``[B, F, D]`` ->
    ``[B, P]``, or the products' vectors ``[B, P, D]`` without
    ``reduction``."""

    def __init__(self, num_fields: int, reduction: bool = True):
        super().__init__()
        self.num_fields, self.reduction = num_fields, reduction

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, inputs.device)
        p = inputs[..., rows, :] * inputs[..., cols, :]
        return p.sum(-1) if self.reduction else p


class OuterProductLayer(nn.Module):
    """PNN's kernel-weighted outer products (``ctr.py:392-407``): for each
    pair ``(i, j)``, ``e_i^T K_p e_j`` with ``kernel [D, P, D]`` in the JAX
    layout (xavier by the model's rule, flax's fans ``P D`` and ``D D``)."""

    def __init__(self, num_fields: int, embed_dim: int):
        super().__init__()
        self.num_fields = num_fields
        P = num_fields * (num_fields - 1) // 2
        self.kernel = nn.Parameter(torch.zeros(embed_dim, P, embed_dim))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, inputs.device)
        kp = torch.einsum("...pd,dpe->...pe", inputs[..., rows, :], self.kernel)
        return (kp * inputs[..., cols, :]).sum(-1)


class CIN(nn.Module):
    """xDeepFM's compressed interaction network (``ctr.py:410-441``). Layer
    ``i`` takes the outer products of the hidden maps and the input fields
    ``[B, H F0, D]`` to ``size`` maps by ``conv_{i} [H F0, size]`` (flax
    ``xavier_uniform``) and ``conv_b_{i}``, then the activation. With
    ``direct`` every layer's maps are kept and fed on; without, each
    layer but the last is halved (sizes rounded down to even, ``:424``):
    its first half feeds the next layer, its second half is kept. The kept
    maps are summed over D and scored by ``linear``."""

    def __init__(self, embed_dim: int, num_features: int, cin_layer_size: Sequence[int],
                 activation: str = "relu", direct: bool = True):
        super().__init__()
        sizes = list(cin_layer_size)
        if not direct:
            sizes = [s // 2 * 2 for s in sizes[:-1]] + [sizes[-1]]
        self.sizes, self.direct = sizes, direct
        self.act = get_act(activation)
        self.raw_init = {}
        hidden = num_features
        for i, size in enumerate(sizes):
            self.register_parameter(f"conv_{i}", nn.Parameter(
                torch.zeros(hidden * num_features, size)))
            self.register_parameter(f"conv_b_{i}", nn.Parameter(torch.zeros(size)))
            self.raw_init[f"conv_{i}"] = "xavier_uniform"
            hidden = size if direct else size // 2
        kept = sum(sizes) if direct else sum(s // 2 for s in sizes[:-1]) + sizes[-1]
        self.linear = nn.Linear(kept, 1)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        B, F0, D = inputs.shape
        hidden, finals = inputs, []
        for i, size in enumerate(self.sizes):
            z = (hidden[:, :, None, :] * inputs[:, None, :, :]).reshape(B, -1, D)
            out = self.act(torch.einsum("bkd,kh->bhd", z, getattr(self, f"conv_{i}"))
                           + getattr(self, f"conv_b_{i}")[None, :, None])
            if self.direct:
                finals.append(out)
                hidden = out
            elif i != len(self.sizes) - 1:
                hidden, direct = out.split(size // 2, dim=1)
                finals.append(direct)
            else:
                finals.append(out)
        return self.linear(torch.cat(finals, dim=1).sum(-1)).squeeze(-1)


class AFMLayer(nn.Module):
    """Attentional FM (``ctr.py:444-461``): a softmax over the pairs of
    ``attn_h(relu(attn_w(e_i * e_j)))`` weighs the pairs' product vectors;
    their sum, after dropout, is scored by ``p``."""

    def __init__(self, embed_dim: int, attention_dim: int, num_fields: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.inner = InnerProductLayer(num_fields, reduction=False)
        self.attn_w = nn.Linear(embed_dim, attention_dim)
        self.attn_h = nn.Linear(attention_dim, 1, bias=False)
        self.p = nn.Linear(embed_dim, 1, bias=False)

    def forward(self, inputs: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        prod = self.inner(inputs)                                     # [B, P, D]
        a = torch.softmax(self.attn_h(torch.relu(self.attn_w(prod))), dim=1)
        out = seeded_dropout((a * prod).sum(1), self.dropout, self.training, rng)
        return self.p(out).squeeze(-1)


class FieldAwareFMLayer(nn.Module):
    """FFM's interaction (``ctr.py:464-478``): each field keeps one vector a
    other field in its ``[(F - 1) D]`` row; the score sums ``<v_{i,j},
    v_{j,i}>`` over the pairs, ``v_{i,j}`` at slot ``j - 1`` of field ``i``
    (``j > i``) and ``v_{j,i}`` at slot ``i`` of field ``j``."""

    def __init__(self, num_fields: int):
        super().__init__()
        self.num_fields = num_fields

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        B, F = inputs.shape[0], self.num_fields
        emb = inputs.reshape(B, F, F - 1, -1)
        rows, cols = _pairs(F, inputs.device)
        return (emb[:, rows, cols - 1, :] * emb[:, cols, rows, :]).sum(dim=(-1, -2))


class FMFMLayer(nn.Module):
    """FmFM's field-matrixed interaction (``ctr.py:481-495``): ``sum_p <e_i
    W_p, e_j>`` with ``field_weight [P, D, D]`` (flax ``normal(1.0)``)."""

    def __init__(self, num_fields: int, embed_dim: int):
        super().__init__()
        self.num_fields = num_fields
        P = num_fields * (num_fields - 1) // 2
        self.field_weight = nn.Parameter(torch.zeros(P, embed_dim, embed_dim))
        self.raw_init = {"field_weight": "normal"}

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, inputs.device)
        proj = torch.einsum("bpd,pde->bpe", inputs[:, rows, :], self.field_weight)
        return (proj * inputs[:, cols, :]).sum(dim=(-1, -2))


class SqueezeExcitation(nn.Module):
    """FiBiNET's SENET field reweighting (``ctr.py:498-512``): each field's
    embedding pooled (``avg`` or ``max``), ``squeeze`` to ``max(1, F //
    ratio)`` and ``excite`` back to ``F`` (no biases, the activation after
    each), the fields scaled by the result."""

    def __init__(self, num_fields: int, reduction_ratio: float, activation: str = "relu",
                 pool: str = "avg"):
        super().__init__()
        self.pool = pool
        reduced = max(1, int(num_fields // reduction_ratio))
        self.act = get_act(activation)
        self.squeeze = nn.Linear(num_fields, reduced, bias=False)
        self.excite = nn.Linear(reduced, num_fields, bias=False)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        z = inputs.mean(-1) if self.pool == "avg" else inputs.amax(-1)
        a = self.act(self.excite(self.act(self.squeeze(z))))
        return inputs * a[..., None]


class BilinearInteraction(nn.Module):
    """FiBiNET's bilinear interaction (``ctr.py:515-538``): ``(e_i W) * e_j``
    over the pairs, ``[B, P, D]``, with ``weight`` (flax ``normal(1.0)``,
    the JAX layout) shared by all fields (``all``, ``[D, D]``), one a field
    (``each``, ``[F, D, D]``) or one a pair (``interaction``, ``[P, D,
    D]``)."""

    def __init__(self, num_fields: int, embed_dim: int, bilinear_type: str = "interaction"):
        super().__init__()
        self.num_fields = num_fields
        self.bilinear_type = bilinear_type.lower()
        P = num_fields * (num_fields - 1) // 2
        shape = {"all": (embed_dim, embed_dim),
                 "each": (num_fields, embed_dim, embed_dim)}.get(
                     self.bilinear_type, (P, embed_dim, embed_dim))
        self.weight = nn.Parameter(torch.zeros(shape))
        self.raw_init = {"weight": "normal"}

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, inputs.device)
        if self.bilinear_type == "all":
            hidden = torch.matmul(inputs, self.weight)[:, rows, :]
        elif self.bilinear_type == "each":
            hidden = torch.einsum("bfd,fde->bfe", inputs, self.weight)[:, rows, :]
        else:
            hidden = torch.einsum("bpd,pde->bpe", inputs[:, rows, :], self.weight)
        return hidden * inputs[:, cols, :]


class MaskBlock(nn.Module):
    """MaskNet's instance-guided mask block (``ctr.py:541-562``): a mask
    from the embeddings (``mask_1``, relu, ``mask_2``) scales ``v``, then
    ``hidden`` (no bias), a LayerNorm (``ln``, flax's epsilon 1e-6) with
    ``layer_norm``, the activation and dropout."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 reduction_ratio: float = 1.0, activation: str = "relu", dropout: float = 0.0,
                 layer_norm: bool = True):
        super().__init__()
        self.dropout = dropout
        self.mask_1 = nn.Linear(input_dim, int(hidden_dim * reduction_ratio))
        self.mask_2 = nn.Linear(int(hidden_dim * reduction_ratio), hidden_dim)
        self.hidden = nn.Linear(hidden_dim, output_dim, bias=False)
        self.ln = nn.LayerNorm(output_dim, eps=1e-6) if layer_norm else None
        self.act = get_act(activation)

    def forward(self, v_emb: torch.Tensor, v: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = self.mask_2(torch.relu(self.mask_1(v_emb)))
        out = self.hidden(mask * v)
        if self.ln is not None:
            out = self.ln(out)
        return seeded_dropout(self.act(out), self.dropout, self.training, rng)


class OperationAwareFMLayer(nn.Module):
    """ONN's interaction (``ctr.py:565-579``): from ``[B, F, F D]`` (a copy
    of each field a operation), the diagonal copies flattened, then the
    pairs' ``<v_i^(j), v_j^(i)>``."""

    def __init__(self, num_fields: int):
        super().__init__()
        self.num_fields = num_fields

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        B, F = inputs.shape[0], self.num_fields
        fw = inputs.reshape(B, F, F, -1)
        idx = torch.arange(F, device=inputs.device)
        diag = fw[:, idx, idx, :].reshape(B, -1)
        inner = (fw.transpose(1, 2) * fw).sum(-1)                    # [B, F, F]
        rows, cols = _pairs(F, inputs.device)
        return torch.cat([diag, inner[:, rows, cols]], dim=1)


class HolographicFMLayer(nn.Module):
    """HFM's interaction (``ctr.py:582-601``): the pairs' circular
    correlation or convolution by ``torch.fft`` (cuFFT on the card, as the
    JAX package's ``jnp.fft`` is XLA's), or their elementwise product
    (any other ``op``), ``[B, P, D]``."""

    def __init__(self, num_fields: int, op: str = "circular_correlation"):
        super().__init__()
        self.num_fields, self.op = num_fields, op

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        rows, cols = _pairs(self.num_fields, inputs.device)
        a, b = inputs[:, rows, :], inputs[:, cols, :]
        if self.op not in ("circular_correlation", "circular_convolution"):
            return a * b
        fa, fb = torch.fft.rfft(a, dim=-1), torch.fft.rfft(b, dim=-1)
        if self.op == "circular_correlation":
            fa = torch.conj(fa)
        return torch.fft.irfft(fa * fb, n=a.shape[-1], dim=-1)


class LogTransformLayer(nn.Module):
    """AFN's logarithmic transform (``ctr.py:604-619``): ``log(max(|e|,
    clamp_min))``, batch-normalized over D (``log_bn``), ``linear`` from
    the F fields to ``hidden_size`` logarithmic neurons, ``exp``, batch
    norm (``exp_bn``), flattened to ``[B, hidden_size D]``."""

    def __init__(self, num_fields: int, embed_dim: int, hidden_size: int,
                 clamp_min: float = 1e-5):
        super().__init__()
        self.clamp_min = clamp_min
        self.log_bn = SimpleBatchNorm(embed_dim)
        self.linear = nn.Linear(num_fields, hidden_size)
        self.exp_bn = SimpleBatchNorm(embed_dim)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        log_emb = self.log_bn(torch.log(torch.clamp_min(inputs.abs(), self.clamp_min)))
        log_out = self.linear(log_emb.transpose(1, 2)).transpose(1, 2)   # [B, H, D]
        out = self.exp_bn(torch.exp(log_out))
        return out.reshape(out.shape[0], -1)
