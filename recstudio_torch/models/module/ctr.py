"""CTR field embeddings and the FM interaction.

Counterpart of ``recstudio_tpu/models/module/ctr.py``: the field specs of
a dataset (``make_field_specs``), the ``Embeddings`` feature embedder
(token and float fields stacked to ``[..., F, D]``), the first-order
``LinearLayer`` and the second-order ``FMLayer``.

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
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FieldSpecTuple = Tuple[str, str, int]  # (name, type, num_values)


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
        return self.weight(x[..., None].float())


class Embeddings(nn.Module):
    """Per-field embeddings stacked to ``[..., F, D]`` in field-spec order
    (``ctr.py:182-318``). The JAX module's ``share_dense_embedding`` and
    ``dense_emb_bias`` options, which no model of the JAX package sets,
    are left out."""

    def __init__(self, field_specs: Sequence[FieldSpecTuple], embed_dim: int):
        super().__init__()
        self.field_specs = tuple(field_specs)
        seq = [name for name, t, _ in self.field_specs if t == "token_seq"]
        if seq:
            raise NotImplementedError(f"token_seq fields {seq} are not ported yet")
        self.token = [(i, name) for i, (name, t, _) in enumerate(self.field_specs)
                      if t == "token"]
        self.floats = [(i, name) for i, (name, t, _) in enumerate(self.field_specs)
                       if t != "token"]
        sizes = [n for _, t, n in self.field_specs if t == "token"]
        if len(self.token) == 1:
            self.add_module(f"{self.token[0][1]}_embedding", nn.Embedding(sizes[0], embed_dim))
        elif self.token:
            self.token_embedding = nn.Embedding(int(sum(sizes)), embed_dim)
            offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
            self.register_buffer("offsets", torch.from_numpy(offs), persistent=False)
        if len(self.floats) == 1:
            self.add_module(f"{self.floats[0][1]}_dense", DenseEmbedding(embed_dim))
        elif self.floats:
            self.dense_embedding = nn.Parameter(torch.zeros(len(self.floats), embed_dim))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        embs = [None] * len(self.field_specs)
        if len(self.token) == 1:
            i, name = self.token[0]
            embs[i] = getattr(self, f"{name}_embedding")(batch[name])
        elif self.token:
            ids = torch.stack([batch[name] for _, name in self.token], dim=-1)   # [..., T]
            fused = F.embedding(ids + self.offsets.to(ids.dtype), self.token_embedding.weight)
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
