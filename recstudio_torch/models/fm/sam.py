"""SAM: the shallow attentive interaction model.

Counterpart of ``recstudio_tpu/models/fm/sam.py``: ``SAMInteraction`` of
``interaction_type`` ``sam1`` (the embeddings), ``sam2a`` (pairwise inner
products times ``W [F, F, D]``), ``sam2e`` (pairwise product vectors
weighed by their sums), ``sam3a`` or ``sam3e`` (``K``-projected inner
products weighing ``W`` or the product vectors, summed over the second
field, plus ``res``); dropout (the plain Philox mask); ``fc`` over the
flattened result. ``aggregation`` is not read: the JAX module flattens
for ``weighted_pooling`` as for ``concat``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import seeded_dropout

# the interaction's output fields a field (F of them, each D wide)
_OUT_FIELDS = {"sam1": lambda F: 1, "sam2a": lambda F: F, "sam2e": lambda F: F,
               "sam3a": lambda F: 1, "sam3e": lambda F: 1}


class SAMInteraction(nn.Module):
    """``sam.py:16-51``. ``W`` (``sam2a``, ``sam3a``) is a kernel to the JAX
    rule by name (its lower-cased name ``w``), drawn by the model's
    ``init_method`` over flax's fans."""

    def __init__(self, interaction_type: str, embed_dim: int, num_fields: int,
                 dropout: float = 0.0):
        super().__init__()
        if interaction_type not in _OUT_FIELDS:
            raise ValueError(f"unknown interaction_type {interaction_type!r}")
        self.interaction_type, self.dropout = interaction_type, dropout
        if interaction_type in ("sam2a", "sam3a"):
            self.W = nn.Parameter(torch.ones(num_fields, num_fields, embed_dim))
        if interaction_type in ("sam3a", "sam3e"):
            self.K = nn.Linear(embed_dim, embed_dim, bias=False)
            self.res = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, inputs: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        it = self.interaction_type
        if it == "sam1":
            out = inputs
        elif it == "sam2a":
            inner = torch.matmul(inputs, inputs.transpose(1, 2))
            out = inner[..., None] * self.W
        elif it == "sam2e":
            inner = inputs[:, :, None, :] * inputs[:, None, :, :]              # [B, F, F, D]
            out = inner.sum(-1, keepdim=True) * inner
        else:
            inner = torch.matmul(inputs, self.K(inputs).transpose(1, 2))       # [B, F, F]
            if it == "sam3a":
                out = (inner[..., None] * self.W).sum(2)
            else:
                out = (inner[..., None] * (inputs[:, :, None, :] * inputs[:, None, :, :])).sum(2)
            out = out + self.res(inputs)
        return seeded_dropout(out, self.dropout, self.training, rng)


class SAMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, interaction_type: str, dropout: float):
        super().__init__()
        F = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.interaction = SAMInteraction(interaction_type, embed_dim, F, dropout)
        self.fc = nn.Linear(F * _OUT_FIELDS[interaction_type](F) * embed_dim, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.interaction(self.embedding(batch), rng)
        return self.fc(out.reshape(out.shape[0], -1)).squeeze(-1)


class SAM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return SAMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      mc.get("interaction_type", "sam2e"), mc.get("dropout", 0.0))
