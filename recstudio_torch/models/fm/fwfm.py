"""FwFM: field-weighted factorization machine.

Counterpart of ``recstudio_tpu/models/fm/fwfm.py``: the pairs' inner
products weighted by ``field_weight`` (a ``Linear(P, 1)``), plus a linear
part by ``linear_type``: ``lw`` the first-order ``LinearLayer``, ``felv``
the inner product of each field's embedding with a second embedding
(``linear_embedding``), ``filv`` a ``Linear`` over the flattened
embeddings.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, InnerProductLayer, LinearLayer, make_field_specs


class FwFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, linear_type: str = "lw"):
        super().__init__()
        F = len(field_specs)
        self.linear_type = linear_type.lower()
        self.embedding = Embeddings(field_specs, embed_dim)
        self.inner = InnerProductLayer(F)
        self.field_weight = nn.Linear(F * (F - 1) // 2, 1)
        if self.linear_type == "lw":
            self.linear = LinearLayer(field_specs)
        elif self.linear_type == "felv":
            self.linear_embedding = Embeddings(field_specs, embed_dim)
        elif self.linear_type == "filv":
            self.linear = nn.Linear(F * embed_dim, 1, bias=False)
        else:
            raise ValueError("linear_type must be lw|felv|filv")

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        fwfm = self.field_weight(self.inner(emb)).squeeze(-1)
        if self.linear_type == "lw":
            lr = self.linear(batch)
        elif self.linear_type == "felv":
            lr = (self.linear_embedding(batch) * emb).sum(dim=(1, 2))
        else:
            lr = self.linear(emb.reshape(emb.shape[0], -1)).squeeze(-1)
        return lr + fwfm


class FwFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return FwFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                       self.config["model"].get("linear_type", "lw"))
