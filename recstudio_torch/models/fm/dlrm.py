"""DLRM: deep learning recommendation model.

Counterpart of ``recstudio_tpu/models/fm/dlrm.py``: token fields are
embedded; the float fields go through a bottom MLP to one more ``embed_dim``
vector; the vectors interact by their pairwise dot products (``dot``, the
bottom vector beside), are concatenated (``cat``) or summed (``sum``), and
a top MLP scores the result.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, InnerProductLayer, make_field_specs


class DLRMNet(nn.Module):
    def __init__(self, sparse_specs, dense_fields, embed_dim: int, bottom_mlp_layer,
                 top_mlp_layer, bottom_activation: str, top_activation: str,
                 bottom_dropout: float, top_dropout: float, op: str = "dot"):
        super().__init__()
        if op not in ("dot", "cat", "sum"):
            raise ValueError("op must be dot|cat|sum")
        self.dense_fields, self.op = tuple(dense_fields), op
        self.embedding = Embeddings(sparse_specs, embed_dim)
        F = len(sparse_specs) + (1 if self.dense_fields else 0)
        if self.dense_fields:
            self.bottom_mlp = MLPModule([len(self.dense_fields), *bottom_mlp_layer, embed_dim],
                                        activation_func=bottom_activation,
                                        dropout=bottom_dropout, last_activation=False,
                                        last_bn=False)
        width = {"dot": F * (F - 1) // 2 + (embed_dim if self.dense_fields else 0),
                 "cat": F * embed_dim, "sum": embed_dim}[op]
        if op == "dot":
            self.inner = InnerProductLayer(F)
        self.top_mlp = MLPModule([width, *top_mlp_layer, 1], activation_func=top_activation,
                                 dropout=top_dropout, last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        dense_emb = None
        if self.dense_fields:
            dense = torch.stack([batch[f] for f in self.dense_fields], dim=-1)
            dense_emb = self.bottom_mlp(dense.to(self.bottom_mlp.dense_0.weight.dtype), rng)
            emb = torch.cat([emb, dense_emb[:, None, :]], dim=1)
        if self.op == "dot":
            inter = self.inner(emb)
            if dense_emb is not None:
                inter = torch.cat([inter, dense_emb], dim=-1)
        elif self.op == "cat":
            inter = emb.reshape(emb.shape[0], -1)
        else:
            inter = emb.sum(1)
        return self.top_mlp(inter, rng).squeeze(-1)


class DLRM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        ratings = self.frating if isinstance(self.frating, list) else [self.frating]
        sparse = {f for f in self.fields
                  if (train_data.field2type.get(f) or "").startswith("token")}
        dense = tuple(sorted(f for f in self.fields
                             if train_data.field2type.get(f) == "float" and f not in ratings))
        return DLRMNet(make_field_specs(sparse, train_data), dense, self.embed_dim,
                       tuple(mc["bottom_mlp_layer"]), tuple(mc["top_mlp_layer"]),
                       mc["bottom_activation"], mc["top_activation"], mc["bottom_dropout"],
                       mc["top_dropout"], mc.get("op", "dot"))
