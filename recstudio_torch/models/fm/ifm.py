"""IFM: the input-aware factorization machine.

Counterpart of ``recstudio_tpu/models/fm/ifm.py``: a factor-estimating
MLP (``fen``) over the flattened embeddings and ``fen_out`` (no bias),
softmaxed over the fields, reweight each field's first-order term (a
second ``Embeddings`` of width 1, ``linear_emb``, plus the scalar
``bias``) and its embedding, which ``FMLayer(reduction="sum")`` scores.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FMLayer, make_field_specs


class IFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 batch_norm: bool):
        super().__init__()
        F = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.fen = MLPModule([F * embed_dim, *mlp_layer], activation_func=activation,
                             dropout=dropout, batch_norm=batch_norm)
        self.fen_out = nn.Linear(mlp_layer[-1], F, bias=False)
        self.linear_emb = Embeddings(field_specs, 1)
        self.bias = nn.Parameter(torch.zeros(1))
        self.fm = FMLayer(reduction="sum")

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        h = self.fen(emb.reshape(emb.shape[0], -1), rng)
        weight = torch.softmax(self.fen_out(h), dim=-1)                 # [B, F]
        lr = (self.linear_emb(batch).squeeze(-1) * weight).sum(-1) + self.bias[0]
        return lr + self.fm(emb * weight[..., None])


class IFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return IFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                      mc.get("batch_norm", False))
