"""HFM: holographic factorization machine.

Counterpart of ``recstudio_tpu/models/fm/hfm.py``: the pairs' circular
correlation, convolution or product (``HolographicFMLayer``), scored by an
MLP over all of them (``deep``) or by ``proj`` over their sum, plus the
first-order ``LinearLayer``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, HolographicFMLayer, LinearLayer, make_field_specs


class HFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, op: str, deep: bool, mlp_layer,
                 activation: str, dropout: float):
        super().__init__()
        F = len(field_specs)
        self.deep = deep
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.hfm = HolographicFMLayer(F, op)
        if deep:
            self.mlp = MLPModule([F * (F - 1) // 2 * embed_dim, *mlp_layer, 1],
                                 activation_func=activation, dropout=dropout,
                                 last_activation=False, last_bn=False)
        else:
            self.proj = nn.Linear(embed_dim, 1, bias=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        inter = self.hfm(self.embedding(batch))                          # [B, P, D]
        if self.deep:
            h = self.mlp(inter.reshape(inter.shape[0], -1), rng).squeeze(-1)
        else:
            h = self.proj(inter.sum(1)).squeeze(-1)
        return self.linear(batch) + h


class HFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return HFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      mc.get("op", "circular_correlation"), mc.get("deep", True),
                      tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"])
