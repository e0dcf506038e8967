"""ONN: operation-aware neural network.

Counterpart of ``recstudio_tpu/models/fm/onn.py``: each field's table is
``F D`` wide, one copy a operation (``OperationAwareFMLayer``); an MLP
(batch norm with ``batch_norm``) scores the copies and the pairs'
products, plus the first-order ``LinearLayer``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, LinearLayer, OperationAwareFMLayer, make_field_specs


class ONNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 batch_norm: bool):
        super().__init__()
        F = len(field_specs)
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim * F)
        self.onn = OperationAwareFMLayer(F)
        self.mlp = MLPModule([F * embed_dim + F * (F - 1) // 2, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout, batch_norm=batch_norm,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        inter = self.onn(self.embedding(batch))
        return self.linear(batch) + self.mlp(inter, rng).squeeze(-1)


class ONN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return ONNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                      mc.get("batch_norm", False))
