"""NFM: neural factorization machine.

Counterpart of ``recstudio_tpu/models/fm/nfm.py``: the bi-interaction
pooling of the field embeddings (``FMLayer`` with no reduction, ``[B,
D]``), batch-normalized (``bn``), then an MLP (batch norm after each hidden
layer with ``batch_norm``), plus the first-order ``LinearLayer``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FMLayer, LinearLayer, make_field_specs
from ..module.layers import SimpleBatchNorm


class NFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 batch_norm: bool):
        super().__init__()
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.fm = FMLayer()
        self.bn = SimpleBatchNorm(embed_dim)
        self.mlp = MLPModule([embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, batch_norm=batch_norm, last_activation=False,
                             last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        lr_score = self.linear(batch)
        bi = self.bn(self.fm(self.embedding(batch)))                    # [B, D]
        return lr_score + self.mlp(bi, rng).squeeze(-1)


class NFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return NFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                      mc.get("batch_norm", False))
