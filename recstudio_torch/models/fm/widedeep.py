"""WideDeep: a wide linear part and a deep MLP over the field embeddings.

Counterpart of ``recstudio_tpu/models/fm/widedeep.py``: the logit is the
first-order ``LinearLayer`` plus an MLP over the flattened ``[B, F, D]``
embeddings (batch norm after each hidden layer with ``batch_norm``, none
after the last, which has no activation).
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, LinearLayer, make_field_specs


class WideDeepNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 batch_norm: bool):
        super().__init__()
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.mlp = MLPModule([len(field_specs) * embed_dim, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout, batch_norm=batch_norm,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        wide = self.linear(batch)
        emb = self.embedding(batch)
        return wide + self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1)


class WideDeep(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return WideDeepNet(make_field_specs(self.fields, train_data), self.embed_dim,
                           tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                           mc.get("batch_norm", False))
