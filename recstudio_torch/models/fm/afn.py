"""AFN: adaptive factorization network.

Counterpart of ``recstudio_tpu/models/fm/afn.py``: ``LogTransformLayer``
(``ltl``) over the field embeddings, then an MLP (``afn_mlp``); with
``ensemble``, a DNN over separate embeddings (``embedding_dnn``,
``dnn_mlp``) beside, the two mixed by ``0.5 + ensemble_weight``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, LogTransformLayer, make_field_specs


class AFNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, log_hidden_size: int, mlp_layer,
                 activation: str, dropout: float, ensemble: bool, ensemble_mlp_layer,
                 ensemble_activation: str, ensemble_dropout: float):
        super().__init__()
        F = len(field_specs)
        self.ensemble = ensemble
        self.embedding = Embeddings(field_specs, embed_dim)
        self.ltl = LogTransformLayer(F, embed_dim, log_hidden_size)
        self.afn_mlp = MLPModule([log_hidden_size * embed_dim, *mlp_layer, 1],
                                 activation_func=activation, dropout=dropout,
                                 last_activation=False, last_bn=False)
        if ensemble:
            self.embedding_dnn = Embeddings(field_specs, embed_dim)
            self.dnn_mlp = MLPModule([F * embed_dim, *ensemble_mlp_layer, 1],
                                     activation_func=ensemble_activation,
                                     dropout=ensemble_dropout, last_activation=False,
                                     last_bn=False)
            self.ensemble_weight = nn.Parameter(torch.zeros(2))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        afn = self.afn_mlp(self.ltl(self.embedding(batch)), rng).squeeze(-1)
        if not self.ensemble:
            return afn
        emb2 = self.embedding_dnn(batch)
        dnn = self.dnn_mlp(emb2.reshape(emb2.shape[0], -1), rng).squeeze(-1)
        w = self.ensemble_weight
        return afn * (0.5 + w[0]) + dnn * (0.5 + w[1])


class AFN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return AFNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      mc["log_hidden_size"], tuple(mc["mlp_layer"]), mc["activation"],
                      mc["dropout"], mc.get("ensemble", True),
                      tuple(mc.get("ensemble_mlp_layer", [64])),
                      mc.get("ensemble_activation", "relu"), mc.get("ensemble_dropout", 0.0))
