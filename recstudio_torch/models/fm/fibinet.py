"""FiBiNET: SENET field reweighting and bilinear interactions.

Counterpart of ``recstudio_tpu/models/fm/fibinet.py``: the embeddings and
their SENET-reweighted copy (``senet``) each go through a
``BilinearInteraction`` (one ``bilinear`` for both with
``shared_bilinear``, else ``bilinear_se`` for the copy); an MLP scores
the two concatenated, plus the first-order ``LinearLayer``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import (BilinearInteraction, Embeddings, LinearLayer, SqueezeExcitation,
                          make_field_specs)


class FiBiNETNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, reduction_ratio: float, bilinear_type: str,
                 mlp_layer, activation: str, dropout: float, excitation_activation: str = "relu",
                 shared_bilinear: bool = True):
        super().__init__()
        F = len(field_specs)
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.senet = SqueezeExcitation(F, reduction_ratio, excitation_activation)
        self.bilinear = BilinearInteraction(F, embed_dim, bilinear_type)
        self.bilinear_se = None if shared_bilinear else \
            BilinearInteraction(F, embed_dim, bilinear_type)
        self.mlp = MLPModule([F * (F - 1) * embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        p = self.bilinear(emb)
        q = (self.bilinear_se or self.bilinear)(self.senet(emb))
        h = torch.cat([p.reshape(p.shape[0], -1), q.reshape(q.shape[0], -1)], dim=-1)
        return self.linear(batch) + self.mlp(h, rng).squeeze(-1)


class FiBiNET(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return FiBiNETNet(make_field_specs(self.fields, train_data), self.embed_dim,
                          mc["reduction_ratio"], mc["bilinear_type"], tuple(mc["mlp_layer"]),
                          mc["activation"], mc["dropout"], mc.get("excitation_activation", "relu"),
                          mc.get("shared_bilinear", True))
