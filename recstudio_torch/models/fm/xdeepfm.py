"""xDeepFM: a compressed interaction network, a deep MLP and a linear part.

Counterpart of ``recstudio_tpu/models/fm/xdeepfm.py``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import CIN, Embeddings, LinearLayer, make_field_specs


class XDeepFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, cin_layer_size, mlp_layer, activation: str,
                 dropout: float, direct: bool):
        super().__init__()
        F = len(field_specs)
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.cin = CIN(embed_dim, F, cin_layer_size, activation, direct)
        self.mlp = MLPModule([F * embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        return (self.linear(batch) + self.cin(emb)
                + self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1))


class xDeepFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return XDeepFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                          tuple(mc["cin_layer_size"]), tuple(mc["mlp_layer"]),
                          mc["activation"], mc["dropout"], mc.get("direct", True))
