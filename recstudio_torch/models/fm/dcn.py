"""DCN: deep and cross network.

Counterpart of ``recstudio_tpu/models/fm/dcn.py``: the flattened ``[B, F
D]`` embeddings go through ``CrossNetwork`` and through an MLP (batch norm
after every layer with ``batch_norm``, the last included), and a
``Linear(., 1)`` (``fc``) scores the two concatenated.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import CrossNetwork, Embeddings, make_field_specs


class DCNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, num_layers: int, activation: str,
                 dropout: float, batch_norm: bool):
        super().__init__()
        width = len(field_specs) * embed_dim
        self.embedding = Embeddings(field_specs, embed_dim)
        self.cross_net = CrossNetwork(width, num_layers)
        self.mlp = MLPModule([width, *mlp_layer], activation_func=activation, dropout=dropout,
                             batch_norm=batch_norm)
        self.fc = nn.Linear(mlp_layer[-1] + width, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        cross = self.cross_net(x)
        deep = self.mlp(x, rng)
        return self.fc(torch.cat([deep, cross], dim=-1)).squeeze(-1)


class DCN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DCNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      tuple(mc["mlp_layer"]), mc["num_layers"], mc["activation"],
                      mc["dropout"], mc.get("batch_norm", False))
