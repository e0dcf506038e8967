"""DeepFM: an FM and a deep MLP over shared field embeddings.

Counterpart of ``recstudio_tpu/models/fm/deepfm.py``: the logit is the
first-order ``LinearLayer``, the ``FMLayer`` over the ``[B, F, D]`` field
embeddings, and an MLP over the flattened embeddings (dropout before each
layer from ``seeded_dropout``, the activation after each but the last).
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FMLayer, LinearLayer, make_field_specs


class DeepFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float):
        super().__init__()
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.fm = FMLayer(reduction="sum")
        self.mlp = MLPModule([len(field_specs) * embed_dim, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout, last_activation=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        lr_score = self.linear(batch)
        emb = self.embedding(batch)
        fm_score = self.fm(emb)
        mlp_score = self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1)
        return lr_score + fm_score + mlp_score


class DeepFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DeepFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                         tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"])
