"""DeepCrossing: residual MLP units over the stacked field embeddings.

Counterpart of ``recstudio_tpu/models/fm/deepcrossing.py``: the flattened
embeddings go through ``residual_{i}`` units, each ``MLPModule([W, h,
W])`` (no activation after its last layer) added to its input and passed
through a relu, then dropout (the plain Philox mask, where the JAX module
takes ``nn.Dropout``); ``fc`` scores the result.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import seeded_dropout


class DeepCrossingNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, hidden_dims, activation: str, dropout: float):
        super().__init__()
        width = len(field_specs) * embed_dim
        self.dropout, self.n_units = dropout, len(hidden_dims)
        self.embedding = Embeddings(field_specs, embed_dim)
        for i, hidden in enumerate(hidden_dims):
            self.add_module(f"residual_{i}", MLPModule(
                [width, hidden, width], activation_func=activation, last_activation=False,
                last_bn=False))
        self.fc = nn.Linear(width, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        for i in range(self.n_units):
            x = torch.relu(x + getattr(self, f"residual_{i}")(x, rng))
            x = seeded_dropout(x, self.dropout, self.training, rng)
        return self.fc(x).squeeze(-1)


class DeepCrossing(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DeepCrossingNet(make_field_specs(self.fields, train_data), self.embed_dim,
                               tuple(mc["hidden_dims"]), mc["activation"], mc["dropout"])
