"""InterHAt: interpretable hierarchical attention.

Counterpart of ``recstudio_tpu/models/fm/interhat.py``: the field
embeddings go through one ``TransformerLayer`` (``trm``, relu, no key
padding mask and no attention mask), then ``order`` levels of
``AttentionalAggregation`` (``agg_{i}``: ``x_{i+1} = u_i x_1 + x_i``), a
last aggregation over the levels' summaries (``agg_final``) and an MLP.
The layer's route is the JAX gate's: inside the fused layer's gate (as
InterHAt's d 16, F 64, L = the fields are) it is ``fused_transformer_layer``,
K1 in evaluation and serving, K1 with its four dropouts and K2 as its
backward in training; the ranker's generator gives the layer its seeds.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule, TransformerLayer
from ..module.ctr import Embeddings, make_field_specs


class AttentionalAggregation(nn.Module):
    """A softmax over the fields of ``w2(relu(w1(key)))`` (no biases)
    weighs ``value``'s rows, summed: ``[B, D]``."""

    def __init__(self, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.w1 = nn.Linear(embed_dim, hidden_dim, bias=False)
        self.w2 = nn.Linear(hidden_dim, 1, bias=False)

    def forward(self, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.w2(torch.relu(self.w1(key))), dim=1)
        return (w * value).sum(1)


class InterHAtNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, n_head: int, feedforward_dim: int,
                 order: int, aggregation_dim: int, mlp_layer, activation: str, dropout: float):
        super().__init__()
        self.order = order
        self.embedding = Embeddings(field_specs, embed_dim)
        self.trm = TransformerLayer(embed_dim, n_head, feedforward_dim, dropout, "relu")
        for i in range(order):
            self.add_module(f"agg_{i}", AttentionalAggregation(embed_dim, aggregation_dim))
        self.agg_final = AttentionalAggregation(embed_dim, aggregation_dim)
        self.mlp = MLPModule([embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x1 = self.trm(self.embedding(batch), rng=rng)
        xi, us = x1, []
        for i in range(self.order):
            ui = getattr(self, f"agg_{i}")(xi, xi)
            us.append(ui)
            xi = ui[:, None, :] * x1 + xi
        U = torch.stack(us, dim=1)
        return self.mlp(self.agg_final(U, U), rng).squeeze(-1)


class InterHAt(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return InterHAtNet(make_field_specs(self.fields, train_data), self.embed_dim,
                           mc["n_head"], mc["feedforward_dim"], mc["order"],
                           mc["aggregation_dim"], tuple(mc["mlp_layer"]), mc["activation"],
                           mc["dropout"])
