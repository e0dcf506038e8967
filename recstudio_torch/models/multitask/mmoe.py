"""MMoE: multi-gate mixture-of-experts multitask ranker.

Counterpart of ``recstudio_tpu/models/multitask/mmoe.py``. The expert bank
is one module whose weights carry a leading expert axis (``ExpertBank``:
``kernel_{i} [E, in, out]``, ``bias_{i} [E, out]``, the JAX bank's
``nn.vmap``-ed ``dense_{i}`` leaves), applied with one batched product a
layer; in training each expert draws its own dropout mask, as the JAX
bank splits its dropout stream per expert. Each rating has its gate
(``gate_{rating}``, a softmax over the experts) and its tower
(``tower_{rating}``).
"""
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule, get_act
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import seeded_dropout


class ExpertBank(nn.Module):
    """``num_experts`` MLPs ``[in, *sizes]`` with their weights stacked on
    a leading expert axis: ``x [B, in]`` -> ``[B, E, sizes[-1]]``. Each
    layer is dropout (a mask per expert), ``einsum("bei,eio->beo")`` plus
    the bias, then the activation, as ``MLPModule`` with its defaults."""

    def __init__(self, num_experts: int, mlp_layers: Sequence[int], activation="relu",
                 dropout: float = 0.0):
        super().__init__()
        sizes = list(mlp_layers)
        self.num_experts, self.n_layers, self.dropout = num_experts, len(sizes) - 1, dropout
        for i in range(self.n_layers):
            self.register_parameter(f"kernel_{i}", nn.Parameter(
                torch.zeros(num_experts, sizes[i], sizes[i + 1])))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.zeros(num_experts, sizes[i + 1])))
        self.act = get_act(activation, sizes[-1])
        if isinstance(self.act, nn.Module):
            raise ValueError("an expert bank takes no dice activation")

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x[:, None, :].expand(x.shape[0], self.num_experts, x.shape[-1])
        for i in range(self.n_layers):
            x = seeded_dropout(x, self.dropout, self.training, rng)
            x = torch.einsum("bei,eio->beo", x, getattr(self, f"kernel_{i}")) \
                + getattr(self, f"bias_{i}")
            x = self.act(x)
        return x


class MMoENet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, ratings, num_experts: int,
                 expert_mlp_layer, gate_mlp_layer, tower_mlp_layer,
                 expert_activation: str = "relu", gate_activation: str = "relu",
                 tower_activation: str = "relu", expert_dropout: float = 0.0,
                 gate_dropout: float = 0.0, tower_dropout: float = 0.0):
        super().__init__()
        self.ratings = tuple(ratings)
        in_dim = len(field_specs) * embed_dim
        self.embedding = Embeddings(field_specs, embed_dim)
        self.experts = ExpertBank(num_experts, [in_dim, *expert_mlp_layer], expert_activation,
                                  expert_dropout)
        for r in self.ratings:
            self.add_module(f"gate_{r}", MLPModule([in_dim, *gate_mlp_layer, num_experts],
                                                   gate_activation, gate_dropout))
            self.add_module(f"tower_{r}", MLPModule(
                [expert_mlp_layer[-1], *tower_mlp_layer, 1], tower_activation, tower_dropout,
                last_activation=False, last_bn=False))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        experts = self.experts(x, rng)                                   # [B, E, De]
        out = {}
        for r in self.ratings:
            gate = torch.softmax(getattr(self, f"gate_{r}")(x, rng), dim=-1)
            mixed = (gate[..., None] * experts).sum(1)
            out[r] = getattr(self, f"tower_{r}")(mixed, rng).squeeze(-1)
        return out


class MMoE(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return MMoENet(
            make_field_specs(self.fields, train_data), self.embed_dim,
            self._multitask_ratings("MMoE"), mc["num_experts"], mc["expert_mlp_layer"],
            mc["gate_mlp_layer"], mc["tower_mlp_layer"], mc["expert_activation"],
            mc["gate_activation"], mc["tower_activation"], mc["expert_dropout"],
            mc["gate_dropout"], mc["tower_dropout"])
