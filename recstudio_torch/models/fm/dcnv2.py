"""DCNv2: deep and cross network with full-matrix cross layers.

Counterpart of ``recstudio_tpu/models/fm/dcnv2.py``: the flattened
embeddings go through ``CrossNetworkV2`` (or, with ``low_rank``, the
low-rank mixture of experts ``CrossNetworkMix``) and an MLP (batch norm
with ``batch_norm``), side by side (``parallel``) or one after the other
(``stacked``), scored by ``fc``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule, get_act
from ..module.ctr import CrossNetworkV2, Embeddings, make_field_specs


class CrossNetworkMix(nn.Module):
    """DCN-Mix (``dcnv2.py:14-42``): in each layer ``num_experts`` low-rank
    experts ``x_0 (U act(C act(V^T x_l)) + bias)`` mixed by a softmax gate
    (``gate_{i}``, no bias), plus ``x_l``. ``U_{i}``, ``V_{i}`` ``[E, d,
    r]``, ``C_{i}`` ``[E, r, r]`` and ``bias_{i}`` ``[d]`` keep the JAX
    layout and its ``normal(1.0)``."""

    def __init__(self, embed_dim: int, num_layers: int, low_rank: int, num_experts: int,
                 activation: str = "tanh"):
        super().__init__()
        self.num_layers = num_layers
        self.act = get_act(activation)
        self.raw_init = {}
        for i in range(num_layers):
            for name, shape in ((f"U_{i}", (num_experts, embed_dim, low_rank)),
                                (f"V_{i}", (num_experts, embed_dim, low_rank)),
                                (f"C_{i}", (num_experts, low_rank, low_rank)),
                                (f"bias_{i}", (embed_dim,))):
                self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
                self.raw_init[name] = "normal"
            self.add_module(f"gate_{i}", nn.Linear(embed_dim, num_experts, bias=False))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        xl = x0
        for i in range(self.num_layers):
            U, V, C = (getattr(self, f"{n}_{i}") for n in "UVC")
            gate = torch.softmax(getattr(self, f"gate_{i}")(xl), dim=-1)
            vx = self.act(torch.einsum("edr,bd->ber", V, xl))
            cvx = self.act(torch.einsum("ers,bes->ber", C, vx))
            expert_out = x0 * (torch.einsum("edr,ber->ebd", U, cvx) + getattr(self, f"bias_{i}"))
            xl = torch.einsum("be,ebd->bd", gate, expert_out) + xl
        return xl


class DCNv2Net(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, num_layers: int, activation: str,
                 cross_activation: str, dropout: float, batch_norm: bool,
                 combination: str = "parallel", low_rank: int = 0, num_experts: int = 4):
        super().__init__()
        width = len(field_specs) * embed_dim
        self.combination = combination
        self.embedding = Embeddings(field_specs, embed_dim)
        self.cross_net = CrossNetworkMix(width, num_layers, low_rank, num_experts,
                                         cross_activation) if low_rank else \
            CrossNetworkV2(width, num_layers)
        self.mlp = MLPModule([width, *mlp_layer], activation_func=activation, dropout=dropout,
                             batch_norm=batch_norm)
        self.fc = nn.Linear(mlp_layer[-1] + (width if combination == "parallel" else 0), 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        cross = self.cross_net(x)
        if self.combination == "parallel":
            out = torch.cat([cross, self.mlp(x, rng)], dim=-1)
        else:
            out = self.mlp(cross, rng)
        return self.fc(out).squeeze(-1)


class DCNv2(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DCNv2Net(make_field_specs(self.fields, train_data), self.embed_dim,
                        tuple(mc["mlp_layer"]), mc["num_layers"], mc["activation"],
                        mc.get("cross_activation", "tanh"), mc["dropout"],
                        mc.get("batch_norm", False), mc.get("combination", "parallel"),
                        mc.get("low_rank") or 0, mc.get("num_experts", 4))
