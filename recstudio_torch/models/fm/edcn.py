"""EDCN: deep and cross with bridge and regulation modules.

Counterpart of ``recstudio_tpu/models/fm/edcn.py``: a ``RegulationLayer``
splits the flattened embeddings into a cross and a deep input, each
scaled by a softmax over the fields' gates (each gate repeated
``embed_dim`` times, field-major); each layer takes a cross step ``c_i +
c_0 (c_i . w_i) + b_i`` (``cross_w_{i}`` drawn from ``normal(1.0)``), a
deep step (``deep_{i}``) and a ``BridgeLayer`` between the two, whose
output the next regulation splits again; ``fc`` scores the last cross,
deep and bridge outputs side by side.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class BridgeLayer(nn.Module):
    """``edcn.py:18-38``: ``pointwise_addition``, ``hadamard_product``,
    ``concatenation`` (``relu(proj([x0, x1]))``) or ``attention_pooling``
    (each input weighed by a softmax of ``{a0,a1}_2(relu({a0,a1}_1(x)))``,
    the second layer without a bias)."""

    def __init__(self, width: int, bridge_type: str = "hadamard_product"):
        super().__init__()
        self.bridge_type = bridge_type.lower()
        if self.bridge_type == "concatenation":
            self.proj = nn.Linear(2 * width, width)
        elif self.bridge_type not in ("pointwise_addition", "hadamard_product"):
            for name in ("a0", "a1"):
                self.add_module(f"{name}_1", nn.Linear(width, width))
                self.add_module(f"{name}_2", nn.Linear(width, width, bias=False))

    def _att(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(getattr(self, f"{name}_1")(x))
        return torch.softmax(getattr(self, f"{name}_2")(h), dim=-1)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        if self.bridge_type == "pointwise_addition":
            return x0 + x1
        if self.bridge_type == "hadamard_product":
            return x0 * x1
        if self.bridge_type == "concatenation":
            return torch.relu(self.proj(torch.cat([x0, x1], dim=-1)))
        return self._att("a0", x0) * x0 + self._att("a1", x1) * x1


class RegulationLayer(nn.Module):
    """``edcn.py:41-52``: ``(softmax(cross_gate / T) x, softmax(deep_gate /
    T) x)``, each field's gate repeated over its ``embed_dim`` columns;
    the gates start at 1."""

    def __init__(self, num_fields: int, embed_dim: int, temperature: float = 1.0):
        super().__init__()
        self.embed_dim, self.temperature = embed_dim, temperature
        self.cross_gate = nn.Parameter(torch.ones(num_fields))
        self.deep_gate = nn.Parameter(torch.ones(num_fields))

    def forward(self, x: torch.Tensor):
        cgs = torch.softmax(self.cross_gate / self.temperature, dim=0)
        dgs = torch.softmax(self.deep_gate / self.temperature, dim=0)
        return (cgs.repeat_interleave(self.embed_dim) * x,
                dgs.repeat_interleave(self.embed_dim) * x)


class EDCNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, num_layers: int, bridge_type: str,
                 temperature: float, activation: str, dropout: float, batch_norm: bool):
        super().__init__()
        F = len(field_specs)
        width = F * embed_dim
        self.num_layers = num_layers
        self.embedding = Embeddings(field_specs, embed_dim)
        self.raw_init = {}
        for i in range(max(num_layers, 1)):
            self.add_module(f"regulation_{i}", RegulationLayer(F, embed_dim, temperature))
        for i in range(num_layers):
            self.register_parameter(f"cross_w_{i}", nn.Parameter(torch.zeros(width)))
            self.register_parameter(f"cross_b_{i}", nn.Parameter(torch.zeros(width)))
            self.raw_init[f"cross_w_{i}"] = "normal"
            self.add_module(f"deep_{i}", MLPModule([width, width], activation_func=activation,
                                                   dropout=dropout, batch_norm=batch_norm))
            self.add_module(f"bridge_{i}", BridgeLayer(width, bridge_type))
        self.fc = nn.Linear(3 * width, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        ci, di = self.regulation_0(x)
        c0 = bi = ci
        for i in range(self.num_layers):
            w, b = getattr(self, f"cross_w_{i}"), getattr(self, f"cross_b_{i}")
            ci = ci + c0 * torch.matmul(ci, w)[:, None] + b
            di = getattr(self, f"deep_{i}")(di, rng)
            bi = getattr(self, f"bridge_{i}")(ci, di)
            if i + 1 < self.num_layers:
                ci, di = getattr(self, f"regulation_{i + 1}")(bi)
        return self.fc(torch.cat([ci, di, bi], dim=-1)).squeeze(-1)


class EDCN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return EDCNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                       mc["num_layers"], mc.get("bridge_type", "hadamard_product"),
                       mc.get("temperature", 1.0), mc["activation"], mc["dropout"],
                       mc.get("batch_norm", False))
