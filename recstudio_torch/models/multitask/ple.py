"""PLE: progressive layered extraction.

Counterpart of ``recstudio_tpu/models/multitask/ple.py``: ``num_levels``
extraction layers, each with ``specific_experts_per_task`` experts a task
(``task{t}_{e}``), ``num_shared_experts`` shared ones (``shared_{s}``) and
a gate a task (``gate_{t}``) mixing that task's experts with the shared
ones; every level but the last also gates all experts into the shared
input of the next (``gate_shared``). Then a tower a rating.
"""
from typing import Dict, List, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class ExtractionLayer(nn.Module):
    def __init__(self, in_dim: int, specific_per_task: int, num_task: int, num_shared: int,
                 share_gate: bool, expert_mlp_layer, expert_activation: str,
                 expert_dropout: float, gate_mlp_layer, gate_activation: str,
                 gate_dropout: float):
        super().__init__()
        self.specific_per_task, self.num_task = specific_per_task, num_task
        self.num_shared, self.share_gate = num_shared, share_gate

        def expert():
            return MLPModule([in_dim, *expert_mlp_layer], expert_activation, expert_dropout)

        def gate(n_out):
            return MLPModule([in_dim, *gate_mlp_layer, n_out], gate_activation, gate_dropout,
                             last_activation=False)

        for s in range(num_shared):
            self.add_module(f"shared_{s}", expert())
        for t in range(num_task):
            for e in range(specific_per_task):
                self.add_module(f"task{t}_{e}", expert())
        for t in range(num_task):
            self.add_module(f"gate_{t}", gate(specific_per_task + num_shared))
        if share_gate:
            self.gate_shared = gate(num_task * specific_per_task + num_shared)

    def forward(self, inputs: List[torch.Tensor], rng: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``inputs``: a tensor a task, then the shared input."""
        shared = torch.stack([getattr(self, f"shared_{s}")(inputs[-1], rng)
                              for s in range(self.num_shared)], dim=1)
        spec = [torch.stack([getattr(self, f"task{t}_{e}")(inputs[t], rng)
                             for e in range(self.specific_per_task)], dim=1)
                for t in range(self.num_task)]
        outs = []
        for t in range(self.num_task):
            experts = torch.cat([spec[t], shared], dim=1)
            g = torch.softmax(getattr(self, f"gate_{t}")(inputs[t], rng), dim=-1)
            outs.append((g[..., None] * experts).sum(1))
        if self.share_gate:
            experts = torch.cat(spec + [shared], dim=1)
            g = torch.softmax(self.gate_shared(inputs[-1], rng), dim=-1)
            outs.append((g[..., None] * experts).sum(1))
        return outs


class PLENet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, ratings, num_levels: int,
                 specific_per_task: int, num_shared: int, expert_mlp_layer, gate_mlp_layer,
                 tower_mlp_layer, expert_activation: str, gate_activation: str,
                 tower_activation: str, expert_dropout: float, gate_dropout: float,
                 tower_dropout: float, tower_batch_norm: bool = False):
        super().__init__()
        self.ratings = tuple(ratings)
        self.num_levels = num_levels
        self.embedding = Embeddings(field_specs, embed_dim)
        in_dim = len(field_specs) * embed_dim
        for lvl in range(num_levels):
            self.add_module(f"extraction_{lvl}", ExtractionLayer(
                in_dim, specific_per_task, len(self.ratings), num_shared,
                lvl != num_levels - 1, expert_mlp_layer, expert_activation, expert_dropout,
                gate_mlp_layer, gate_activation, gate_dropout))
            in_dim = expert_mlp_layer[-1]
        for r in self.ratings:
            self.add_module(f"tower_{r}", MLPModule(
                [expert_mlp_layer[-1], *tower_mlp_layer, 1], tower_activation, tower_dropout,
                batch_norm=tower_batch_norm, last_activation=False, last_bn=False))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        inputs = [x] * (len(self.ratings) + 1)
        for lvl in range(self.num_levels):
            inputs = getattr(self, f"extraction_{lvl}")(inputs, rng)
        return {r: getattr(self, f"tower_{r}")(inputs[t], rng).squeeze(-1)
                for t, r in enumerate(self.ratings)}


class PLE(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return PLENet(make_field_specs(self.fields, train_data), self.embed_dim,
                      self._multitask_ratings("PLE"), mc["num_levels"],
                      mc["specific_experts_per_task"], mc["num_shared_experts"],
                      mc["expert_mlp_layer"], mc["gate_mlp_layer"], mc["tower_mlp_layer"],
                      mc["expert_activation"], mc["gate_activation"], mc["tower_activation"],
                      mc["expert_dropout"], mc["gate_dropout"], mc["tower_dropout"],
                      mc.get("tower_batch_norm", False))
