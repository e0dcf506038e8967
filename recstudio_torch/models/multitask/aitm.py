"""AITM: adaptive information transfer multitask ranker.

Counterpart of ``recstudio_tpu/models/multitask/aitm.py``: a tower a
rating (``tower_{rating}``) over the flattened field embeddings; for each
task after the first, a one-head ``MultiHeadAttention`` (``att_{rating}``)
over ``[info, tower]`` of the previous task's transferred information and
this task's tower, summed over the two positions; ``fc_{rating}`` gives
the logits and ``info_{rating}`` (relu) the information passed on. The
attention goes through ``fused_mha`` (K3 on the card) in evaluation and
serving, as the JAX gate routes it. The training loss adds the
calibrator ``sum(mean(relu(s_next - s_prev)))`` over consecutive tasks
(``aitm.py:69-74``), read from the scores the loss was computed on: the
JAX step recomputes them with the same dropout stream, which gives the
same values and gradients.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import MultiHeadAttention


class AITMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, ratings, tower_mlp_layer,
                 tower_activation: str, tower_dropout: float, tower_batch_norm: bool = False):
        super().__init__()
        self.ratings = tuple(ratings)
        self.embedding = Embeddings(field_specs, embed_dim)
        in_dim, T = len(field_specs) * embed_dim, tower_mlp_layer[-1]
        for i, r in enumerate(self.ratings):
            self.add_module(f"tower_{r}", MLPModule([in_dim, *tower_mlp_layer], tower_activation,
                                                    tower_dropout, batch_norm=tower_batch_norm))
            if i > 0:
                self.add_module(f"att_{r}", MultiHeadAttention(T, n_head=1))
            self.add_module(f"fc_{r}", nn.Linear(T, 1))
            if i < len(self.ratings) - 1:
                self.add_module(f"info_{r}", nn.Linear(T, T))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        emb = self.embedding(batch)
        x = emb.reshape(emb.shape[0], -1)
        out, info = {}, None
        for i, r in enumerate(self.ratings):
            tower = getattr(self, f"tower_{r}")(x, rng)
            if i == 0:
                ait = tower
            else:
                u = torch.stack([info, tower], dim=1)                    # [B, 2, T]
                ait = getattr(self, f"att_{r}")(u, u, u, rng=rng).sum(1)
            out[r] = getattr(self, f"fc_{r}")(ait).squeeze(-1)
            if i < len(self.ratings) - 1:
                info = torch.relu(getattr(self, f"info_{r}")(ait))
        return out


class AITM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return AITMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                       self._multitask_ratings("AITM"), mc["tower_mlp_layer"],
                       mc["tower_activation"], mc["tower_dropout"],
                       mc.get("tower_batch_norm", False))

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.forward(batch)
        scores = {r: o["pos_score"] for r, o in out.items()}
        calib = sum(torch.relu(scores[nxt] - scores[prev]).mean()
                    for prev, nxt in zip(self.frating[:-1], self.frating[1:]))
        return self._multitask_loss(out) + calib
