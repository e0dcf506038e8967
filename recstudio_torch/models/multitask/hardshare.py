"""HardShare: a shared-bottom multitask ranker.

Counterpart of ``recstudio_tpu/models/multitask/hardshare.py``: one bottom
MLP over the flattened field embeddings, shared by every task, and one top
MLP a rating field (``top_{rating}``) giving that task's logits.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class HardShareNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, ratings, bottom_mlp_layer, top_mlp_layer,
                 bottom_activation: str = "relu", top_activation: str = "relu",
                 bottom_dropout: float = 0.0, top_dropout: float = 0.0,
                 bottom_batch_norm: bool = False, top_batch_norm: bool = False):
        super().__init__()
        self.ratings = tuple(ratings)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.bottom = MLPModule([len(field_specs) * embed_dim, *bottom_mlp_layer],
                                bottom_activation, bottom_dropout,
                                batch_norm=bottom_batch_norm)
        for r in self.ratings:
            self.add_module(f"top_{r}", MLPModule(
                [bottom_mlp_layer[-1], *top_mlp_layer, 1], top_activation, top_dropout,
                batch_norm=top_batch_norm, last_activation=False))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        emb = self.embedding(batch)
        shared = self.bottom(emb.reshape(emb.shape[0], -1), rng)
        return {r: getattr(self, f"top_{r}")(shared, rng).squeeze(-1) for r in self.ratings}


class HardShare(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return HardShareNet(
            make_field_specs(self.fields, train_data), self.embed_dim,
            self._multitask_ratings("HardShare"), mc["bottom_mlp_layer"],
            mc["top_mlp_layer"], mc["bottom_activation"], mc["top_activation"],
            mc["bottom_dropout"], mc["top_dropout"], mc.get("bottom_batch_norm", False),
            mc.get("top_batch_norm", False))
