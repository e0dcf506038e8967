"""FM: factorization machine, first and second order.

Counterpart of ``recstudio_tpu/models/fm/fm.py``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, FMLayer, LinearLayer, make_field_specs


class FMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int):
        super().__init__()
        self.embeddings = Embeddings(field_specs, embed_dim)
        self.fm = FMLayer(reduction="sum")
        self.linear = LinearLayer(field_specs)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fm(self.embeddings(batch)) + self.linear(batch)


class FM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return FMNet(make_field_specs(self.fields, train_data), self.embed_dim)
