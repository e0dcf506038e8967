"""FFM: field-aware factorization machine.

Counterpart of ``recstudio_tpu/models/fm/ffm.py``: each field's table is
``(F - 1) D`` wide, one vector a other field (``FieldAwareFMLayer``), plus
the first-order ``LinearLayer``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, FieldAwareFMLayer, LinearLayer, make_field_specs


class FFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int):
        super().__init__()
        F = len(field_specs)
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim * (F - 1))
        self.ffm = FieldAwareFMLayer(F)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(batch) + self.ffm(self.embedding(batch))


class FFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return FFMNet(make_field_specs(self.fields, train_data), self.embed_dim)
