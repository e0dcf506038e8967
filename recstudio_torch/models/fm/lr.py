"""LR: logistic regression over every declared feature.

Counterpart of ``recstudio_tpu/models/fm/lr.py``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import LinearLayer, make_field_specs


class LRNet(nn.Module):
    def __init__(self, field_specs):
        super().__init__()
        self.linear = LinearLayer(field_specs)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(batch)


class LR(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return LRNet(make_field_specs(self.fields, train_data))
