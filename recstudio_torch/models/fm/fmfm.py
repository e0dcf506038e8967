"""FmFM: field-matrixed factorization machine.

Counterpart of ``recstudio_tpu/models/fm/fmfm.py``: the first-order
``LinearLayer`` plus ``FMFMLayer`` (``fmfm``) over the field embeddings.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, FMFMLayer, LinearLayer, make_field_specs


class FmFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int):
        super().__init__()
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.fmfm = FMFMLayer(len(field_specs), embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(batch) + self.fmfm(self.embedding(batch))


class FmFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return FmFMNet(make_field_specs(self.fields, train_data), self.embed_dim)
