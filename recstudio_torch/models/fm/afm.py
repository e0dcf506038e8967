"""AFM: attentional factorization machine.

Counterpart of ``recstudio_tpu/models/fm/afm.py``: the first-order
``LinearLayer`` plus ``AFMLayer`` over the field embeddings.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import AFMLayer, Embeddings, LinearLayer, make_field_specs


class AFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, attention_dim: int, dropout: float):
        super().__init__()
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.afm = AFMLayer(embed_dim, attention_dim, len(field_specs), dropout)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(batch) + self.afm(self.embedding(batch), rng)


class AFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return AFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      mc["attention_dim"], mc["dropout"])
