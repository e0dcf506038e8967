"""LorentzFM: triangle-pooled interactions in Lorentz space.

Counterpart of ``recstudio_tpu/models/fm/lorentzfm.py``: each field's
embedding is lifted to ``sqrt(1 + |e|^2)``; for every pair ``i < j`` (in
``triu_indices`` order) ``gamma = 1 + (1 - <e_i, e_j> - u_i - u_j) /
(u_i u_j)``, summed over the pairs. No first-order term, no bias.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, _pairs, make_field_specs


class LorentzFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int):
        super().__init__()
        self.num_fields = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        rows, cols = _pairs(self.num_fields, emb.device)
        inner = (emb[:, rows, :] * emb[:, cols, :]).sum(-1)             # [B, P]
        zero = torch.sqrt(1.0 + (emb * emb).sum(-1))                    # [B, F]
        u0, v0 = zero[:, rows], zero[:, cols]
        gamma = 1.0 + (1.0 - inner - u0 - v0) / (u0 * v0)
        return gamma.sum(-1)


class LorentzFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        return LorentzFMNet(make_field_specs(self.fields, train_data), self.embed_dim)
