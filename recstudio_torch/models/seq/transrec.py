"""TransRec: translation-based recommendation.

Counterpart of ``recstudio_tpu/models/seq/transrec.py``: the query is the
user's translation (its own embedding plus a global one) added to the
embedding of the history's last true item in the shared item table,
scored by inner product (the JAX package's, whose reference hook is
misnamed) and trained with ``BPRLoss`` on one uniform negative.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding
from .fpmc import last_item


class TransRecQueryEncoder(nn.Module):
    def __init__(self, fuid: str, fiid: str, num_users: int, embed_dim: int,
                 item_encoder: nn.Module):
        super().__init__()
        self.fuid, self.fiid = fuid, fiid
        self.item_encoder = item_encoder
        self.user_embedding = Embedding(num_users, embed_dim)
        self.global_user_emb = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        u = self.user_embedding(batch[self.fuid]) + self.global_user_emb[None, :]
        return u + self.item_encoder(last_item(batch, self.fiid))


class TransRec(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        return TransRecQueryEncoder(self.fuid, self.fiid, train_data.num_users, self.embed_dim,
                                    self.item_encoder)

    def _get_loss_func(self):
        return BPRLoss()
