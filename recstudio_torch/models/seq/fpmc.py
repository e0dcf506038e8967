"""FPMC: factorized personalized Markov chains.

Counterpart of ``recstudio_tpu/models/seq/fpmc.py``: the query is the
user's embedding beside the embedding of the history's last true item
(a table of its own), scored by inner product against a ``2 D`` wide item
table and trained with ``BPRLoss`` on one uniform negative.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding


def last_item(batch: Dict[str, torch.Tensor], fiid: str) -> torch.Tensor:
    """The id at each history's last true position, ``max(seqlen - 1, 0)``."""
    hist = batch["in_" + fiid]
    idx = torch.clamp_min(batch["seqlen"].long() - 1, 0)
    return hist[torch.arange(hist.shape[0], device=hist.device), idx]


class FPMCQueryEncoder(nn.Module):
    def __init__(self, fuid: str, fiid: str, num_users: int, num_items: int, embed_dim: int):
        super().__init__()
        self.fuid, self.fiid = fuid, fiid
        self.user_embedding = Embedding(num_users, embed_dim)
        self.last_item_embedding = Embedding(num_items, embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.cat([self.user_embedding(batch[self.fuid]),
                          self.last_item_embedding(last_item(batch, self.fiid))], dim=-1)


class FPMC(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, 2 * self.embed_dim)

    def _get_query_encoder(self, train_data):
        return FPMCQueryEncoder(self.fuid, self.fiid, train_data.num_users,
                                train_data.num_items, self.embed_dim)

    def _get_loss_func(self):
        return BPRLoss()
