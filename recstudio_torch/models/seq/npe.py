"""NPE: neural personalized embedding.

Counterpart of ``recstudio_tpu/models/seq/npe.py``: the item tower is its
table through a relu; the query reads the raw table (no relu): the relu
of the history's summed embeddings plus the relu of the user's
embedding, each dropped at ``dropout_rate`` in training (two masks from
one dropout module, two seeds here). Scored by inner product and trained
with ``BinaryCrossEntropyLoss`` on one uniform negative.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ...ops.dropout import SITE_HIDDEN, SITE_INPUT
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BinaryCrossEntropyLoss
from ..module import Embedding
from ..module.layers import seeded_dropout


class NPEItemEncoder(nn.Module):
    def __init__(self, num_items: int, embed_dim: int):
        super().__init__()
        self.embedding_layer = Embedding(num_items, embed_dim)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The raw table's rows, without the relu (the query tower's)."""
        return self.embedding_layer(ids)

    def forward(self, ids: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.relu(self.embedding_layer(ids))


class NPEQueryEncoder(nn.Module):
    def __init__(self, fuid: str, fiid: str, num_users: int, embed_dim: int,
                 dropout_rate: float, item_encoder: NPEItemEncoder):
        super().__init__()
        self.fuid, self.fiid, self.dropout_rate = fuid, fiid, dropout_rate
        self.item_encoder = item_encoder
        self.user_embedding = Embedding(num_users, embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.item_encoder.embed(batch["in_" + self.fiid]).sum(1))
        u = torch.relu(self.user_embedding(batch[self.fuid]))
        h = seeded_dropout(h, self.dropout_rate, self.training, rng, SITE_INPUT)
        u = seeded_dropout(u, self.dropout_rate, self.training, rng, SITE_HIDDEN)
        return h + u


class NPE(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_item_encoder(self, train_data):
        return NPEItemEncoder(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return NPEQueryEncoder(self.fuid, self.fiid, train_data.num_users, self.embed_dim,
                               self.config["model"]["dropout_rate"], self.item_encoder)

    def _get_loss_func(self):
        return BinaryCrossEntropyLoss()
