"""GRU4Rec: session-based recommendation with a recurrent encoder.

Counterpart of ``recstudio_tpu/models/seq/gru4rec.py``: the item-embedding
sequence, dropout (``train``), a GRU stack, the state at the last true
position, a projection back to ``embed_dim`` (with a bias); scored by inner
product against the shared item table and trained with ``BPRLoss`` on
uniform negatives (``train.negative_count``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ...ops.dropout import SITE_INPUT
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import GRULayer, SeqPoolingLayer
from ..module.layers import seeded_dropout


class GRU4RecQueryEncoder(nn.Module):
    def __init__(self, fiid: str, embed_dim: int, hidden_size: int, layer_num: int,
                 dropout: float, item_encoder: nn.Module):
        super().__init__()
        self.fiid = fiid
        self.dropout = dropout
        self.item_encoder = item_encoder
        self.gru = GRULayer(embed_dim, hidden_size, layer_num)
        self.pooling = SeqPoolingLayer("last")
        self.proj = nn.Linear(hidden_size, embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.item_encoder(batch["in_" + self.fiid])
        x = seeded_dropout(x, self.dropout, self.training, rng, SITE_INPUT)
        return self.proj(self.pooling(self.gru(x, rng), batch["seqlen"]))


class GRU4Rec(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return GRU4RecQueryEncoder(self.fiid, self.embed_dim, mc["hidden_size"],
                                   mc["layer_num"], mc["dropout_rate"], self.item_encoder)

    def _get_loss_func(self):
        return BPRLoss()
