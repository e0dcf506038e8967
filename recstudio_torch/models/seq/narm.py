"""NARM: neural attentive session-based recommendation.

Counterpart of ``recstudio_tpu/models/seq/narm.py``: the item-embedding
sequence, dropout ``dropout_rate[0]``, a GRU stack; its state at the last
true position ``h_t`` (the global encoder) and the feedforward attention of
``h_t`` over every position's state (the local encoder, padded positions
weighted 0); their concatenation, dropout ``dropout_rate[1]``, and ``fc``
to ``embed_dim``. Scored by inner product against the shared item table and
trained with the full-catalog ``SoftmaxLoss``, through
``_fused_softmax_step`` (K7, K8, K9 on the card) unless
``train.fused_softmax`` is ``false``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ...ops.dropout import SITE_HIDDEN, SITE_INPUT
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SoftmaxLoss
from ..module import AttentionLayer, GRULayer, SeqPoolingLayer
from ..module.layers import seeded_dropout


class NARMQueryEncoder(nn.Module):
    def __init__(self, fiid: str, embed_dim: int, hidden_size: int, layer_num: int,
                 dropout_rate: Sequence[float], item_encoder: nn.Module):
        super().__init__()
        self.fiid = fiid
        self.dropout_rate = tuple(dropout_rate)
        self.item_encoder = item_encoder
        self.gru = GRULayer(embed_dim, hidden_size, layer_num)
        self.pooling = SeqPoolingLayer("last")
        self.attn = AttentionLayer(q_dim=hidden_size, mlp_layers=[hidden_size], bias=False)
        self.fc = nn.Linear(2 * hidden_size, embed_dim, bias=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hist = batch["in_" + self.fiid]
        x = seeded_dropout(self.item_encoder(hist), self.dropout_rate[0], self.training, rng,
                           SITE_INPUT)
        gru_vec = self.gru(x, rng)
        h_t = self.pooling(gru_vec, batch["seqlen"])
        c_local = self.attn(h_t[:, None, :], gru_vec, gru_vec,
                            key_padding_mask=hist == 0).squeeze(1)
        c = torch.cat([h_t, c_local], dim=-1)
        return self.fc(seeded_dropout(c, self.dropout_rate[1], self.training, rng, SITE_HIDDEN))


class NARM(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return NARMQueryEncoder(self.fiid, self.embed_dim, mc["hidden_size"], mc["layer_num"],
                                mc["dropout_rate"], self.item_encoder)

    def _get_loss_func(self):
        return SoftmaxLoss()

    def _get_sampler(self, train_data):
        return None
