"""HGN: hierarchical gating networks.

Counterpart of ``recstudio_tpu/models/seq/hgn.py``: the embedded history
``S [B, L, D]`` through a feature gate (``sigmoid(W_g_1 S + W_g_2 u +
b_g)``) and an instance gate (``sigmoid(w_g_3 S_F + u W_g_4[:L]^T +
b_g_4[:L])``), pooled by the gate-weighted mean (or the max) over every
position, plus the user's embedding and the plain sum of ``S`` (the
item-item term); scored by inner product against the shared item table
and trained with ``BPRLoss`` on one uniform negative.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding


class HGNQueryEncoder(nn.Module):
    def __init__(self, fuid: str, fiid: str, num_users: int, embed_dim: int, max_seq_len: int,
                 item_encoder: nn.Module, pooling_type: str = "mean"):
        super().__init__()
        if pooling_type not in ("mean", "max"):
            raise ValueError("pooling_type must be mean or max")
        self.fuid, self.fiid, self.pooling_type = fuid, fiid, pooling_type
        self.item_encoder = item_encoder
        self.user_embedding = Embedding(num_users, embed_dim)
        self.b_g = nn.Parameter(torch.zeros(embed_dim))
        self.W_g_1 = nn.Linear(embed_dim, embed_dim, bias=False)
        self.W_g_2 = nn.Linear(embed_dim, embed_dim, bias=False)
        self.w_g_3 = nn.Linear(embed_dim, 1, bias=False)
        self.W_g_4 = nn.Parameter(torch.zeros(max_seq_len, embed_dim))
        self.b_g_4 = nn.Parameter(torch.zeros(max_seq_len))
        self.raw_init = {"W_g_4": "xavier_normal"}     # flax's, left by the rule by name

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        U = self.user_embedding(batch[self.fuid])
        S = self.item_encoder(batch["in_" + self.fiid])                    # [B, L, D]
        L = S.shape[1]
        gate_f = torch.sigmoid(self.W_g_1(S) + self.W_g_2(U)[:, None, :] + self.b_g)
        S_F = S * gate_f
        inst_logit = (U @ self.W_g_4[:L].t() + self.b_g_4[:L])[:, :, None]
        weight = torch.sigmoid(self.w_g_3(S_F) + inst_logit)               # [B, L, 1]
        S_I = S_F * weight
        if self.pooling_type == "mean":
            s = S_I.sum(1) / torch.clamp_min(weight.sum(1), 1e-8)
        else:
            s = S_I.amax(1)
        return U + s + S.sum(1)


class HGN(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        return HGNQueryEncoder(self.fuid, self.fiid, train_data.num_users, self.embed_dim,
                               train_data.config["max_seq_len"], self.item_encoder,
                               self.config["model"]["pooling_type"])

    def _get_loss_func(self):
        return BPRLoss()
