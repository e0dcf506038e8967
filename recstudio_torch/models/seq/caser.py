"""Caser: convolutional sequence embedding.

Counterpart of ``recstudio_tpu/models/seq/caser.py``: the embedded
history ``[B, L, D]`` as an image. ``n_v`` vertical filters ``(n_v, L)``
each sum the positions (an einsum); for every height h in 1..L, ``n_h``
horizontal filters slide over the positions (a VALID ``conv1d`` with the
weight ``horizontal_kernel_{h} [n_h, D, h]``: the JAX ``(h, D, n_h)``
kernel reversed), each followed by a relu and a max over time. Their
concatenation, dropout (the plain Philox mask), ``fc`` and a relu,
beside the user's embedding, is the query; the item table is ``2 D``
wide. The JAX package computes the convolutions in XLA
(``lax.conv_general_dilated``), not in a Pallas kernel; on the card they
run through cuDNN in float32 in both passes (``float32_cudnn``). Trained
with ``BPRLoss`` on one uniform negative.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.dataset import SeqDataset
from ...ops.dropout import SITE_HIDDEN
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding
from ..module.layers import float32_cudnn, seeded_dropout


class CaserQueryEncoder(nn.Module):
    def __init__(self, fuid: str, fiid: str, num_users: int, num_items: int, embed_dim: int,
                 max_seq_len: int, n_v: int, n_h: int, dropout: float = 0.2):
        super().__init__()
        self.fuid, self.fiid, self.max_seq_len, self.dropout = fuid, fiid, max_seq_len, dropout
        self.user_embedding = Embedding(num_users, embed_dim)
        self.item_embedding = Embedding(num_items, embed_dim)
        self.vertical_kernel = nn.Parameter(torch.zeros(n_v, max_seq_len))
        self.vertical_bias = nn.Parameter(torch.zeros(n_v))
        # each horizontal kernel takes flax's xavier normal, which the JAX
        # rule by name leaves (the vertical kernel takes train.init_method)
        self.raw_init = {}
        for h in range(1, max_seq_len + 1):
            self.register_parameter(f"horizontal_kernel_{h}",
                                    nn.Parameter(torch.zeros(n_h, embed_dim, h)))
            self.register_parameter(f"horizontal_bias_{h}", nn.Parameter(torch.zeros(n_h)))
            self.raw_init[f"horizontal_kernel_{h}"] = "xavier_normal_conv1d"
        self.fc = nn.Linear(n_v * embed_dim + n_h * max_seq_len, embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        p_u = self.user_embedding(batch[self.fuid])
        seq = batch["in_" + self.fiid]
        L = self.max_seq_len
        if seq.shape[1] < L:
            seq = F.pad(seq, (0, L - seq.shape[1]))
        E = self.item_embedding(seq)                                        # [B, L, D]
        o_v = torch.einsum("bld,vl->bvd", E, self.vertical_kernel) \
            + self.vertical_bias[None, :, None]
        Et = E.transpose(1, 2)                                              # [B, D, L]
        o_h = [torch.relu(float32_cudnn(F.conv1d, Et, getattr(self, f"horizontal_kernel_{h}"),
                                        getattr(self, f"horizontal_bias_{h}"))).amax(dim=2)
               for h in range(1, L + 1)]
        o = torch.cat([o_v.reshape(E.shape[0], -1)] + o_h, dim=1)
        o = seeded_dropout(o, self.dropout, self.training, rng, SITE_HIDDEN)
        return torch.cat([torch.relu(self.fc(o)), p_u], dim=1)


class Caser(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim * 2)

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return CaserQueryEncoder(self.fuid, self.fiid, train_data.num_users,
                                 train_data.num_items, self.embed_dim,
                                 train_data.config["max_seq_len"], mc["n_v"], mc["n_h"],
                                 mc["dropout"])

    def _get_loss_func(self):
        return BPRLoss()
