"""STAMP: short-term attention/memory priority model.

Counterpart of ``recstudio_tpu/models/seq/stamp.py``: the last true item's
embedding ``m_t`` and the sequence's mean ``m_s`` (the sum over every
position, the ``[PAD]`` row being 0, over ``max(seqlen, 1)``); the
feedforward attention of ``[m_t, m_s]`` over the embedded sequence
(padded positions weighted 0) gives ``m_a``; the query is ``tanh(A m_a +
a) o tanh(B m_t + b)``. Scored by inner product against the shared item
table and trained with the full-catalog ``SoftmaxLoss`` through
``_fused_softmax_step`` (K7, K8, K9 on the card) unless
``train.fused_softmax`` is ``false``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SoftmaxLoss
from ..module import AttentionLayer, MLPModule, SeqPoolingLayer


class STAMPQueryEncoder(nn.Module):
    def __init__(self, fiid: str, embed_dim: int, item_encoder: nn.Module):
        super().__init__()
        self.fiid = fiid
        self.item_encoder = item_encoder
        self.pooling = SeqPoolingLayer("last")
        self.attn = AttentionLayer(q_dim=2 * embed_dim, k_dim=embed_dim, mlp_layers=[embed_dim])
        self.mlpA = MLPModule([embed_dim, embed_dim], activation_func="tanh")
        self.mlpB = MLPModule([embed_dim, embed_dim], activation_func="tanh")

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hist, seqlen = batch["in_" + self.fiid], batch["seqlen"]
        seq_emb = self.item_encoder(hist)
        m_t = self.pooling(seq_emb, seqlen)
        m_s = seq_emb.sum(1) / torch.clamp_min(seqlen, 1)[:, None].to(seq_emb.dtype)
        query = torch.cat([m_t, m_s], dim=-1)
        m_a = self.attn(query[:, None, :], seq_emb, seq_emb,
                        key_padding_mask=hist == 0).squeeze(1)
        return self.mlpA(m_a) * self.mlpB(m_t)


class STAMP(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        return STAMPQueryEncoder(self.fiid, self.embed_dim, self.item_encoder)

    def _get_loss_func(self):
        return SoftmaxLoss()

    def _get_sampler(self, train_data):
        return None
