"""SASRec: self-attentive sequential recommendation.

Counterpart of ``recstudio_tpu/models/seq/sasrec.py``: a causal
transformer over the item-embedding sequence plus learned positions,
pooled at the last position, scored by inner product against the shared
item table.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..module import SeqPoolingLayer, TransformerEncoder


class SASRecQueryEncoder(nn.Module):
    def __init__(self, fiid: str, embed_dim: int, max_seq_len: int, n_head: int,
                 hidden_size: int, dropout: float, activation: str, layer_norm_eps: float,
                 n_layer: int, item_encoder: nn.Module, bidirectional: bool = False,
                 eval_pooling_type: str = "last"):
        super().__init__()
        self.fiid = fiid
        self.max_seq_len = max_seq_len
        self.bidirectional = bidirectional
        self.item_encoder = item_encoder
        self.pos_emb_table = nn.Parameter(torch.zeros(max_seq_len, embed_dim))
        self.transformer = TransformerEncoder(n_layer, embed_dim, n_head, hidden_size,
                                              dropout, activation, layer_norm_eps)
        self.pooling = SeqPoolingLayer(eval_pooling_type)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        hist = batch["in_" + self.fiid]                       # [B, L]
        L = hist.shape[1]
        x = self.item_encoder(hist) + self.pos_emb_table[:L][None]
        pad_mask = hist == 0
        attn_mask = None if self.bidirectional else torch.triu(
            torch.ones((L, L), dtype=torch.bool, device=hist.device), 1)
        out = self.transformer(x, key_padding_mask=pad_mask, attn_mask=attn_mask)
        return self.pooling(out, batch["seqlen"])


class SASRec(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return SASRecQueryEncoder(
            fiid=self.fiid, embed_dim=self.embed_dim,
            max_seq_len=train_data.config["max_seq_len"], n_head=mc["head_num"],
            hidden_size=mc["hidden_size"], dropout=mc["dropout_rate"],
            activation=mc["activation"], layer_norm_eps=float(mc["layer_norm_eps"]),
            n_layer=mc["layer_num"], item_encoder=self.item_encoder)
