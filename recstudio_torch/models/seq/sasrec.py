"""SASRec: self-attentive sequential recommendation.

Counterpart of ``recstudio_tpu/models/seq/sasrec.py``: a causal
transformer over the item-embedding sequence plus learned positions,
pooled at the last position, scored by inner product against the shared
item table. ``SASRecQueryEncoder`` is shared with BERT4Rec
(``bidirectional=True``, no attention mask; training pooling ``"mask"``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ...ops.dropout import SITE_INPUT, draw_seed, keep_scale
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BinaryCrossEntropyLoss
from ..module import SeqPoolingLayer, TransformerEncoder


class SASRecQueryEncoder(nn.Module):
    def __init__(self, fiid: str, embed_dim: int, max_seq_len: int, n_head: int,
                 hidden_size: int, dropout: float, activation: str, layer_norm_eps: float,
                 n_layer: int, item_encoder: nn.Module, bidirectional: bool = False,
                 training_pooling_type: str = "last", eval_pooling_type: str = "last"):
        super().__init__()
        self.fiid = fiid
        self.max_seq_len = max_seq_len
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.item_encoder = item_encoder
        self.pos_emb_table = nn.Parameter(torch.zeros(max_seq_len, embed_dim))
        self.transformer = TransformerEncoder(n_layer, embed_dim, n_head, hidden_size,
                                              dropout, activation, layer_norm_eps)
        self.training_pooling = _pooling(training_pooling_type)
        self.pooling = _pooling(eval_pooling_type)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Query vectors ``[B, D]``, or ``[B, L, D]`` under pooling ``"mask"``
        or ``"origin"`` (every position, ``sasrec.py:58-66``). In training
        mode the embedded sequence
        and every layer drop at ``dropout`` (``sasrec.py:50-51``), with seeds
        drawn from ``rng``."""
        hist = batch["in_" + self.fiid]                       # [B, L]
        L = hist.shape[1]
        x = self.item_encoder(hist) + self.pos_emb_table[:L][None]
        if self.training and self.dropout > 0:
            x = x * keep_scale(x.shape, self.dropout, draw_seed(rng), SITE_INPUT, x.device)
        pad_mask = hist == 0
        attn_mask = None if self.bidirectional else torch.triu(
            torch.ones((L, L), dtype=torch.bool, device=hist.device), 1)
        out = self.transformer(x, key_padding_mask=pad_mask, attn_mask=attn_mask, rng=rng)
        pooling = self.training_pooling if self.training else self.pooling
        return out if pooling is None else pooling(out, batch["seqlen"])


def _pooling(pooling_type: str) -> Optional[SeqPoolingLayer]:
    """``None`` for the types that keep every position."""
    return None if pooling_type in ("mask", "origin") else SeqPoolingLayer(pooling_type)


class SASRec(BaseRetriever):
    # the query encoder's pooling in training: the last true position
    # (CL4SRec's family trains on every position, "origin")
    _training_pooling = "last"

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
            n_layer=mc["layer_num"], item_encoder=self.item_encoder,
            training_pooling_type=self._training_pooling)

    def _get_loss_func(self):
        return BinaryCrossEntropyLoss()
