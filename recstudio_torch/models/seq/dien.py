"""DIEN: deep interest evolution network, a sequence-aware CTR ranker.

Counterpart of ``recstudio_tpu/models/seq/dien.py``: a ``GRULayer``
interest extractor over the history (cuDNN in float32 on the card), the
target projected to the hidden width (``target_proj``), the target's
scaled dot-product attention over the interests (a softmax with the pads
at ``finfo(float32).min``, then 0 there), an ``AUGRU`` interest evolution
gated by those weights (``models/module/gru.py``, a PyTorch time loop),
whose last state joins the projected target in ``fc_mlp``, then ``fc``
and the item bias.
"""
import math
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseranker import BaseRanker
from ..module import Embedding, GRULayer, MLPModule
from ..module.gru import AUGRU


class DIENNet(nn.Module):
    def __init__(self, fiid: str, num_items: int, embed_dim: int, hidden_size: int, fc_mlp,
                 activation: str = "sigmoid", dropout: float = 0.0):
        super().__init__()
        self.fiid, self.hidden_size = fiid, hidden_size
        self.item_embedding = Embedding(num_items, embed_dim)
        self.item_bias = Embedding(num_items, 1)
        self.extractor = GRULayer(embed_dim, hidden_size)
        self.target_proj = nn.Linear(embed_dim, hidden_size)
        self.evolution = AUGRU(hidden_size, hidden_size)
        self.fc_mlp = MLPModule([3 * hidden_size, *fc_mlp], activation, dropout)
        self.fc = nn.Linear(fc_mlp[-1], 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hist = batch["in_" + self.fiid]                                  # [B, L]
        seq_emb = self.item_embedding(hist)
        target = self.item_embedding(batch[self.fiid])
        bias = self.item_bias(batch[self.fiid]).squeeze(-1)
        pad = hist == 0
        interests = self.extractor(seq_emb, rng)                         # [B, L, H]
        t_proj = self.target_proj(target)
        logits = (interests * t_proj[:, None, :]).sum(-1) / math.sqrt(self.hidden_size)
        logits = logits.masked_fill(pad, torch.finfo(torch.float32).min)
        att = torch.softmax(logits, dim=-1).masked_fill(pad, 0.0)
        _, final = self.evolution(interests, att)
        h = self.fc_mlp(torch.cat([final, t_proj, final * t_proj], dim=-1), rng)
        return self.fc(h).squeeze(-1) + bias


class DIEN(BaseRanker):

    def _set_data_field(self, data):
        pass  # keep the dataset's default fields, as DIN

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DIENNet(self.fiid, train_data.num_items, self.embed_dim,
                       int(mc.get("hidden_size", self.embed_dim)), mc["fc_mlp"],
                       mc.get("activation", "sigmoid"), mc.get("dropout", 0.0))
