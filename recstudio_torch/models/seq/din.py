"""DIN: deep interest network, a sequence-aware CTR ranker.

Counterpart of ``recstudio_tpu/models/seq/din.py``. The activation unit
(``AttentionLayer(3d, d, attention_mlp, activation="dice")`` in its
feedforward mode) scores each history item from ``[t, t s, t - s]`` of the
target t and the item s, with padded items weighted 0 and no softmax; the
weighted sum of the history goes through ``norm_bn`` (with
``batch_norm``), ``norm_fc``, then joins the target in the ``dense_mlp``
(Dice, batch norm, dropout), ``fc`` and the item bias. The JAX unit calls
its MLP with ``training=False``: its Dice batch norms normalize with their
calibrated statistics (the batch's before any calibration) in training
too, so the unit's MLP stays in eval mode here (``train``). All batch
norms are calibrated by ``_calibration_forward``.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import SeqDataset
from ..basemodel.baseranker import BaseRanker
from ..module import AttentionLayer, Embedding, MLPModule
from ..module.layers import SimpleBatchNorm


class DINNet(nn.Module):
    def __init__(self, fiid: str, num_items: int, embed_dim: int, attention_mlp, fc_mlp,
                 activation: str = "dice", dropout: float = 0.0, batch_norm: bool = False):
        super().__init__()
        d = embed_dim
        self.fiid = fiid
        self.item_embedding = Embedding(num_items, d)
        self.item_bias = Embedding(num_items, 1)
        self.activation_unit = AttentionLayer(3 * d, d, mlp_layers=attention_mlp,
                                              activation=activation)
        self.norm_bn = SimpleBatchNorm(d) if batch_norm else None
        self.norm_fc = nn.Linear(d, d)
        self.dense_mlp = MLPModule([3 * d, *fc_mlp], activation, dropout, batch_norm=batch_norm)
        self.fc = nn.Linear(fc_mlp[-1], 1)

    def train(self, mode: bool = True) -> "DINNet":
        super().train(mode)
        self.activation_unit.mlp.eval()        # the JAX unit's MLP runs with training=False
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hist = batch["in_" + self.fiid]
        seq_emb = self.item_embedding(hist)                              # [B, L, D]
        target = self.item_embedding(batch[self.fiid])                   # [B, D]
        bias = self.item_bias(batch[self.fiid]).squeeze(-1)
        t = target[:, None, :].expand_as(seq_emb)
        key = torch.cat([t, t * seq_emb, t - seq_emb], dim=-1)
        attn_seq = self.activation_unit(target[:, None, :], key, seq_emb,
                                        key_padding_mask=hist == 0, softmax=False).squeeze(1)
        if self.norm_bn is not None:
            attn_seq = self.norm_bn(attn_seq)
        attn_seq = self.norm_fc(attn_seq)
        h = self.dense_mlp(torch.cat([attn_seq, target, target * attn_seq], dim=-1), rng)
        return self.fc(h).squeeze(-1) + bias


class DIN(BaseRanker):

    def _set_data_field(self, data):
        pass  # keep the dataset's default fields (din.py:56-57)

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DINNet(self.fiid, train_data.num_items, self.embed_dim, mc["attention_mlp"],
                      mc["fc_mlp"], mc["activation"], mc["dropout"], mc.get("batch_norm", False))
