"""PDA: popularity-bias deconfounded training.

Counterpart of ``recstudio_tpu/models/debias/pda.py``: BPR's towers and
uniform negatives; in training every score becomes ``(elu(s) + 1) *
pop ^ pda_gamma``, ``pop`` the item's ``item_freq`` over the largest
(counts clamped to at least 1), on the positive and on each sampled
negative id, under the BPR loss. Evaluation and serving rank by the
plain inner product.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding
from ..scorer import InnerProductScorer


class PDA(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return Embedding(train_data.num_users, self.embed_dim)

    def _get_score_func(self):
        return InnerProductScorer()

    def _get_loss_func(self):
        return BPRLoss()

    def _init_model(self, train_data):
        super()._init_model(train_data)
        gamma = float(self.config["model"].get("pda_gamma", 0.1))
        freq = np.maximum(train_data.item_freq.astype(np.float64), 1.0)
        self._pop_weight = torch.from_numpy(
            ((freq / freq.max()) ** gamma).astype(np.float32)).to(self.device)

    def _sparse_rows_enabled(self) -> bool:
        return False                       # the row-sparse step computes plain BPR

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``pda.py:45-53``."""
        s = self.forward(batch, return_neg_id=True)
        pos = (F.elu(s["pos_score"]) + 1.0) * self._pop_weight[batch[self.fiid].long()]
        neg = (F.elu(s["neg_score"]) + 1.0) * self._pop_weight[s["neg_id"].long()]
        return -torch.mean(F.logsigmoid(pos[..., None] - neg))
