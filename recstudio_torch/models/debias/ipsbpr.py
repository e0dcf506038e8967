"""IPS-BPR: BPR with each positive weighted by its inverse propensity.

Counterpart of ``recstudio_tpu/models/debias/ipsbpr.py``: BPR's towers
and uniform negatives; a positive item's weight is ``min((freq /
max_freq) ^ -ips_gamma, ips_clip)`` from the split's ``item_freq``
(counts clamped to at least 1), and the loss is the self-normalized
weighted BPR, ``sum(w * per_pair) / max(sum(w), 1e-8)``.
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


class IPSBPR(BaseRetriever):

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
        gamma = float(self.config["model"].get("ips_gamma", 0.5))
        clip = float(self.config["model"].get("ips_clip", 100.0))
        freq = np.maximum(train_data.item_freq.astype(np.float64), 1.0)
        propensity = (freq / freq.max()) ** gamma
        self._ips_weight = torch.from_numpy(
            np.minimum(1.0 / propensity, clip).astype(np.float32)).to(self.device)

    def _sparse_rows_enabled(self) -> bool:
        return False                       # the row-sparse step computes plain BPR

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``ipsbpr.py:49-57``."""
        s = self.forward(batch)
        w = self._ips_weight[batch[self.fiid].long()]                   # [B]
        per_pair = -F.logsigmoid(s["pos_score"][..., None] - s["neg_score"]).mean(-1)
        return (w * per_pair).sum() / torch.clamp_min(w.sum(), 1e-8)
