"""ItemKNN: each item scored by its most similar items' interactions.

Counterpart of ``recstudio_tpu/models/mf/itemknn.py``: EASE's engine with
another closed form. ``S`` is the item-item cosine similarity (``+1e-6``
on the product of the norms) or Jaccard similarity (``+1e-6`` in its
denominator) of the split's interaction matrix with a zero diagonal;
each column keeps the entries at least its ``knn``-th largest value (so
a tie at that place keeps every tied entry) and ``B`` is the pruned
``S`` with a zero diagonal. Another ``train.similarity`` raises.
"""
from __future__ import annotations

import torch

from .ease import EASE

SIMILARITIES = ("cosine", "jaccard")


class ItemKNN(EASE):

    def _init_model(self, train_data):
        super()._init_model(train_data)
        sim = self.config["train"].get("similarity", "cosine")
        if sim not in SIMILARITIES:
            raise ValueError(f"train.similarity must be one of {SIMILARITIES}, not {sim!r}")

    def training_epoch(self, nepoch: int) -> float:
        R = self._interaction_matrix()
        self.states["R"] = R
        self.states["B"] = self.solve(R)
        return 0.0

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """``B`` for the interaction matrix ``R`` (``itemknn.py:24-42``)."""
        cfg = self.config["train"]
        G = R.t() @ R
        G = G - torch.diag(torch.diagonal(G))
        if cfg.get("similarity", "cosine") == "cosine":
            norm = torch.sqrt(torch.sum(R * R, dim=0))
            S = G / (norm[:, None] * norm[None, :] + 1e-6)
        else:
            nz = (R > 0).sum(0).to(torch.float32)
            S = G / (nz[:, None] + nz[None, :] - G + 1e-6)
        k = min(int(cfg["knn"]), S.shape[0])
        thresh = torch.topk(S.t(), k, dim=-1).values[:, -1]       # each column's k-th value
        B = torch.where(S >= thresh[None, :], S, torch.zeros((), dtype=S.dtype, device=S.device))
        return B - torch.diag(torch.diagonal(B))
