"""SLIM: a sparse linear item model, every column's elastic net at once.

Counterpart of ``recstudio_tpu/models/mf/slim.py``: EASE's engine with
``train.max_iter`` proximal-gradient (ISTA) steps on ``G = RᵀR / n``
(``n`` users), step ``1 / (max row-sum |G| + l2)``, soft-thresholding at
``step * l1``, clipping at 0 with ``positive_only`` and a zero diagonal,
where ``l1 = alpha * l1_ratio`` and ``l2 = alpha * (1 - l1_ratio)``. The
config's ``train.knn`` is read by no code, as in the JAX package.
"""
from __future__ import annotations

import torch

from .ease import EASE


class SLIM(EASE):

    def training_epoch(self, nepoch: int) -> float:
        R = self._interaction_matrix()
        self.states["R"] = R
        self.states["B"] = self.solve(R)
        return 0.0

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """``B`` for the interaction matrix ``R`` (``slim.py:24-49``)."""
        cfg = self.config["train"]
        alpha = float(cfg.get("alpha", 1.0))
        l1_ratio = float(cfg.get("l1_ratio", 0.1))
        positive_only = bool(cfg.get("positive_only", True))
        G = (R.t() @ R) / R.shape[0]
        l1, l2 = alpha * l1_ratio, alpha * (1.0 - l1_ratio)
        eta = 1.0 / (torch.max(torch.sum(torch.abs(G), dim=1)) + l2)
        eye = torch.eye(G.shape[0], dtype=torch.bool, device=G.device)
        zero = torch.zeros((), dtype=G.dtype, device=G.device)
        B = torch.zeros_like(G)
        for _ in range(int(cfg.get("max_iter", 200))):
            grad = G @ B - G + l2 * B
            B = B - eta * grad
            B = torch.sign(B) * torch.clamp_min(torch.abs(B) - eta * l1, 0.0)
            if positive_only:
                B = torch.clamp_min(B, 0.0)
            B = torch.where(eye, zero, B)
        return B
