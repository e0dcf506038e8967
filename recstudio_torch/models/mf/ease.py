"""EASE: a closed-form ridge regression of the interaction matrix on itself.

Counterpart of ``recstudio_tpu/models/mf/ease.py``: no net and no
optimizer. Its one training epoch densifies the split's interaction
matrix ``R [U, N]`` (``get_graph(0, "csr")``), solves ``G = RᵀR + λI``,
``P = G⁻¹``, ``B = P / -diag(P)`` with a zero diagonal, all in float32 on
the model's device (``torch.linalg.inv``, as ``jnp.linalg.inv``), keeps
``R`` and ``B`` in ``states`` (the model's weights, ``_state_weights``)
and returns the residual ``‖R - RB‖``. A user's scores are
``R[user] @ B[:, 1:]``, the history masked as every retriever's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from .recommender_helpers import init_linear_retriever


class EASE(BaseRetriever):

    _state_weights = ("R", "B")

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _init_model(self, train_data):
        init_linear_retriever(self, train_data)

    def _init_parameter(self, train_data=None):
        self.states.clear()

    def _get_optimizers(self):
        return None

    def _get_loss_func(self):
        return None

    def _get_sampler(self, train_data):
        return None

    def _epoch_refresh(self, nepoch: int):
        pass

    def _get_train_loaders(self, train_data):
        return {"user_item_matrix": train_data.get_graph(0, "csr")}

    def _interaction_matrix(self) -> torch.Tensor:
        """The split's ``R``, dense float32 on the model's device."""
        return self.trainloaders["user_item_matrix"].to_dense().to(self.device)

    def training_epoch(self, nepoch: int) -> float:
        R = self._interaction_matrix()
        B, resid = self.solve(R)
        self.states["R"] = R
        self.states["B"] = B
        return float(resid)

    def solve(self, R: torch.Tensor):
        """``(B, ‖R - RB‖)`` for the interaction matrix ``R``
        (``ease.py:60-68``)."""
        G = R.t() @ R
        G = G + float(self.config["train"]["lambda"]) * torch.eye(
            G.shape[0], dtype=G.dtype, device=G.device)
        P = torch.linalg.inv(G)
        B = P / (-torch.diagonal(P))[None, :]
        B = B - torch.diag(torch.diagonal(B))
        return B, torch.linalg.vector_norm(R - R @ B)

    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int,
             user_hist: Optional[torch.Tensor] = None, return_query: bool = False):
        query = self.states["R"][batch[self.fuid].long()]          # [B, N]
        scores = query @ self.states["B"][:, 1:]                    # [B, N - 1]
        score_k, topk_items = self._topk_from_scores(scores, k, user_hist)
        if return_query:
            return score_k, topk_items, query
        return score_k, topk_items
