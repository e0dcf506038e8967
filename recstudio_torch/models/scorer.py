"""Score functions between query and item representations.

Counterpart of ``InnerProductScorer`` in ``recstudio_tpu/models/scorer.py``.
The JAX scorer decides from the shapes whether ``items`` is the catalog
(``_is_catalog``, ``scorer.py:16-18``), which misreads a batch whose size
equals the catalog's. Here catalog scoring is its own method, called
explicitly by ``BaseRetriever.topk``.
"""
from __future__ import annotations

import torch


class InnerProductScorer:
    def __call__(self, query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Pairwise: ``(B, D) x (B, D) -> [B]``, ``(..., D) x (..., neg, D) -> [..., neg]``."""
        if query.dim() < items.dim():
            return torch.einsum("...d,...nd->...n", query, items)
        return (query * items).sum(-1)

    def catalog(self, query: torch.Tensor, item_vectors: torch.Tensor) -> torch.Tensor:
        """``(B, D) x (N, D) -> [B, N]``: every query against every item."""
        return torch.matmul(query, item_vectors.t())
