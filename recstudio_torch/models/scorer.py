"""Score functions between query and item representations.

Counterpart of ``recstudio_tpu/models/scorer.py``. A scorer called as
``scorer(query, items)`` scores pairs: ``(B, D) x (B, D) -> [B]``,
``(..., D) x (..., n, D) -> [..., n]``, ``(B, L, D) x (B, L, D) -> [B, L]``.
The JAX scorers decide from the shapes whether ``items`` is the catalog
(``_is_catalog``, ``scorer.py:16-18``), which misreads a batch whose size
equals the catalog's; here catalog scoring is its own method,
``scorer.catalog(query [B, D], items [N, D]) -> [B, N]``, called
explicitly by ``BaseRetriever``.

``InnerProductScorer``, ``CosineScorer``, ``EuclideanScorer`` and
``NormScorer`` have no parameters. ``MLPScorer``, ``GMFScorer`` and
``FusionMFMLPScorer`` (NCF's) are ``nn.Module``s: a two-tower net
registers the scorer as its ``score_func`` submodule, so their weights
train, checkpoint and convert with the towers'. Their catalog path
expands query and items to ``[B, N, .]`` (``_pairwise_expand``,
``scorer.py:58-67``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .module.layers import get_act


class InnerProductScorer:
    def __call__(self, query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Pairwise: ``(B, D) x (B, D) -> [B]``, ``(..., D) x (..., neg, D) -> [..., neg]``."""
        if query.dim() < items.dim():
            return torch.einsum("...d,...nd->...n", query, items)
        return (query * items).sum(-1)

    def catalog(self, query: torch.Tensor, item_vectors: torch.Tensor) -> torch.Tensor:
        """``(B, D) x (N, D) -> [B, N]``: every query against every item."""
        return torch.matmul(query, item_vectors.t())


class CosineScorer(InnerProductScorer):
    """The inner product over both norms (``scorer.py:29-35``)."""

    def __call__(self, query, items):
        out = super().__call__(query, items) / torch.linalg.vector_norm(items, dim=-1)
        qn = torch.linalg.vector_norm(query, dim=-1, keepdim=query.dim() < items.dim())
        return out / qn

    def catalog(self, query, item_vectors):
        out = super().catalog(query, item_vectors) / torch.linalg.vector_norm(item_vectors, dim=-1)
        return out / torch.linalg.vector_norm(query, dim=-1, keepdim=True)


class EuclideanScorer(InnerProductScorer):
    """The negated squared distance, ``-(|i|^2 - 2 q.i + |q|^2)``
    (``scorer.py:38-44``)."""

    def __call__(self, query, items):
        out = -2.0 * super().__call__(query, items)
        out = out + (items * items).sum(-1)
        out = out + (query * query).sum(-1, keepdim=query.dim() < items.dim())
        return -out

    def catalog(self, query, item_vectors):
        out = -2.0 * super().catalog(query, item_vectors)
        out = out + (item_vectors * item_vectors).sum(-1)
        out = out + (query * query).sum(-1, keepdim=True)
        return -out


class NormScorer(InnerProductScorer):
    """The negated ``p``-norm of the difference (``scorer.py:47-55``)."""

    def __init__(self, p: int = 2):
        self.p = p

    def __call__(self, query, items):
        if query.dim() < items.dim():
            query = query[..., None, :]
        return -torch.linalg.vector_norm(query - items, ord=self.p, dim=-1)

    def catalog(self, query, item_vectors):
        return -torch.linalg.vector_norm(query[:, None, :] - item_vectors[None, :, :],
                                         ord=self.p, dim=-1)


def _pairwise_expand(query: torch.Tensor, items: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``query`` broadcast to the rank of ``items`` (a pair's negatives)."""
    if query.dim() < items.dim():
        query = query[..., None, :].expand(items.shape[:-1] + query.shape[-1:])
    return query, items


def _catalog_expand(query: torch.Tensor, items: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, D] x [N, D]`` -> both ``[B, N, D]`` (``_pairwise_expand``'s
    catalog case)."""
    B, N = query.shape[0], items.shape[0]
    return (query[:, None, :].expand(B, N, query.shape[-1]),
            items[None, :, :].expand(B, N, items.shape[-1]))


class MLPScorer(nn.Module):
    """``transform(concat(query, item))`` (``scorer.py:70-78``);
    ``transform`` is an MLP ending in one unit."""

    def __init__(self, transform: nn.Module):
        super().__init__()
        self.transform = transform

    def _score(self, q, it):
        return self.transform(torch.cat([q, it], dim=-1)).squeeze(-1)

    def forward(self, query, items):
        return self._score(*_pairwise_expand(query, items))

    def catalog(self, query, item_vectors):
        return self._score(*_catalog_expand(query, item_vectors))


class GMFScorer(nn.Module):
    """``act(W (query * item))`` (``scorer.py:81-95``), ``W`` one unit."""

    def __init__(self, emb_dim: int, bias: bool = False, activation: str = "relu"):
        super().__init__()
        self.W = nn.Linear(emb_dim, 1, bias=bias)
        self.act = get_act(activation)

    def _score(self, q, k):
        return self.act(self.W(q * k)).squeeze(-1)

    def forward(self, query, key):
        if query.dim() < key.dim():
            query = query[..., None, :]
        return self._score(query, key)

    def catalog(self, query, item_vectors):
        return self._score(*_catalog_expand(query, item_vectors))


class FusionMFMLPScorer(nn.Module):
    """NCF's fusion, ``act(W [query * item ; mlp(query || item)])`` with no
    bias in ``W`` (``scorer.py:98-116``; its ``bias`` is unused there too)."""

    def __init__(self, emb_dim: int, hidden_size: int, mlp: nn.Module, bias: bool = False,
                 activation: str = "relu"):
        super().__init__()
        self.mlp = mlp
        self.W = nn.Linear(emb_dim + hidden_size, 1, bias=False)
        self.act = get_act(activation)

    def _score(self, q, k):
        h_mlp = self.mlp(torch.cat([q, k], dim=-1))
        return self.act(self.W(torch.cat([q * k, h_mlp], dim=-1)).squeeze(-1))

    def forward(self, query, key):
        return self._score(*_pairwise_expand(query, key))

    def catalog(self, query, item_vectors):
        return self._score(*_catalog_expand(query, item_vectors))
