"""Exact top-k over a ``[B, N]`` score matrix.

Counterpart of ``recstudio_tpu/ops/topk.py`` (``jax.lax.top_k`` there; it
is not a Pallas kernel). Values come sorted in descending order, equal
values in the order of their columns, lower first, as ``jax.lax.top_k``
orders them: two calls with different k list the items both hold in one
order (a served top-20 and evaluation's top-100 rank a tie alike). Which
of several equal values at the k-th place is kept is ``torch.topk``'s
choice, so comparisons with the JAX package stay tie-aware.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.topk(scores, k, dim=-1, largest=True, sorted=True)
    by_col = torch.argsort(idx, dim=-1)
    vals, idx = vals.gather(-1, by_col), idx.gather(-1, by_col)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)
