"""Exact top-k over a ``[..., N]`` score matrix.

Counterpart of ``recstudio_tpu/ops/topk.py`` (``jax.lax.top_k`` there; it
is not a Pallas kernel). Values come sorted in descending order, equal
values in the order of their columns, lower first, and of several equal
values at the k-th place the lowest columns are kept, as
``jax.lax.top_k`` keeps them: the result is a function of the scores
alone, so two calls with different k list the items both hold in one
order and pick the same ones at a tie (a served top-20 and evaluation's
top-100 agree even where many items score exactly alike, as ItemKNN's
pruned neighbourhoods leave them at 0).
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    kth = torch.topk(scores, k, dim=-1, largest=True, sorted=True).values[..., -1:]
    above = scores > kth
    tie = scores == kth
    need = k - above.sum(-1, keepdim=True)
    # every column above the k-th value, and the lowest of those equal to it
    keep = above | (tie & (torch.cumsum(tie.to(torch.int32), -1) <= need))
    slot = torch.where(keep, torch.cumsum(keep.to(torch.int32), -1) - 1, k)
    cols = torch.arange(scores.shape[-1], device=scores.device).expand(scores.shape)
    idx = torch.zeros(*scores.shape[:-1], k + 1, dtype=torch.long, device=scores.device)
    idx = idx.scatter_(-1, slot.long(), cols)[..., :k]     # kept columns, ascending
    vals = scores.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)
