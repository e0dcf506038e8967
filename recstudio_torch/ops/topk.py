"""Exact top-k over a ``[B, N]`` score matrix.

Counterpart of ``recstudio_tpu/ops/topk.py`` (``jax.lax.top_k`` there; it
is not a Pallas kernel). Values come sorted in descending order; the order
among equal scores is unspecified, so comparisons with the JAX package are
tie-aware.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)
