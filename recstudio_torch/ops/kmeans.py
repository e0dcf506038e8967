"""On-device k-means for the model-based samplers (MIDX, cluster).

Counterpart of ``recstudio_tpu/ops/kmeans.py``: a fixed number of
iterations, squared distances through the product identity, per-cluster
sums and counts, empty clusters reseeded from random rows each round, and
the final assignment recomputed from the last centres. The sums take the
rows sorted by cluster through one ordered ``segment_reduce``
(``segment_sums``; the JAX package's is a one-hot product): the order of
every addition is fixed, so a run repeats bit for bit. The random parts
(the initial rows, a random permutation's first ``k``, and each round's
reseed rows) come from a ``torch.Generator`` or are passed in, so a test
can start the port and the JAX package from the same rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums of the rows of ``x`` and the clusters' counts,
    ``([k, ...], [k] int64)``, in the order of a stable sort by cluster
    (an empty cluster sums to 0)."""
    order, indptr = construct_index(assign, k)
    counts = indptr[1:] - indptr[:-1]
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0), counts


def _assign(x: torch.Tensor, x_sq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = x_sq - 2.0 * (x @ c.t()) + (c * c).sum(-1)[None, :]
    return torch.argmin(d, dim=-1)


def kmeans(x: torch.Tensor, k: int, max_iter: int = 30,
           generator: Optional[torch.Generator] = None,
           init_idx: Optional[torch.Tensor] = None,
           reseed_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster ``x [N, D]`` into ``k`` centres (``kmeans.py:18-51``).

    Returns ``(centers [k, D], assign [N])``. ``init_idx`` and
    ``reseed_idx`` are drawn from ``generator`` unless given."""
    n = x.shape[0]
    if init_idx is None or reseed_idx is None:
        init_idx = torch.randperm(n, generator=generator, device=x.device)[:k]
        reseed_idx = torch.randint(0, n, (max_iter, k), generator=generator, device=x.device)
    init_idx, reseed_idx = init_idx.to(x.device).long(), reseed_idx.to(x.device).long()
    centers = x[init_idx]
    x_sq = (x * x).sum(-1, keepdim=True)
    for i in range(max_iter):
        assign = _assign(x, x_sq, centers)
        sums, counts = segment_sums(x, assign, k)
        counts = counts.to(x.dtype)
        new_centers = sums / torch.clamp_min(counts, 1.0)[:, None]
        empty = counts < 0.5
        centers = torch.where(empty[:, None], x[reseed_idx[i]], new_centers)
    return centers, _assign(x, x_sq, centers)


def construct_index(assign: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR inverted index (``kmeans.py:54-63``): the row ids sorted by
    cluster, stably, and the clusters' offsets. Returns ``(indices [N]
    int64, indptr [k + 1] int64)``."""
    order = torch.argsort(assign, stable=True)
    # each cluster's first place in the sorted assignment (no atomics)
    bounds = torch.arange(k + 1, device=assign.device, dtype=assign.dtype)
    indptr = torch.searchsorted(assign[order].contiguous(), bounds)
    return order, indptr
