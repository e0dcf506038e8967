"""Lazy Adam (``learner: sparse_adam``), dense and row-sparse; optax's
Adagrad and RMSprop (``learner: adagrad``, ``rmsprop``).

Counterpart of ``recstudio_tpu/models/optim.py:32-221``. Adam's moments are
updated only for the rows a step touches: a row (a slice along the first
dimension) is touched when its gradient has a nonzero entry. An untouched
row keeps its moments and takes no step. The step count is global, and the
bias correction uses it for every row. For a dense layer every row is
touched each step, and lazy Adam is Adam there.

This is not ``torch.optim.SparseAdam``: that one updates every row present
in a sparse gradient, rows whose gradient is exactly zero included, and
needs ``sparse=True`` embeddings.

- ``LazyAdam``: the optimizer over dense gradients (``lazy_adam``);
- ``row_lazy_adam``: the same update applied to the touched rows alone,
  from per-lookup row gradients with duplicate ids (``row_lazy_adam``),
  which the row-sparse step of ``BaseRetriever`` calls;
- ``fused_table_lazy_adam_packed``: the same update on a ranker's fused
  token table packed as ``[N, 3D]`` rows of (params | mu | nu), from the
  per-lookup gradients of its ``[B, T]`` offset ids: one gather of the
  candidate rows and one write back (``BaseRanker``'s packed row-sparse
  CTR step).

All compute in the JAX package's order of operations, so one step of
either agrees with the others to float32 rounding.

``OptaxAdagrad`` and ``OptaxRMSprop`` are ``optax.adagrad(lr)`` and
``optax.rmsprop(lr)`` of optax 0.2.6, whose defaults are not
``torch.optim``'s: Adagrad's accumulator starts at 0.1 and its step is
``g / sqrt(sum + 1e-7)`` (0 where the sum is 0); RMSprop decays by 0.9
from a scale of 0 and its step is ``g / sqrt(nu + 1e-8)``.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``1 - b ** count`` for both moments, in float32 as the JAX package
    computes them."""
    cf = np.float32(count)
    return (float(np.float32(1.0) - np.float32(b1) ** cf),
            float(np.float32(1.0) - np.float32(b2) ** cf))


def lazy_update_(param: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, bc1: float, bc2: float, lr: float,
                 b1: float, b2: float, eps: float) -> None:
    """One lazy-Adam update of a whole tensor, in place
    (``lazy_update_leaf``)."""
    if grad.dim() <= 1:
        touched = (grad.abs() > 0).to(grad.dtype)
    else:
        touched = (grad.abs() > 0).flatten(1).any(1).to(grad.dtype) \
            .reshape((-1,) + (1,) * (grad.dim() - 1))
    mu.add_(touched * ((1.0 - b1) * (grad - mu)))
    nu.add_(touched * ((1.0 - b2) * (grad * grad - nu)))
    param.add_((-lr * touched) * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))


class LazyAdam(torch.optim.Optimizer):
    """``lazy_adam`` as a ``torch.optim.Optimizer``. The state of each
    parameter holds ``mu`` and ``nu``; the global step count is
    ``param_groups[i]["count"]``, advanced once a step for every group, so
    it travels with ``state_dict``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, count=0))

    def moments(self, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mu, nu)`` of ``p``, zeros at first use."""
        state = self.state[p]
        if "mu" not in state:
            state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state["mu"], state["nu"]

    def advance(self) -> int:
        """Advance the global step count; returns the new count."""
        for group in self.param_groups:
            group["count"] += 1
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        count = self.advance()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            bc1, bc2 = bias_corrections(count, b1, b2)
            for p in group["params"]:
                if p.grad is None:
                    continue
                mu, nu = self.moments(p)
                lazy_update_(p, p.grad, mu, nu, bc1, bc2, group["lr"], b1, b2, group["eps"])
        return loss


def segment_rows(ids: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the rows of ``g [K, D]`` that share an id of ``ids [K]``, in
    sorted-id order (``argsort`` + ``segment_sum``). Returns ``(seg_ids [K],
    agg [K, D])``: slot s holds the s-th distinct id and its summed row;
    the slots past the number of distinct ids hold id 0 and a zero row.
    Each sum runs over its rows in order (``torch.segment_reduce``), with
    no atomic additions, so the result repeats bit for bit."""
    K = ids.shape[0]
    sid, order = torch.sort(ids, stable=True)
    sg = g[order]
    head = torch.ones(K, dtype=torch.bool, device=ids.device)
    head[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(head, 0) - 1                       # segment of each sorted slot
    slots = torch.arange(K, device=ids.device)
    starts = torch.searchsorted(seg, slots)
    lengths = torch.searchsorted(seg, slots, right=True) - starts
    agg = torch.segment_reduce(sg, "sum", lengths=lengths, axis=0, unsafe=True)
    live = slots < head.sum()
    seg_ids = torch.where(live, sid[starts.clamp_max(K - 1)], torch.zeros_like(sid))
    return seg_ids, agg


@torch.no_grad()
def row_lazy_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                  ids: torch.Tensor, g: torch.Tensor, count: int, lr: float,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Row-sparse lazy Adam, in place: the update ``LazyAdam`` makes, read
    and written for the touched rows alone (``optim.py:85-125``).

    ``ids [K]`` and ``g [K, D]`` are per-lookup row gradients, duplicates
    allowed: they are summed first (``segment_rows``), which is the dense
    gradient of the gather. Rows with id 0 ([PAD]) or an all-zero summed
    gradient are skipped, as ``zero_pad_rows_in_grads`` and the dense
    ``touched`` rule skip them. Every slot writes its row back; a skipped
    slot reads and writes row 0 unchanged, so the writes never disagree."""
    seg_ids, agg = segment_rows(ids, g)
    valid = (seg_ids > 0) & (agg.abs() > 0).any(-1)
    read = torch.where(valid, seg_ids, torch.zeros_like(seg_ids))
    p_r, mu_r, nu_r = table[read], mu[read], nu[read]
    bc1, bc2 = bias_corrections(count, b1, b2)
    mu2 = mu_r + (1.0 - b1) * (agg - mu_r)
    nu2 = nu_r + (1.0 - b2) * (agg * agg - nu_r)
    step = -lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    v = valid[:, None]
    table[read] = torch.where(v, p_r + step, p_r)
    mu[read] = torch.where(v, mu2, mu_r)
    nu[read] = torch.where(v, nu2, nu_r)


def _blocked_dedup(ids: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate lookups of pre-blocked ids ``ids [F, B]``, ``g [F, B,
    D]`` whose F blocks index disjoint id ranges (the fused token table's
    per-field offset slabs), so duplicates occur only inside a block
    (``optim.py:127-153``): each block is sorted on its own (one batched
    stable sort), and one segment sum runs over the blocks' sorted rows in
    order. Returns ``(ids [F*B], agg [F*B, D])``: slot s holds the s-th
    segment's id and summed row; the slots past the last segment hold id
    0 and a zero row, which callers treat as untouched."""
    F, B = ids.shape
    K, D = F * B, g.shape[-1]
    sid, order = torch.sort(ids, dim=-1, stable=True)
    sg = torch.gather(g, 1, order[..., None].expand(F, B, D)).reshape(K, D)
    head = torch.ones((F, B), dtype=torch.bool, device=ids.device)
    head[:, 1:] = sid[:, 1:] != sid[:, :-1]
    fh, sid = head.reshape(-1), sid.reshape(-1)
    seg = torch.cumsum(fh, 0) - 1                         # globally contiguous segments
    slots = torch.arange(K, device=ids.device)
    starts = torch.searchsorted(seg, slots)
    lengths = torch.searchsorted(seg, slots, right=True) - starts
    agg = torch.segment_reduce(sg, "sum", lengths=lengths, axis=0, unsafe=True)
    live = slots < fh.sum()
    return torch.where(live, sid[starts.clamp_max(K - 1)], torch.zeros_like(sid)), agg


def _fused_table_candidates(sizes: Sequence[int], ids2: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate update rows ``(ids [K], agg [K, D])`` of the per-lookup
    gradients ``g [B, T, D]`` at offset ids ``ids2 [B, T]`` of a fused
    table of ``sizes`` (``optim.py:156-182``). Every field goes through
    ``_blocked_dedup``: the JAX package sums the fields of at most 1024
    values by one-hot products instead, a device of the TPU's layout that
    gives the same sums up to float32 order."""
    if ids2.shape[-1] != len(sizes):
        raise ValueError(f"{ids2.shape[-1]} id columns for {len(sizes)} fields")
    return _blocked_dedup(ids2.t(), g.transpose(0, 1))


def unpack_table_params(packed: torch.Tensor) -> torch.Tensor:
    """The first D columns of a packed ``[N, 3D]`` buffer: the parameters."""
    return packed[:, :packed.shape[-1] // 3]


@torch.no_grad()
def fused_table_lazy_adam_packed(sizes: Sequence[int], packed: torch.Tensor,
                                 ids2: torch.Tensor, g: torch.Tensor, count: int, lr: float,
                                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """Lazy Adam on a packed ``[N, 3D]`` table of (params | mu | nu) rows,
    in place (``optim.py:190-221``): the per-lookup gradients ``g [B, T,
    D]`` at offset ids ``ids2 [B, T]`` are summed by id
    (``_fused_table_candidates``), then one gather reads the candidate rows
    and one write puts them back. Rows with id 0 and rows whose summed
    gradient is all zero are left untouched; the bias correction uses the
    global step ``count``. Every slot writes its row back; an untouched
    slot reads and writes row 0 unchanged, so the writes never disagree
    and the step repeats bit for bit."""
    D = g.shape[-1]
    ids, agg = _fused_table_candidates(sizes, ids2, g)
    valid = (ids > 0) & (agg.abs() > 0).any(-1)
    read = torch.where(valid, ids, torch.zeros_like(ids))
    rows = packed[read]                                     # [K, 3D]
    p_r, mu_r, nu_r = rows[:, :D], rows[:, D:2 * D], rows[:, 2 * D:]
    bc1, bc2 = bias_corrections(count, b1, b2)
    mu2 = mu_r + (1.0 - b1) * (agg - mu_r)
    nu2 = nu_r + (1.0 - b2) * (agg * agg - nu_r)
    step = -lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    packed[read] = torch.where(valid[:, None], torch.cat([p_r + step, mu2, nu2], dim=-1), rows)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)`` (``scale_by_rss(0.1, 1e-7)`` then ``-lr``):
    ``sum += g^2``, ``p += -lr * g * rsqrt(sum + eps)`` where ``sum > 0``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if "sum" not in state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad if p.grad is not None else torch.zeros_like(p)  # optax's zeros
                acc = state["sum"]
                acc.copy_(g * g + acc)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                  torch.zeros_like(acc))
                p.add_((inv * g) * (-group["lr"]))


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` (``scale_by_rms(0.9, 1e-8)`` then ``-lr``):
    ``nu = 0.1 g^2 + 0.9 nu`` from ``nu = 0``, ``p += -lr * g * rsqrt(nu +
    eps)``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, initial_scale=initial_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.full_like(p, group["initial_scale"])
                g = p.grad if p.grad is not None else torch.zeros_like(p)  # optax's zeros
                nu = state["nu"]
                nu.copy_((1.0 - group["decay"]) * (g * g) + group["decay"] * nu)
                p.add_((torch.rsqrt(nu + group["eps"]) * g) * (-group["lr"]))
