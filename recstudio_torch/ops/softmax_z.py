"""Full-catalog softmax partition function: ``logZ = logsumexp(q items^T)``.

Counterpart of ``recstudio_tpu/ops/softmax_z.py``, the hot op of every
full-softmax model (the SoftmaxLoss retrievers: BERT4Rec, MultiVAE,
MultiDAE, NARM, STAMP). ``catalog_logsumexp(query [M, D], items [N, D])
-> logZ [M]`` is a ``torch.autograd.Function``:

- forward: ``catalog_logsumexp_fwd`` (K7, replacing the Pallas
  ``_fwd_kernel``);
- backward, with ``P = exp(q items^T - logZ)`` recomputed from the saved
  logZ as ``_clse_bwd`` does: ``catalog_logsumexp_dq`` (K8, ``dq = g o
  (P items)``, replacing ``_bwd_dq_kernel``) and
  ``catalog_logsumexp_ditems`` (K9, ``ditems = P^T (g o q)``, replacing
  ``_bwd_ditems_kernel``).

Each of the three launches its hand-written kernel in
``csrc/softmax_z.cu`` on a CUDA tensor, or raises, and counts its launches
in ``<function>.launches``; on a CPU tensor it computes the same function
with its plain version (``catalog_logsumexp_plain``,
``catalog_logsumexp_dq_plain``, ``catalog_logsumexp_ditems_plain``), which
materialise the ``[M, N]`` scores as the JAX package's
``catalog_logsumexp_xla`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .attention import _check

MAX_DIM = 256   # widest accumulator tile of csrc/softmax_z.cu


def catalog_logsumexp_plain(query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (``catalog_logsumexp_xla``)."""
    return torch.logsumexp(query @ items.t(), dim=-1)


def _weighted_probs(query, items, logz, g) -> torch.Tensor:
    """``g_m P_mn`` as an ``[M, N]`` matrix."""
    return torch.exp(query @ items.t() - logz[:, None]) * g[:, None]


def catalog_logsumexp_dq_plain(query: torch.Tensor, items: torch.Tensor, logz: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: ``dq = (g o P) items``."""
    return _weighted_probs(query, items, logz, g) @ items


def catalog_logsumexp_ditems_plain(query: torch.Tensor, items: torch.Tensor,
                                   logz: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``ditems = (g o P)^T q``."""
    return _weighted_probs(query, items, logz, g).t() @ query


# ---------------------------------------------------------------------------
def _check_inputs(query, items, *rows) -> Tuple[int, int, int]:
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    if query.dim() != 2 or items.dim() != 2 or query.shape[1] != items.shape[1]:
        raise ValueError(f"expected query [M, D] and items [N, D], got {tuple(query.shape)} "
                         f"and {tuple(items.shape)}")
    (M, D), N = query.shape, items.shape[0]
    if D > MAX_DIM:
        raise ValueError(f"embedding width {D} > {MAX_DIM} is not supported by the "
                         "catalog log-partition kernels")
    if M == 0 or N == 0 or D == 0:
        raise ValueError(f"empty query or catalog: M={M}, N={N}, D={D}")
    dev = query.device
    _check(query, "query", (M, D), dev)
    _check(items, "items", (N, D), dev)
    for name, t in zip(("logz", "g"), rows):
        _check(t, name, (M,), dev)
    return M, N, D


def _workspace(lib, M: int, N: int, kind: int, per_split: int, dev) -> torch.Tensor:
    """The partial sums of the kernel's fixed ranges (empty with one range)."""
    splits = int(lib.lib.rs_catalog_lse_splits(M, N, kind))
    return torch.empty((splits * per_split if splits > 1 else 0,), dtype=torch.float32,
                       device=dev)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def catalog_logsumexp_fwd(query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """K7: ``logZ [M]`` of ``query [M, D]`` against ``items [N, D]``."""
    if query.device.type == "cpu":
        return catalog_logsumexp_plain(query, items)
    from . import _native
    M, N, D = _check_inputs(query, items)
    lib = _native.load()
    part = _workspace(lib, M, N, 0, 2 * M, query.device)
    logz = torch.empty((M,), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        lib.call("rs_catalog_lse_fwd", query.data_ptr(), items.data_ptr(), part.data_ptr(),
                 logz.data_ptr(), M, N, D, _stream(query.device))
    catalog_logsumexp_fwd.launches += 1
    return logz


def catalog_logsumexp_dq(query: torch.Tensor, items: torch.Tensor, logz: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """K8: ``dq [M, D] = g o (P items)``."""
    if query.device.type == "cpu":
        return catalog_logsumexp_dq_plain(query, items, logz, g)
    from . import _native
    M, N, D = _check_inputs(query, items, logz, g)
    lib = _native.load()
    part = _workspace(lib, M, N, 0, M * D, query.device)
    dq = torch.empty_like(query)
    with torch.cuda.device(query.device):
        lib.call("rs_catalog_lse_bwd_dq", query.data_ptr(), items.data_ptr(), logz.data_ptr(),
                 g.data_ptr(), part.data_ptr(), dq.data_ptr(), M, N, D, _stream(query.device))
    catalog_logsumexp_dq.launches += 1
    return dq


def catalog_logsumexp_ditems(query: torch.Tensor, items: torch.Tensor, logz: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """K9: ``ditems [N, D] = P^T (g o q)``."""
    if query.device.type == "cpu":
        return catalog_logsumexp_ditems_plain(query, items, logz, g)
    from . import _native
    M, N, D = _check_inputs(query, items, logz, g)
    lib = _native.load()
    part = _workspace(lib, M, N, 1, N * D, query.device)
    ditems = torch.empty_like(items)
    with torch.cuda.device(query.device):
        lib.call("rs_catalog_lse_bwd_ditems", query.data_ptr(), items.data_ptr(),
                 logz.data_ptr(), g.data_ptr(), part.data_ptr(), ditems.data_ptr(), M, N, D,
                 _stream(query.device))
    catalog_logsumexp_ditems.launches += 1
    return ditems


class _CatalogLogSumExp(torch.autograd.Function):
    """K7 with K8 and K9 as its backward (``jax.custom_vjp`` at
    ``softmax_z.py:212-231``)."""

    @staticmethod
    def forward(ctx, query, items):
        logz = catalog_logsumexp_fwd(query, items)
        ctx.save_for_backward(query, items, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        query, items, logz = ctx.saved_tensors
        g = g.contiguous()
        dq = catalog_logsumexp_dq(query, items, logz, g) if ctx.needs_input_grad[0] else None
        ditems = (catalog_logsumexp_ditems(query, items, logz, g)
                  if ctx.needs_input_grad[1] else None)
        return dq, ditems


def catalog_logsumexp(query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """``logsumexp(query @ items.T, -1)`` without the ``[M, N]`` scores on
    the card; differentiable in both arguments."""
    return _CatalogLogSumExp.apply(query.contiguous(), items.contiguous())


catalog_logsumexp_fwd.launches = 0
catalog_logsumexp_dq.launches = 0
catalog_logsumexp_ditems.launches = 0
