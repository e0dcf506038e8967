"""The catalog log-partition kernels' plain versions (K7, K8, K9) against
the JAX package's ``catalog_logsumexp``.

The JAX op runs its Pallas kernels in interpret mode on the CPU with small
blocks (16 query rows by 128 items, as ``tests/test_ops.py`` runs them), so
the item count below is not a multiple of the block and the last block is
ragged; it is also held to ``catalog_logsumexp_xla``. Gradients are taken
through both packages' autograd against the same cotangent ``g``, which is
zero on some rows (the padded and unmasked positions of a BERT4Rec batch).
Tolerance: float32 on both sides under ``default_matmul_precision
("float32")``, sums over up to 300 items in another order: rtol 1e-5 and
atol 1e-5 for logZ (values near 6), rtol 1e-4 and atol 1e-5 times the
gradient's largest magnitude for dq and ditems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu.ops.softmax_z import catalog_logsumexp as jax_clse
from recstudio_tpu.ops.softmax_z import catalog_logsumexp_xla

from recstudio_torch.ops import launch_counts, reset_launch_counts
from recstudio_torch.ops.softmax_z import (catalog_logsumexp, catalog_logsumexp_ditems,
                                           catalog_logsumexp_ditems_plain, catalog_logsumexp_dq,
                                           catalog_logsumexp_dq_plain, catalog_logsumexp_fwd,
                                           catalog_logsumexp_plain)

BLOCK_B, BLOCK_N = 16, 128


def _inputs(M, N, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, D)).astype(np.float32)
    items = rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)
    g = rng.normal(size=M).astype(np.float32)
    g[rng.random(M) < 0.5] = 0.0
    g[0] = 0.0
    return q, items, g


def _close(got, want, rel_atol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=rel_atol * max(float(np.abs(want).max()), 1e-6))


def _jax_grads(fn, q, items, g):
    with jax.default_matmul_precision("float32"):
        logz, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(items))
        dq, ditems = vjp(jnp.asarray(g))
    return np.asarray(logz), np.asarray(dq), np.asarray(ditems)


@pytest.mark.parametrize("M,N,D", [(48, 300, 32), (20, 200, 64), (7, 129, 16)])
def test_plain_kernels_match_jax_pallas_and_xla(M, N, D):
    q, items, g = _inputs(M, N, D, M + N)
    pallas = _jax_grads(lambda a, b: jax_clse(a, b, BLOCK_B, BLOCK_N), q, items, g)
    xla = _jax_grads(catalog_logsumexp_xla, q, items, g)
    tq, titems, tg = torch.from_numpy(q), torch.from_numpy(items), torch.from_numpy(g)
    logz = catalog_logsumexp_plain(tq, titems)
    dq = catalog_logsumexp_dq_plain(tq, titems, logz, tg)
    ditems = catalog_logsumexp_ditems_plain(tq, titems, logz, tg)
    for want_logz, want_dq, want_ditems in (pallas, xla):
        np.testing.assert_allclose(logz.numpy(), want_logz, rtol=1e-5, atol=1e-5)
        _close(dq.numpy(), want_dq, 1e-5)
        _close(ditems.numpy(), want_ditems, 1e-5)
    assert np.all(dq.numpy()[g == 0] == 0.0)          # a row with g = 0 has no gradient


def test_autograd_on_cpu_takes_the_plain_route():
    q, items, g = _inputs(24, 150, 16, 3)
    _, want_dq, want_ditems = _jax_grads(lambda a, b: jax_clse(a, b, BLOCK_B, BLOCK_N),
                                         q, items, g)
    tq = torch.from_numpy(q).requires_grad_()
    titems = torch.from_numpy(items).requires_grad_()
    reset_launch_counts()
    logz = catalog_logsumexp(tq, titems)
    (logz * torch.from_numpy(g)).sum().backward()
    assert torch.equal(logz.detach(), catalog_logsumexp_plain(tq.detach(), titems.detach()))
    _close(tq.grad.numpy(), want_dq, 1e-5)
    _close(titems.grad.numpy(), want_ditems, 1e-5)
    counts = launch_counts()
    assert [counts[f.__name__] for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                         catalog_logsumexp_ditems)] == [0, 0, 0]


def test_only_the_query_gradient_when_items_are_constant():
    q, items, _ = _inputs(6, 40, 8, 4)
    tq = torch.from_numpy(q).requires_grad_()
    catalog_logsumexp(tq, torch.from_numpy(items)).sum().backward()
    logz = catalog_logsumexp_plain(tq.detach(), torch.from_numpy(items))
    torch.testing.assert_close(tq.grad, catalog_logsumexp_dq_plain(
        tq.detach(), torch.from_numpy(items), logz, torch.ones(6)))
