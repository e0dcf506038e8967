"""CUDA kernels of recstudio_torch against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip. Run on the
card with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``
(``--noconftest``: the shared conftest imports JAX, which the card lacks).
Tolerances: float32 throughout (TF32 off); sums are taken in another order
than PyTorch's, so results agree to float32 rounding, not bit for bit.
"""
import numpy as np
import pytest
import torch

from recstudio_torch.ops.attention import additive_masks, fused_mha, mha_plain
from recstudio_torch.ops.softmax_z import (catalog_logsumexp, catalog_logsumexp_ditems,
                                           catalog_logsumexp_ditems_plain, catalog_logsumexp_dq,
                                           catalog_logsumexp_dq_plain, catalog_logsumexp_fwd,
                                           catalog_logsumexp_plain)
from recstudio_torch.ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer,
                                                   fused_transformer_layer_bwd,
                                                   training_residuals,
                                                   transformer_layer_bwd_plain,
                                                   transformer_layer_plain)
from recstudio_torch.utils.convert import layer_params_from_jax, random_sasrec_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _masks(rng, B, L, dev, all_masked_row=False):
    lens = rng.integers(1, L + 1, size=B)
    pad = np.arange(L)[None, :] >= lens[:, None]
    if all_masked_row:
        pad[0] = True
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=dev), 1)
    return torch.from_numpy(pad).to(dev), causal


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal", [
    (3, 2, 20, 20, 32, True), (2, 2, 200, 200, 64, True), (2, 1, 384, 384, 128, True),
    (2, 4, 7, 45, 16, False), (1, 1, 33, 512, 256, False)])
def test_fused_mha_matches_plain(dev, B, H, Lq, Lk, Dh, causal):
    rng = np.random.default_rng(Lq + Lk + Dh)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    pad = torch.from_numpy(rng.random((B, Lk)) < 0.3).to(dev)
    pad[:, 0] = False
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool, device=dev), 1) if causal else None
    before = fused_mha.launches
    got = fused_mha(q, k, v, pad, attn)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    want = mha_plain(q, k, v, *additive_masks(pad, attn))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


def test_fused_mha_all_masked_row_is_uniform(dev):
    rng = np.random.default_rng(0)
    B, H, L, Dh = 2, 2, 40, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    pad, causal = _masks(rng, B, L, dev, all_masked_row=True)
    got = fused_mha(q, k, v, pad, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]),
                               rtol=1e-4, atol=2e-5)


def test_fused_mha_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 1, 8, 16), device=dev)
    with pytest.raises(ValueError):
        fused_mha(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        fused_mha(q, q.transpose(2, 3), q)
    with pytest.raises(NotImplementedError):
        big = torch.zeros((1, 1, 600, 16), device=dev)
        fused_mha(big, big, big)


@pytest.mark.parametrize("B,L,D,F,H,act,eps", [
    (5, 20, 64, 128, 2, "gelu", 1e-12), (3, 200, 128, 128, 2, "gelu", 1e-12),
    (4, 37, 96, 160, 3, "relu", 1e-6), (2, 256, 256, 1024, 4, "gelu", 1e-5)])
def test_fused_transformer_layer_matches_plain(dev, B, L, D, F, H, act, eps):
    rng = np.random.default_rng(B * L)
    tree = random_sasrec_params(L, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev)
    before = fused_transformer_layer.launches
    got = fused_transformer_layer(x, params, pad, causal, H, 0.0, act, eps, False)
    torch.cuda.synchronize()
    assert fused_transformer_layer.launches == before + 1
    want = transformer_layer_plain(x, params, pad, causal, H, act, eps)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,L,D,F,H,act,p", [
    (5, 20, 64, 128, 2, "gelu", 0.5), (3, 200, 128, 128, 2, "gelu", 0.5),
    (4, 37, 96, 160, 3, "relu", 0.2), (2, 24, 64, 128, 2, "gelu", 0.0)])
def test_fused_layer_training_matches_plain(dev, B, L, D, F, H, act, p):
    """K1 (training) and K2 against the plain forward and autograd through
    it, with dropout on: the kernels regenerate the plain version's masks
    from the same seed. Tolerance: K1 as eval; gradients atol 1e-4 times
    their largest magnitude (float32 sums of up to B L terms)."""
    rng = np.random.default_rng(B * L + 1)
    tree = random_sasrec_params(L + 1, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev)
    seed = 12345
    k1, k2 = fused_transformer_layer.launches, fused_transformer_layer_bwd.launches
    out, res = training_residuals(x, params, pad, causal, H, p, act, 1e-12, seed)
    dx, grads = fused_transformer_layer_bwd(g, x, params, pad, causal, H, p, act, 1e-12, seed,
                                            res)
    torch.cuda.synchronize()
    assert (fused_transformer_layer.launches, fused_transformer_layer_bwd.launches) == \
        (k1 + 1, k2 + 1)
    want = transformer_layer_plain(x, params, pad, causal, H, act, 1e-12, p, seed, True)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    wdx, wgrads = transformer_layer_bwd_plain(g, x, params, pad, causal, H, p, act, 1e-12, seed)
    torch.testing.assert_close(dx, wdx, rtol=1e-4, atol=1e-4 * float(wdx.abs().max()))
    for name in PARAM_NAMES:
        torch.testing.assert_close(grads[name], wgrads[name], rtol=1e-4,
                                   atol=1e-4 * max(float(wgrads[name].abs().max()), 1e-3),
                                   msg=name)
    dx2, grads2 = fused_transformer_layer_bwd(g, x, params, pad, causal, H, p, act, 1e-12,
                                              seed, res)
    assert torch.equal(dx, dx2)                   # no atomics: bitwise repeatable
    assert all(torch.equal(grads[n], grads2[n]) for n in PARAM_NAMES)


def test_fused_layer_autograd_and_eval_path(dev):
    """In training mode the entry point is differentiable through K2; in
    eval mode it still launches the eval kernel, ignoring the seed."""
    tree = random_sasrec_params(0, 2, 32, 1, 64, 1)
    params = {n: t.to(dev).requires_grad_() for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.randn((2, 4, 32), device=dev, requires_grad=True)
    before = fused_transformer_layer_bwd.launches
    fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, True, 5).sum().backward()
    torch.cuda.synchronize()
    assert fused_transformer_layer_bwd.launches == before + 1
    assert torch.isfinite(x.grad).all() and all(torch.isfinite(p.grad).all()
                                                for p in params.values())
    with torch.no_grad():
        a = fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, False, 5)
        b = fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, False, 6)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused_transformer_layer(x.double(), params, None, None, 2, 0.1, "gelu", 1e-12, True, 5)


def test_fused_layer_without_attention_mask(dev):
    """The bidirectional layer of BERT4Rec: K1 (eval and training) and K2
    with no attention mask, only key padding."""
    B, L, D, F, H, p, seed = 4, 50, 64, 128, 2, 0.2, 99
    rng = np.random.default_rng(5)
    tree = random_sasrec_params(7, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, _ = _masks(rng, B, L, dev)
    got = fused_transformer_layer(x, params, pad, None, H, 0.0, "gelu", 1e-12, False)
    torch.testing.assert_close(got, transformer_layer_plain(x, params, pad, None, H, "gelu",
                                                            1e-12), rtol=1e-4, atol=1e-4)
    out, res = training_residuals(x, params, pad, None, H, p, "gelu", 1e-12, seed)
    torch.testing.assert_close(out, transformer_layer_plain(x, params, pad, None, H, "gelu",
                                                            1e-12, p, seed, True),
                               rtol=1e-4, atol=1e-4)
    dx, grads = fused_transformer_layer_bwd(g, x, params, pad, None, H, p, "gelu", 1e-12, seed,
                                            res)
    wdx, wgrads = transformer_layer_bwd_plain(g, x, params, pad, None, H, p, "gelu", 1e-12, seed)
    torch.testing.assert_close(dx, wdx, rtol=1e-4, atol=1e-4 * float(wdx.abs().max()))
    for name in PARAM_NAMES:
        torch.testing.assert_close(grads[name], wgrads[name], rtol=1e-4,
                                   atol=1e-4 * max(float(wgrads[name].abs().max()), 1e-3),
                                   msg=name)


def _clse_inputs(M, N, D, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
    items = torch.from_numpy(rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)).to(dev)
    g = rng.normal(size=M).astype(np.float32)
    g[rng.random(M) < 0.8] = 0.0
    return q, items, torch.from_numpy(g).to(dev)


@pytest.mark.parametrize("M,N,D", [(300, 1000, 64), (37, 5000, 200), (1000, 129, 16),
                                   (512, 40000, 64), (5, 3, 256), (6000, 3706, 64)])
def test_catalog_logsumexp_kernels_match_plain(dev, M, N, D):
    """K7, K8, K9 against their plain versions, ragged tiles and every
    split plan (one range, items split, rows split). Tolerance: logZ atol
    1e-4 (sums of up to 40,000 terms); gradients atol 1e-4 times their
    largest magnitude, rtol 1e-3. K8 and K9 repeat bit for bit."""
    q, items, g = _clse_inputs(M, N, D, dev, M + N)
    counts = [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                   catalog_logsumexp_ditems)]
    logz = catalog_logsumexp_fwd(q, items)
    dq = catalog_logsumexp_dq(q, items, logz, g)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                 catalog_logsumexp_ditems)] == [c + 1 for c in counts]
    torch.testing.assert_close(logz, catalog_logsumexp_plain(q, items), rtol=1e-5, atol=1e-4)
    for got, want in ((dq, catalog_logsumexp_dq_plain(q, items, logz, g)),
                      (ditems, catalog_logsumexp_ditems_plain(q, items, logz, g))):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-4 * max(float(want.abs().max()), 1e-6))
    assert torch.equal(dq, catalog_logsumexp_dq(q, items, logz, g))
    assert torch.equal(ditems, catalog_logsumexp_ditems(q, items, logz, g))
    assert bool((dq[g == 0] == 0).all())


def test_catalog_logsumexp_autograd_on_the_card(dev):
    q, items, g = _clse_inputs(700, 2000, 64, dev)
    qs, its = q.clone().requires_grad_(), items.clone().requires_grad_()
    before = catalog_logsumexp_dq.launches, catalog_logsumexp_ditems.launches
    (catalog_logsumexp(qs, its) * g).sum().backward()
    torch.cuda.synchronize()
    assert (catalog_logsumexp_dq.launches, catalog_logsumexp_ditems.launches) == \
        (before[0] + 1, before[1] + 1)
    logz = catalog_logsumexp_fwd(q, items)
    assert torch.equal(qs.grad, catalog_logsumexp_dq(q, items, logz, g))
    assert torch.equal(its.grad, catalog_logsumexp_ditems(q, items, logz, g))


def test_catalog_logsumexp_refuses_what_it_does_not_take(dev):
    q, items, g = _clse_inputs(8, 16, 64, dev)
    with pytest.raises(ValueError, match="width"):
        catalog_logsumexp_fwd(torch.zeros((8, 300), device=dev), torch.zeros((16, 300),
                                                                             device=dev))
    with pytest.raises(ValueError):
        catalog_logsumexp_fwd(q.double(), items.double())
    with pytest.raises(ValueError):
        catalog_logsumexp_dq(q, items, torch.zeros(7, device=dev), g)
