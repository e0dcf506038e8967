"""The port's training loss and uniform samplers.

``BinaryCrossEntropyLoss`` against the JAX package's on random scores with
``-inf`` pads (values and gradients to rtol 1e-5 / atol 1e-6: float32 on
both sides); the samplers' ranges and the history exclusion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu.models.loss_func import BinaryCrossEntropyLoss as JaxBCE

from recstudio_torch.ann.sampler import MaskedUniformSampler, UniformSampler
from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss


@pytest.mark.parametrize("shape,neg", [((64,), 1), ((16,), 5), ((8, 12), 3)],
                         ids=["pair", "negs", "per-position"])
def test_bce_matches_jax(shape, neg):
    rng = np.random.default_rng(len(shape) * 10 + neg)
    pos = rng.normal(size=shape).astype(np.float32) * 3
    negs = rng.normal(size=(*shape, neg)).astype(np.float32) * 3
    pos.reshape(-1)[::5] = -np.inf                       # pads
    label = np.ones(shape, np.float32)
    zeros = np.zeros_like(negs)
    jloss = lambda p, n: JaxBCE()(jnp.asarray(label), p, None, n, jnp.asarray(zeros))
    want, (wgp, wgn) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(pos),
                                                                 jnp.asarray(negs))
    tp, tn = torch.from_numpy(pos).requires_grad_(), torch.from_numpy(negs).requires_grad_()
    got = BinaryCrossEntropyLoss()(torch.from_numpy(label), tp, None, tn,
                                   torch.from_numpy(zeros))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(wgn), rtol=1e-5, atol=1e-6)


def test_uniform_sampler_range():
    n_items = 50                                         # ids 1..49, 0 = [PAD]
    gen = torch.Generator().manual_seed(0)
    q = torch.zeros(4000, 8)
    pos_p, neg, neg_p = UniformSampler(n_items)(q, 5, gen, pos_items=torch.ones(4000))
    assert neg.shape == (4000, 5) and int(neg.min()) == 1 and int(neg.max()) == n_items - 1
    assert torch.equal(neg_p, torch.zeros_like(neg_p)) and pos_p.shape == (4000,)
    again = UniformSampler(n_items)(q, 5, torch.Generator().manual_seed(0))[1]
    assert torch.equal(neg, again)                       # the generator fixes the draw


def test_masked_uniform_sampler_avoids_history():
    n_items, B, H = 40, 64, 12
    rng = np.random.default_rng(1)
    hist = np.zeros((B, H), np.int32)
    for b in range(B):
        k = rng.integers(0, H + 1)
        hist[b, :k] = rng.choice(np.arange(1, n_items), size=k, replace=False)
    gen = torch.Generator().manual_seed(2)
    _, neg, _ = MaskedUniformSampler(n_items)(torch.zeros(B, 4), 2000, gen,
                                              user_hist=torch.from_numpy(hist))
    neg = neg.numpy()
    assert neg.min() >= 1 and neg.max() <= n_items - 1
    for b in range(B):
        assert not np.isin(neg[b], hist[b][hist[b] > 0]).any()
        free = set(range(1, n_items)) - set(hist[b].tolist())
        assert set(neg[b].tolist()) == free              # every free id is reachable
