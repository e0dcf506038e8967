"""Training mode of the port's fused layer: K1 with dropout and K2.

- The plain K1 (training) and K2 against the JAX package's fused layer with
  ``training=True, dropout=0``: its ``custom_vjp`` runs the Pallas
  ``_bwd_kernel`` in interpret mode on the CPU, as ``tests/test_ops.py``
  does, under ``jax.default_matmul_precision("float32")``. Right padding
  with seqlen >= 1 under a causal mask, so no query row has every key
  masked (there the two packages' gradients take different conventions).
  Tolerance rtol 1e-4 / atol 1e-5 (outputs) and atol 1e-5 times the
  gradient's largest magnitude (gradients): float32 on both sides, sums in
  another order.
- Dropout: the masks cannot match JAX's threefry bits, so their properties
  are tested, as ``tests/test_ops.py:332-352`` does, and the gradient with
  dropout on is checked against finite differences in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu.ops.transformer_layer import fused_transformer_layer as jax_ftl

from recstudio_torch.models.module import TransformerLayer
from recstudio_torch.ops import fused_mha, fused_transformer_layer, mha_plain
from recstudio_torch.ops.attention import additive_masks
from recstudio_torch.ops.dropout import (SITE_ATTN, SITE_FFN_HIDDEN, keep_scale,
                                         philox4x32_10, threshold)
from recstudio_torch.ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer_bwd,
                                                   transformer_layer_bwd_plain,
                                                   transformer_layer_plain)
from recstudio_torch.utils.convert import (layer_params_from_jax, layer_params_to_jax,
                                           random_sasrec_params)

B, L, D, H, F = 3, 8, 16, 2, 32


def _setup(seed=0, act="gelu"):
    rng = np.random.default_rng(seed)
    layer = random_sasrec_params(seed, 2, D, 1, F, 1)["query_encoder"]["transformer"]["layer_0"]
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    lens = rng.integers(1, L + 1, size=B)
    pad = np.arange(L)[None, :] >= lens[:, None]
    mask = np.triu(np.ones((L, L), bool), 1)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    return layer, x, pad, mask, g


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_plain_k1_train_and_k2_match_jax_kernel(act):
    layer, x, pad, mask, g = _setup(1 if act == "gelu" else 2)
    jparams = {k: jnp.asarray(v) for k, v in layer.items()}

    def loss(x, params):
        out = jax_ftl(x, params, jnp.asarray(pad), jnp.asarray(mask), H, 0.0, act, 1e-12,
                      True, jnp.int32(7))
        return (out * jnp.asarray(g)).sum(), out

    with jax.default_matmul_precision("float32"):
        (_, want), (jdx, jgrads) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jparams)
    params = layer_params_from_jax(layer)
    tx, tpad, tmask = torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(mask)
    got = transformer_layer_plain(tx, params, tpad, tmask, H, act, 1e-12, 0.0, 7, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    dx, grads = fused_transformer_layer_bwd(torch.from_numpy(g), tx, params, tpad, tmask, H,
                                            0.0, act, 1e-12, 7)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jdx).max()))
    ours = layer_params_to_jax(grads)
    assert sorted(ours) == sorted(jgrads) and len(ours) == 12
    for leaf, want_g in jgrads.items():
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(ours[leaf], want_g, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(want_g).max()), 1e-3),
                                   err_msg=leaf)


def test_k2_plain_is_autograd_of_the_fused_entry_point():
    """On the CPU the fused entry point's autograd and the K2 wrapper agree
    bit for bit with dropout on: the same plain function, the same masks."""
    layer, x, pad, mask, g = _setup(3)
    params = {k: v.requires_grad_() for k, v in layer_params_from_jax(layer).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = fused_transformer_layer(tx, params, torch.from_numpy(pad), torch.from_numpy(mask), H,
                                  0.5, "gelu", 1e-12, True, 11)
    out.backward(torch.from_numpy(g))
    dx, grads = transformer_layer_bwd_plain(torch.from_numpy(g), tx.detach(),
                                            {k: v.detach() for k, v in params.items()},
                                            torch.from_numpy(pad), torch.from_numpy(mask), H,
                                            0.5, "gelu", 1e-12, 11)
    assert torch.equal(dx, tx.grad)
    for name in PARAM_NAMES:
        assert torch.equal(grads[name], params[name].grad), name


def test_dropout_properties():
    layer, x, pad, mask, _ = _setup(4)
    params = layer_params_from_jax(layer)
    args = (torch.from_numpy(x), params, torch.from_numpy(pad), torch.from_numpy(mask), H,
            "gelu", 1e-12, 0.5)
    o1 = transformer_layer_plain(*args, 123, True)
    o2 = transformer_layer_plain(*args, 123, True)
    assert torch.equal(o1, o2)                               # the seed fixes the masks
    o_eval = transformer_layer_plain(*args, 123, False)
    assert float((o1 - o_eval).abs().max()) > 1e-3           # dropout perturbs the output
    assert torch.equal(o_eval, transformer_layer_plain(*args[:-1], 0.0))
    o3 = transformer_layer_plain(*args, 124, True)
    assert float((o1 - o3).abs().max()) > 0.0                # another seed, other masks


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_share_is_binomial(p):
    n = 200_000
    for site in (SITE_ATTN, SITE_FFN_HIDDEN):
        m = keep_scale((n,), p, 99, site, "cpu")
        share = float((m > 0).float().mean())
        assert abs(share - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
        assert set(torch.unique(m).tolist()) == {0.0, float(torch.tensor(1 / (1 - p)))}
    a, b = keep_scale((n,), p, 99, SITE_ATTN, "cpu"), keep_scale((n,), p, 99, SITE_FFN_HIDDEN, "cpu")
    assert not torch.equal(a, b)                             # sites draw other bits
    assert threshold(p) == min(int(np.ceil(p * 2 ** 24)), 2 ** 24 - 1)


def test_philox_known_answers():
    """Philox-4x32-10 test vectors of its authors (Random123's kat_vectors)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in philox4x32_10(tuple(t(c) for c in ctr), key)) == want


def test_dropout_gradient_matches_finite_differences():
    """Autograd of the plain training layer (the plain K2) against finite
    differences in float64, with the masks of one seed held fixed."""
    rng = np.random.default_rng(5)
    b, l, d, h, f = 2, 4, 8, 2, 8
    layer = random_sasrec_params(5, 2, d, 1, f, 1)["query_encoder"]["transformer"]["layer_0"]
    params = {k: v.double().requires_grad_() for k, v in layer_params_from_jax(layer).items()}
    x = torch.from_numpy(rng.normal(size=(b, l, d))).requires_grad_()
    pad = torch.tensor([[False] * l, [False, False, True, True]])
    mask = torch.triu(torch.ones((l, l), dtype=torch.bool), 1)

    def fn(x, *weights):
        ps = dict(zip(PARAM_NAMES, weights))
        return transformer_layer_plain(x, ps, pad, mask, h, "gelu", 1e-6, 0.5, 21, True)

    assert torch.autograd.gradcheck(fn, (x, *(params[n] for n in PARAM_NAMES)),
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


def test_fused_mha_is_differentiable():
    """The unfused route's attention: its gradient is autograd of the plain
    version (on the CPU the two are one function)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 6, 4)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    pad = torch.tensor([[False] * 6, [False] * 4 + [True] * 2])
    mask = torch.triu(torch.ones((6, 6), dtype=torch.bool), 1)
    g = torch.from_numpy(rng.normal(size=(2, 2, 6, 4)).astype(np.float32))
    grads = torch.autograd.grad(fused_mha(q, k, v, pad, mask), (q, k, v), g)
    want = torch.autograd.grad(mha_plain(q, k, v, *additive_masks(pad, mask)), (q, k, v), g)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("L_", [20, 300], ids=["fused-route", "unfused-route"])
def test_layer_module_trains_with_a_generator(L_):
    """Both routes of the module in training mode: seeds from the generator,
    the same function on the fused and the unfused route."""
    rng = np.random.default_rng(L_)
    d, h, f = 16, 2, 32
    layer = random_sasrec_params(L_, 2, d, 1, f, 1)["query_encoder"]["transformer"]["layer_0"]
    mod = TransformerLayer(d, h, f, 0.3, "gelu", 1e-12).train()
    with torch.no_grad():
        for name, value in layer_params_from_jax(layer).items():
            getattr(mod, name).copy_(value)
    x = torch.from_numpy(rng.normal(size=(2, L_, d)).astype(np.float32))
    pad = torch.from_numpy(np.arange(L_)[None, :] >= np.array([[L_], [L_ // 2]]))
    mask = torch.triu(torch.ones((L_, L_), dtype=torch.bool), 1)
    out = mod(x, pad, mask, rng=torch.Generator().manual_seed(3))
    seed = int(torch.randint(0, 1 << 62, (1,), generator=torch.Generator().manual_seed(3)))
    want = transformer_layer_plain(x, mod.params(), pad, mask, h, "gelu", 1e-12, 0.3, seed, True)
    assert torch.equal(out, want)
    out.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in mod.parameters())
