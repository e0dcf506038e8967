"""Plain versions of the port's kernels against the JAX package's kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_ops.py`` does, under ``jax.default_matmul_precision("float32")``.
Tolerance rtol 1e-4, atol 1e-5: float32 on both sides, sums taken in a
different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu.models.module.layers import SeqPoolingLayer as JaxSeqPooling
from recstudio_tpu.models.module.layers import TransformerLayer as JaxTransformerLayer
from recstudio_tpu.ops.attention import fused_mha as jax_fused_mha
from recstudio_tpu.ops.transformer_layer import fused_transformer_layer as jax_ftl
from recstudio_tpu.ops.transformer_layer import supports_fused_layer as jax_supports

from recstudio_torch.models.module import SeqPoolingLayer, TransformerLayer
from recstudio_torch.ops import fused_mha, mha_plain, supports_fused_layer, transformer_layer_plain
from recstudio_torch.ops.attention import additive_masks
from recstudio_torch.ops.transformer_layer import gelu_tanh
from recstudio_torch.utils.convert import layer_params_from_jax, random_sasrec_params

RTOL, ATOL = 1e-4, 1e-5


def _layer(seed, D, F):
    return random_sasrec_params(seed, 2, D, 1, F, 1)["query_encoder"]["transformer"]["layer_0"]


def _pad(rng, B, L, right: bool):
    """Right padding (SASRec histories) or random padding, key 0 always valid,
    so no query row has every key masked."""
    if right:
        lens = rng.integers(1, L + 1, size=B)
        return np.arange(L)[None, :] >= lens[:, None]
    pad = rng.random((B, L)) < 0.3
    pad[:, 0] = False
    return pad


@pytest.mark.parametrize("B,L,D,H,F,causal,act,eps,dropout", [
    (4, 20, 32, 2, 64, True, "gelu", 1e-6, 0.0),     # causal + padding
    (3, 12, 32, 4, 64, False, "gelu", 1e-12, 0.0),   # bidirectional, odd batch
    (2, 16, 24, 3, 48, True, "relu", 1e-12, 0.0),    # relu
    (5, 20, 64, 2, 128, True, "gelu", 1e-12, 0.5),   # SASRec shape; eval mode ignores dropout
], ids=["causal", "bidir-oddbatch", "relu", "sasrec-eval"])
def test_transformer_layer_plain_matches_jax_kernel(B, L, D, H, F, causal, act, eps, dropout):
    rng = np.random.default_rng(B * 100 + L)
    layer = _layer(L, D, F)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    pad = _pad(rng, B, L, right=causal)
    mask = np.triu(np.ones((L, L), bool), 1) if causal else None
    with jax.default_matmul_precision("float32"):
        want = jax_ftl(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
                       jnp.asarray(pad), None if mask is None else jnp.asarray(mask), H,
                       dropout, act, eps, False, jnp.int32(0))
    got = transformer_layer_plain(torch.from_numpy(x), layer_params_from_jax(layer),
                                  torch.from_numpy(pad),
                                  None if mask is None else torch.from_numpy(mask),
                                  H, act, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal", [
    (3, 2, 20, 20, 16, True), (2, 2, 200, 200, 32, True), (2, 1, 8, 24, 16, False),
    (1, 2, 512, 512, 8, True)])
def test_mha_plain_matches_jax_kernel(B, H, Lq, Lk, Dh, causal):
    rng = np.random.default_rng(Lq + Lk)
    q = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, Lk, Dh)).astype(np.float32) for _ in range(2))
    pad = _pad(rng, B, Lk, right=False)
    mask = np.triu(np.ones((Lq, Lk), bool), 1) if causal else None
    with jax.default_matmul_precision("float32"):
        want = jax_fused_mha(*(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(pad),
                             None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_mha(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(pad), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fully_masked_row_stays_finite():
    """An example whose keys are all masked (a padded serving row, seqlen 0)
    comes out finite: the average of its values. With Lk a multiple of 128
    the JAX kernel's lane padding adds no keys, and the two agree."""
    rng = np.random.default_rng(0)
    B, H, L, Dh = 2, 2, 128, 16
    q, k, v = (rng.normal(size=(B, H, L, Dh)).astype(np.float32) for _ in range(3))
    pad = _pad(rng, B, L, right=True)
    pad[0] = True
    mask = np.triu(np.ones((L, L), bool), 1)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax_fused_mha(*(jnp.asarray(t) for t in (q, k, v)),
                                        jnp.asarray(pad), jnp.asarray(mask)))
    got = mha_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                    *additive_masks(torch.from_numpy(pad), torch.from_numpy(mask))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape),
                               rtol=RTOL, atol=ATOL)


def test_fully_masked_example_follows_the_unpadded_function():
    """An example whose keys are all masked averages its own L values, as the
    JAX package's XLA paths (``mha_xla``, ``TransformerLayer._xla_layer``)
    give. The JAX Pallas kernels do not: ``_mha_pallas`` also averages the
    zero keys it pads Lk with to 128 lanes (``attention.py:97-98``), and the
    fused layer averages over every key of its packed group of examples
    (``transformer_layer.py:241,251``). The port keeps the unpadded function."""
    rng = np.random.default_rng(3)
    B, H, L, D, F = 3, 2, 20, 32, 64
    pad = _pad(rng, B, L, right=True)
    pad[0] = True
    mask = np.triu(np.ones((L, L), bool), 1)
    q, k, v = (rng.normal(size=(B, H, L, D // H)).astype(np.float32) for _ in range(3))
    got = fused_mha(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(pad),
                    torch.from_numpy(mask)).numpy()
    with jax.default_matmul_precision("float32"):
        pallas = np.asarray(jax_fused_mha(*(jnp.asarray(t) for t in (q, k, v)),
                                          jnp.asarray(pad), jnp.asarray(mask)))
    mean = np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape)
    np.testing.assert_allclose(got[0], mean, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pallas[0], mean * L / 128, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1:], pallas[1:], rtol=RTOL, atol=ATOL)

    layer = _layer(5, D, F)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in layer.items()}
    with jax.default_matmul_precision("float32"):
        xla = JaxTransformerLayer(D, H, F, 0.0, "gelu", 1e-12).apply(
            {"params": jparams}, jnp.asarray(x), jnp.asarray(pad), jnp.asarray(mask))
        fused = jax_ftl(jnp.asarray(x), jparams, jnp.asarray(pad), jnp.asarray(mask), H,
                        0.0, "gelu", 1e-12, False, jnp.int32(0))
    got = transformer_layer_plain(torch.from_numpy(x), layer_params_from_jax(layer),
                                  torch.from_numpy(pad), torch.from_numpy(mask), H, "gelu",
                                  1e-12).numpy()
    np.testing.assert_allclose(got, np.asarray(xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1:], np.asarray(fused)[1:], rtol=RTOL, atol=ATOL)
    assert np.abs(got[0] - np.asarray(fused)[0]).max() > 1e-2


@pytest.mark.parametrize("L,D,H,F", [(20, 32, 2, 64), (300, 16, 2, 32)],
                         ids=["fused-layer-branch", "attention-branch"])
def test_transformer_layer_module_matches_jax(L, D, H, F):
    """The module's dispatch on the CPU (fused-layer branch at L <= 256, the
    projections + fused_mha branch above) against the JAX module, which on
    the CPU runs ``_xla_layer``."""
    assert supports_fused_layer(D, L, H, F, "gelu") == (L <= 256)
    rng = np.random.default_rng(L)
    B = 3
    layer = _layer(L + 1, D, F)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    pad = _pad(rng, B, L, right=True)
    mask = np.triu(np.ones((L, L), bool), 1)
    jmod = JaxTransformerLayer(D, H, F, 0.5, "gelu", 1e-12)
    with jax.default_matmul_precision("float32"):
        want = jmod.apply({"params": {k: jnp.asarray(v) for k, v in layer.items()}},
                          jnp.asarray(x), jnp.asarray(pad), jnp.asarray(mask), training=False)
    mod = TransformerLayer(D, H, F, 0.5, "gelu", 1e-12).eval()
    with torch.no_grad():
        for name, value in layer_params_from_jax(layer).items():
            getattr(mod, name).copy_(value)
        got = mod(torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(mask))
        mod.plain = True
        plain = mod(torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_training_mode_is_refused():
    """Training-mode dropout needs the model's generator for its seeds, and
    per-example attention masks are not ported; both are refused."""
    mod = TransformerLayer(16, 2, 32, 0.1, "gelu", 1e-12)   # nn.Module starts in training mode
    with pytest.raises(ValueError, match="torch.Generator"):
        mod(torch.zeros(1, 4, 16))
    with pytest.raises(NotImplementedError):
        mod(torch.zeros(1, 4, 16), attn_mask=torch.zeros((1, 4, 4), dtype=torch.bool),
            rng=torch.Generator())
    assert mod(torch.zeros(1, 4, 16), rng=torch.Generator()).shape == (1, 4, 16)


@pytest.mark.parametrize("pooling", ["last", "mean", "sum", "max"])
def test_seq_pooling_matches_jax(pooling):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 7, 4)).astype(np.float32)
    seqlen = np.array([0, 1, 3, 7, 5], np.int32)
    want = np.asarray(JaxSeqPooling(pooling)(jnp.asarray(x), jnp.asarray(seqlen)))
    got = SeqPoolingLayer(pooling)(torch.from_numpy(x), torch.from_numpy(seqlen)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,L,H,F,act", [
    (64, 20, 2, 128, "gelu"), (256, 256, 4, 1024, "relu"), (257, 20, 1, 128, "gelu"),
    (64, 257, 2, 128, "gelu"), (64, 20, 2, 1025, "gelu"), (64, 20, 3, 128, "gelu"),
    (64, 20, 2, 128, "tanh")])
def test_fused_gate_matches_jax(d, L, H, F, act):
    assert supports_fused_layer(d, L, H, F, act) == jax_supports(d, L, H, F, act)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
