"""The CTR zoo's initializers, and the JAX kernels at InterHAt's and DIFM's
shapes: the port against the JAX package.

- The raw 3-D and 2-D parameters (``OuterProductLayer.kernel``, CIN's
  ``conv_{i}``, FmFM's ``field_weight``, FiBiNET's bilinear ``weight``,
  DCN-Mix's ``U``, ``V``, ``C``) start with the JAX package's spreads:
  each model built by both packages from its own seed, each parameter's
  standard deviation and mean within five standard errors of JAX's (700 to
  4,900 draws each: 7 % to 19 % of the spread), where a fan taken over the
  wrong axes moves the spread by a factor of 2 or more.
- The JAX fused layer K1 (Pallas, interpret mode on the CPU) at InterHAt's
  shape (39 fields, d 16, 2 heads of 8, feedforward 64, relu, no key
  padding mask and no attention mask), in evaluation and in training at
  dropout 0 with its backward K2, against the port's plain layer and its
  autograd (rtol 1e-4, atol 1e-5; gradients 1e-5 of their largest); the
  JAX attention kernel K3 at DIFM's shape (39 fields, 2 heads, Dh 5, no
  mask) against ``mha_plain`` (atol 2e-5, rtol 1e-4).
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_close(got, want, tol, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol[1],
                               atol=tol[0] * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


# (model, config overrides, the raw parameters whose spread is compared)
SPREAD_CASES = [
    ("PNN", {"product_type": "outer"}, ("outer.kernel",)),
    ("xDeepFM", {}, ("cin.conv_0", "cin.conv_1", "cin.conv_2")),
    ("FmFM", {}, ("fmfm.field_weight",)),
    ("FiBiNET", {}, ("bilinear.weight",)),
    ("FiBiNET", {"bilinear_type": "each", "shared_bilinear": False},
     ("bilinear.weight", "bilinear_se.weight")),
    ("DCNv2", {"low_rank": 16}, ("cross_net.U_0", "cross_net.V_0", "cross_net.C_0",
                                 "cross_net.U_2", "cross_net.C_2")),
]


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    from test_torch_ctr_zoo import build_splits
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        return build_splits()


@pytest.mark.parametrize("name,over,leaves", SPREAD_CASES,
                         ids=["outer", "cin", "fmfm", "bilinear", "bilinear_each", "dcn_mix"])
def test_initial_spreads_match_jax(name, over, leaves, splits):
    """Both packages initialise each raw parameter as the JAX module
    declares it and the JAX rule by name treats it (xavier by the model's
    ``init_method`` over flax's fans for a 3-D ``kernel``, flax's
    ``xavier_uniform`` for CIN's ``conv_{i}``, ``normal(1.0)`` for the
    rest), on ml-100k (7 fields, 21 pairs, D 10)."""
    check_spreads(name, over, leaves, splits)


def check_spreads(name, over, leaves, splits):
    """``name`` with ``over`` built by both packages from their own seeds:
    each leaf's standard deviation and mean within five standard errors of
    the JAX package's (at least 500 draws). A leaf is the port's name and
    the JAX path, dotted, or one name for both (the same layout)."""
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    (ours, theirs) = splits
    cls, conf = get_model(name)
    conf["model"].update(over)
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    jcls, jconf = jax_get_model(name)
    jconf["model"].update(over)
    jmodel = jcls(jconf)
    jmodel._init_model(theirs[0])
    jmodel._init_variables = jax.jit(jmodel._init_variables)
    jmodel._init_parameter(theirs[0])
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    ours_p = dict(model.net.named_parameters())
    for leaf in leaves:
        port_name, jax_path = leaf if isinstance(leaf, tuple) else (leaf, leaf)
        node = params
        for k in jax_path.split("."):
            node = node[k]
        mine = ours_p[port_name].detach().numpy()
        n = node.size
        assert sorted(mine.shape) == sorted(node.shape) and n >= 500, leaf
        assert isinstance(leaf, tuple) or mine.shape == node.shape, leaf
        # five standard errors of two samples' ratio of spreads and of means
        assert abs(mine.std() / node.std() - 1) < 5 / n ** 0.5, (leaf, mine.std(), node.std())
        assert abs(mine.mean() - node.mean()) < 5 * node.std() * (2 / n) ** 0.5, leaf


def test_k1_and_k2_jax_kernels_at_interhat_shape_match_the_plain_layer():
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.ops.transformer_layer import fused_transformer_layer as jax_ftl
    from recstudio_torch.ops import transformer_layer_plain
    from recstudio_torch.ops.transformer_layer import PARAM_NAMES
    from recstudio_torch.utils.convert import (layer_params_from_jax, layer_params_to_jax,
                                               random_sasrec_params)
    Bk, L, d, H, Ff = 3, 39, 16, 2, 64
    rng = np.random.default_rng(5)
    layer = random_sasrec_params(5, 2, d, 1, Ff, 1)["query_encoder"]["transformer"]["layer_0"]
    x = rng.normal(size=(Bk, L, d)).astype(np.float32)
    g = rng.normal(size=(Bk, L, d)).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in layer.items()}

    def run(x, params, training):
        return jax_ftl(x, params, None, None, H, 0.0, "relu", 1e-5, training, jnp.int32(0))

    with jax.default_matmul_precision("float32"):
        want = run(jnp.asarray(x), jparams, False)
        jdx, jgrads = jax.grad(lambda x, p: (run(x, p, True) * jnp.asarray(g)).sum(),
                               argnums=(0, 1))(jnp.asarray(x), jparams)
    params = {k: v.requires_grad_() for k, v in layer_params_from_jax(layer).items()}
    tx = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        got = transformer_layer_plain(tx, params, None, None, H, "relu", 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    out = transformer_layer_plain(tx, params, None, None, H, "relu", 1e-5, 0.0, 0, True)
    out.backward(torch.from_numpy(g))
    _assert_close(tx.grad, jdx, (1e-5, 1e-4), "dx")
    ours = layer_params_to_jax({n: params[n].grad for n in PARAM_NAMES})
    for leaf, want_g in jgrads.items():
        _assert_close(ours[leaf], want_g, (1e-5, 1e-4), leaf)


def test_k3_jax_kernel_at_difm_shape_matches_mha_plain():
    """The JAX attention kernel (Pallas in interpret mode) at DIFM's criteo
    shape: 39 fields, 2 heads, Dh 5 (d 10), no mask."""
    import jax.numpy as jnp
    from recstudio_tpu.ops.attention import fused_mha as jax_fused_mha
    from recstudio_torch.ops import mha_plain
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(3, 2, 39, 5)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = mha_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
