"""The interaction layers of the CTR zoo (``recstudio_tpu/models/module/
ctr.py:366-619``): the port against the flax modules.

Each of the thirteen layers, with every variant its models use, on the
same numpy inputs and the same weights (N(0, 0.3), loaded by
``ranker_params_from_jax``): the output to 1e-5 absolute + 1e-5 relative
(``TOL_OUT``; the FFT layer's 2e-5, ``TOL_FFT``: two transforms of float32
sums), and the gradients of ``sum(out * g)`` with respect to the inputs
and every weight to 1e-5 of their largest magnitude + 1e-4 relative
(``TOL_GRAD``). ``LogTransformLayer`` runs in training mode and in
evaluation on drawn statistics. ``test_torch_ctr_zoo_init.py`` holds the
initializers and the JAX kernels at InterHAt's and DIFM's shapes.
"""
import numpy as np
import pytest
import torch

TOL_OUT = (1e-5, 1e-5)     # (atol, rtol)
TOL_FFT = (2e-5, 1e-5)
TOL_GRAD = (1e-5, 1e-4)    # (atol as a share of max |g|, rtol)
TOL_ZERO_GRAD = 1e-6       # a zero-in-exact-arithmetic gradient, share of max |g|
B, F, D = 8, 5, 4


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cases():
    """id -> (JAX module factory, port module factory, input shapes, fft)."""
    from recstudio_tpu.models.module import ctr as j
    from recstudio_torch.models.module import ctr as t
    P = F * (F - 1) // 2
    return {
        "cross_v2": (lambda: j.CrossNetworkV2(12, 3), lambda: t.CrossNetworkV2(12, 3),
                     [(B, 12)], False),
        "inner": (lambda: j.InnerProductLayer(F), lambda: t.InnerProductLayer(F),
                  [(B, F, D)], False),
        "inner_vectors": (lambda: j.InnerProductLayer(F, reduction=False),
                          lambda: t.InnerProductLayer(F, reduction=False), [(B, F, D)], False),
        "outer": (lambda: j.OuterProductLayer(F, D), lambda: t.OuterProductLayer(F, D),
                  [(B, F, D)], False),
        "cin_direct": (lambda: j.CIN(D, F, (7, 5, 3), "relu", True),
                       lambda: t.CIN(D, F, (7, 5, 3), "relu", True), [(B, F, D)], False),
        "cin_halved": (lambda: j.CIN(D, F, (7, 5, 3), "relu", False),
                       lambda: t.CIN(D, F, (7, 5, 3), "relu", False), [(B, F, D)], False),
        "afm": (lambda: j.AFMLayer(D, 3, F), lambda: t.AFMLayer(D, 3, F), [(B, F, D)], False),
        "ffm": (lambda: j.FieldAwareFMLayer(F), lambda: t.FieldAwareFMLayer(F),
                [(B, F, (F - 1) * D)], False),
        "fmfm": (lambda: j.FMFMLayer(F, D), lambda: t.FMFMLayer(F, D), [(B, F, D)], False),
        "senet_avg": (lambda: j.SqueezeExcitation(F, 2, "relu"),
                      lambda: t.SqueezeExcitation(F, 2, "relu"), [(B, F, D)], False),
        "senet_max": (lambda: j.SqueezeExcitation(F, 3, "sigmoid", "max"),
                      lambda: t.SqueezeExcitation(F, 3, "sigmoid", "max"), [(B, F, D)], False),
        "bilinear_all": (lambda: j.BilinearInteraction(F, D, "all"),
                         lambda: t.BilinearInteraction(F, D, "all"), [(B, F, D)], False),
        "bilinear_each": (lambda: j.BilinearInteraction(F, D, "each"),
                          lambda: t.BilinearInteraction(F, D, "each"), [(B, F, D)], False),
        "bilinear_interaction": (lambda: j.BilinearInteraction(F, D, "interaction"),
                                 lambda: t.BilinearInteraction(F, D, "interaction"),
                                 [(B, F, D)], False),
        "mask_block_ln": (lambda: j.MaskBlock(20, 12, 6, 1.0, "relu", 0.0, True),
                          lambda: t.MaskBlock(20, 12, 6, 1.0, "relu", 0.0, True),
                          [(B, 20), (B, 12)], False),
        "mask_block_ratio": (lambda: j.MaskBlock(20, 12, 6, 2.0, "tanh", 0.0, False),
                             lambda: t.MaskBlock(20, 12, 6, 2.0, "tanh", 0.0, False),
                             [(B, 20), (B, 12)], False),
        "onn": (lambda: j.OperationAwareFMLayer(F), lambda: t.OperationAwareFMLayer(F),
                [(B, F, F * D)], False),
        "hfm_correlation": (lambda: j.HolographicFMLayer(F, "circular_correlation"),
                            lambda: t.HolographicFMLayer(F, "circular_correlation"),
                            [(B, F, 5)], True),
        "hfm_convolution": (lambda: j.HolographicFMLayer(F, "circular_convolution"),
                            lambda: t.HolographicFMLayer(F, "circular_convolution"),
                            [(B, F, 6)], True),
        "hfm_product": (lambda: j.HolographicFMLayer(F, "product"),
                        lambda: t.HolographicFMLayer(F, "product"), [(B, F, D)], False),
        "log_transform": (lambda: j.LogTransformLayer(F, 6), lambda: t.LogTransformLayer(F, D, 6),
                          [(B, F, D)], False),
    }, P


def _assert_close(got, want, tol, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol[1],
                               atol=tol[0] * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


@pytest.mark.parametrize("case", sorted(_cases()[0]))
def test_layer_matches_flax_module(case):
    jax_make, port_make, shapes, fft = _cases()[0][case]
    check_layer(case, jax_make, port_make, shapes, TOL_FFT if fft else TOL_OUT,
                sorted(_cases()[0]).index(case))


def check_layer(case, jax_make, port_make, shapes, tol, seed, zero=()):
    """The flax module ``jax_make()`` and the port's ``port_make()`` on the
    same inputs (N(0, 1), ``shapes``) and weights (N(0, 0.3), loaded by
    ``ranker_params_from_jax``): the output to ``tol``, the gradients of
    ``sum(out * g)`` with respect to the inputs and every weight to
    ``TOL_GRAD``; in training mode and in evaluation where the module has
    batch statistics. The weights in ``zero`` (JAX paths, ``a/b``) have a
    zero gradient in exact arithmetic: both packages' float32 noise there
    is held under ``TOL_ZERO_GRAD`` of the largest weight gradient."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jm = jax_make()
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                           *map(jnp.asarray, xs)))
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.3, a.shape).astype(np.float32), variables.get("params", {}))
    stats = variables.get("batch_stats")
    if stats is not None:       # LogTransformLayer: calibrated-looking statistics
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: np.float32(4.0) if str(p[-1].key) == "count" else
            (rng.random(a.shape) + 0.5).astype(np.float32) if str(p[-1].key) == "var" else
            rng.normal(0.0, 0.5, a.shape).astype(np.float32), stats)
    layer = port_make()
    sd = ranker_params_from_jax(params, layer, batch_stats=stats)
    assert sorted(sd) == sorted(layer.state_dict())
    layer.load_state_dict(sd)
    g = rng.normal(size=np.shape(jm.apply(variables, *map(jnp.asarray, xs)))).astype(np.float32)
    for training in ((True, False) if stats is not None else (False,)):
        def jax_out(p, *inputs):
            v = {"params": p, **({"batch_stats": stats} if stats is not None else {})}
            kw = {"training": training} if stats is not None else {}
            return jm.apply(v, *inputs, **kw)

        def jax_loss(p, *inputs):
            return (jax_out(p, *inputs) * jnp.asarray(g)).sum()

        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jx = list(map(jnp.asarray, xs))
        with jax.default_matmul_precision("float32"):
            want = jax.jit(jax_out)(jp, *jx)
            jgrads = jax.jit(jax.grad(jax_loss, argnums=tuple(range(len(xs) + 1))))(jp, *jx)
        layer.train(training)
        tx = [torch.from_numpy(x).requires_grad_() for x in xs]
        layer.zero_grad(set_to_none=True)
        got = layer(*tx)
        (got * torch.from_numpy(g)).sum().backward()
        _assert_close(got.detach(), want, tol, f"{case} out, training={training}")
        for i, x in enumerate(tx):
            _assert_close(x.grad, jgrads[i + 1], TOL_GRAD, f"{case} d input {i}")
        ours = ranker_params_to_jax({n: p.grad for n, p in layer.named_parameters()}, layer)
        theirs = jax.tree_util.tree_map(np.asarray, jgrads[0])
        flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
        assert len(flat) == len(jax.tree_util.tree_leaves(ours))
        largest = max([float(np.abs(a).max()) for _, a in flat], default=0.0)
        for path, want_g in flat:
            node = ours
            for k in path:
                node = node[k.key]
            if "/".join(k.key for k in path) in zero:
                assert max(np.abs(node).max(), np.abs(want_g).max()) < TOL_ZERO_GRAD * largest
                continue
            _assert_close(node, want_g, TOL_GRAD, f"{case} d{jax.tree_util.keystr(path)}")
