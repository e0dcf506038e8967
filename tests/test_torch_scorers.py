"""The port's score functions against the JAX package's, pairwise and on
the catalog, to rtol 1e-5 (atol 1e-5): the parameter-free four on every
pairwise shape and the catalog, and NCF's three scorers with the JAX
module's weights carried over (``utils.convert.params_from_jax``, the
``score_func`` subtree), with the gradients of the inputs and the weights.
The JAX scorers find the catalog case from the shapes; the port's is
``scorer.catalog``.
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, NEG, L, D = 6, 11, 4, 3, 8


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = {"pair": ((B, D), (B, D)), "negatives": ((B, D), (B, NEG, D)),
         "per-position": ((B, L, D), (B, L, D)),
         "per-position-negatives": ((B, L, D), (B, L, NEG, D))}


@pytest.mark.parametrize("name", ["InnerProductScorer", "CosineScorer", "EuclideanScorer",
                                  "NormScorer", "NormScorer-1"])
@pytest.mark.parametrize("case", list(CASES) + ["catalog"])
def test_parameter_free_scorer_matches_jax(name, case):
    import jax.numpy as jnp
    from recstudio_tpu.models import scorer as J
    from recstudio_torch.models import scorer as P
    cls, _, p = name.partition("-")
    kwargs = {"p": int(p)} if p else {}
    js, ps = getattr(J, cls)(**kwargs), getattr(P, cls)(**kwargs)
    qs, its = ((B, D), (N, D)) if case == "catalog" else CASES[case]
    q, it = _x(1, *qs), _x(2, *its)
    want = np.asarray(js(jnp.asarray(q), jnp.asarray(it)))
    got = (ps.catalog if case == "catalog" else ps)(_t(q), _t(it)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _ncf_scorers(mode):
    """(JAX scorer module, its params, port scorer) for NCF's ``mode``."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models import scorer as J
    from recstudio_tpu.models.module import MLPModule as JaxMLP
    from recstudio_torch.models import scorer as P
    from recstudio_torch.models.module import MLPModule
    hidden = [16, 8]
    if mode == "mlp":
        js = J.MLPScorer(JaxMLP([2 * D] + hidden + [1], last_activation=False))
        ps = P.MLPScorer(MLPModule([2 * D] + hidden + [1], last_activation=False))
    elif mode == "mf":
        js, ps = J.GMFScorer(D), P.GMFScorer(D)
    else:
        js = J.FusionMFMLPScorer(D, hidden[-1], JaxMLP([2 * D] + hidden))
        ps = P.FusionMFMLPScorer(D, hidden[-1], MLPModule([2 * D] + hidden))
    params = js.init(jax.random.PRNGKey(3), jnp.asarray(_x(1, B, D)),
                     jnp.asarray(_x(2, B, NEG, D)))["params"]
    # nonzero biases, so a wrong mapping shows
    params = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.asarray(_x(a.size, *a.shape)),
                                    params)
    return js, params, ps


@pytest.mark.parametrize("mode", ["mlp", "mf", "fusion"])
@pytest.mark.parametrize("case", ["pair", "negatives", "catalog"])
def test_ncf_scorers_match_jax_with_carried_weights(mode, case):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    js, params, ps = _ncf_scorers(mode)
    sd = params_from_jax({"score_func": jax.tree_util.tree_map(np.asarray, params)})
    ps.load_state_dict({k[len("score_func."):]: v for k, v in sd.items()})
    qs, its = ((B, D), (N, D)) if case == "catalog" else CASES[case]
    q, it = _x(4, *qs), _x(5, *its)

    def jloss(p, a, b):
        return (js.apply({"params": p}, a, b) ** 2).sum()

    want, (gp, ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(q), jnp.asarray(it))
    tq, tit = _t(q).requires_grad_(), _t(it).requires_grad_()
    out = (ps.catalog if case == "catalog" else ps)(tq, tit)
    assert out.shape == tuple(np.asarray(js.apply({"params": params}, jnp.asarray(q),
                                                  jnp.asarray(it))).shape)
    got = (out ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(tit.grad.numpy(), np.asarray(gb), **TOL)
    grads = params_to_jax({"score_func." + n: p.grad for n, p in ps.named_parameters()})
    flat_want = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat_want) == len(list(ps.parameters()))
    for path, g in flat_want:
        node = grads["score_func"]
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(g), err_msg=str(path), **TOL)


def test_parameter_scorers_register_in_the_net():
    """NCF's fusion scorer is a submodule of the two-tower net: its weights
    are the net's parameters and train with the towers'."""
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    cls, conf = get_model("NCF")
    trn = TripletDataset("ml-100k").build(**conf["data"])[0]
    model = cls(conf, device="cpu")
    model._init_model(trn)
    names = {n for n, _ in model.net.named_parameters()}
    assert {"score_func.W.weight", "score_func.mlp.dense_0.weight",
            "score_func.mlp.dense_1.bias"} <= names
    assert model._sparse_rows_enabled() is False
