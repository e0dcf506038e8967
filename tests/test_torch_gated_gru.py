"""The attention-gated GRUs (``AGRU``, ``AUGRU``, ``AIGRU``): the port
against the JAX modules.

Both packages hold the same numpy weights (converted by
``ranker_params_from_jax``: ``w_ih`` a ``Linear``, ``w_hh`` the raw ``[H,
3H]`` parameter, ``AIGRU``'s GRU an ``nn.GRU``'s layer) and see the same
inputs and attention scores, with zero scores at the padded tail of some
rows: every step's state and the last state to 1e-5 absolute + 1e-5
relative, and the gradients of a weighted sum of both (inputs, scores and
every weight) to 1e-4 of each gradient's largest value + 1e-3 relative.
"""
import numpy as np
import pytest
import torch

B, L, D, H = 6, 7, 8, 12
TOL_OUT = (1e-5, 1e-5)
TOL_GRAD = (1e-4, 1e-3)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (B, L, D)).astype(np.float32)
    att = rng.random((B, L)).astype(np.float32)
    lens = np.array([L, 1, 3, L, 5, 2])
    att[np.arange(L)[None, :] >= lens[:, None]] = 0.0         # padded steps: score 0
    w_out = rng.normal(0.0, 1.0, (B, L, H)).astype(np.float32)
    w_last = rng.normal(0.0, 1.0, (B, H)).astype(np.float32)
    return x, att, w_out, w_last


def _pair(name, seed=3):
    """The flax module, its random weights, and the port's module holding
    them."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module import gru as jgru
    from recstudio_torch.models.module import gru
    from recstudio_torch.utils.convert import ranker_params_from_jax
    jmod = getattr(jgru, name)(H)
    x, att, _, _ = _inputs()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(att))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.4, a.shape).astype(np.float32), variables["params"])
    mod = getattr(gru, name)(D, H)
    mod.load_state_dict(ranker_params_from_jax(params, mod))
    return jmod, params, mod


def _grads_to_jax(mod):
    from recstudio_torch.utils.convert import ranker_params_to_jax
    return ranker_params_to_jax({n: p.grad for n, p in mod.named_parameters()}, mod)


def _assert_tree(got, want, tag):
    assert sorted(got) == sorted(want), tag
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_tree(got[key], w, f"{tag}/{key}")
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(got[key], w, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(w).max()),
                                   err_msg=f"{tag}/{key}")


@pytest.mark.parametrize("name", ["AGRU", "AUGRU"])
def test_gated_gru_states_and_gradients_match_jax(name):
    import jax
    import jax.numpy as jnp
    jmod, params, mod = _pair(name)
    x, att, w_out, w_last = _inputs()

    def objective(p, xx, aa):
        out, last = jmod.apply({"params": p}, xx, aa)
        return (out * w_out).sum() + (last * w_last).sum(), (out, last)

    with jax.default_matmul_precision("float32"):
        (_, (jout, jlast)), jgrads = jax.value_and_grad(objective, argnums=(0, 1, 2),
                                                        has_aux=True)(
            params, jnp.asarray(x), jnp.asarray(att))
    tx = torch.from_numpy(x).requires_grad_()
    ta = torch.from_numpy(att).requires_grad_()
    out, last = mod(tx, ta)
    ((out * torch.from_numpy(w_out)).sum() + (last * torch.from_numpy(w_last)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), *TOL_OUT[::-1])
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast), *TOL_OUT[::-1])
    np.testing.assert_array_equal(last.detach().numpy(), out.detach().numpy()[:, -1])
    _assert_tree(_grads_to_jax(mod), jax.tree_util.tree_map(np.asarray, jgrads[0]), name)
    _assert_tree({"x": tx.grad.numpy(), "att": ta.grad.numpy()},
                 {"x": np.asarray(jgrads[1]), "att": np.asarray(jgrads[2])}, name)


@pytest.mark.parametrize("name", ["AGRU", "AUGRU"])
def test_zero_attention_carries_the_state(name):
    """A step whose score is 0 keeps the state as it was: past a row's
    last real step its state no longer moves."""
    _, _, mod = _pair(name)
    x, att, _, _ = _inputs()
    with torch.no_grad():
        out, last = mod(torch.from_numpy(x), torch.from_numpy(att))
    # row 1 has one real step, row 5 two
    np.testing.assert_array_equal(last[1].numpy(), out[1, 0].numpy())
    np.testing.assert_array_equal(last[5].numpy(), out[5, 1].numpy())


def test_aigru_states_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    jmod, params, mod = _pair("AIGRU")
    x, att, w_out, _ = _inputs(1)

    def objective(p, xx, aa):
        out = jmod.apply({"params": p}, xx, aa)
        return (out * w_out).sum(), out

    with jax.default_matmul_precision("float32"):
        (_, jout), jgrads = jax.value_and_grad(objective, argnums=(0, 1, 2), has_aux=True)(
            params, jnp.asarray(x), jnp.asarray(att))
    tx = torch.from_numpy(x).requires_grad_()
    ta = torch.from_numpy(att).requires_grad_()
    out = mod(tx, ta)
    (out * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), *TOL_OUT[::-1])
    _assert_tree(_grads_to_jax(mod), jax.tree_util.tree_map(np.asarray, jgrads[0]), "AIGRU")
    _assert_tree({"x": tx.grad.numpy(), "att": ta.grad.numpy()},
                 {"x": np.asarray(jgrads[1]), "att": np.asarray(jgrads[2])}, "AIGRU")


def test_gated_gru_weights_round_trip():
    """``ranker_params_to_jax`` gives back the JAX tree the weights came
    from: ``w_ih`` a Dense kernel, ``w_hh`` raw."""
    for name in ("AGRU", "AUGRU", "AIGRU"):
        _, params, mod = _pair(name)
        from recstudio_torch.utils.convert import ranker_params_to_jax
        back = ranker_params_to_jax(mod.state_dict(), mod)
        _assert_tree(back, params, name)


def test_w_hh_init_is_flax_lecun_normal():
    """The JAX rule leaves ``w_hh`` as flax declared it, LeCun normal
    (truncated at two standard deviations); the port draws the same."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module import gru as jgru
    from recstudio_torch.models.init import init_parameters
    from recstudio_torch.models.module import gru
    x, att, _, _ = _inputs()
    big = jgru.AUGRU(256).init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(att))
    want = np.asarray(big["params"]["cell"]["w_hh"])
    mod = gru.AUGRU(D, 256)
    init_parameters(mod, torch.Generator().manual_seed(0))
    got = mod.cell.w_hh.detach().numpy()
    assert abs(got.std() / want.std() - 1) < 0.03
    assert np.abs(got).max() <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
