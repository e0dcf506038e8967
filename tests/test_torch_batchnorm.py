"""``SimpleBatchNorm``, ``Dice`` and the batch-normed ``MLPModule``: the port
against the JAX package's flax modules on the same numpy inputs and
weights.

- ``SimpleBatchNorm`` in its three modes: training (the batch's
  statistics), calibration (a cumulative average of the batch means and
  variances, counted, the batch's statistics applied) over three batches,
  and evaluation (the calibrated statistics, or the batch's while the
  count is 0), on ``[B, F]`` and ``[B, L, F]`` inputs and on a batch of
  one; outputs and statistics to 1e-5 absolute + 1e-5 relative;
- ``Dice`` in training and evaluation, and ``get_act("dice", dim)``;
- ``MLPModule`` with ``batch_norm`` (dropout, Linear, batch norm,
  activation in each layer; the last layer's batch norm only with
  ``last_bn``), relu, sigmoid and dice, against the JAX module in training
  and after a calibration, its weights and statistics carried by
  ``ranker_params_from_jax`` / ``ranker_batch_stats_to_jax``;
- the statistics are buffers: no optimizer moves them, and they travel
  with ``state_dict``, ``snapshot``/``restore`` and checkpoints.
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_bn(F, seed, **kw):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import SimpleBatchNorm as JaxBN
    mod = JaxBN(**kw)
    variables = mod.init(jax.random.PRNGKey(0), jnp.zeros((2, F)))
    rng = np.random.default_rng(seed)
    params = {k: jnp.asarray(rng.normal(1.0 if k == "scale" else 0.0, 0.3, F), jnp.float32)
              for k in variables.get("params", {})}
    return mod, {"params": params, "batch_stats": dict(variables["batch_stats"])}


def _port_bn(F, variables, **kw):
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    bn = SimpleBatchNorm(F, **kw)
    with torch.no_grad():
        for k, v in variables["params"].items():
            getattr(bn, k).copy_(torch.from_numpy(np.asarray(v)))
    return bn


def _stats(bn):
    return {k: getattr(bn, k).numpy().copy() for k in ("mean", "var", "count")}


@pytest.mark.parametrize("shape", [(64, 6), (16, 5, 6), (1, 6)])
def test_simple_batch_norm_three_modes_match_jax(shape):
    import jax.numpy as jnp
    F = shape[-1]
    mod, variables = _jax_bn(F, 1)
    bn = _port_bn(F, variables)
    rng = np.random.default_rng(2)
    xs = [rng.normal(0.5 * i, 1.0 + i, shape).astype(np.float32) for i in range(4)]
    # evaluation before any calibration: the batch's statistics (count 0)
    bn.eval()
    with torch.no_grad():
        got = bn(torch.from_numpy(xs[0])).numpy()
    want = np.asarray(mod.apply(variables, jnp.asarray(xs[0]), training=False))
    np.testing.assert_allclose(got, want, **TOL)
    # training: the batch's statistics, nothing stored
    bn.train()
    got = bn(torch.from_numpy(xs[1])).detach().numpy()
    want = np.asarray(mod.apply(variables, jnp.asarray(xs[1]), training=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(bn.count) == 0.0
    # calibration over three batches (the engine's reset: statistics 0)
    stats = {k: jnp.zeros_like(v) for k, v in variables["batch_stats"].items()}
    bn.eval()
    for buf in (bn.mean, bn.var, bn.count):
        buf.zero_()
    bn.calibrating = True
    for x in xs[:3]:
        with torch.no_grad():
            got = bn(torch.from_numpy(x)).numpy()
        want, upd = mod.apply({**variables, "batch_stats": stats}, jnp.asarray(x),
                              training=False, mutable=["batch_stats"])
        stats = dict(upd["batch_stats"])
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        for k, v in _stats(bn).items():
            np.testing.assert_allclose(v, np.asarray(stats[k]), **TOL, err_msg=k)
    bn.calibrating = False
    assert float(bn.count) == 3.0
    # evaluation on the calibrated statistics
    with torch.no_grad():
        got = bn(torch.from_numpy(xs[3])).numpy()
    want = np.asarray(mod.apply({**variables, "batch_stats": stats}, jnp.asarray(xs[3]),
                                training=False))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("training", [True, False])
def test_dice_matches_jax(training):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import Dice as JaxDice
    from recstudio_torch.models.module.layers import Dice, get_act
    F = 7
    rng = np.random.default_rng(3)
    x = rng.normal(0.2, 2.0, (32, F)).astype(np.float32)
    jd = JaxDice(F)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    alpha = rng.normal(0.0, 0.5, F).astype(np.float32)
    stats = {"mean": rng.normal(size=F).astype(np.float32),
             "var": rng.random(F).astype(np.float32) + 0.5, "count": np.float32(4.0)}
    variables = {"params": {"alpha": jnp.asarray(alpha)}, "batch_stats": {"bn": stats}}
    dice = get_act("dice", F)
    assert isinstance(dice, Dice) and [n for n, _ in dice.named_parameters()] == ["alpha"]
    with torch.no_grad():
        dice.alpha.copy_(torch.from_numpy(alpha))
        for k, v in stats.items():
            getattr(dice.bn, k).copy_(torch.as_tensor(v))
    dice.train(training)
    with torch.no_grad():
        got = dice(torch.from_numpy(x)).numpy()
    want = np.asarray(jd.apply(variables, jnp.asarray(x), training=training))
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="dimension"):
        get_act("dice")


MLP_CASES = [("relu", True, False, True), ("sigmoid", True, False, False),
             ("relu", True, True, True), ("dice", True, False, False),
             ("tanh", False, True, True)]


@pytest.mark.parametrize("act,batch_norm,last_activation,last_bn", MLP_CASES)
def test_batch_norm_mlp_matches_jax(act, batch_norm, last_activation, last_bn):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import MLPModule as JaxMLP
    from recstudio_torch.models.module.layers import MLPModule, SimpleBatchNorm
    from recstudio_torch.utils.convert import ranker_batch_stats_to_jax, ranker_params_from_jax
    sizes = [12, 16, 8, 3]
    rng = np.random.default_rng(4)
    xs = [rng.normal(0.3, 1.5, (40, sizes[0])).astype(np.float32) for _ in range(3)]
    jm = JaxMLP(sizes, activation_func=act, batch_norm=batch_norm,
                last_activation=last_activation, last_bn=last_bn)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(xs[0]))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(0.0, 0.4, a.shape), np.float32), variables["params"])
    mlp = MLPModule(sizes, act, batch_norm=batch_norm, last_activation=last_activation,
                    last_bn=last_bn)
    stats0 = {k: v for k, v in mlp.state_dict().items() if k.rsplit(".", 1)[-1] in
              ("mean", "var", "count")}
    mlp.load_state_dict({**stats0, **ranker_params_from_jax(params, mlp)})
    bns = [n for n, m in mlp.named_modules() if isinstance(m, SimpleBatchNorm)]
    want_bns = (["bn_0", "bn_1"] + (["bn_2"] if last_bn else [])) if batch_norm else []
    if act == "dice":
        want_bns += [f"Dice_{i}.bn" for i in range(2 + last_activation)]
    assert sorted(bns) == sorted(want_bns)
    jvars = {"params": params, "batch_stats": variables.get("batch_stats", {})}
    mlp.train()
    got = mlp(torch.from_numpy(xs[0])).detach().numpy()
    want = np.asarray(jm.apply(jvars, jnp.asarray(xs[0]), training=True))
    np.testing.assert_allclose(got, want, **TOL)
    if not bns:
        return
    # calibrate both on two batches, then evaluate a third
    stats = jax.tree_util.tree_map(jnp.zeros_like, jvars["batch_stats"])
    mlp.eval()
    for m in mlp.modules():
        if isinstance(m, SimpleBatchNorm):
            m.mean.zero_(), m.var.zero_(), m.count.zero_()
            m.calibrating = True
    for x in xs[:2]:
        with torch.no_grad():
            mlp(torch.from_numpy(x))
        _, upd = jm.apply({**jvars, "batch_stats": stats}, jnp.asarray(x), training=False,
                          mutable=["batch_stats"])
        stats = upd["batch_stats"]
    for m in mlp.modules():
        if isinstance(m, SimpleBatchNorm):
            m.calibrating = False
    got_stats = ranker_batch_stats_to_jax(mlp.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        node = got_stats
        for k in path:
            node = node[str(getattr(k, "key", k))]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL, err_msg=str(path))
    with torch.no_grad():
        got = mlp(torch.from_numpy(xs[2])).numpy()
    want = np.asarray(jm.apply({**jvars, "batch_stats": stats}, jnp.asarray(xs[2]),
                               training=False))
    np.testing.assert_allclose(got, want, **TOL)


def test_statistics_are_buffers_that_travel(tmp_path):
    """No optimizer touches the statistics; ``state_dict``, snapshots and
    checkpoints carry them."""
    from recstudio_torch.models.module.layers import MLPModule
    from recstudio_torch.models.optim import LazyAdam
    mlp = MLPModule([6, 5, 1], "relu", batch_norm=True, last_activation=False, last_bn=False)
    names = [n for n, _ in mlp.named_parameters()]
    assert names == ["dense_0.weight", "dense_0.bias", "bn_0.scale", "bn_0.bias",
                     "dense_1.weight", "dense_1.bias"]
    assert sorted(n for n, _ in mlp.named_buffers()) == ["bn_0.count", "bn_0.mean", "bn_0.var"]
    with torch.no_grad():
        mlp.bn_0.mean.fill_(0.5), mlp.bn_0.var.fill_(2.0), mlp.bn_0.count.fill_(3.0)
    before = {k: v.clone() for k, v in mlp.state_dict().items()}
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    for opt in (torch.optim.Adam(mlp.parameters(), lr=0.1), LazyAdam(mlp.parameters(), lr=0.1)):
        mlp.train()
        mlp(x).sum().backward()
        opt.step()
    after = mlp.state_dict()
    for k in ("bn_0.mean", "bn_0.var", "bn_0.count"):
        assert torch.equal(after[k], before[k]), k
    assert not torch.equal(after["dense_0.weight"], before["dense_0.weight"])
    path = str(tmp_path / "m.pt")
    torch.save(mlp.state_dict(), path)
    again = MLPModule([6, 5, 1], "relu", batch_norm=True, last_activation=False, last_bn=False)
    again.load_state_dict(torch.load(path, weights_only=True))
    assert float(again.bn_0.count) == 3.0 and float(again.bn_0.var[0]) == 2.0
