"""WRMF's ALS sweeps and IRGAN's two players: the port against the JAX
package on the CPU.

Both packages build the same ml-100k ``ALSDataset`` split (numpy seed 42,
the ``mf`` family's ratio split) and hold the same seeded weights at d 16.
Checks:

- one WRMF user half-sweep and then one item half-sweep against the JAX
  package's ``_als_sweep``: the new table to 1e-4 relative + 1e-5 of its
  largest magnitude (batched float32 solves of 16-wide systems); the rows
  a sweep does not own are left bit for bit; the config's ``batch_size``
  is read by nothing (a fit at another value gives the same tables);
- IRGAN's ``_gen_sample`` given the JAX package's draws (the importance
  weights and the draws' probabilities, to 1e-5 relative), the
  discriminator's and the generator's losses (1e-5 relative) and
  gradients (``TOL_GRAD``: 1e-4 of each gradient's largest magnitude +
  1e-3 relative) with the same draws, one optimizer step of each player
  against optax's masked Adam-with-weight-decay step (1e-5 relative +
  1e-5, 1% of the learning rate: Adam's first step divides each gradient by
  its own size, so a gradient near Adam's eps moves by up to a step), with
  the other player's tables left bit for bit, and the phase
  schedule; the initial tables are ``0.02 N(0, 1)`` with zero pad rows.
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42
WEIGHT_SEED = 5
D = 16
B = 16
TOL_GRAD = (1e-4, 1e-3)
TOL_SWEEP = dict(rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def als_splits():
    from recstudio_tpu.data.advance_dataset import ALSDataset as JaxALS
    from recstudio_torch.data import ALSDataset
    from recstudio_torch.utils import get_model
    build = get_model("WRMF")[1]["data"]
    np.random.seed(SPLIT_SEED)
    ours = ALSDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxALS("ml-100k").build(**build)
    return ours, theirs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables(names, sizes, seed=WEIGHT_SEED, scale=0.1):
    rng = np.random.default_rng(seed)
    out = {}
    for name, n in zip(names, sizes):
        t = rng.normal(0.0, scale, (n, D)).astype(np.float32)
        t[0] = 0.0
        out[name] = t
    return out


def _pair(als_splits, name, **conf_over):
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    ours, theirs = als_splits
    jcls, jconf = jax_get_model(name)
    cls, conf = get_model(name)
    for c in (jconf, conf):
        c["model"]["embed_dim"] = D
        for group, values in conf_over.items():
            c[group].update(values)
    jmodel, model = jcls(jconf), cls(conf, device="cpu")
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    return jmodel, model


# ---------------------------------------------------------------------------
def test_wrmf_sweeps_match_jax(als_splits):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_from_jax
    jmodel, model = _pair(als_splits, "WRMF")
    trn = als_splits[0][0]
    t = _tables(("user", "item"), (trn.num_users, trn.num_items))
    tree = {"query_encoder": {"embedding": t["user"]}, "item_encoder": {"embedding": t["item"]}}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model.load_state_dict(params_from_jax(tree))
    jdata = jmodel._get_train_loaders(als_splits[1][0])
    data = model._get_train_loaders(trn)
    for mine, theirs in zip(data, jdata):
        for key in ("keys", "vals", "ratings"):
            np.testing.assert_array_equal(_np(mine[key]), np.asarray(theirs[key]), err_msg=key)
    for epoch, (own, other) in enumerate((("query_encoder", "item_encoder"),
                                          ("item_encoder", "query_encoder"))):
        before = {k: _np(p).copy() for k, p in model.net.state_dict().items()}
        with jax.default_matmul_precision("float32"):
            params = jmodel._als_sweep(params, jdata[epoch], epoch == 0)
        model.trainloaders = data
        assert model.training_epoch(epoch) == 0.0
        got, want = _np(getattr(model.net, own).weight), np.asarray(params[own]["embedding"])
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), **TOL_SWEEP)
        keys = _np(data[epoch]["keys"])
        assert not np.array_equal(got[keys], before[f"{own}.weight"][keys])
        np.testing.assert_array_equal(_np(getattr(model.net, other).weight),
                                      before[f"{other}.weight"])
        untouched = np.setdiff1d(np.arange(len(got)), keys)
        np.testing.assert_array_equal(got[untouched], before[f"{own}.weight"][untouched])


def test_wrmf_batch_size_is_read_by_nothing(als_splits, tmp_path):
    """The config's ``batch_size`` (100) is read by no code: a two-epoch fit
    at 7 gives the same tables, bit for bit; the fit builds no optimizer."""
    from recstudio_torch.utils import get_model
    trn = als_splits[0][0]
    tables = []
    for bs in (100, 7):
        cls, conf = get_model("WRMF")
        conf["model"]["embed_dim"] = D
        conf["train"].update(batch_size=bs, epochs=2)
        conf["eval"]["save_path"] = str(tmp_path)
        model = cls(conf, device="cpu").fit(trn)
        assert model.optimizers == [] and model.optimizer is None
        tables.append({k: _np(v) for k, v in model.net.state_dict().items()})
    for key in tables[0]:
        np.testing.assert_array_equal(tables[0][key], tables[1][key], err_msg=key)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def irgan(als_splits):
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import graph_params_from_jax
    jmodel, model = _pair(als_splits, "IRGAN")
    trn = als_splits[0][0]
    from recstudio_torch.models.mf.irgan import TABLES
    tree = _tables(TABLES, [trn.num_users if "user" in n else trn.num_items for n in TABLES])
    jmodel.params = {k: jnp.asarray(v) for k, v in tree.items()}
    model.load_state_dict(graph_params_from_jax(tree))
    jmodel.optimizers = jmodel._get_optimizers()
    model.optimizers = model._get_optimizers()
    return jmodel, model, tree


def _irgan_batch(als_splits):
    trn = als_splits[1][0]
    trn.eval_mode = False
    idx = np.arange(0, len(trn.data_index), len(trn.data_index) // B)[:B]
    return trn._get_pos_batch(idx)


def test_irgan_initial_tables(als_splits):
    _, model = _pair(als_splits, "IRGAN")
    for name in ("dis_user_embedding", "dis_item_embedding", "gen_user_embedding",
                 "gen_item_embedding"):
        w = _np(getattr(model.net, name).weight)
        assert np.all(w[0] == 0.0)
        assert abs(w[1:].std() - 0.02) < 0.001 and abs(w[1:].mean()) < 0.001


def test_irgan_phase_schedule(irgan):
    jmodel, model, _ = irgan
    phases = [model._phase(e) for e in range(14)]
    assert phases == [jmodel._phase(e) for e in range(14)] == [0] * 5 + [1] * 2 + [0] * 5 + [1] * 2
    assert [model.current_epoch_optimizers(e) for e in (0, 5)] == [[0], [1]]
    assert [g["params"][0].shape[0] for opt in model.optimizers
            for g in opt.param_groups][:1] and len(model.optimizers) == 2


def _jax_draws(jmodel, batch, num_neg, t, rng):
    import jax
    import jax.numpy as jnp
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        w, draws, p = jmodel._gen_sample(jax.lax.stop_gradient(jmodel.params), rng, jb,
                                         num_neg, t)
    return np.asarray(w), np.asarray(draws), np.asarray(p)


def test_irgan_gen_sample_matches_jax(irgan, als_splits):
    import jax
    jmodel, model, _ = irgan
    batch = _irgan_batch(als_splits)
    L = batch["item_id"].shape[1]
    w, draws, p = _jax_draws(jmodel, batch, 2, 1.0, jax.random.PRNGKey(3))
    assert draws.shape == (B, 2 * L) and draws.min() >= 1
    got_w, got_draws, got_p = model._gen_sample({k: torch.from_numpy(v) for k, v in
                                                 batch.items()}, 2, 1.0,
                                                torch.from_numpy(draws.copy()))
    np.testing.assert_array_equal(_np(got_draws), draws)
    np.testing.assert_allclose(_np(got_p), p, rtol=1e-5)
    np.testing.assert_allclose(_np(got_w), w, rtol=1e-5)
    # the port's own draws: ids of the catalog, never the pad, shape [B, n L]
    _, own, _ = model._gen_sample({k: torch.from_numpy(v) for k, v in batch.items()}, 2, 1.0)
    assert own.shape == (B, 2 * L) and int(own.min()) >= 1


def _grads_to_tree(model):
    from recstudio_torch.utils.convert import graph_params_to_jax
    return graph_params_to_jax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                for n, p in model.net.named_parameters()})


@pytest.mark.parametrize("phase", [0, 1], ids=["dis", "gen"])
def test_irgan_losses_and_gradients_match_jax(irgan, als_splits, phase):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    jmodel, model, _ = irgan
    batch = _irgan_batch(als_splits)
    rng = jax.random.PRNGKey(7)
    mc = jmodel.config["model"]
    n, t = (jmodel.neg_count, mc["T_dis"]) if phase == 0 else (2 * jmodel.neg_count, mc["T_gen"])
    _, draws, _ = _jax_draws(jmodel, batch, n, t, rng)
    loss_fn = jmodel._dis_loss if phase == 0 else jmodel._gen_loss
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        jloss, jgrads = jax.value_and_grad(loss_fn)(jmodel.params, jb, rng)
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()}, phase,
                               torch.from_numpy(draws.copy()))
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = _grads_to_tree(model)
    own = "dis_" if phase == 0 else "gen_"
    for key, want in jgrads.items():
        got = grads[key]
        if key.startswith(own):
            assert float(np.abs(want).max()) > 0.0, key
            np.testing.assert_allclose(got, want, rtol=TOL_GRAD[1],
                                       atol=TOL_GRAD[0] * float(np.abs(want).max()), err_msg=key)
        else:                                   # the other player's tables: no gradient
            assert float(np.abs(want).max()) == 0.0 and float(np.abs(got).max()) == 0.0, key
    model.net.zero_grad(set_to_none=True)


@pytest.mark.parametrize("phase", [0, 1], ids=["dis", "gen"])
def test_irgan_each_optimizer_moves_only_its_tables(als_splits, phase):
    """One step of player ``phase`` from the same weights and draws: its
    tables as optax's masked Adam-with-weight-decay step leaves them, the
    other player's bit for bit as they were (no weight decay either)."""
    import jax
    import jax.numpy as jnp
    import optax
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.mf.irgan import TABLES
    from recstudio_torch.utils.convert import graph_params_from_jax
    jmodel, model = _pair(als_splits, "IRGAN")
    trn = als_splits[0][0]
    tree = _tables(TABLES, [trn.num_users if "user" in n else trn.num_items for n in TABLES])
    params = {k: jnp.asarray(v) for k, v in tree.items()}
    model.load_state_dict(graph_params_from_jax(tree))
    model.optimizers = model._get_optimizers()
    assert [type(o).__name__ for o in model.optimizers] == ["AdamW", "AdamW"]
    batch = _irgan_batch(als_splits)
    rng = jax.random.PRNGKey(11)
    mc = jmodel.config["model"]
    n, t = (jmodel.neg_count, mc["T_dis"]) if phase == 0 else (2 * jmodel.neg_count, mc["T_gen"])
    jmodel.params = params
    _, draws, _ = _jax_draws(jmodel, batch, n, t, rng)
    opt = jmodel._get_optimizers()[phase]["optimizer"]
    loss_fn = jmodel._dis_loss if phase == 0 else jmodel._gen_loss
    with jax.default_matmul_precision("float32"):
        grads = jax.grad(loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        updates, _ = opt.update(jax_zero_pad(grads), opt.init(params), params)
        want = optax.apply_updates(params, updates)
    model.phase_step({k: torch.from_numpy(v) for k, v in batch.items()}, phase,
                     torch.from_numpy(draws.copy()))
    own = "dis_" if phase == 0 else "gen_"
    for name in TABLES:
        got = _np(getattr(model.net, name).weight)
        if name.startswith(own):
            assert not np.array_equal(got, tree[name]), name
            np.testing.assert_allclose(got, np.asarray(want[name]), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, tree[name], err_msg=name)
