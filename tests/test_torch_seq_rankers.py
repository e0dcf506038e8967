"""DIN and DIEN, and device staging of feature columns: the port against
the JAX package.

- ``SeqDataset`` and ``UserDataset`` staging (``device_epoch_arrays``)
  with user and item feature columns gives JAX ``_get_pos_batch``'s batch
  (ml-100k with its user features, and a small file with token and float
  features of both entities), the ``in_`` history of each item feature
  too;
- on ml-100k as DIN's ``SeqDataset`` (L 8, ratings binarized at 3.0),
  both packages hold the same numpy weights and batch-norm statistics and
  see the same 16 rows (one with a single history item), dropout off:
  DIN's and DIEN's logits in evaluation and in training to 1e-5 absolute
  + 1e-5 relative, one step's loss to 1e-5 relative and every gradient to
  1e-4 of its largest value + 1e-3 relative (a bias that feeds a batch
  norm in training mode has a zero gradient, held under 1e-6 of the net's
  largest as float32 noise in both); five Adam steps on five batches, each
  step's loss to 1e-5 relative;
- DIN's batch-norm statistics after ``_refresh_net_state``, the
  activation unit's Dice norms among them, to 1e-5.
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42
WEIGHT_SEED = 8
ROWS = 16
L = 8
TOL_OUT = (1e-5, 1e-5)     # (atol, rtol)
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)
SMALL = {"embed_dim": 8, "attention_mlp": [8, 4], "fc_mlp": [8, 4], "hidden_size": 12,
         "dropout": 0.0}


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


# ---------------------------------------------------------------------------
# staging of feature columns
# ---------------------------------------------------------------------------
def _write_feature_data(root):
    """A small file with a token and a float feature of each entity."""
    rng = np.random.default_rng(5)
    n = 600
    users, items = rng.integers(1, 40, n), rng.integers(1, 60, n)
    with open(root / "feat.inter", "w") as f:
        f.write("user_id\titem_id\trating\ttimestamp\n")
        for i, (u, it) in enumerate(zip(users, items)):
            f.write(f"u{u}\ti{it}\t{float(rng.integers(1, 6))!r}\t{float(i)!r}\n")
    with open(root / "feat.user", "w") as f:
        f.write("user_id\tage\tscore\n")
        for u in range(1, 40):
            f.write(f"u{u}\ta{u % 5}\t{float(np.float32(rng.random())):.6f}\n")
    with open(root / "feat.item", "w") as f:
        f.write("item_id\tgenre\tprice\n")
        for it in range(1, 58):                    # two items have no row: zeros
            f.write(f"i{it}\tg{it % 7}\t{float(np.float32(rng.random())):.6f}\n")
    return {"url": str(root), "inter_feat_name": "feat.inter",
            "inter_feat_field": ["user_id:token", "item_id:token", "rating:float",
                                 "timestamp:float"], "inter_feat_header": 0,
            "user_feat_name": ["feat.user"], "user_feat_header": 0,
            "user_feat_field": [["user_id:token", "age:token", "score:float"]],
            "item_feat_name": ["feat.item"], "item_feat_header": 0,
            "item_feat_field": [["item_id:token", "genre:token", "price:float"]],
            "max_seq_len": 6, "low_rating_thres": None, "drop_dup": False}


def _staged(split, idx):
    arrays, batch_fn = split.device_epoch_arrays()
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    return {k: v.numpy() for k, v in batch_fn(tensors, torch.from_numpy(idx)).items()}


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype.kind == w.dtype.kind, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _feature_splits(kind, name, config, fields):
    from recstudio_tpu import data as jdata
    from recstudio_torch import data
    out = []
    for module in (data, jdata):
        np.random.seed(SPLIT_SEED)
        ds = getattr(module, kind)(name, config=dict(config))
        splits = ds.build(split_ratio=2) if kind == "SeqDataset" else ds.build()
        for s in splits:
            s.use_field = fields
        out.append(splits)
    return out


@pytest.mark.parametrize("kind", ["SeqDataset", "UserDataset"])
def test_staging_with_feature_columns_matches_jax(kind, tmp_path):
    config = _write_feature_data(tmp_path)
    fields = {"user_id", "item_id", "rating", "timestamp", "age", "score", "genre", "price"}
    ours, theirs = _feature_splits(kind, "feat", config, fields)
    trn, jtrn = ours[0], theirs[0]
    n = len(trn.data_index)
    assert n == len(jtrn.data_index) and n > 20
    for idx in (np.arange(min(n, 16)), np.random.default_rng(0).permutation(n)[:16]):
        want = jtrn._get_pos_batch(idx)
        assert {"in_genre", "in_price", "age", "score"} <= set(want)
        _assert_same_batch(_staged(trn, idx), want)
        _assert_same_batch(trn._get_pos_batch(idx), want)


@pytest.mark.parametrize("kind", ["SeqDataset", "UserDataset"])
def test_staging_with_ml100k_user_features_matches_jax(kind):
    config = {"low_rating_thres": 0.0, "max_seq_len": L}
    fields = {"user_id", "item_id", "rating", "age", "gender", "occupation", "zip_code"}
    ours, theirs = _feature_splits(kind, "ml-100k", config, fields)
    trn, jtrn = ours[0], theirs[0]
    idx = np.random.default_rng(1).permutation(len(trn.data_index))[:64]
    want = jtrn._get_pos_batch(idx)
    assert {"age", "gender", "occupation", "zip_code"} <= set(want)
    _assert_same_batch(_staged(trn, idx), want)


# ---------------------------------------------------------------------------
# DIN and DIEN
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def splits():
    from recstudio_tpu.data import SeqDataset as JaxSeqDataset
    from recstudio_torch.data import SeqDataset
    from recstudio_torch.utils import get_model
    conf = get_model("DIN")[1]["data"]
    data = {"low_rating_thres": conf["low_rating_thres"], "max_seq_len": L}
    ours = SeqDataset("ml-100k", config=dict(data)).build(**conf)
    theirs = JaxSeqDataset("ml-100k", config=dict(data)).build(**conf)
    return ours, theirs


_BUILT = {}


def _draw_state(params, batch_stats, seed=WEIGHT_SEED):
    """Numpy weights N(0, 0.15) in ``params``' layout (tables' row 0 zero,
    batch-norm scales near 1) and calibrated-looking statistics."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(1.0 if name == "scale" else 0.0, 0.15, leaf.shape).astype(np.float32)
        if name == "embedding":
            a[0] = 0.0
        return a

    def stat(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "count":
            return np.float32(4.0)
        if name == "var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        return rng.normal(0.0, 0.2, leaf.shape).astype(np.float32)
    return (jax.tree_util.tree_map_with_path(draw, params),
            jax.tree_util.tree_map_with_path(stat, batch_stats))


def _models(name, splits):
    """The JAX and the port's ``name`` at a small width on the same split,
    dropout off, holding the same drawn weights and statistics."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax
    ours, theirs = splits
    if name not in _BUILT:
        out = []
        for getter in (jax_get_model, get_model):
            cls, conf = getter(name)
            conf["model"].update(SMALL)
            conf["train"]["batch_size"] = ROWS
            out.append((cls, conf))
        (jcls, jconf), (cls, conf) = out
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_parameter(theirs[0])
        jmodel.val_check = False
        model = cls(conf, device="cpu")
        model._init_model(ours[0])
        stats = jmodel.states.get("net", {}).get("batch_stats", {})
        _BUILT[name] = (jmodel, model, _draw_state(
            jax.tree_util.tree_map(np.asarray, jmodel.params), stats))
    jmodel, model, (params, stats) = _BUILT[name]
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    if stats:
        jmodel.states["net"] = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    model.load_state_dict(ranker_params_from_jax(params, model.net, batch_stats=stats))
    model._calib_batches = None
    return jmodel, model


def _batch(trn, start=0):
    """``ROWS`` rows spread over the split, the first with one history item."""
    n = len(trn.data_index)
    one = np.flatnonzero(trn.data_index[:, 2] - trn.data_index[:, 1] == 1)
    idx = np.r_[one[start % len(one)], (np.arange(start, start + ROWS - 1) * (n // ROWS)) % n]
    batch = trn._get_pos_batch(idx)
    assert batch["seqlen"].min() == 1 and batch["seqlen"].max() == L
    return batch


def _assert_tree(got, want, tol, tag):
    assert sorted(got) == sorted(want), tag
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree(got[key], want[key], tol, f"{tag}/{key}")
            continue
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=tol[1],
                                   atol=tol[0] * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{tag}/{key}")


@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_forward_matches_jax(name, splits):
    import jax
    import jax.numpy as jnp
    jmodel, model = _models(name, splits)
    batch = _batch(splits[0][0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    score = jax.jit(jmodel.score, static_argnames=("training",))
    with jax.default_matmul_precision("float32"):
        for training in (False, True):
            want = np.asarray(score(jmodel.params, jb, training=training,
                                    net_state=jmodel.states.get("net")))
            model.net.train(training)
            with torch.no_grad():
                got = model.score(tb).numpy()
            model.net.eval()
            np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1],
                                       err_msg=f"training={training}")


def test_din_activation_unit_stays_in_eval_mode(splits):
    """The JAX unit calls its MLP with ``training=False``: in training its
    Dice norms read the calibrated statistics, the rest of the net the
    batch's."""
    _, model = _models("DIN", splits)
    model.net.train()
    assert not model.net.activation_unit.mlp.training
    assert model.net.dense_mlp.training and model.net.norm_bn.training
    model.net.eval()


@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_one_step_loss_and_gradients_match_jax(name, splits):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import ranker_params_to_jax
    jmodel, model = _models(name, splits)
    batch = _batch(splits[0][0], 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_and_grads = jax.jit(jax.value_and_grad(jmodel._loss_and_aux, has_aux=True))
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = loss_and_grads(jmodel.params, jb, jax.random.PRNGKey(0),
                                            jmodel.states)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ranker_params_to_jax({n: p.grad for n, p in model.net.named_parameters()}, model.net)
    want = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    if name == "DIN":        # dense_{i} feeds bn_{i} in training mode
        for i in range(len(SMALL["fc_mlp"])):
            for tree in (grads, want):
                assert float(np.abs(tree["dense_mlp"][f"dense_{i}"].pop("bias")).max()) \
                    < 1e-6 * largest, i
    _assert_tree(grads, want, TOL_GRAD, f"{name} grad")


@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_adam_steps_track_jax(name, splits):
    import jax
    import jax.numpy as jnp
    import optax
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    jmodel, model = _models(name, splits)
    opt = optax.adam(1e-3)
    params, opt_state = jmodel.params, opt.init(jmodel.params)
    loss_and_grads = jax.jit(jax.value_and_grad(jmodel._loss_and_aux, has_aux=True))
    model.optimizer = model._get_optimizer()
    for step in range(5):
        batch = _batch(splits[0][0], 7 * step)
        with jax.default_matmul_precision("float32"):
            (jloss, _), grads = loss_and_grads(params, {k: jnp.asarray(v) for k, v in
                                                        batch.items()},
                                               jax.random.PRNGKey(step), jmodel.states)
            updates, opt_state = opt.update(jax_zero_pad(grads), opt_state, params)
            params = optax.apply_updates(params, updates)
        model.net.train()
        loss = model._grad_step({k: torch.from_numpy(v) for k, v in batch.items()})
        model.net.eval()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=str(step))


def test_din_refresh_net_state_matches_jax(splits):
    import jax
    from recstudio_torch.utils.convert import ranker_batch_stats_to_jax
    jmodel, model = _models("DIN", splits)
    jmodel._train_data, model._train_data = splits[1][0], splits[0][0]
    with jax.default_matmul_precision("float32"):
        jmodel._refresh_net_state()
    model._refresh_net_state()
    want = jax.tree_util.tree_map(np.asarray, jmodel.states["net"]["batch_stats"])
    got = ranker_batch_stats_to_jax(model.net.state_dict())
    assert "bn" in want["activation_unit"]["mlp"]["Dice_0"]
    counts = [float(v) for p, v in jax.tree_util.tree_flatten_with_path(want)[0]
              if str(getattr(p[-1], "key", "")) == "count"]
    assert counts and set(counts) == {32.0}
    _assert_tree(got, want, (1e-5, 1e-5), "DIN batch_stats")
