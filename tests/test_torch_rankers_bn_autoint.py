"""WideDeep, DCN, NFM and AutoInt, their layers and the batch-norm
calibration: the port against the JAX package.

On ml-100k under the fm family's config, both packages hold the same
numpy weights and batch-norm statistics (``ranker_params_from_jax`` with
``batch_stats``) and see the same batch, dropout off:

- each net's logits in evaluation (calibrated statistics, and the batch's
  while the count is 0) and in training, to 1e-5 absolute + 1e-5
  relative; one step's loss to 1e-5 relative and every gradient to 1e-4
  of its largest magnitude + 1e-3 relative (a bias whose shift a batch
  norm in training mode or a softmax removes has a zero gradient: both
  packages' float32 noise there is held under 1e-6 of the net's largest
  gradient);
- ``_refresh_net_state`` (the first 32 training batches in order, the
  statistics reset first) gives the JAX package's statistics to 1e-5;
- ``evaluate`` and ``ScorePredictor`` after the calibration, and a
  prediction from a batch of one row, calibrated or not;
- ``CrossNetwork``, ``MultiHeadAttention`` (masks, weights, both routes),
  ``AttentionLayer``'s ``multi-head`` mode and
  ``SelfAttentionInteractingLayer`` against the flax modules;
- the JAX attention kernel K3 (Pallas, interpret mode on the CPU) at
  AutoInt's shape (L 39 fields, Dh 32, no mask) against the port's
  ``mha_plain``, which K3's CUDA kernel is held to on the card;
- AutoInt's attention takes ``fused_mha`` in evaluation and the plain
  softmax in training with dropout, as the JAX gate routes it;
- a one-epoch ``quickstart.run`` of each on the CPU (dropout off) learns
  past its JAX band's untrained AUC, its batch norms calibrated.

``{widedeep,dcn,nfm,autoint}_ml100k_train_reference.json`` hold the JAX
package's test AUC after ``quickstart.run(name, "ml-100k")`` at the
repo's config, for at most ``ML100K_EPOCHS`` epochs, for six seeds
(``scripts/torch_ctr_seeds.py --jax-ml100k``).
"""
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
MODELS = ("WideDeep", "DCN", "NFM", "AutoInt")
BN_MODELS = ("WideDeep", "DCN", "NFM")
SEEDS = (2022, 2023, 2024, 2025, 2026, 2027)
SPLIT_SEED = 42
WEIGHT_SEED = 6
ROWS = 512
AUC_MARGIN = 0.1
TOL_OUT = (1e-5, 1e-5)     # (atol, rtol) of logits and layer outputs
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)


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
def splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    conf = get_model("NFM")[1]["data"]
    data = {"low_rating_thres": conf["low_rating_thres"]}
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k", config=dict(data)).build(**conf)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k", config=dict(data)).build(**conf)
    return ours, theirs


_BUILT = {}


def _draw_state(params, batch_stats, seed=WEIGHT_SEED):
    """Numpy weights N(0, 0.1) in ``params``' layout (token tables' row 0
    zero, batch-norm scales near 1) and calibrated-looking statistics."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(1.0 if name == "scale" else 0.0, 0.1, leaf.shape).astype(np.float32)
        if name.endswith("_embedding") and name != "dense_embedding":
            a[0] = 0.0
        return a

    def stat(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "count":
            return np.float32(4.0)
        if name == "var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        return rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
    return (jax.tree_util.tree_map_with_path(draw, params),
            jax.tree_util.tree_map_with_path(stat, batch_stats))


def _models(name, splits):
    """The JAX and the port's ``name`` on the same split, dropout off, both
    holding the same drawn weights and statistics (fresh at each call)."""
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
            conf["model"]["dropout"] = 0.0
            out.append((cls, conf))
        (jcls, jconf), (cls, conf) = out
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_variables = jax.jit(jmodel._init_variables)
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
    model.load_state_dict(ranker_params_from_jax(params, model.embed_dim, batch_stats=stats))
    model._calib_batches = None
    return jmodel, model


def _batch(trn, start=0):
    n = len(trn.data_index)
    return trn._get_pos_batch((np.arange(start, start + ROWS) * (n // ROWS)) % n)


def _assert_tree(got, want, tol, tag):
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree(got[key], want[key], tol, f"{tag}/{key}")
            continue
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=tol[1],
                                   atol=tol[0] * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{tag}/{key}")
    assert sorted(got) == sorted(want), tag


def _zero_counts(jmodel, model):
    import jax
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    if "net" in jmodel.states:
        jmodel.states["net"] = jax.tree_util.tree_map_with_path(
            lambda p, v: v * 0 if str(getattr(p[-1], "key", "")) == "count" else v,
            jmodel.states["net"])
    for m in model.net.modules():
        if isinstance(m, SimpleBatchNorm):
            m.count.zero_()


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name, splits):
    """Logits in evaluation (calibrated statistics, then the batch's with
    the counts at 0) and in training."""
    import jax
    import jax.numpy as jnp
    jmodel, model = _models(name, splits)
    batch = _batch(splits[0][0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    score = jax.jit(jmodel.score, static_argnames=("training",))
    with jax.default_matmul_precision("float32"):
        for tag in ("calibrated", "uncalibrated", "training"):
            if tag == "uncalibrated":
                _zero_counts(jmodel, model)
            training = tag == "training"
            want = np.asarray(score(jmodel.params, jb, training=training,
                                    net_state=jmodel.states.get("net")))
            model.net.train(training)
            with torch.no_grad():
                got = model.score(tb).numpy()
            model.net.eval()
            np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1],
                                       err_msg=tag)


@pytest.mark.parametrize("name", MODELS)
def test_one_step_loss_and_gradients_match_jax(name, splits):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import ranker_params_to_jax
    jmodel, model = _models(name, splits)
    batch = _batch(splits[0][0], 7)
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
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = ranker_params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    want = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    # a Linear's bias that feeds a batch norm in training mode has a zero
    # gradient (the norm subtracts the batch mean), and so has NFM's ``bn``
    # bias, which feeds ``dense_0`` and then ``bn_0``; and an attention's
    # ``k_proj`` bias, which moves every score of a query row by the same
    # amount, which the softmax removes: both packages give float32 noise
    # there, held to be noise, not to each other
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    noise = [("mlp", f"dense_{i}") for i in range(len(want.get("mlp", {})))
             if f"bn_{i}" in want["mlp"]]
    if "bn" in want and "bn_0" in want["mlp"]:
        noise.append(("bn",))
    noise += [(key, "attn", "k_proj") for key in want
              if key.startswith("attn_") and key[5:].isdigit()]
    for path in noise:
        for tree in (grads, want):
            node = tree
            for key in path:
                node = node[key]
            assert float(np.abs(node.pop("bias")).max()) < 1e-6 * largest, path
    _assert_tree(grads, want, TOL_GRAD, f"{name} grad")


@pytest.mark.parametrize("name", BN_MODELS)
def test_refresh_net_state_matches_jax(name, splits):
    import jax
    from recstudio_torch.utils.convert import ranker_batch_stats_to_jax
    jmodel, model = _models(name, splits)
    jmodel._train_data, model._train_data = splits[1][0], splits[0][0]
    with jax.default_matmul_precision("float32"):
        jmodel._refresh_net_state()
    model._refresh_net_state()
    want = jax.tree_util.tree_map(np.asarray, jmodel.states["net"]["batch_stats"])
    got = ranker_batch_stats_to_jax(model.net.state_dict())
    counts = [float(v) for p, v in jax.tree_util.tree_flatten_with_path(want)[0]
              if str(getattr(p[-1], "key", "")) == "count"]
    assert counts and set(counts) == {32.0}
    _assert_tree(got, want, (1e-5, 1e-5), f"{name} batch_stats")
    assert len(model._calib_batches) == 32 and not model.net.training


@pytest.mark.parametrize("name", ("NFM", "AutoInt"))
def test_evaluate_and_score_predictor_match_jax(name, splits):
    import jax
    from recstudio_tpu.serving import ScorePredictor as JaxScorePredictor
    from recstudio_torch.serving import ScorePredictor
    jmodel, model = _models(name, splits)
    tst, jtst = splits[0][2], splits[1][2]
    jmodel._train_data, model._train_data = splits[1][0], splits[0][0]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)        # calibrates (no validation ran)
        rows = tst.data_index[:300]
        request = {f: tst.inter_feat.get_col(f)[rows] for f in ("user_id", "item_id",
                                                                "timestamp")}
        served = JaxScorePredictor(jmodel, max_batch=512, train_data=splits[1][0])(request)
    got = model.evaluate(tst, verbose=False)
    np.testing.assert_allclose(got["auc"], float(want["auc"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["logloss"], float(want["logloss"]), rtol=1e-5)
    pred = ScorePredictor(model, max_batch=512, train_data=splits[0][0])(request)
    np.testing.assert_allclose(pred, served, rtol=0, atol=1e-5)
    tst.use_field = model.fields
    np.testing.assert_allclose(pred, model.predict(tst._get_pos_batch(np.arange(300))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("calibrated", [True, False])
def test_batch_of_one_matches_jax(calibrated, splits):
    """One row: the calibrated statistics, or (count 0) the row's own, whose
    variance is 0."""
    import jax
    jmodel, model = _models("NFM", splits)
    if not calibrated:
        _zero_counts(jmodel, model)
    tst = splits[0][2]
    tst.use_field = model.fields
    for i in (0, 17):
        row = tst._get_pos_batch(np.array([i]))
        with jax.default_matmul_precision("float32"):
            want = jmodel.predict(row)
        np.testing.assert_allclose(model.predict(row), want, rtol=1e-5, atol=1e-6)


def _flax_vars(module, *inputs, seed=0, scale=0.3, **kw):
    import jax
    variables = module.init(jax.random.PRNGKey(seed), *inputs, **kw)
    rng = np.random.default_rng(seed + 11)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(0.0, scale, a.shape), np.float32), variables)


def _load(module, params):
    from recstudio_torch.utils.convert import ranker_params_from_jax
    sd = ranker_params_from_jax(params, 1)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected and not [m for m in missing if not m.endswith(("mean", "var", "count"))]


def test_cross_network_matches_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.module.ctr import CrossNetwork as JaxCross
    from recstudio_torch.models.module.ctr import CrossNetwork
    x = np.random.default_rng(0).normal(size=(16, 12)).astype(np.float32)
    jc = JaxCross(12, 3)
    variables = _flax_vars(jc, jnp.asarray(x))
    cross = CrossNetwork(12, 3)
    _load(cross, variables["params"])
    assert sorted(n for n, _ in cross.named_parameters()) == sorted(
        f"{k}_{i}" for k in "wb" for i in range(3))
    np.testing.assert_allclose(cross(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jc.apply(variables, jnp.asarray(x))), **dict(
                                   atol=TOL_OUT[0], rtol=TOL_OUT[1]))


MHA_CASES = ["none", "padding", "causal", "per-example", "weights"]


@pytest.mark.parametrize("case", MHA_CASES)
def test_multi_head_attention_matches_jax(case, monkeypatch):
    """Both routes against the flax module (which on the CPU computes the
    plain softmax): the fused route, ``fused_mha`` (its plain version on a
    CPU tensor), where the JAX gate sends the heads there, else the plain
    softmax; and ``plain = True`` everywhere."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import MultiHeadAttention as JaxMha
    from recstudio_torch.models.module import layers
    B, L, d, H = 6, 9, 16, 2
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, L, d)).astype(np.float32) for _ in range(3))
    pad = np.arange(L)[None, :] >= rng.integers(1, L + 1, size=B)[:, None]
    attn = np.triu(np.ones((L, L), bool), 1)
    kw = {"none": {}, "padding": {"key_padding_mask": pad}, "causal": {"attn_mask": attn},
          "per-example": {"attn_mask": np.broadcast_to(attn, (B, L, L)).copy(),
                          "key_padding_mask": pad},
          "weights": {"key_padding_mask": pad, "need_weight": True}}[case]
    jm = JaxMha(d, H)
    variables = _flax_vars(jm, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    with jax.default_matmul_precision("float32"):
        want = jm.apply(variables, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    mha = layers.MultiHeadAttention(d, H)
    _load(mha, variables["params"])
    calls = []
    real = layers.fused_mha
    monkeypatch.setattr(layers, "fused_mha", lambda *a: calls.append(1) or real(*a))
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    for plain in (False, True):
        mha.plain = plain
        with torch.no_grad():
            got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
        if case == "weights":
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6,
                                       rtol=1e-5)
            got, want_out = got[0], want[0]
        else:
            want_out = want
        np.testing.assert_allclose(got.numpy(), np.asarray(want_out), atol=TOL_OUT[0],
                                   rtol=TOL_OUT[1], err_msg=f"plain={plain}")
    assert len(calls) == (0 if case in ("per-example", "weights") else 1)


def test_attention_layer_multi_head_matches_jax():
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import AttentionLayer as JaxAttention
    from recstudio_torch.models.module.layers import AttentionLayer
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 3, 8)).astype(np.float32)
    kv = rng.normal(size=(5, 7, 12)).astype(np.float32)
    pad = np.arange(7)[None, :] >= rng.integers(1, 8, size=5)[:, None]
    ja = JaxAttention(8, k_dim=12, v_dim=12, n_head=2, attention_type="multi-head")
    variables = _flax_vars(ja, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    with jax.default_matmul_precision("float32"):
        want = ja.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                        key_padding_mask=jnp.asarray(pad))
    layer = AttentionLayer(8, k_dim=12, v_dim=12, n_head=2, attention_type="multi-head")
    _load(layer, variables["params"])
    with torch.no_grad():
        got = layer(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                    key_padding_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_OUT[0],
                               rtol=TOL_OUT[1])


@pytest.mark.parametrize("residual,residual_project,layer_norm",
                         [(True, True, False), (True, False, True), (False, True, False)])
def test_self_attention_interacting_layer_matches_jax(residual, residual_project, layer_norm):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.ctr import SelfAttentionInteractingLayer as JaxSail
    from recstudio_torch.models.module.ctr import SelfAttentionInteractingLayer
    x = np.random.default_rng(3).normal(size=(8, 11, 16)).astype(np.float32)
    js = JaxSail(16, 2, 0.0, residual, residual_project, layer_norm)
    variables = _flax_vars(js, jnp.asarray(x))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(js.apply(variables, jnp.asarray(x)))
    layer = SelfAttentionInteractingLayer(16, 2, 0.0, residual, residual_project, layer_norm)
    _load(layer, variables["params"])
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1])


def test_k3_jax_kernel_at_autoint_shape_matches_mha_plain():
    """The JAX attention kernel (Pallas in interpret mode) at AutoInt's
    criteo shape: 39 fields, 2 heads, Dh 32, no mask."""
    import jax.numpy as jnp
    from recstudio_tpu.ops.attention import fused_mha as jax_fused_mha
    from recstudio_torch.ops import mha_plain
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(3, 2, 39, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = mha_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_autoint_routes_attention_as_the_jax_gate(splits, monkeypatch):
    """Training with dropout 0.5 takes the plain softmax (dropout on the
    weights, seeds from the model's generator: a step repeats from the same
    generator state); evaluation takes ``fused_mha``, once a layer."""
    from recstudio_torch.models.module import layers
    _, model = _models("AutoInt", splits)
    calls = []
    real = layers.fused_mha
    monkeypatch.setattr(layers, "fused_mha", lambda *a: calls.append(1) or real(*a))
    batch = {k: torch.from_numpy(v) for k, v in _batch(splits[0][0]).items()}
    attn = [m for m in model.net.modules() if isinstance(m, layers.MultiHeadAttention)]
    assert len(attn) == model.config["model"]["num_attention_layers"] == 3
    for m in attn:
        m.dropout = 0.5
    try:
        state = model.generator.get_state()
        model.net.train()
        with torch.no_grad():
            a = model.training_step(batch)
            model.generator.set_state(state)
            b = model.training_step(batch)
        assert calls == [] and float(a) == float(b)
        model.net.eval()
        with torch.no_grad():
            model.score(batch)
        assert len(calls) == 3
    finally:
        for m in attn:
            m.dropout = 0.0
        model.net.eval()


@pytest.mark.parametrize("name", MODELS)
def test_quickstart_one_epoch_learns_on_cpu(name, tmp_path):
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    from recstudio_torch.quickstart import run
    with open(os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")) as f:
        ref = json.load(f)
    model, (trn, val, tst), out = run(
        name, "ml-100k", device="cpu", verbose=False,
        model_config={"train": {"epochs": 1, "batch_size": 2048}, "model": {"dropout": 0.0},
                      "eval": {"save_path": str(tmp_path)}})
    assert len(model.epoch_log) == 1 and "auc" in model.epoch_log[0]
    assert np.isfinite(out["logloss"]) and ref["untrained_auc"] < out["auc"] < 1
    counts = [float(m.count) for m in model.net.modules() if isinstance(m, SimpleBatchNorm)]
    assert counts == ([32.0] * {"WideDeep": 3, "DCN": 3, "NFM": 4, "AutoInt": 0}[name])


@pytest.mark.parametrize("name", MODELS)
def test_training_reference_file(name):
    """Phase X's bands can fail: each clears the untrained AUC by
    ``AUC_MARGIN``, from six JAX seeds at the repo's config, for at most
    the epochs ``scripts/torch_ctr_seeds.py`` caps the runs at."""
    import importlib.util
    from recstudio_torch.utils import get_model
    spec = importlib.util.spec_from_file_location(
        "torch_ctr_seeds", os.path.join(REPO, "scripts", "torch_ctr_seeds.py"))
    seeds_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeds_script)
    with open(os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")) as f:
        ref = json.load(f)
    tc = get_model(name)[1]["train"]
    assert (ref["epochs"], ref["early_stop_patience"]) == (seeds_script.ML100K_EPOCHS[name],
                                                          tc["early_stop_patience"])
    assert ref["metric"] == "auc" and [r["seed"] for r in ref["runs"]] == list(SEEDS)
    aucs = [r["auc"] for r in ref["runs"]]
    spread = max(aucs) - min(aucs)
    assert ref["auc_band"] == [min(aucs) - spread, max(aucs) + spread]
    assert ref["untrained_auc"] == max(r["untrained_auc"] for r in ref["runs"])
    assert ref["untrained_auc"] + AUC_MARGIN < ref["auc_band"][0] < ref["auc_band"][1] < 1
    assert all(0 <= r["best_epoch"] < ref["epochs"] for r in ref["runs"])
