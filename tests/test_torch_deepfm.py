"""DeepFM, FM and LR: the port's ranker path against the JAX package.

On ml-100k under the fm family's config (``fmeval``, ratings binarized at
3.0), both packages hold the same numpy weights (``ranker_params_from_jax``)
and see the same batch:

- three Adam steps of each model, dropout off: at every step the logits
  agree to 1e-5 absolute + 1e-5 relative, the loss to 1e-5 relative and
  every gradient to 1e-4 of its largest magnitude + 1e-3 relative
  (``chip_smoke``'s ``grad_errors`` tolerance); DeepFM also under
  ``sparse_adam`` (the port's dense ``LazyAdam``) against the JAX package's
  dense lazy Adam (``sparse_rows: "false"``), its moments after the steps
  to 1e-5 of their largest magnitude;
- on an id-less criteo-layout split (4,000 rows, 13 float and 4 token
  fields, no user or item id: phase R's path at a small size), each
  model's logits, loss and gradients at the same tolerances, the port
  given the JAX weights at each of three Adam steps;
- ``evaluate``'s AUC (to 1e-6) and logloss (to 1e-5 relative), and
  ``ScorePredictor``'s probabilities against the JAX ``ScorePredictor``'s
  (to 1e-5) and against ``predict``;
- a short ``quickstart.run("DeepFM", "ml-100k")`` on the CPU (one epoch
  at batch 2048, dropout off: the plain Philox masks are most of a CPU
  epoch) reaches a finite test AUC above the ``untrained`` value of its
  JAX band; the MLP's dropout draws its masks from the model's generator,
  so a step repeats exactly from the same generator state.

``{deepfm,fm,lr}_ml100k_train_reference.json`` hold the JAX package's test
AUC after ``quickstart.run(name, "ml-100k")`` at the repo's config (early
stopping on validation AUC, patience 10) for three seeds;
``deepfm_criteo1m_train_reference.json`` the JAX DeepFM's test AUC and
logloss after each of ``CRITEO_EPOCHS`` epochs at phase R's setup
(``generate_ctr("criteo-1m-shape")``, batch 8192) for five seeds.
``chip_smoke.py`` holds the card's runs to the bands they span. Rewrite
them with ``JAX_PLATFORMS=cpu python tests/test_torch_deepfm.py [DeepFM FM
LR criteo]`` (the 1M-row runs take several minutes, the ml-100k runs a
few, the seeds in parallel).
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
MODELS = ("DeepFM", "FM", "LR")
REF_SEEDS = (2022, 2023, 2024)

# phase R's data: the JAX bench's ctr_scale setup (scripts/scale_bench.py)
CRITEO_SHAPE = "criteo-1m-shape"
CRITEO_ROWS = 1_000_000
CRITEO_DATA_SEED = 11
CRITEO_SPLIT_SEED = 11
CRITEO_BUILD = dict(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
CRITEO_TRAIN = dict(epochs=1, batch_size=8192, learner="adam", learning_rate=1e-3)
CRITEO_EVAL = dict(batch_size=8192, val_metrics=["auc"], test_metrics=["auc", "logloss"])
# the band is read after CRITEO_EPOCHS epochs, where the seeds agree (after
# one they lie 0.60 to 0.71 apart), and must clear the untrained AUC by
# AUC_MARGIN, so that a model that does not learn falls outside it
CRITEO_EPOCHS = 5
CRITEO_SEEDS = (2022, 2023, 2024, 2025, 2026)
AUC_MARGIN = 0.1


def train_reference(name: str) -> str:
    return os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")


CRITEO_REFERENCE = os.path.join(ASSETS, "deepfm_criteo1m_train_reference.json")


def jax_training_run(name: str, seed: int):
    """One JAX ``quickstart.run(name, "ml-100k")`` at the repo's config, and
    the test AUC of the same seed's untrained model."""
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model as jax_get_model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model, (trn, _, tst), out = run(name, "ml-100k", verbose=False,
                                        model_config={"train": {"seed": seed},
                                                      "eval": {"save_path": tmp}})
        fit_s = time.time() - t0
        cls, conf = jax_get_model(name)
        conf["train"].update(seed=seed)
        conf["eval"]["save_path"] = tmp
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        before = untrained.evaluate(tst, verbose=False)
    return {"seed": seed, "fit_s": fit_s, "auc": float(out["auc"]),
            "logloss": float(out["logloss"]),
            "best_epoch": int(model.callback.best_epoch),
            "untrained_auc": float(before["auc"])}


def jax_criteo_run(seed: int, data_dir: str, n_rows: int = CRITEO_ROWS):
    """The JAX DeepFM at the ``ctr_scale`` setup on the rows
    ``generate_ctr`` writes to ``data_dir``: ``fit(train, None)`` for one
    epoch, then ``CRITEO_EPOCHS - 1`` more epochs, the test AUC and logloss
    after each; and the test AUC and logloss of the same seed's untrained
    model."""
    from recstudio_tpu.data import TripletDataset
    from recstudio_tpu.data.synthetic import ctr_shape_vocabs, generate_ctr
    from recstudio_tpu.utils import get_model as jax_get_model
    name, config = generate_ctr(CRITEO_SHAPE, n_rows, out_dir=data_dir, seed=CRITEO_DATA_SEED,
                                vocabs=ctr_shape_vocabs(CRITEO_SHAPE))
    config["save_cache"] = False
    np.random.seed(CRITEO_SPLIT_SEED)
    trn, _, tst = TripletDataset(name, config=config).build(**CRITEO_BUILD)
    cls, conf = jax_get_model("DeepFM")
    conf["train"].update(CRITEO_TRAIN, seed=seed, device_data_budget=6 << 30)

    def test_metrics(model):
        return {k: float(v) for k, v in model.evaluate(tst, verbose=False).items()}
    with tempfile.TemporaryDirectory() as tmp:
        conf["eval"].update(CRITEO_EVAL, save_path=tmp)
        model = cls(conf)
        t0 = time.time()
        model.fit(trn, None)
        log = [{"epochs": 1, **test_metrics(model)}]
        for n in range(1, CRITEO_EPOCHS):
            model.training_epoch(n)
            log.append({"epochs": n + 1, **test_metrics(model)})
        fit_s = time.time() - t0
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        before = test_metrics(untrained)
    return {"seed": seed, "fit_s": fit_s, "auc": log[-1]["auc"], "logloss": log[-1]["logloss"],
            "untrained_auc": before["auc"], "untrained_logloss": before["logloss"], "log": log}


SPLIT_SEED = 42
WEIGHT_SEED = 5
# the id-less CTR split of the steps test: criteo's 13 float fields, 4 token fields
CTR_ROWS = 4000
CTR_KW = dict(n_float=13, vocabs=(1600, 300, 40, 6))
ROWS = 512
TOL_OUT = (1e-5, 1e-5)     # (atol, rtol) of logits
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these shapes gain nothing from more, and other
    test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    conf = get_model("DeepFM")[1]["data"]
    data = {"low_rating_thres": conf["low_rating_thres"]}
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k", config=dict(data)).build(**conf)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k", config=dict(data)).build(**conf)
    return ours, theirs


@pytest.fixture(scope="module")
def ctr_splits(tmp_path_factory):
    """The criteo layout at a small size (``CTR_ROWS`` rows, 13 float and 4
    token fields, no user or item id), read by both packages from the
    file the JAX generator writes (``test_torch_ranker_data`` holds the
    two generators' files equal)."""
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_tpu.data.synthetic import generate_ctr
    from recstudio_torch.data import TripletDataset
    name, config = generate_ctr("ctr-idless", CTR_ROWS, seed=0, **CTR_KW,
                                out_dir=str(tmp_path_factory.mktemp("ctr")))
    config["save_cache"] = False
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset(name, config=dict(config)).build(**CRITEO_BUILD)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset(name, config=dict(config)).build(**CRITEO_BUILD)
    return ours, theirs


def _random_tree(params):
    """``params``' layout with every leaf drawn from numpy, N(0, 0.1); token
    tables' row 0 is 0, as the JAX initialisation leaves it."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(WEIGHT_SEED)

    def draw(path, leaf):
        a = rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("_embedding") and name != "dense_embedding":
            a[0] = 0.0
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(draw, params)


_BUILT = {}


def _models(name, splits, learner="adam"):
    """The JAX and the port's ``name`` on the same split (ml-100k's or the
    id-less CTR one), holding the same numpy weights, dropout off, the
    port's optimizer ``learner``'s. Each pair is built once a test process
    and dataset (the JAX initialisation is the slow part) and given fresh
    weights at every call."""
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax
    ours, theirs = splits
    key = (name, ours[0].name)
    if key not in _BUILT:
        out = []
        for getter in (jax_get_model, get_model):
            cls, conf = getter(name)
            conf["train"].update(sparse_rows="false")
            if "dropout" in conf["model"]:
                conf["model"]["dropout"] = 0.0
            out.append((cls, conf))
        (jcls, jconf), (cls, conf) = out
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_variables = jax.jit(jmodel._init_variables)   # one compile, not eager
        jmodel._init_parameter(theirs[0])
        jmodel.val_check = False
        model = cls(conf, device="cpu")
        model._init_model(ours[0])
        _BUILT[key] = (jmodel, model, _random_tree(jmodel.params))
    jmodel, model, tree = _BUILT[key]
    jmodel.params = tree
    jmodel.config["train"]["learner"] = model.config["train"]["learner"] = learner
    model.load_state_dict(ranker_params_from_jax(tree, model.embed_dim))
    model.optimizer = None
    return jmodel, model


def _batch(trn):
    n = len(trn.data_index)
    return trn._get_pos_batch(np.arange(0, n, n // ROWS)[:ROWS])


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


def _three_steps(jmodel, model, batch, learner, follow_jax=False):
    """Three optimizer steps of both packages on ``batch``, the logits, loss
    and gradients held at each. With ``follow_jax`` the port is given the
    JAX weights before each step and takes none of its own: its function
    and gradient are held at three points of the JAX trajectory."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    opt = jmodel._make_optax(learner, 1e-3)
    params, state = jmodel.params, opt.init(jmodel.params)
    model.optimizer = model._get_optimizer()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # jitted: eager JAX compiles each of its few hundred operations alone
    score = jax.jit(jmodel.score)
    loss_and_grads = jax.jit(jax.value_and_grad(jmodel._loss_and_aux, has_aux=True))
    grad_step = jax.jit(lambda p, s, b, r: jmodel._grad_step(opt, p, s, b, r, jmodel.states))
    with jax.default_matmul_precision("float32"):
        for i in range(3):
            if follow_jax:
                model.load_state_dict(ranker_params_from_jax(params, model.embed_dim))
            want = np.asarray(score(params, jbatch))
            with torch.no_grad():
                got = model.score(tbatch).numpy()
            np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1],
                                       err_msg=f"logits {i}")
            (jloss, _), jgrads = loss_and_grads(params, jbatch, jax.random.PRNGKey(i),
                                                jmodel.states)
            model.net.train()
            if follow_jax:
                model.net.zero_grad(set_to_none=True)
                loss = model.training_step(tbatch)
                loss.backward()
                loss = loss.detach()
                zero_pad_rows_in_grads(model.net)
            else:
                loss = model._grad_step(tbatch)
            model.net.eval()
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"loss {i}")
            grads = ranker_params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
            _assert_tree(grads, jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads)),
                         TOL_GRAD, f"grad {i}")
            params, state, _ = grad_step(params, state, jbatch, jax.random.PRNGKey(i))
    return params, state


@pytest.mark.parametrize("name", MODELS)
def test_three_adam_steps_match_jax(name, splits):
    jmodel, model = _models(name, splits)
    assert model.config["train"]["learner"] == "adam"
    _three_steps(jmodel, model, _batch(splits[0][0]), "adam")


@pytest.mark.parametrize("name", MODELS)
def test_three_adam_steps_match_jax_without_ids(name, ctr_splits):
    """Phase R's path at a small size: no user or item id, 13 float fields
    through the one shared ``dense_embedding`` kernel (unscaled lognormal
    values), 4 token fields through the fused table. The port follows the
    JAX weights: the lognormals saturate DeepFM's tanh units, whose
    gradients of a few 1e-9 the two packages round some 10 % apart (1e-7
    of the largest, inside the tolerance), and Adam's first steps divide
    each gradient by its own size, so such a weight moves 1.4e-5 apart and
    the logits after it 2e-5. The port's Adam is held by the ml-100k
    trajectories above."""
    jmodel, model = _models(name, ctr_splits)
    assert model.fuid is None and model.fiid is None
    shapes = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    tables = 1 if name == "LR" else 2                  # the first-order tree's, the embedder's
    assert sorted(v for k, v in shapes.items() if k.endswith("dense_embedding")) == sorted(
        [(13, 1), (13, model.embed_dim)][:tables])
    assert sum(k.endswith("token_embedding.weight") for k in shapes) == tables
    _three_steps(jmodel, model, _batch(ctr_splits[0][0]), "adam", follow_jax=True)


def test_three_sparse_adam_steps_match_jax(splits):
    from recstudio_torch.models.optim import LazyAdam
    from recstudio_torch.utils.convert import ranker_params_to_jax
    jmodel, model = _models("DeepFM", splits, "sparse_adam")
    assert not jmodel._ctr_sparse_enabled()            # sparse_rows "false": dense lazy Adam
    _, state = _three_steps(jmodel, model, _batch(splits[0][0]), "sparse_adam")
    assert isinstance(model.optimizer, LazyAdam)
    (inner,) = state
    assert model.optimizer.param_groups[0]["count"] == int(inner.count) == 3
    for key, tree in (("mu", inner.mu), ("nu", inner.nu)):
        got = ranker_params_to_jax({n: model.optimizer.moments(p)[0 if key == "mu" else 1]
                                    for n, p in model.net.named_parameters()})
        _assert_tree(got, tree, (1e-5, 1e-3), key)


def test_model_layout(splits):
    from recstudio_torch.models.loss_func import BCEWithLogitLoss
    _, model = _models("DeepFM", splits)
    assert isinstance(model.loss_fn, BCEWithLogitLoss)
    batch = {k: torch.from_numpy(v) for k, v in _batch(splits[0][0]).items()}
    model.net.mlp.dropout = 0.3
    try:
        state = model.generator.get_state()
        model.net.train()
        with torch.no_grad():
            a = model.training_step(batch)
            model.generator.set_state(state)
            b = model.training_step(batch)
            model.net.eval()
            c = model.training_step(batch)
    finally:
        model.net.mlp.dropout = 0.0
        model.net.eval()
    assert float(a) == float(b) != float(c)
    assert [s[0] for s in model.net.embedding.field_specs] == [
        "age", "gender", "item_id", "occupation", "timestamp", "user_id", "zip_code"]
    assert model.net.mlp.dense_0.weight.shape == (256, 70)
    assert model.net.embedding.token_embedding.weight.shape[1] == 10


@pytest.fixture
def eval_pair(splits):
    jmodel, model = _models("DeepFM", splits)
    return jmodel, model, splits[0][2], splits[1][2]


def test_evaluate_matches_jax(eval_pair):
    import jax
    jmodel, model, tst, jtst = eval_pair
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
    got = model.evaluate(tst, verbose=False)
    assert sorted(got) == sorted(want) == ["auc", "logloss"]
    np.testing.assert_allclose(got["auc"], float(want["auc"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["logloss"], float(want["logloss"]), rtol=1e-5)


def test_score_predictor_matches_jax(eval_pair, splits):
    import jax
    from recstudio_tpu.serving import ScorePredictor as JaxScorePredictor
    from recstudio_torch.serving import ScorePredictor
    jmodel, model, tst, _ = eval_pair
    rows = tst.data_index[:200]
    request = {f: tst.inter_feat.get_col(f)[rows] for f in ("user_id", "item_id", "timestamp")}
    with jax.default_matmul_precision("float32"):
        want = JaxScorePredictor(jmodel, max_batch=256, train_data=splits[1][0])(request)
    pred = ScorePredictor(model, max_batch=256, train_data=splits[0][0]).warm(request)
    got = pred(request)
    assert got.shape == (200,) and pred.stats()["requests"] == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    tst.use_field = model.fields                     # as evaluate() sets it
    full = tst._get_pos_batch(np.arange(200))
    np.testing.assert_allclose(got, model.predict(full), rtol=0, atol=1e-6)


def test_unported_ranker_cases_raise(splits):
    from recstudio_torch.utils import get_model
    cls, conf = get_model("DeepFM")
    with pytest.raises(NotImplementedError, match="retriever"):
        cls(conf, device="cpu", retriever=object())
    conf["train"].update(learner="sparse_adam", sparse_rows="true")
    with pytest.raises(NotImplementedError, match="row-sparse"):
        cls(conf, device="cpu")
    _, model = _models("DeepFM", splits)
    with pytest.raises(NotImplementedError, match="rank metrics"):
        model._eval_epoch(splits[0][1], ["auc", "ndcg"], [10])
    from recstudio_torch.serving import ScorePredictor
    bpr, bconf = get_model("BPR")
    with pytest.raises(NotImplementedError, match="serves rankers"):
        ScorePredictor(bpr(bconf, device="cpu"))


def test_ranker_weights_from_jax_packed_table():
    """A packed ``[N, 3D]`` table (params | mu | nu) gives its first D
    columns; the linear tree's tables are 1 wide."""
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    rng = np.random.default_rng(0)
    tree = {"embedding": {"token_embedding": rng.normal(size=(9, 12)).astype(np.float32),
                          "dense_embedding": rng.normal(size=(3, 4)).astype(np.float32)},
            "linear": {"embedding": {"token_embedding": rng.normal(size=(9, 3)),
                                     "f_dense": {"weight": {"kernel": np.ones((1, 1))}}},
                       "bias": np.zeros(1)},
            "mlp": {"dense_0": {"kernel": rng.normal(size=(5, 2)), "bias": np.ones(2)}}}
    sd = ranker_params_from_jax(tree, 4)
    np.testing.assert_array_equal(sd["embedding.token_embedding.weight"],
                                  tree["embedding"]["token_embedding"][:, :4])
    assert sd["linear.embedding.token_embedding.weight"].shape == (9, 1)
    assert sd["mlp.dense_0.weight"].shape == (2, 5)
    assert sd["linear.embedding.f_dense.weight.weight"].shape == (1, 1)
    back = ranker_params_to_jax(sd)
    np.testing.assert_allclose(back["mlp"]["dense_0"]["kernel"], tree["mlp"]["dense_0"]["kernel"],
                               rtol=1e-6)
    assert back["embedding"]["dense_embedding"].shape == (3, 4)


def test_quickstart_deepfm_learns_on_cpu(tmp_path):
    from recstudio_torch.quickstart import run
    with open(train_reference("DeepFM")) as f:
        ref = json.load(f)
    model, (trn, val, tst), out = run(
        "DeepFM", "ml-100k", device="cpu", verbose=False,
        model_config={"train": {"epochs": 1, "batch_size": 2048}, "model": {"dropout": 0.0},
                      "eval": {"save_path": str(tmp_path)}})
    assert trn.fmeval and len(model.epoch_log) == 1 and "auc" in model.epoch_log[0]
    assert sorted(out) == ["auc", "logloss"] and np.isfinite(out["logloss"])
    assert ref["untrained_auc"] < out["auc"] < 1


@pytest.mark.parametrize("name", MODELS)
def test_training_reference_file(name):
    from recstudio_torch.utils import get_model
    with open(train_reference(name)) as f:
        ref = json.load(f)
    tc = get_model(name)[1]["train"]
    assert ref["epochs"] == tc["epochs"] and ref["early_stop_patience"] == tc.get(
        "early_stop_patience", 10)
    assert ref["metric"] == "auc" and [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    assert ref["auc_band"] == _band(ref["runs"])
    assert 0.5 < ref["auc_band"][0] < ref["auc_band"][1] < 1
    assert all(0 <= r["best_epoch"] < ref["epochs"] for r in ref["runs"])
    assert ref["untrained_auc"] == max(r["untrained_auc"] for r in ref["runs"])


def test_criteo_reference_file():
    """Phase R's bands can fail: the AUC band sits ``AUC_MARGIN`` above the
    untrained AUC, the logloss band below every seed's untrained logloss
    (2 to 10: the unscaled lognormal floats)."""
    with open(CRITEO_REFERENCE) as f:
        ref = json.load(f)
    assert (ref["rows"], ref["epochs"], ref["batch_size"]) == (CRITEO_ROWS, CRITEO_EPOCHS, 8192)
    assert ref["metric"] == "auc" and [r["seed"] for r in ref["runs"]] == list(CRITEO_SEEDS)
    assert ref["auc_band"] == _band(ref["runs"])
    assert ref["logloss_band"] == _band(ref["runs"], "logloss")
    assert ref["untrained_auc"] == max(r["untrained_auc"] for r in ref["runs"])
    for r in ref["runs"]:
        assert [e["epochs"] for e in r["log"]] == list(range(1, CRITEO_EPOCHS + 1))
        assert (r["auc"], r["logloss"]) == (r["log"][-1]["auc"], r["log"][-1]["logloss"])
    lo, hi = ref["auc_band"]
    assert ref["untrained_auc"] + AUC_MARGIN < lo < hi < 1
    assert 0 < ref["logloss_band"][0] < ref["logloss_band"][1] < min(
        r["untrained_logloss"] for r in ref["runs"])


_ABOUT = {
    "DeepFM": "embed_dim 10, MLP [256, 256, 256], tanh, dropout 0.3",
    "FM": "embed_dim 10",
    "LR": "first-order terms only",
}


def _band(runs, key="auc"):
    vals = [r[key] for r in runs]
    spread = max(vals) - min(vals)
    return [min(vals) - spread, max(vals) + spread]


def _write(path, ref):
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--run"]:      # one run: print it as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            if sys.argv[2] == "criteo":
                print(json.dumps(jax_criteo_run(int(sys.argv[3]), sys.argv[4])))
            else:
                print(json.dumps(jax_training_run(sys.argv[2], int(sys.argv[3]))))
        sys.exit(0)
    import subprocess
    from recstudio_tpu.utils import get_model
    names = sys.argv[1:] or list(MODELS) + ["criteo"]

    def spawn(jobs):
        procs = {k: subprocess.Popen([sys.executable, __file__, "--run", *map(str, k)],
                                     stdout=subprocess.PIPE, text=True, cwd=REPO)
                 for k in jobs}
        return {k: json.loads(p.communicate()[0].strip().splitlines()[-1])
                for k, p in procs.items()}

    if "criteo" in names:
        from recstudio_tpu.data.synthetic import ctr_shape_vocabs, generate_ctr
        with tempfile.TemporaryDirectory() as data_dir:
            generate_ctr(CRITEO_SHAPE, CRITEO_ROWS, out_dir=data_dir, seed=CRITEO_DATA_SEED,
                         vocabs=ctr_shape_vocabs(CRITEO_SHAPE))
            out = spawn([("criteo", s, data_dir) for s in CRITEO_SEEDS])
        runs = [out[("criteo", s, data_dir)] for s in CRITEO_SEEDS]
        _write(CRITEO_REFERENCE, {
            "about": "recstudio_tpu DeepFM at the repo's config (embed_dim 10, MLP [256, 256, "
                     "256], tanh, dropout 0.3) on generate_ctr('criteo-1m-shape', 1,000,000 "
                     "rows, seed 11, ctr_shape_vocabs), build(fmeval, split_mode entry, "
                     "[0.8, 0.1, 0.1]) after np.random.seed(11); batch 8192, adam 1e-3: "
                     "fit(train, None) for one epoch, then training_epoch for "
                     f"{CRITEO_EPOCHS - 1} more, evaluate(test) at eval batch 8192 after each "
                     "epoch (log), JAX on the CPU at the full 1,000,000 rows; metric = test "
                     f"AUC after {CRITEO_EPOCHS} epochs; bands = seeds' range widened by their "
                     "spread; untrained = the largest test AUC of the seeds' models before fit",
            "rows": CRITEO_ROWS, "epochs": CRITEO_EPOCHS,
            "batch_size": CRITEO_TRAIN["batch_size"], "metric": "auc", "runs": runs,
            "auc_band": _band(runs), "logloss_band": _band(runs, "logloss"),
            "untrained_auc": max(r["untrained_auc"] for r in runs)})
    models = [n for n in names if n in MODELS]
    out = spawn([(n, s) for n in models for s in REF_SEEDS])
    for name in models:
        tc = get_model(name)[1]["train"]
        patience = tc.get("early_stop_patience", 10)
        runs = [out[(name, s)] for s in REF_SEEDS]
        _write(train_reference(name), {
            "about": f"recstudio_tpu {name} on ml-100k at the repo's config ({_ABOUT[name]}; "
                     "fm family: fmeval, ratings binarized at 3.0, low_rating_thres 0.0, "
                     "ratio split [0.8, 0.1, 0.1] per user, batch 512, adam 1e-3, BCE), "
                     f"quickstart.run: fit(train, val) for at most {tc['epochs']} epochs, "
                     f"early stopping on validation AUC with patience {patience} and the "
                     "best epoch's weights restored, then evaluate(test), JAX on the CPU; "
                     "metric = test AUC; band = seeds' range widened by their spread; "
                     "untrained = the largest test AUC of the seeds' models before fit",
            "epochs": tc["epochs"], "early_stop_patience": patience, "metric": "auc",
            "runs": runs, "auc_band": _band(runs),
            "untrained_auc": max(r["untrained_auc"] for r in runs)})
