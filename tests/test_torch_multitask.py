"""Several rating fields and the multitask rankers (HardShare, MMoE, PLE,
AITM): the port against the JAX package.

On a small two-rating file (the columns of ``tests/test_zoo.py``'s
fixture, written with numpy; timestamps at unit scale, since every field
is a feature) under the multitask family's config (``fmeval``, no
binarization):

- the splits, row for row, and their batches;
- with the same numpy weights and the same 16 rows, dropout off: each
  net's per-rating logits in evaluation and in training to 1e-5 absolute
  + 1e-5 relative; one step's loss (each rating's BCE weighted by
  ``softmax(train.weights)``, AITM's calibrator added) to 1e-5 relative
  and every gradient to 1e-4 of its largest value + 1e-3 relative (AITM's
  attention ``k_proj`` bias, which the softmax removes, has a zero
  gradient, held under 1e-6 of the largest as float32 noise in both);
- ``evaluate``'s per-rating metrics, named ``{rating}_{metric}``;
- MMoE's expert dropout: a mask a expert in training, none in evaluation;
- ``ScorePredictor`` and ``predict`` give a dict of probabilities, one a
  rating, where the JAX server cannot serve a multitask ranker;
- a rating threshold binarizes each rating column, where the JAX
  package's frame indexing raises.
"""
import numpy as np
import pytest
import torch

RATINGS = ("click", "like")
SPLIT_SEED = 42
WEIGHT_SEED = 4
ROWS = 16
TOL_OUT = (1e-5, 1e-5)
TOL_GRAD = (1e-4, 1e-3)
MODELS = ("HardShare", "MMoE", "PLE", "AITM")
SMALL = {
    "HardShare": {"bottom_mlp_layer": [16, 8], "top_mlp_layer": [8], "bottom_dropout": 0.0,
                  "top_dropout": 0.0},
    "MMoE": {"num_experts": 3, "expert_mlp_layer": [16, 8], "gate_mlp_layer": [8],
             "tower_mlp_layer": [8], "expert_dropout": 0.0, "gate_dropout": 0.0,
             "tower_dropout": 0.0},
    "PLE": {"num_levels": 2, "specific_experts_per_task": 2, "num_shared_experts": 1,
            "expert_mlp_layer": [16, 8], "gate_mlp_layer": [8], "tower_mlp_layer": [8],
            "expert_dropout": 0.0, "gate_dropout": 0.0, "tower_dropout": 0.0},
    "AITM": {"tower_mlp_layer": [16, 8], "tower_dropout": 0.0},
}


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
def data_config(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("mtl")
    n = 2000
    cols = {"user_id": rng.integers(1, 60, n), "item_id": rng.integers(1, 150, n),
            "click": rng.integers(0, 2, n).astype(float),
            "like": rng.integers(0, 2, n).astype(float),
            "timestamp": np.round(rng.random(n), 6)}
    with open(d / "mtl.inter", "w") as f:
        f.write("\t".join(cols) + "\n")
        f.writelines("\t".join(repr(v) if isinstance(v, float) else str(v) for v in row)
                     + "\n" for row in zip(*(c.tolist() for c in cols.values())))
    return {"url": str(d), "user_id_field": "user_id:token", "item_id_field": "item_id:token",
            "rating_field": ["click:float", "like:float"], "time_field": "timestamp:float",
            "inter_feat_name": "mtl.inter",
            "inter_feat_field": ["user_id:token", "item_id:token", "click:float",
                                 "like:float", "timestamp:float"],
            "inter_feat_header": 0, "user_feat_name": None, "item_feat_name": None,
            "network_feat_name": None}


def _build(module, data_config, **kw):
    from recstudio_torch.utils import get_model
    conf = dict(get_model("MMoE")[1]["data"], **kw)
    np.random.seed(SPLIT_SEED)
    return module.TripletDataset("mtl", config=dict(data_config)).build(**conf)


@pytest.fixture(scope="module")
def splits(data_config):
    from recstudio_tpu import data as jdata
    from recstudio_torch import data
    return _build(data, data_config), _build(jdata, data_config)


def test_splits_match_jax_row_for_row(splits):
    ours, theirs = splits
    assert ours[0].frating == list(RATINGS) and ours[0].fmeval
    for mine, jax_split in zip(ours, theirs):
        np.testing.assert_array_equal(mine.data_index, jax_split.data_index)
        idx = np.arange(len(mine.data_index))
        got, want = mine._get_pos_batch(idx), jax_split._get_pos_batch(idx)
        assert sorted(got) == sorted(want) == sorted(["user_id", "item_id", *RATINGS])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_each_rating_is_binarized(data_config):
    """A rating threshold binarizes every rating column here; the JAX
    package's ``_binarize_rating`` indexes its frame with a frame of
    booleans there, which raises (``ROADMAP.md`` §3, Settled)."""
    from recstudio_tpu import data as jdata
    from recstudio_torch import data
    cfg = dict(data_config)
    raw = data.TripletDataset("mtl", config=dict(cfg))
    want = {r: raw.inter_feat[r].copy() for r in RATINGS}
    ds = data.TripletDataset("mtl", config=dict(cfg))
    ds._binarize_rating(0.5)
    for r in RATINGS:
        np.testing.assert_array_equal(ds.inter_feat[r], np.where(want[r] < 0.5, 0.0, 1.0))
    jds = jdata.TripletDataset("mtl", config=dict(cfg))
    with pytest.raises(Exception):
        jds._binarize_rating(0.5)


_BUILT = {}


def _models(name, splits, weights=None):
    """The JAX and the port's ``name`` at a small width, dropout off, with
    the same numpy weights N(0, 0.3) (fresh at each call)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax
    ours, theirs = splits
    key = (name, tuple(weights or ()))
    if key not in _BUILT:
        out = []
        for getter in (jax_get_model, get_model):
            cls, conf = getter(name)
            conf["model"].update(embed_dim=8, **SMALL[name])
            conf["train"].update(batch_size=ROWS, weights=weights)
            out.append((cls, conf))
        (jcls, jconf), (cls, conf) = out
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_parameter(theirs[0])
        jmodel.val_check = False
        model = cls(conf, device="cpu")
        model._init_model(ours[0])
        rng = np.random.default_rng(WEIGHT_SEED)
        params = jax.tree_util.tree_map(
            lambda a: rng.normal(0.0, 0.3, a.shape).astype(np.float32), jmodel.params)
        _BUILT[key] = (jmodel, model, params)
    jmodel, model, params = _BUILT[key]
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    model.load_state_dict(ranker_params_from_jax(params, model.net))
    return jmodel, model


def _batch(trn, start=0):
    n = len(trn.data_index)
    return trn._get_pos_batch((np.arange(start, start + ROWS) * (n // ROWS)) % n)


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


@pytest.mark.parametrize("name", MODELS)
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
            want = score(jmodel.params, jb, training=training)
            model.net.train(training)
            with torch.no_grad():
                got = model.score(tb)
            model.net.eval()
            assert sorted(got) == sorted(want) == sorted(RATINGS)
            for r in RATINGS:
                np.testing.assert_allclose(got[r].numpy(), np.asarray(want[r]),
                                           atol=TOL_OUT[0], rtol=TOL_OUT[1],
                                           err_msg=f"{name} {r} training={training}")


@pytest.mark.parametrize("name,weights", [(m, [0.3, 1.2]) for m in MODELS]
                         + [("HardShare", None)])
def test_one_step_loss_and_gradients_match_jax(name, weights, splits):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import ranker_params_to_jax
    jmodel, model = _models(name, splits, weights)
    batch = _batch(splits[0][0], 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_and_grads = jax.jit(jax.value_and_grad(jmodel._loss_and_aux, has_aux=True))
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = loss_and_grads(jmodel.params, jb, jax.random.PRNGKey(0),
                                            jmodel.states)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ranker_params_to_jax({n: p.grad for n, p in model.net.named_parameters()}, model.net)
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    for key in [k for k in want if k.startswith("att_")]:
        for tree in (grads, want):
            assert float(np.abs(tree[key]["k_proj"].pop("bias")).max()) < 1e-6 * largest
    _assert_tree(grads, want, TOL_GRAD, f"{name} grad")


def test_aitm_calibrator_reads_the_loss_scores(splits):
    """AITM's loss is the weighted BCE plus ``sum(mean(relu(s_next -
    s_prev)))`` of the scores of the same forward pass."""
    _, model = _models("AITM", splits)
    batch = {k: torch.from_numpy(v) for k, v in _batch(splits[0][0], 1).items()}
    with torch.no_grad():
        scores = model.score(batch)
        want = model._multitask_loss({r: {"pos_score": scores[r], "label": batch[r]}
                                      for r in RATINGS}) \
            + torch.relu(scores["like"] - scores["click"]).mean()
        np.testing.assert_allclose(float(model.training_step(batch)), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["MMoE", "PLE"])
def test_evaluate_per_rating_metrics_match_jax(name, splits):
    import jax
    jmodel, model = _models(name, splits)
    tst, jtst = splits[0][2], splits[1][2]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
    got = model.evaluate(tst, verbose=False)
    names = [f"{r}_{m}" for r in RATINGS for m in ("auc", "logloss")]
    assert sorted(got) == sorted(want) == sorted(names)
    for k in names:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_mmoe_expert_dropout_draws_a_mask_per_expert():
    """With the same weights in every expert, training outputs differ
    from expert to expert and from draw to draw; evaluation's do not."""
    from recstudio_torch.models.multitask.mmoe import ExpertBank
    bank = ExpertBank(4, [12, 16, 8], dropout=0.5)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for i in range(2):
            w = torch.randn(12 if i == 0 else 16, 16 if i == 0 else 8, generator=gen)
            getattr(bank, f"kernel_{i}").copy_(w.expand_as(getattr(bank, f"kernel_{i}")))
        x = torch.randn(6, 12, generator=gen)
        bank.eval()
        a, b = bank(x, gen), bank(x, gen)
        assert torch.equal(a, b) and torch.equal(a[:, 0], a[:, 3])
        bank.train()
        c, d = bank(x, gen), bank(x, gen)
    assert not torch.equal(c, d)
    assert not torch.equal(c[:, 0], c[:, 1])


def test_score_predictor_returns_each_ratings_probabilities(splits):
    """``ScorePredictor`` and ``predict`` give ``{rating: probabilities}``,
    ``evaluate``'s scores; the JAX server reads one array and raises on a
    multitask ranker (``ROADMAP.md`` §3, Settled)."""
    import jax
    from recstudio_tpu.serving import ScorePredictor as JaxScorePredictor
    from recstudio_torch.serving import ScorePredictor
    jmodel, model = _models("MMoE", splits)
    tst = splits[0][2]
    tst.use_field = model.fields
    rows = tst._get_pos_batch(np.arange(40))
    request = {f: rows[f] for f in ("user_id", "item_id", "timestamp")}
    pred = ScorePredictor(model, max_batch=64, train_data=splits[0][0]).warm(request)
    served = pred(request)
    assert sorted(served) == sorted(RATINGS)
    predicted = model.predict(rows)
    with torch.no_grad():
        logits = model.score({k: torch.from_numpy(v) for k, v in rows.items()})
    with jax.default_matmul_precision("float32"):
        want = jmodel.score(jmodel.params, {k: jax.numpy.asarray(v) for k, v in rows.items()})
    for r in RATINGS:
        assert served[r].shape == (40,)
        np.testing.assert_allclose(served[r], predicted[r], rtol=0, atol=1e-7)
        np.testing.assert_allclose(served[r], torch.sigmoid(logits[r]).numpy(), atol=1e-7)
        np.testing.assert_allclose(served[r], 1 / (1 + np.exp(-np.asarray(want[r]))),
                                   atol=1e-6)
    with pytest.raises(Exception):
        JaxScorePredictor(jmodel, max_batch=64, train_data=splits[1][0])(request)


def test_a_multitask_model_needs_several_ratings(splits):
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    cls, conf = get_model("MMoE")
    conf["model"].update(embed_dim=8, **SMALL["MMoE"])
    trn = TripletDataset("ml-100k").build(**conf["data"])[0]
    with pytest.raises(ValueError, match="list-valued rating_field"):
        cls(conf, device="cpu")._init_model(trn)


def test_a_multitask_ranker_takes_no_retriever(splits):
    """As the JAX forward asserts (``baseranker.py:398-399``), when the
    model is built."""
    from recstudio_torch.utils import get_model
    trn = splits[0][0]
    bpr_cls, bpr_conf = get_model("BPR")
    bpr = bpr_cls(bpr_conf, device="cpu")
    bpr._init_model(trn)
    bpr._init_parameter(trn)
    cls, conf = get_model("MMoE")
    conf["model"].update(embed_dim=8, **SMALL["MMoE"])
    with pytest.raises(ValueError, match="takes no retriever"):
        cls(conf, device="cpu", retriever=bpr)._init_model(trn)


def test_expert_bank_init_reads_the_stacked_fans():
    """The JAX rule initialises the bank's stacked ``[E, in, out]`` kernel
    with fans ``E in`` and ``E out`` (``init.py:18-25``); the port's draw
    has the same scale."""
    import jax
    from recstudio_tpu.models.init import init_parameters as jax_init
    from recstudio_torch.models.init import init_parameters
    from recstudio_torch.models.multitask.mmoe import ExpertBank
    bank = ExpertBank(4, [300, 100])
    init_parameters(bank, torch.Generator().manual_seed(0))
    tree = jax_init({"experts": {"dense_0": {"kernel": np.zeros((4, 300, 100), np.float32)}}},
                    jax.random.PRNGKey(0))
    want = float(np.asarray(tree["experts"]["dense_0"]["kernel"]).std())
    assert abs(float(bank.kernel_0.detach().std()) / want - 1) < 0.02


def test_fit_monitors_the_first_ratings_metric(splits, tmp_path):
    """Early stopping reads ``{first rating}_{val metric}``, as the JAX
    fit does (``recommender.py:824-834``), and restores that best epoch."""
    from recstudio_torch.utils import get_model
    cls, conf = get_model("HardShare")
    conf["model"].update(embed_dim=8, **SMALL["HardShare"])
    conf["train"].update(epochs=2, batch_size=256)
    conf["eval"]["save_path"] = str(tmp_path)
    model = cls(conf, device="cpu").fit(splits[0][0], splits[0][1])
    assert model.val_metric == "click_auc"
    assert model.callback.best_epoch in (0, 1)
    assert model.callback.best_value == max(e["click_auc"] for e in model.epoch_log)
