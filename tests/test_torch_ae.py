"""MultiDAE and MultiVAE: the port against the JAX package on the CPU.

Both packages build the model on ml-100k's ``UserDataset`` splits at small
widths (d 16; MultiDAE encoder [8, 4], decoder [4, 8]; MultiVAE encoder
[12, 6], decoder [6, 12], so every Dense of both trees exists) with
dropout 0; the JAX model's initial weights plus seeded noise on every leaf
(``perturbed``) go into both (``params_from_jax``). MultiVAE's ``eps`` is
drawn here and given to both packages (the JAX draw is replaced for the
call). Batches are rows spread over the training split. Tolerances, as in
``test_torch_narm_stamp.py`` (float32 on both sides, sums in other orders):

- the query encoder in eval mode: rtol 1e-4, atol 1e-5;
- one training step: the loss to rtol 1e-5; each gradient to 1e-5 of its
  largest magnitude + rtol 1e-4. MultiDAE with ``train.fused_softmax``
  ``true`` (the JAX package's Pallas kernels in interpret mode against the
  port's plain K7, K8, K9, one softmax a user shared by its targets) and
  ``false`` (both materialize the ``[B, N]`` scores); MultiVAE's own step
  with ``anneal_total_step`` small enough that ``anneal * kl`` counts;
- three Adam steps (lr 1e-3, weight decay 1e-5, optax.adamw against
  ``torch.optim.AdamW``): every parameter to atol 2e-6;
- served top-20 lists: scores to rtol 1e-4 / atol 1e-5, ids up to ties
  within 1e-5.

``multidae_ml100k_train_reference.json`` and
``multivae_ml100k_train_reference.json`` hold the JAX package's test
NDCG@10 and Recall@10 after ``quickstart.run(<model>, "ml-100k")`` at the
repo's config (its epoch cap, with early stopping on validation NDCG@5),
over three seeds, and the test NDCG@10 of each seed's untrained model;
``chip_smoke.py`` (phase Q) holds the card's run of the port to the band
those seeds span. Rewrite both (six JAX fits in parallel, about four
minutes on 8 cores) with ``JAX_PLATFORMS=cpu python tests/test_torch_ae.py``.
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
REF_SEEDS = (2022, 2023, 2024)
MODELS = ("MultiDAE", "MultiVAE")
D_TEST, ROWS, WEIGHT_SEED, K = 16, 64, 5, 20
TEST_MODEL = {"MultiDAE": {"embed_dim": D_TEST, "dropout": 0.0, "encoder_dims": [8, 4],
                           "decoder_dims": [4, 8]},
              "MultiVAE": {"embed_dim": D_TEST, "dropout_rate": 0.0, "encoder_dims": [12, 6],
                           "decoder_dims": [6, 12]}}
# the tests' train overrides: Adam at 1e-3 (the tolerance below is a share
# of one step's move there) and, for MultiVAE, an anneal that reaches 0.1
# at epoch 1 of 4 steps
TEST_TRAIN = {"learning_rate": 1e-3, "anneal_total_step": 40}
STEPS_PER_EPOCH = 4
TOL_ENCODE = dict(rtol=1e-4, atol=1e-5)
TOL_GRAD = (1e-5, 1e-4)        # (atol as a share of the largest magnitude, rtol)
TOL_ADAM = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in each test (see ``test_torch_narm_stamp.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def model_pair(name):
    """The JAX and the port's ``name`` on the same ml-100k splits, holding
    the same weights: (JAX model, port model, JAX test split, port train
    and test splits, the weights as a JAX tree)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax
    from test_torch_gru import perturbed
    jcls, jconf = jax_get_model(name)
    jconf["model"].update(TEST_MODEL[name])
    jconf["train"].update(TEST_TRAIN)
    np.random.seed(2022)
    jtrn, _, jtst = jcls._get_dataset_class()("ml-100k").build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    tree = perturbed(jax.tree_util.tree_map(np.asarray, jmodel.params), WEIGHT_SEED)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel.val_check = False            # set by fit, which these models skip
    cls, conf = get_model(name)
    conf["model"].update(TEST_MODEL[name])
    conf["train"].update(TEST_TRAIN)
    np.random.seed(2022)
    trn, _, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, model, jtst, trn, tst, tree


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return (request.param,) + model_pair(request.param)


def train_batch(trn):
    """``ROWS`` rows spread over the training split, among them the user
    with the shortest history."""
    n = len(trn.data_index)
    idx = np.arange(0, n, n // ROWS)[:ROWS]
    idx[0] = int(np.argmin(trn.data_index[:, 2] - trn.data_index[:, 1]))
    return trn._get_pos_batch(idx)


def leaves_of(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from leaves_of(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def draw_eps(name, rows, seed=11):
    """MultiVAE's ``eps [rows, latent]``, or None for MultiDAE."""
    if name != "MultiVAE":
        return None
    latent = TEST_MODEL[name]["encoder_dims"][-1]
    return np.random.default_rng(seed).normal(size=(rows, latent)).astype(np.float32)


class injected_eps:
    """Inside the block the JAX package draws ``eps`` as given (its
    ``jax.random.normal`` returns it) and the port's ``training_step`` takes
    it; outside, both draw their own."""

    def __init__(self, model, eps):
        self.model, self.eps = model, eps

    def __enter__(self):
        import jax
        import jax.numpy as jnp
        if self.eps is None:
            return
        self.normal = jax.random.normal
        jax.random.normal = lambda key, shape, *a, **k: jnp.asarray(self.eps).reshape(shape)
        step = type(self.model).training_step
        self.model.training_step = lambda batch: step(self.model, batch,
                                                      eps=torch.from_numpy(self.eps))

    def __exit__(self, *exc):
        import jax
        if self.eps is None:
            return
        jax.random.normal = self.normal
        del self.model.training_step


def set_anneal(jmodel, model, nepoch):
    for m in (jmodel, model):
        m._steps_per_epoch = STEPS_PER_EPOCH
        m._epoch_refresh(nepoch)


def check_training_step(name, jmodel, model, batch):
    """One step's loss and every gradient against the JAX step's."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    eps = draw_eps(name, ROWS)
    with injected_eps(model, eps), jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jmodel.states)
        model.net.train()
        model.net.zero_grad()
        loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    for path, a, b in leaves_of(grads, jgrads):
        np.testing.assert_allclose(a, b, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * max(float(np.abs(b).max()), 1e-3),
                                   err_msg=path)
        assert float(np.abs(a).max()) > 0, path
    for tower, table in (("item_encoder", ()), ("query_encoder", ("item_embedding",))):
        node = grads[tower]
        for part in table:
            node = node[part]
        assert float(np.abs(node["embedding"][0]).max()) == 0.0
    return float(loss.detach())


def test_model_shape(pair):
    from recstudio_torch.models.basemodel.baseretriever import TwoTowerNet
    from recstudio_torch.models.loss_func import SoftmaxLoss
    name, jmodel, model, _, trn, _, tree = pair
    assert type(model.net) is TwoTowerNet and model.sampler is None
    assert isinstance(model.loss_fn, SoftmaxLoss) and model._use_fused_softmax()
    assert model.query_fields == jmodel.query_fields == {"user_id", "in_item_id"}
    assert model.history_width == trn._in_width()
    assert model._compute_item_vector().shape == (trn.num_items - 1, D_TEST)
    names = sorted(n for n, _ in model.net.named_parameters())
    want = {"MultiDAE": ["item_encoder.weight",
                         *[f"query_encoder.encoder_decoder.dense_{i}.{w}" for i in range(3)
                           for w in ("bias", "weight")],
                         "query_encoder.item_embedding.weight",
                         "query_encoder.out_proj.bias", "query_encoder.out_proj.weight"],
            "MultiVAE": ["item_encoder.weight", "query_encoder.decoder.dense_0.bias",
                         "query_encoder.decoder.dense_0.weight", "query_encoder.enc_out.bias",
                         "query_encoder.enc_out.weight", "query_encoder.encoder.dense_0.bias",
                         "query_encoder.encoder.dense_0.weight",
                         "query_encoder.item_embedding.weight",
                         "query_encoder.out_proj.bias", "query_encoder.out_proj.weight"]}[name]
    assert names == want


@pytest.mark.parametrize("name", MODELS)
def test_repo_widths_match_the_jax_tree(name):
    """At the repo's config MultiVAE's ``MLPModule([600])`` and
    ``MLPModule([200])`` are identities with no parameter, as in the JAX
    package: both trees hold the same leaves, of the same shapes."""
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_to_jax
    jcls, jconf = jax_get_model(name)
    np.random.seed(2022)
    jtrn, _, _ = jcls._get_dataset_class()("ml-100k").build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    cls, conf = get_model(name)
    np.random.seed(2022)
    trn, _, _ = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    got = params_to_jax(model.net.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jmodel.params)
    for path, a, b in leaves_of(got, want):
        assert a.shape == b.shape, path
    if name == "MultiVAE":
        assert sorted(want["query_encoder"]) == ["enc_out", "item_embedding", "out_proj"]
        assert list(model.query_encoder.encoder.parameters()) == []
        x = torch.randn(3, 600)
        assert torch.equal(model.query_encoder.encoder(x), x)


def test_encoder_matches_jax(pair):
    import jax
    import jax.numpy as jnp
    _, jmodel, model, _, trn, _, _ = pair
    batch = train_batch(trn)
    feat = {k: batch[k] for k in ("user_id", "in_item_id")}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel._apply(jmodel.params, "encode_query",
                                        {k: jnp.asarray(v) for k, v in feat.items()}))
    with torch.no_grad():
        got = model.net.encode_query({k: torch.from_numpy(v) for k, v in feat.items()})
    assert got.shape == (ROWS, D_TEST)
    np.testing.assert_allclose(got.numpy(), want, **TOL_ENCODE)


def test_encoder_of_an_empty_history_matches_jax(pair):
    """In ``user`` mode the validation users have no training items: their
    history window is all padding, the bag is zero, and the query is the
    MLP's image of zero in both packages."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.data import UserDataset
    _, jmodel, model, _, _, _, _ = pair
    np.random.seed(2022)
    val = UserDataset("ml-100k").build(split_mode="user")[1]
    lengths = val.data_index[:, 2] - val.data_index[:, 1]
    rows = np.r_[np.flatnonzero(lengths == 0)[:8], np.flatnonzero(lengths > 0)[0]]
    batch = val._get_pos_batch(rows)
    assert not batch["in_item_id"][:8].any() and batch["in_item_id"][8].any()
    feat = {k: batch[k] for k in ("user_id", "in_item_id")}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel._apply(jmodel.params, "encode_query",
                                        {k: jnp.asarray(v) for k, v in feat.items()}))
    with torch.no_grad():
        got = model.net.encode_query({k: torch.from_numpy(v) for k, v in feat.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL_ENCODE)


@pytest.mark.parametrize("fused", ["true", "false"])
def test_multidae_training_step_matches_jax(fused):
    """The port's fused step (plain K7, K8, K9 on the CPU, a ``[B]`` logZ
    shared by each user's ``[B, T]`` target scores) or its materialized
    scores, against the JAX package's ``SoftmaxLoss`` step on the same path."""
    jmodel, model, _, trn, _, _ = model_pair("MultiDAE")
    jmodel.config["train"]["fused_softmax"] = fused
    model.config["train"]["fused_softmax"] = fused
    assert jmodel._use_fused_softmax() == model._use_fused_softmax() == (fused == "true")
    batch = train_batch(trn)
    assert batch["item_id"].ndim == 2 and (batch["item_id"] == 0).any()
    check_training_step("MultiDAE", jmodel, model, batch)


def test_multivae_training_step_matches_jax():
    """MultiVAE's own step (materialized scores, ``anneal * kl``) with the
    same ``eps``; the KL term is held to count in the loss."""
    jmodel, model, _, trn, _, _ = model_pair("MultiVAE")
    set_anneal(jmodel, model, 1)
    assert float(jmodel.states["anneal"]) == np.float32(model.states["anneal"]) == np.float32(0.1)
    batch = train_batch(trn)
    loss = check_training_step("MultiVAE", jmodel, model, batch)
    set_anneal(jmodel, model, 0)
    without_kl = check_training_step("MultiVAE", jmodel, model, batch)
    assert abs(loss - without_kl) > 1e-4


def test_anneal_per_epoch_matches_jax(pair):
    name, jmodel, model, _, _, _, _ = pair
    if name != "MultiVAE":
        assert "anneal" not in model.states
        return
    got, want = [], []
    for nepoch in (-1, 0, 1, 2, 3, 50):
        set_anneal(jmodel, model, nepoch)
        got.append(model.states["anneal"])
        want.append(float(jmodel.states["anneal"]))
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert got == [0.0, 0.0, 0.1, 0.2, 0.2, 0.2]


def test_steps_per_epoch_is_set_by_fit_staging(pair):
    """``_steps_per_epoch`` (read by the anneal) is the epoch's batch count,
    as ``Recommender.fit`` sets it in the JAX package."""
    _, _, model, _, trn, _, _ = pair
    model._setup_scan_epoch(trn)
    bs = model.config["train"]["batch_size"]
    assert model._steps_per_epoch == -(-len(trn.data_index) // bs)


def test_three_adam_steps_match_jax(pair):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    name, jmodel, model, _, trn, _, tree = pair
    batch = train_batch(trn)
    tc = model.config["train"]
    assert tc["weight_decay"] == 1e-5 and tc["learning_rate"] == 1e-3
    set_anneal(jmodel, model, 1)
    opt = jmodel._make_optax("adam", 1e-3, 1e-5)
    params, state = jmodel.params, opt.init(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model.optimizer = model._get_optimizer()
    assert type(model.optimizer) is torch.optim.AdamW
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    try:
        with injected_eps(model, draw_eps(name, ROWS)), jax.default_matmul_precision("float32"):
            for i in range(3):
                params, state, _ = jmodel._grad_step(opt, params, state, jbatch,
                                                     jax.random.PRNGKey(i), jmodel.states)
            model.net.train()
            for _ in range(3):
                model._grad_step(tbatch)
            model.net.eval()
        got = params_to_jax(model.net.state_dict())
        for path, a, b in leaves_of(got, jax.tree_util.tree_map(np.asarray, params)):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_ADAM, err_msg=path)
    finally:                            # the module's other tests hold the first weights
        model.load_state_dict(params_from_jax(tree))


def test_served_topk_matches_jax(pair):
    """``Predictor`` over test users, the history masked from the split's
    ``user_hist`` table in both packages (the port's dummy request is as
    wide as the training history)."""
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    _, jmodel, model, jtst, _, tst, _ = pair
    pred = Predictor(model, max_batch=128, k=K, train_data=tst).warm()
    assert pred._dummy()["in_item_id"].shape == (128, model.history_width)
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=K, train_data=jtst)
        for offset, n in ((0, 128), (896, 47)):
            batch = next(iter(tst.eval_loader(offset + n)))
            req = {f: batch[f][offset:offset + n] for f in ("in_item_id", "user_id")}
            s, i = pred(req)
            js, ji = jpred(req)
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0


def test_params_round_trip(pair):
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    _, _, model, _, _, _, tree = pair
    for path, a, b in leaves_of(params_to_jax(params_from_jax(tree)), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)
    for path, a, b in leaves_of(params_to_jax(model.net.state_dict()), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_quickstart_fit_on_the_cpu(name, tmp_path):
    """``quickstart.run(name, "ml-100k", device="cpu")`` for two epochs at
    small widths and Adam at 1e-2 (MultiVAE takes two steps an epoch): a
    finite loss, metrics far above a random ranking, an
    evaluation masked by the history window, and a served request."""
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    model, (trn, _, tst), result = run(
        name, "ml-100k", verbose=False, device="cpu",
        model_config={"model": TEST_MODEL[name],
                      "train": {"epochs": 2, "learning_rate": 1e-2},
                      "eval": {"save_path": str(tmp_path)}})
    assert type(model).__name__ == name and model.device.type == "cpu"
    assert len(model.epoch_log) == 2
    assert all(np.isfinite(e["train_loss"]) for e in model.epoch_log)
    assert np.isfinite(list(result.values())).all() and result["ndcg@10"] > 0.02
    batch = next(iter(tst.eval_loader(8)))
    s, i = Predictor(model, max_batch=8, k=10, train_data=tst).warm()(
        {f: batch[f] for f in sorted(model.query_fields)})
    assert s.shape == (8, 10) and ((i >= 1) & (i < trn.num_items)).all()


def train_reference(name: str) -> str:
    return os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")


@pytest.mark.parametrize("name", MODELS)
def test_training_reference_file(name):
    from recstudio_torch.utils import get_model
    with open(train_reference(name)) as f:
        ref = json.load(f)
    tc = get_model(name)[1]["train"]
    assert ref["epochs"] == tc["epochs"] and ref["early_stop_patience"] == tc.get(
        "early_stop_patience", 10)
    assert ref["metric"] == "ndcg@10"
    assert [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert 0 < ref["ndcg@10_band"][0] < ref["ndcg@10_band"][1] < 1
    assert all(0 <= r["best_epoch"] < ref["epochs"] for r in ref["runs"])
    assert ref["untrained_ndcg@10"] == max(r["untrained_ndcg@10"] for r in ref["runs"])
    assert ref["untrained_ndcg@10"] < ref["ndcg@10_band"][0]


def jax_training_run(name: str, seed: int):
    """One JAX ``quickstart.run(name, "ml-100k")`` at the repo's config, and
    the test NDCG@10 of the same seed's untrained model."""
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
    return {"seed": seed, "fit_s": fit_s, "ndcg@10": float(out["ndcg@10"]),
            "recall@10": float(out["recall@10"]),
            "best_epoch": int(model.callback.best_epoch),
            "untrained_ndcg@10": float(before["ndcg@10"])}


_ABOUT = {
    "MultiDAE": "d 200, encoder [64, 32], decoder [32, 64], relu, dropout 0.5, batch 256, "
                "adam 1e-2, weight decay 1e-5, SoftmaxLoss",
    "MultiVAE": "d 600, encoder [200], decoder [200], tanh, dropout 0.5, batch 500, "
                "adam 1e-3, weight decay 1e-5, anneal_max 0.2 over 2,000,000 steps, "
                "SoftmaxLoss + anneal * KL",
}

if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if len(sys.argv) > 2:      # one model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(jax_training_run(sys.argv[1], int(sys.argv[2]))))
        sys.exit(0)
    import subprocess
    from recstudio_torch.utils import get_model
    names = sys.argv[1:] or MODELS
    procs = {(n, s): subprocess.Popen([sys.executable, __file__, n, str(s)],
                                      stdout=subprocess.PIPE, text=True, cwd=REPO)
             for n in names for s in REF_SEEDS}
    out = {k: json.loads(p.communicate()[0].strip().splitlines()[-1])
           for k, p in procs.items()}
    for name in names:
        tc = get_model(name)[1]["train"]
        patience = tc.get("early_stop_patience", 10)
        runs = [out[(name, s)] for s in REF_SEEDS]
        ndcg = [r["ndcg@10"] for r in runs]
        spread = max(ndcg) - min(ndcg)
        ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config "
                        f"({_ABOUT[name]}), quickstart.run: fit(train, val) for at most "
                        f"{tc['epochs']} epochs, early stopping on validation NDCG@5 with "
                        f"patience {patience} and the best epoch's weights restored, then "
                        "evaluate(test), JAX on the CPU; metric = test NDCG@10; band = "
                        "seeds' range widened by their spread; untrained = the largest "
                        "test NDCG@10 of the seeds' models before fit",
               "epochs": tc["epochs"], "early_stop_patience": patience, "metric": "ndcg@10",
               "runs": runs, "ndcg@10_band": [min(ndcg) - spread, max(ndcg) + spread],
               "untrained_ndcg@10": max(r["untrained_ndcg@10"] for r in runs)}
        with open(train_reference(name), "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(f"wrote {train_reference(name)}")
