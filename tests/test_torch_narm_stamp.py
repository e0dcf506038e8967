"""NARM and STAMP (and, through the same helpers, GRU4Rec in
``test_torch_gru.py``): the port against the JAX package on the CPU.

Both packages build the model on ml-100k at d 16 (GRU hidden 32) with
dropout 0; the JAX model's initial weights plus seeded noise on every leaf
(``perturbed``: every bias nonzero) go into both (``params_from_jax``).
Batches are rows of the training split, among them padded histories and
one of length 1. Tolerances, float32 on both sides with sums in other
orders:

- the query encoder in eval mode: rtol 1e-4, atol 1e-5;
- one training step: the loss to rtol 1e-5; each gradient to 1e-5 of its
  largest magnitude + rtol 1e-4 (``train.fused_softmax`` ``true``: the
  JAX package's Pallas kernels in interpret mode against the port's plain
  K7, K8, K9; ``false``: both materialize the ``[B, N]`` scores);
- three Adam steps: every parameter to atol 2e-6, 0.2 % of the largest
  move of one step (lr 1e-3): Adam divides each gradient by its own
  running size, so an entry whose gradient is near 0 carries the float32
  rounding of that gradient into its step;
- served top-20 lists: scores to rtol 1e-4 / atol 1e-5, ids up to ties
  within 1e-5.

``narm_ml100k_train_reference.json`` and ``stamp_ml100k_train_reference.json``
hold the JAX package's test NDCG@10 and Recall@10 after
``quickstart.run(<model>, "ml-100k")`` for ``EPOCHS`` epochs at the repo's
config (12, phase N's depth, cut from 20 for the script's time limit),
over six seeds, and the test NDCG@10 of each seed's untrained model;
``chip_smoke.py`` (phase N) holds the card's run of the port to the band
those seeds span. Rewrite both (twelve JAX fits in parallel, a few minutes
on a CPU) with ``JAX_PLATFORMS=cpu python tests/test_torch_narm_stamp.py``.
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
EPOCHS = 12
REF_SEEDS = (2022, 2023, 2024, 2025, 2026, 2027)
MODELS = ("NARM", "STAMP")
D_TEST, HIDDEN_TEST, ROWS, WEIGHT_SEED, K = 16, 32, 64, 5, 20
# model overrides of the parity tests: narrow, dropout off
TEST_MODEL = {"NARM": {"hidden_size": HIDDEN_TEST, "dropout_rate": [0.0, 0.0]},
              "STAMP": {},
              "GRU4Rec": {"hidden_size": HIDDEN_TEST, "dropout_rate": 0.0}}
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
    """One intra-op thread in each test: these shapes gain nothing from
    more, and torch's spinning worker threads slow a fit of small steps, and
    every other test process that shares the cores, many times over."""
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
    jconf["model"].update(embed_dim=D_TEST, **TEST_MODEL[name])
    jtrn, _, jtst = jcls._get_dataset_class()("ml-100k").build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    tree = perturbed(jax.tree_util.tree_map(np.asarray, jmodel.params), WEIGHT_SEED)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel.val_check = False            # set by fit, which these models skip
    cls, conf = get_model(name)
    conf["model"].update(embed_dim=D_TEST, **TEST_MODEL[name])
    trn, _, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, model, jtst, trn, tst, tree


def train_batch(trn):
    """``ROWS`` rows spread over the training split, the first of them one
    whose history has length 1."""
    n = len(trn.data_index)
    idx = np.arange(0, n, n // ROWS)[:ROWS]
    seqlen = trn._get_pos_batch(np.arange(n))["seqlen"]
    idx[0] = int(np.flatnonzero(seqlen == 1)[0])
    batch = trn._get_pos_batch(idx)
    L = batch["in_item_id"].shape[1]
    assert batch["seqlen"][0] == 1 and (batch["seqlen"] < L).any()
    return batch


def check_encoder(jmodel, model, batch):
    import jax
    import jax.numpy as jnp
    feat = {k: batch[k] for k in ("in_item_id", "seqlen")}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel._apply(jmodel.params, "encode_query",
                                        {k: jnp.asarray(v) for k, v in feat.items()}))
    with torch.no_grad():
        got = model.net.encode_query({k: torch.from_numpy(v) for k, v in feat.items()})
    assert got.shape == (ROWS, D_TEST)
    np.testing.assert_allclose(got.numpy(), want, **TOL_ENCODE)


def leaves_of(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from leaves_of(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def check_training_step(jmodel, model, batch):
    """One step's loss and every gradient against the JAX step's."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jmodel.states)
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
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
    table = grads["query_encoder"]["item_encoder"]["embedding"]
    assert float(np.abs(table[0]).max()) == 0.0


def check_adam_steps(jmodel, model, batch, n=3):
    """``n`` Adam steps from the same weights: every parameter after them."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_to_jax
    opt = jmodel._make_optax("adam", 1e-3)
    params, state = jmodel.params, opt.init(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        for i in range(n):
            params, state, _ = jmodel._grad_step(opt, params, state, jbatch,
                                                 jax.random.PRNGKey(i), jmodel.states)
    model.optimizer = model._get_optimizer()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.net.train()
    for _ in range(n):
        model._grad_step(tbatch)
    model.net.eval()
    got = params_to_jax(model.net.state_dict())
    for path, a, b in leaves_of(got, jax.tree_util.tree_map(np.asarray, params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_ADAM, err_msg=path)


def check_serving(jmodel, model, jtst, tst):
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    pred = Predictor(model, max_batch=128, k=K, train_data=tst)
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=K, train_data=jtst)
        for offset, n in ((0, 128), (896, 47)):
            batch = next(iter(tst.eval_loader(offset + n)))
            req = {f: batch[f][offset:offset + n] for f in ("in_item_id", "seqlen", "user_id")}
            s, i = pred(req)
            js, ji = jpred(req)
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0


def check_round_trip(model, tree):
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    for path, a, b in leaves_of(params_to_jax(params_from_jax(tree)), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)
    for path, a, b in leaves_of(params_to_jax(model.net.state_dict()), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)


def check_quickstart_fit(name, tmp_path):
    """``quickstart.run(name, "ml-100k", device="cpu")`` for one epoch at d
    16: a finite loss, metrics far above a random ranking, and a served
    request."""
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    model, (trn, _, tst), result = run(
        name, "ml-100k", verbose=False, device="cpu",
        model_config={"model": {"embed_dim": D_TEST, **TEST_MODEL[name]},
                      "train": {"epochs": 1}, "eval": {"save_path": str(tmp_path)}})
    assert type(model).__name__ == name and model.device.type == "cpu"
    assert np.isfinite(model.epoch_log[0]["train_loss"])
    assert np.isfinite(list(result.values())).all() and result["ndcg@10"] > 0.02
    batch = next(iter(tst.eval_loader(8)))
    s, i = Predictor(model, max_batch=8, k=10, train_data=tst).warm()(
        {f: batch[f] for f in sorted(model.query_fields)})
    assert s.shape == (8, 10) and ((i >= 1) & (i < trn.num_items)).all()


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return (request.param,) + model_pair(request.param)


def test_model_shape(pair):
    from recstudio_torch.models.basemodel.baseretriever import SharedItemTowerNet
    from recstudio_torch.models.loss_func import SoftmaxLoss
    name, _, model, _, trn, _, _ = pair
    assert type(model.net) is SharedItemTowerNet and model.sampler is None
    assert isinstance(model.loss_fn, SoftmaxLoss) and model._use_fused_softmax()
    assert model._compute_item_vector().shape == (trn.num_items - 1, D_TEST)
    names = sorted(n for n, _ in model.net.named_parameters())
    want = {"NARM": ["query_encoder.attn.mlp.dense_0.weight", "query_encoder.attn.mlp_out.bias",
                     "query_encoder.attn.mlp_out.weight", "query_encoder.fc.weight",
                     "query_encoder.gru.layers.0.bias_hh_l0",
                     "query_encoder.gru.layers.0.bias_ih_l0",
                     "query_encoder.gru.layers.0.weight_hh_l0",
                     "query_encoder.gru.layers.0.weight_ih_l0",
                     "query_encoder.item_encoder.weight"],
            "STAMP": ["query_encoder.attn.mlp.dense_0.bias", "query_encoder.attn.mlp.dense_0.weight",
                      "query_encoder.attn.mlp_out.bias", "query_encoder.attn.mlp_out.weight",
                      "query_encoder.item_encoder.weight", "query_encoder.mlpA.dense_0.bias",
                      "query_encoder.mlpA.dense_0.weight", "query_encoder.mlpB.dense_0.bias",
                      "query_encoder.mlpB.dense_0.weight"]}[name]
    assert names == want


def test_encoder_matches_jax(pair):
    _, jmodel, model, _, trn, _, _ = pair
    check_encoder(jmodel, model, train_batch(trn))


@pytest.mark.parametrize("fused", ["true", "false"])
def test_training_step_matches_jax(pair, fused):
    """The port's fused step (plain K7, K8, K9 on the CPU, a ``[B]`` logZ
    beside a ``[B]`` positive score) or its materialized scores, against the
    JAX package's ``SoftmaxLoss`` step on the same path."""
    _, jmodel, model, _, trn, _, _ = pair
    jmodel.config["train"]["fused_softmax"] = fused
    model.config["train"]["fused_softmax"] = fused
    assert jmodel._use_fused_softmax() == model._use_fused_softmax() == (fused == "true")
    try:
        check_training_step(jmodel, model, train_batch(trn))
    finally:
        jmodel.config["train"]["fused_softmax"] = "auto"
        model.config["train"]["fused_softmax"] = "auto"


def test_three_adam_steps_match_jax(pair):
    name, jmodel, model, _, trn, _, tree = pair
    try:
        check_adam_steps(jmodel, model, train_batch(trn))
    finally:                            # the module's other tests hold the first weights
        from recstudio_torch.utils.convert import params_from_jax
        model.load_state_dict(params_from_jax(tree))


def test_served_topk_matches_jax(pair):
    _, jmodel, model, jtst, _, tst, _ = pair
    check_serving(jmodel, model, jtst, tst)


def test_params_round_trip(pair):
    _, _, model, _, _, _, tree = pair
    check_round_trip(model, tree)


@pytest.mark.parametrize("name", MODELS)
def test_quickstart_fit_on_the_cpu(name, tmp_path):
    check_quickstart_fit(name, tmp_path)


def train_reference(name: str) -> str:
    return os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")


def jax_training_run(name: str, seed: int, epochs: int = EPOCHS):
    """One JAX ``quickstart.run(name, "ml-100k")`` at the repo's config, and
    the test NDCG@10 of the same seed's untrained model."""
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model as jax_get_model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        _, (trn, _, tst), out = run(name, "ml-100k", verbose=False,
                                    model_config={"train": {"epochs": epochs, "seed": seed},
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
            "untrained_ndcg@10": float(before["ndcg@10"])}


@pytest.mark.parametrize("name", MODELS)
def test_training_reference_file(name):
    with open(train_reference(name)) as f:
        ref = json.load(f)
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    assert ref["epochs"] == EPOCHS and [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert 0 < ref["ndcg@10_band"][0] < ref["ndcg@10_band"][1] < 1
    assert ref["untrained_ndcg@10"] == max(r["untrained_ndcg@10"] for r in ref["runs"])
    assert ref["untrained_ndcg@10"] < ref["ndcg@10_band"][0]


_ABOUT = {
    "NARM": "d 64, GRU hidden 128, one layer, dropout [0.25, 0.5], L 20, batch 512, "
            "adam 1e-3, SoftmaxLoss",
    "STAMP": "d 64, L 20, batch 512, adam 1e-3, SoftmaxLoss",
}

if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if len(sys.argv) > 2:      # one model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(jax_training_run(sys.argv[1], int(sys.argv[2]))))
        sys.exit(0)
    import subprocess
    names = sys.argv[1:] or MODELS
    procs = {(n, s): subprocess.Popen([sys.executable, __file__, n, str(s)],
                                      stdout=subprocess.PIPE, text=True, cwd=REPO)
             for n in names for s in REF_SEEDS}
    out = {k: json.loads(p.communicate()[0].strip().splitlines()[-1])
           for k, p in procs.items()}
    for name in names:
        runs = [out[(name, s)] for s in REF_SEEDS]
        ndcg = [r["ndcg@10"] for r in runs]
        spread = max(ndcg) - min(ndcg)
        ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config "
                        f"({_ABOUT[name]}), quickstart.run: fit(train, val) for a fixed "
                        "epoch cap then evaluate(test), JAX on the CPU; band = seeds' "
                        "range widened by their spread; untrained = the largest test "
                        "NDCG@10 of the seeds' models before fit",
               "epochs": EPOCHS, "runs": runs,
               "ndcg@10_band": [min(ndcg) - spread, max(ndcg) + spread],
               "untrained_ndcg@10": max(r["untrained_ndcg@10"] for r in runs)}
        with open(train_reference(name), "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(f"wrote {train_reference(name)}")
