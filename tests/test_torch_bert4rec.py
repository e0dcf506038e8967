"""BERT4Rec: the port against the JAX package.

- One training step: both packages build BERT4Rec on ml-100k at d 16 with
  dropout 0 and the same parameters (``params_from_jax``; the item table
  has ``num_items + 1`` rows, the last the ``[MASK]`` token). The same
  masked batch, drawn with numpy at mask ratio 0.2, replaces both models'
  ``_reconstruct_train_data``. The loss and every gradient agree with
  ``train.fused_softmax`` ``true`` (the JAX package's Pallas kernels in
  interpret mode; the port's plain K7, K8, K9 on the CPU) and ``false``
  (both materialize the ``[B, L, N]`` scores): rtol 1e-5 for the loss;
  rtol 1e-4 and atol 1e-5 times the gradient's largest magnitude for the
  gradients (float32 on both sides, sums in another order).
- Serving: seeded numpy weights (``random_sasrec_params`` with the
  ``[MASK]`` row) in both; the served top-20 lists agree to rtol 1e-4 /
  atol 1e-5 and ids up to ties within 1e-5.
- The engine on the CPU: a short fit at d 16 lowers the loss, gives the
  same losses on the fused and the materialized paths, and serves.

``bert4rec_ml100k_train_reference.json`` holds the JAX package's test
NDCG@10 and Recall@10 after ``fit(train, val)`` for ``EPOCHS`` epochs at
the repo's BERT4Rec config on ml-100k, over three seeds, and the test
NDCG@10 of each seed's untrained model; ``chip_smoke.py`` (phase G) holds
the card's run of the port to the band those seeds span. Rewrite it (three
JAX fits in parallel, some fifteen minutes on a CPU) with
``JAX_PLATFORMS=cpu python tests/test_torch_bert4rec.py``.
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
TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                               "bert4rec_ml100k_train_reference.json")
# phase G's depth: 20 until the script's time limit cut it to 10, then to 6
# when phases AI and AJ joined the script
EPOCHS = 6
REF_SEEDS = (2022, 2023, 2024)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def jax_training_run(seed: int, epochs: int = EPOCHS):
    """One JAX fit(train, val) + evaluate(test) at the repo's BERT4Rec
    config, and the test NDCG@10 of the same seed's untrained model."""
    from recstudio_tpu.utils import get_model as jax_get_model
    cls, conf = jax_get_model("BERT4Rec")
    ds = cls._get_dataset_class()("ml-100k")
    trn, val, tst = ds.build(**conf["data"])
    conf["train"].update(epochs=epochs, seed=seed, compile_cache=None)
    with tempfile.TemporaryDirectory() as tmp:
        conf["eval"]["save_path"] = tmp
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        before = untrained.evaluate(tst, verbose=False)
        model = cls(conf)
        t0 = time.time()
        model.fit(trn, val)
        out = model.evaluate(tst, verbose=False)
    return {"seed": seed, "fit_s": time.time() - t0,
            "ndcg@10": float(out["ndcg@10"]), "recall@10": float(out["recall@10"]),
            "untrained_ndcg@10": float(before["ndcg@10"])}


# ---------------------------------------------------------------------------
D_TEST, ROWS, MASK_RATIO, MASK_SEED, SERVE_SEED, K = 16, 64, 0.2, 23, 2022, 20


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in each test: these shapes gain nothing from
    more, and torch's spinning worker threads slow a fit of tiny steps, and
    every other test process that shares the cores, many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _masked(batch, num_items, seed=MASK_SEED):
    """``_reconstruct_train_data`` with numpy uniforms."""
    seq = batch["in_item_id"]
    rand = np.random.default_rng(seed).random(seq.shape)
    masked = (rand < MASK_RATIO) & (seq > 0)
    out = dict(batch)
    out["in_item_id"] = np.where(masked, num_items, seq).astype(seq.dtype)
    out["item_id"] = np.where(masked, seq, 0).astype(seq.dtype)
    return out


def _port_model(d=D_TEST, **model):
    from recstudio_torch.utils import get_model
    cls, conf = get_model("BERT4Rec")
    conf["model"].update(embed_dim=d, **model)
    ds = cls._get_dataset_class()("ml-100k")
    trn, _, tst = ds.build(**conf["data"])
    m = cls(conf, device="cpu")
    m._init_model(trn)
    m._init_parameter(trn)
    return m, ds, trn, tst


@pytest.fixture(scope="module")
def step_pair():
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils.convert import params_from_jax
    jcls, jconf = jax_get_model("BERT4Rec")
    jconf["model"].update(embed_dim=D_TEST, dropout=0.0)
    jds = jcls._get_dataset_class()("ml-100k")
    jtrn, _, _ = jds.build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params)
    model, ds, trn, _ = _port_model(dropout=0.0)
    model.load_state_dict(params_from_jax(tree))
    idx = np.arange(0, len(trn.data_index), len(trn.data_index) // ROWS)[:ROWS]
    batch = _masked(trn._get_pos_batch(idx), ds.num_items)
    return jmodel, model, batch, tree


def test_model_shape_and_catalog(step_pair):
    from recstudio_torch.utils.convert import params_to_jax
    jmodel, model, _, tree = step_pair
    n = model.num_items
    assert model.mask_token == jmodel.mask_token == n and model.sampler is None
    assert tuple(model.item_encoder.weight.shape) == (n + 1, D_TEST)
    assert float(model.item_encoder.weight[n].detach().abs().sum()) > 0   # [MASK] row drawn
    assert model._compute_item_vector().shape == (n - 1, D_TEST)         # no [PAD], no [MASK]
    ours = params_to_jax(model.net.state_dict())
    for path, a, b in _leaves(ours, tree):
        np.testing.assert_array_equal(a, b, err_msg=path)
    model.config["train"]["fused_softmax"] = "false"
    assert not model._use_fused_softmax()
    for flag in ("auto", "true"):
        model.config["train"]["fused_softmax"] = flag
        assert model._use_fused_softmax()


@pytest.mark.parametrize("fused", ["true", "false"])
def test_training_step_matches_jax(step_pair, fused):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    jmodel, model, batch, _ = step_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jmodel.config["train"]["fused_softmax"] = fused
    model.config["train"]["fused_softmax"] = fused
    assert jmodel._use_fused_softmax() == model._use_fused_softmax() == (fused == "true")
    jmodel._reconstruct_train_data = lambda b, rng: jbatch
    model._reconstruct_train_data = lambda b: tbatch
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, jbatch, jax.random.PRNGKey(0), jmodel.states)
    jgrads = jax_zero_pad(jgrads)
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step(tbatch)
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    for path, a, b in _leaves(grads, jax.tree_util.tree_map(np.asarray, jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(b).max()), 1e-3), err_msg=path)
    table = grads["query_encoder"]["item_encoder"]["embedding"]
    assert float(np.abs(table[0]).max()) == 0.0 and float(np.abs(table[-1]).max()) > 0.0


def _leaves(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("pooling", ["mask", "origin"])
def test_every_position_poolings(step_pair, pooling):
    """Pooling ``mask`` and ``origin`` return every position, as the JAX
    encoder does: the last true position of that output is ``last``'s."""
    from recstudio_torch.models.seq.sasrec import _pooling
    _, model, batch, _ = step_pair
    enc = model.query_encoder
    feat = {k: torch.from_numpy(batch[k]) for k in ("in_item_id", "seqlen")}
    kept = enc.pooling
    with torch.no_grad():
        last = enc(feat)
        enc.pooling = _pooling(pooling)
        every = enc(feat)
    enc.pooling = kept
    assert every.shape == (ROWS, 20, D_TEST)
    idx = torch.clamp_min(feat["seqlen"].long() - 1, 0)
    torch.testing.assert_close(every[torch.arange(ROWS), idx], last)


def test_reconstruct_train_data_masks_true_positions():
    model, ds, trn, _ = _port_model()
    batch = {k: torch.from_numpy(v) for k, v in trn._get_pos_batch(np.arange(512)).items()}
    state = model.device_generator.get_state()
    out = model._reconstruct_train_data(batch)
    seq, inp, tgt = batch["in_item_id"], out["in_item_id"], out["item_id"]
    masked = inp == ds.num_items
    assert torch.equal(tgt[masked], seq[masked]) and bool((tgt[~masked] == 0).all())
    assert torch.equal(inp[~masked], seq[~masked]) and not bool(masked[seq == 0].any())
    assert abs(float(masked.sum()) / float((seq > 0).sum()) - MASK_RATIO) < 0.02
    model.device_generator.set_state(state)                # the draws are the generator's
    assert torch.equal(model._reconstruct_train_data(batch)["in_item_id"], inp)


@pytest.fixture(scope="module")
def serve_pair():
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
    jcls, jconf = jax_get_model("BERT4Rec")
    jds = jcls._get_dataset_class()("ml-100k")
    jtrn, _, jtst = jds.build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    mc = jconf["model"]
    tree = random_sasrec_params(SERVE_SEED, jds.num_items + 1, mc["embed_dim"],   # + [MASK]
                                jds.config["max_seq_len"], mc["hidden_size"], mc["layer_num"])
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    model, _, _, tst = _port_model(d=mc["embed_dim"])
    model.load_state_dict(params_from_jax(tree))
    return model, tst, jmodel, jtst


def _request(split, n, offset=0):
    batch = next(iter(split.eval_loader(offset + n)))
    return {f: batch[f][offset:offset + n] for f in ("in_item_id", "seqlen", "user_id")}


def test_served_topk_matches_jax(serve_pair):
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    model, tst, jmodel, jtst = serve_pair
    pred = Predictor(model, max_batch=128, k=K, train_data=tst)
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=K, train_data=jtst)
        for offset, n in ((0, 128), (896, 47)):
            req = _request(tst, n, offset)
            s, i = pred(req)
            js, ji = jpred(req)
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0
            assert not (i == jmodel.mask_token).any()


def test_warm_builds_from_bert4rec_query_fields(serve_pair):
    from recstudio_torch.serving import Predictor
    model, tst, _, _ = serve_pair
    pred = Predictor(model, max_batch=8, k=K, train_data=tst)
    assert pred.warm() is pred
    assert sorted(pred._dummy()) == ["in_item_id", "seqlen", "user_id"]
    assert pred._dummy()["in_item_id"].shape == (8, 20)


def _tiny(tmp_path, **train):
    from recstudio_torch.data.synthetic import generate
    from recstudio_torch.utils import get_model
    name, config = generate("tiny-shape", 60, 50, 3000, out_dir=str(tmp_path / "data"), seed=1)
    config["max_seq_len"] = 10
    cls, conf = get_model("BERT4Rec")
    conf["model"].update(embed_dim=16, hidden_size=32)
    conf["train"].update({"epochs": 3, "batch_size": 128, "learning_rate": 1e-2, **train})
    conf["eval"].update(save_path=str(tmp_path / "saved"), topk=20)
    ds = cls._get_dataset_class()(name, config=config)
    trn, val, tst = ds.build(**conf["data"])
    return cls(conf, device="cpu"), trn, val, tst


def test_short_cpu_fit(tmp_path):
    """Three epochs at d 16 on a small synthetic set: the loss falls, the
    fused and the materialized paths give the same losses from the same
    seeds, and the fitted model evaluates and serves."""
    from recstudio_torch.serving import Predictor
    losses = {}
    for flag in ("auto", "false"):
        model, trn, val, tst = _tiny(tmp_path / flag, fused_softmax=flag)
        model.fit(trn, val)
        losses[flag] = [e["train_loss"] for e in model.epoch_log]
    assert all(np.isfinite(losses["auto"])) and losses["auto"][-1] < losses["auto"][0]
    np.testing.assert_allclose(losses["auto"], losses["false"], rtol=1e-5)
    out = model.evaluate(tst, verbose=False)
    assert np.isfinite(out["ndcg@10"])
    batch = next(iter(tst.eval_loader(8)))
    s, i = Predictor(model, max_batch=8, k=10, train_data=tst).warm()(
        {f: batch[f] for f in sorted(model.query_fields)})
    assert s.shape == (8, 10) and ((i >= 1) & (i < trn.num_items)).all()


def test_training_reference_file():
    with open(TRAIN_REFERENCE) as f:
        ref = json.load(f)
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    assert ref["epochs"] == EPOCHS and [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert 0 < ref["ndcg@10_band"][0] < ref["ndcg@10_band"][1] < 1
    assert ref["untrained_ndcg@10"] == max(r["untrained_ndcg@10"] for r in ref["runs"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if len(sys.argv) > 1:      # one seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(jax_training_run(int(sys.argv[1]))))
        sys.exit(0)
    import subprocess
    procs = [subprocess.Popen([sys.executable, __file__, str(s)], stdout=subprocess.PIPE,
                              text=True, cwd=REPO) for s in REF_SEEDS]
    runs = [json.loads(p.communicate()[0].strip().splitlines()[-1]) for p in procs]
    ndcg = [r["ndcg@10"] for r in runs]
    spread = max(ndcg) - min(ndcg)
    ref = {"about": "recstudio_tpu BERT4Rec on ml-100k at the repo's config (d 64, F 128, "
                    "2 heads, 2 layers, L 20, batch 512, dropout 0.2, mask ratio 0.2, "
                    "adamw 1e-3 / 1e-5), fit(train, val) then evaluate(test), JAX on the "
                    "CPU; band = seeds' range widened by their spread; untrained = the "
                    "largest test NDCG@10 of the seeds' models before fit",
           "epochs": EPOCHS, "runs": runs,
           "ndcg@10_band": [min(ndcg) - spread, max(ndcg) + spread],
           "untrained_ndcg@10": max(r["untrained_ndcg@10"] for r in runs)}
    with open(TRAIN_REFERENCE, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {TRAIN_REFERENCE}")
