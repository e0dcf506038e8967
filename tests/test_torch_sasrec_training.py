"""SASRec training: the port against the JAX package on ml-100k.

- One training step: both packages build SASRec on ml-100k at d 16 with
  dropout 0 and the same parameters (``params_from_jax``); the same numpy
  negatives replace both samplers (the JAX model's ``sampling`` attribute
  is set on the instance). The loss and every parameter's gradient, after
  ``zero_pad_rows_in_grads``, agree to rtol 1e-4 and atol 1e-5 times the
  gradient's largest magnitude (float32 on both sides, sums in another
  order); after 3 Adam steps the parameters agree to atol 1e-6 (each step
  moves a parameter by at most the learning rate, 1e-3, so this holds the
  updates to 0.1 %).
- The engine on the CPU: ``fit`` lowers the loss, the tail batch wraps,
  a checkpoint resumes at the next epoch, and ``predict`` after ``fit``
  serves the new weights. Checkpoints go to pytest's ``tmp_path`` only.

``sasrec_ml100k_train_reference.json`` holds the JAX package's test
NDCG@10 and Recall@10 after ``fit(train, val)`` for ``EPOCHS`` epochs at
the repo's config, over three seeds; ``chip_smoke.py`` holds the card's
run of the port to the band those seeds span. Rewrite it (some twenty
minutes on a CPU) with
``JAX_PLATFORMS=cpu python tests/test_torch_sasrec_training.py``.
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
                               "sasrec_ml100k_train_reference.json")
EPOCHS = 20
REF_SEEDS = (2022, 2023, 2024)
NEG_SEED = 17


def jax_training_run(seed: int, epochs: int = EPOCHS):
    """One JAX fit(train, val) + evaluate(test) at the repo's SASRec config."""
    from recstudio_tpu.utils import get_model as jax_get_model
    cls, conf = jax_get_model("SASRec")
    ds = cls._get_dataset_class()("ml-100k")
    trn, val, tst = ds.build(**conf["data"])
    conf["train"].update(epochs=epochs, seed=seed, compile_cache=None)
    with tempfile.TemporaryDirectory() as tmp:
        conf["eval"]["save_path"] = tmp
        model = cls(conf)
        t0 = time.time()
        model.fit(trn, val)
        out = model.evaluate(tst, verbose=False)
    return {"seed": seed, "fit_s": time.time() - t0,
            "ndcg@10": float(out["ndcg@10"]), "recall@10": float(out["recall@10"])}


def _jax_pair(d=16, batch_rows=64):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax

    jcls, jconf = jax_get_model("SASRec")
    jconf["model"].update(embed_dim=d, dropout_rate=0.0)
    jds = jcls._get_dataset_class()("ml-100k")
    jtrn, _, _ = jds.build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params)

    cls, conf = get_model("SASRec")
    conf["model"].update(embed_dim=d, dropout_rate=0.0)
    ds = cls._get_dataset_class()("ml-100k")
    trn, _, _ = ds.build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))

    idx = np.arange(0, len(trn.data_index), len(trn.data_index) // batch_rows)[:batch_rows]
    batch = trn._get_pos_batch(idx)
    neg = np.random.default_rng(NEG_SEED).integers(1, ds.num_items, size=(batch_rows, 1))
    zeros = np.zeros((batch_rows, 1), np.float32)
    jmodel.sampling = lambda *a, **k: (jnp.zeros(batch_rows), jnp.asarray(neg),
                                       jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (torch.zeros(batch_rows), torch.from_numpy(neg),
                                      torch.from_numpy(zeros))
    return jmodel, model, batch


def _assert_tree_close(ours, theirs, rel_atol, path=""):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), path
        for k in theirs:
            _assert_tree_close(ours[k], theirs[k], rel_atol, f"{path}/{k}")
        return
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4,
                               atol=rel_atol * max(float(np.abs(theirs).max()), 1e-3),
                               err_msg=path)


@pytest.fixture(scope="module")
def step_pair():
    return _jax_pair()


def test_training_step_matches_jax(step_pair):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    jmodel, model, batch = step_pair
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jmodel.states)
    jgrads = jax_zero_pad(jgrads)
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    _assert_tree_close(grads, jax.tree_util.tree_map(np.asarray, jgrads), 1e-5)
    assert float(np.abs(grads["query_encoder"]["item_encoder"]["embedding"][0]).max()) == 0.0


def test_three_adam_steps_match_jax(step_pair):
    import jax
    import jax.numpy as jnp
    import optax
    from recstudio_torch.utils.convert import params_to_jax
    jmodel, model, batch = step_pair
    opt = optax.adam(1e-3)
    params, state = jmodel.params, opt.init(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        for i in range(3):
            params, state, _ = jmodel._grad_step(opt, params, state, jbatch,
                                                 jax.random.PRNGKey(i), jmodel.states)
    model.optimizer = model._make_optimizer("adam", 1e-3)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.net.train()
    for _ in range(3):
        model._grad_step(tbatch)
    model.net.eval()
    ours = params_to_jax(model.net.state_dict())
    theirs = jax.tree_util.tree_map(np.asarray, params)
    for path, a, b in _leaves(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=path)


def _leaves(a, b, path=""):
    if isinstance(b, dict):
        for k in b:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


# ---------------------------------------------------------------------------
# the engine, on the CPU
def _tiny(tmp_path, epochs=2, **train):
    from recstudio_torch.data.synthetic import generate
    from recstudio_torch.utils import get_model
    name, config = generate("tiny-shape", 60, 50, 3000, out_dir=str(tmp_path / "data"), seed=1)
    config["max_seq_len"] = 10
    cls, conf = get_model("SASRec")
    conf["model"].update(embed_dim=16, hidden_size=32)
    conf["train"].update({"epochs": epochs, "batch_size": 128, **train})
    conf["eval"].update(save_path=str(tmp_path / "saved"), topk=20)
    ds = cls._get_dataset_class()(name, config=config)
    trn, val, tst = ds.build(**conf["data"])
    return cls(conf, device="cpu"), trn, val, tst


def test_fit_lowers_the_loss_on_ml100k(tmp_path):
    """Two epochs at d 16 on ml-100k, dropout 0.5: finite and falling loss,
    finite test metrics."""
    from recstudio_torch.utils import get_model
    cls, conf = get_model("SASRec")
    conf["model"].update(embed_dim=16, hidden_size=32)
    conf["train"]["epochs"] = 2
    conf["eval"]["save_path"] = str(tmp_path)
    ds = cls._get_dataset_class()("ml-100k")
    trn, val, tst = ds.build(**conf["data"])
    model = cls(conf, device="cpu").fit(trn, val)
    losses = [e["train_loss"] for e in model.epoch_log]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0]
    out = model.evaluate(tst, verbose=False)
    assert set(out) >= {"ndcg@10", "recall@10"} and all(np.isfinite(list(out.values())))
    assert os.path.isfile(model.ckpt_path) and model.ckpt_path.startswith(str(tmp_path))


def test_epoch_tail_wraps_to_the_head(tmp_path):
    model, trn, _, _ = _tiny(tmp_path, batch_size=7)
    model._init_model(trn)
    n = 23
    model._epoch_rows = n
    model._epoch_arrays = {"row": torch.arange(n)}
    model._batch_fn = lambda arrays, sel: {"row": arrays["row"][sel]}
    batches = [b["row"] for b in model._epoch_batches()]
    assert [len(b) for b in batches] == [7, 7, 7, 7]
    rows = torch.cat(batches)
    assert sorted(rows[:n].tolist()) == list(range(n))      # one permutation
    assert torch.equal(rows[n:], rows[:28 - n])              # the tail wraps to the head
    n, bs = len(trn.data_index), 1000
    tail = list(trn.train_loader(bs, shuffle=False))[-1]     # the host loader wraps too
    assert int(tail["_size"]) == bs and n % bs
    head = trn._get_pos_batch(np.arange(bs - n % bs))
    for key in head:
        np.testing.assert_array_equal(tail[key][n % bs:], head[key], err_msg=key)


def test_checkpoint_resumes_at_the_next_epoch(tmp_path):
    model, trn, val, _ = _tiny(tmp_path, epochs=1)
    model.fit(trn)
    saved = {k: v.clone() for k, v in model.net.state_dict().items()}
    assert torch.load(model.ckpt_path, weights_only=True)["epoch"] == 0
    resumed, _, _, _ = _tiny(tmp_path, epochs=3)
    resumed._init_model(trn)
    resumed._init_parameter(trn)
    resumed.optimizer = resumed._get_optimizer()
    resumed.load_checkpoint(model.ckpt_path, restore_optimizer=True)
    for k, v in resumed.net.state_dict().items():
        assert torch.equal(v, saved[k]), k
    resumed.fit(trn, resume_from=model.ckpt_path)
    assert [e["epoch"] for e in resumed.epoch_log] == [1, 2]
    assert torch.load(resumed.ckpt_path, weights_only=True)["epoch"] == 2


def test_predict_after_fit_serves_the_new_weights(tmp_path):
    from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
    model, trn, val, tst = _tiny(tmp_path, epochs=1)
    model._init_model(trn)
    model._init_parameter(trn)
    batch = next(iter(tst.eval_loader(16)))
    req = {f: batch[f] for f in ("in_item_id", "seqlen", "user_id")}
    before = model.predict(req, 10)[0]
    assert "item_vector" in model.states                     # predict caches the catalog
    model.fit(trn, val)
    assert "item_vector" not in model.states                 # fit dropped the stale catalog
    after = model.predict(req, 10)[0]
    assert not np.allclose(before, after)
    with torch.no_grad():
        fresh = model.score_func.catalog(model.net.encode_query(
            {k: torch.from_numpy(v) for k, v in req.items()}), model._compute_item_vector())
    np.testing.assert_allclose(after[:, 0], fresh.max(-1).values.numpy(), rtol=1e-6)
    tree = random_sasrec_params(3, trn.num_items, 16, 10, 32, 2)
    model.load_state_dict(params_from_jax(tree))             # so does a load
    assert "item_vector" not in model.states
    assert not np.allclose(after, model.predict(req, 10)[0])


def test_training_reference_file():
    with open(TRAIN_REFERENCE) as f:
        ref = json.load(f)
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    assert ref["epochs"] == EPOCHS and [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert 0 < ref["ndcg@10_band"][0] < ref["ndcg@10_band"][1] < 1


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if len(sys.argv) > 1:      # one seed: print its run as JSON
        print(json.dumps(jax_training_run(int(sys.argv[1]))))
        sys.exit(0)
    import subprocess
    procs = [subprocess.Popen([sys.executable, __file__, str(s)], stdout=subprocess.PIPE,
                              text=True, cwd=REPO) for s in REF_SEEDS]
    runs = [json.loads(p.communicate()[0].strip().splitlines()[-1]) for p in procs]
    ndcg = [r["ndcg@10"] for r in runs]
    spread = max(ndcg) - min(ndcg)
    ref = {"about": "recstudio_tpu SASRec on ml-100k at the repo's config (d 64, L 20, "
                    "batch 512, dropout 0.5, adam 1e-3), fit(train, val) then "
                    "evaluate(test), JAX on the CPU; band = seeds' range widened by "
                    "their spread",
           "epochs": EPOCHS, "runs": runs,
           "ndcg@10_band": [min(ndcg) - spread, max(ndcg) + spread]}
    with open(TRAIN_REFERENCE, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {TRAIN_REFERENCE}")
