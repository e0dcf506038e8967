"""BPR: the port against the JAX package on ml-100k.

- Splits: ratio splits (``user_entry`` with and without shuffle, ``entry``,
  ``user``), a count split and leave-one-out give the JAX package's rows,
  row for row, from the same numpy seed: the flat train index, the
  ``(uid, start, end)`` rows of val and test, each split's ``user_hist``
  (test's merges train and val), and the first multi-target eval batch.
- One training step: both packages hold the same tables
  (``params_from_jax``) and take the same numpy negatives (each model's
  ``sampling`` is replaced on the instance). The loss agrees to 1e-5
  relative, and the gradients, after ``zero_pad_rows_in_grads``, to
  rtol 1e-3 and 1e-4 of each gradient's largest magnitude (``chip_smoke``'s
  ``grad_errors`` tolerance).
- Lazy Adam (``learner: sparse_adam``): three steps of the dense path and
  of the row-sparse path against the JAX package's same path, parameters
  to atol 1e-6 and moments to 1e-6 of their largest magnitude;
  ``row_lazy_adam`` against the JAX function with duplicate ids, id 0 and a
  zero-gradient row, and a bitwise repeat; the row-sparse path against the
  dense path from the same state; the gate's accept and refuse cases.
- Evaluation of one set of weights at BPR's config (eval batch 20,
  cutoffs 5, 10, 20, the six rank metrics) agrees to 1e-5, and the served
  lists of ``Predictor`` agree with the JAX ``Predictor``'s.

``bpr_ml100k_train_reference.json`` holds the JAX package's test NDCG@5
after ``quickstart.run("BPR", "ml-100k")`` at the repo's config, whose
``EPOCHS`` (1000) no fit reaches: each stops early, 10 validations after
its best, and is evaluated at its best validation epoch. It holds three
seeds; ``chip_smoke.py`` holds the card's run of the port to the band they
span. Rewrite it (about a minute on a CPU) with
``JAX_PLATFORMS=cpu python tests/test_torch_bpr.py``.
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
                               "bpr_ml100k_train_reference.json")
EPOCHS = 1000
REF_SEEDS = (2022, 2023, 2024)
SPLIT_SEED = 42
WEIGHT_SEED = 5
NEG_SEED = 17
ROWS = 256
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol): chip_smoke.grad_errors


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
    more, and torch's spinning worker threads slow a fit of tiny steps, and
    every other test process that shares the cores, many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _splits(build):
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k").build(**build)
    return ours, theirs


SPLITS = {
    "user_entry-shuffle": dict(split_ratio=[0.8, 0.1, 0.1], shuffle=True),
    "user_entry": dict(split_ratio=[0.8, 0.1, 0.1], shuffle=False),
    "entry-shuffle": dict(split_ratio=[0.8, 0.1, 0.1], split_mode="entry", shuffle=True),
    "user": dict(split_ratio=[0.7, 0.2, 0.1], split_mode="user"),
    "entry-count": dict(split_ratio=[70000, 6000, 6520], split_mode="entry"),
    "leave-one-out": dict(split_ratio=2, shuffle=True),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_rows_match_jax(name):
    ours, theirs = _splits(SPLITS[name])
    assert len(ours) == len(theirs) == 3
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a.data_index.dtype == b.data_index.dtype, k
        np.testing.assert_array_equal(a.data_index, b.data_index, err_msg=f"split {k}")
        np.testing.assert_array_equal(a.user_hist, b.user_hist, err_msg=f"hist {k}")
        np.testing.assert_array_equal(a.user_count, b.user_count, err_msg=f"count {k}")
    sel = np.random.default_rng(0).integers(0, len(ours[0].data_index), 300)
    got, want = ours[0]._get_pos_batch(sel), theirs[0]._get_pos_batch(sel)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for k in (1, 2):
        assert ours[k]._eval_target_width() == theirs[k]._eval_target_width()
        got = next(iter(ours[k].eval_loader(20)))
        want = next(iter(theirs[k].eval_loader(20)))
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_ratio_split_shape():
    """The default ratio split holds every user in val and test with a
    multi-target row, and test's history is train's and val's together."""
    ours, _ = _splits(SPLITS["user_entry-shuffle"])
    trn, val, tst = ours
    assert len(val.data_index) == len(tst.data_index) == 943
    assert val._eval_target_width() > 1
    for u in (1, 100, 943):
        want = set(trn.user_hist[u][trn.user_hist[u] > 0]) | set(val.user_hist[u][val.user_hist[u] > 0])
        rows = val.data_index[val.data_index[:, 0] == u][0]
        want |= set(val.inter_feat.get_col("item_id")[rows[1]:rows[2]])
        assert set(tst.user_hist[u][tst.user_hist[u] > 0]) == want


# ---------------------------------------------------------------------------
def random_bpr_params(seed, num_users, num_items, embed_dim):
    """Seeded BPR tables in the JAX layout, N(0, 0.1), [PAD] rows 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for tower, n in (("query_encoder", num_users), ("item_encoder", num_items)):
        table = np.asarray(rng.normal(0.0, 0.1, (n, embed_dim)), np.float32)
        table[0] = 0.0
        out[tower] = {"embedding": table}
    return out


def _models(learner="adam"):
    """The JAX and the port's BPR at the repo's config on the same ml-100k
    split, holding the same seeded tables."""
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax
    ours, theirs = _splits(SPLITS["user_entry-shuffle"])
    jcls, jconf = jax_get_model("BPR")
    jconf["train"]["learner"] = learner
    jmodel = jcls(jconf)
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    tree = random_bpr_params(WEIGHT_SEED, theirs[0].num_users, theirs[0].num_items, 64)
    jmodel.params = {k: {"embedding": jnp.asarray(v["embedding"])} for k, v in tree.items()}
    jmodel.val_check = False            # set by fit, which these models skip
    cls, conf = get_model("BPR")
    conf["train"]["learner"] = learner
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    model.load_state_dict(params_from_jax(tree))
    return jmodel, model, ours, theirs


def _inject_negatives(jmodel, model, n_rows, num_items):
    import jax.numpy as jnp
    neg = np.random.default_rng(NEG_SEED).integers(1, num_items, size=(n_rows, 1))
    zeros = np.zeros((n_rows, 1), np.float32)
    jmodel.sampling = lambda *a, **k: (jnp.zeros(n_rows), jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (torch.zeros(n_rows), torch.from_numpy(neg),
                                      torch.from_numpy(zeros))


def _batch(trn):
    n = len(trn.data_index)
    idx = np.arange(0, n, n // ROWS)[:ROWS]
    idx[1] = idx[0]                       # a repeated (user, item) row
    return trn._get_pos_batch(idx)


@pytest.fixture(scope="module")
def step_pair():
    jmodel, model, ours, theirs = _models()
    _inject_negatives(jmodel, model, ROWS, ours[0].num_items)
    return jmodel, model, _batch(ours[0])


def test_model_is_two_tower(step_pair):
    from recstudio_torch.models.basemodel import TwoTowerNet
    from recstudio_torch.models.loss_func import BPRLoss
    from recstudio_torch.models.module import Embedding
    _, model, _ = step_pair
    assert type(model.net) is TwoTowerNet and isinstance(model.loss_fn, BPRLoss)
    assert type(model.item_encoder) is Embedding and type(model.query_encoder) is Embedding
    assert model.query_fields == {"user_id"} and model.neg_count == 1
    assert sorted(n for n, _ in model.net.named_parameters()) == \
        ["item_encoder.weight", "query_encoder.weight"]


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
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    for tower in ("query_encoder", "item_encoder"):
        got, want = grads[tower]["embedding"], jgrads[tower]["embedding"]
        np.testing.assert_allclose(got, want, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(want).max()), err_msg=tower)
        assert float(np.abs(got[0]).max()) == 0.0
        assert float(np.abs(got).max()) > 0.0


def test_bpr_loss_matches_jax():
    """Both branches (``dns`` off and on), several negatives a row."""
    import jax.numpy as jnp
    from recstudio_tpu.models.loss_func import BPRLoss as JaxBPRLoss
    from recstudio_torch.models.loss_func import BPRLoss
    rng = np.random.default_rng(3)
    pos = rng.normal(size=32).astype(np.float32)
    neg = rng.normal(size=(32, 5)).astype(np.float32)
    for dns in (False, True):
        want = JaxBPRLoss(dns)(None, jnp.asarray(pos), None, jnp.asarray(neg), None)
        got = BPRLoss(dns)(None, torch.from_numpy(pos), None, torch.from_numpy(neg), None)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
def _assert_moments(got, want, tag):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(float(np.abs(want).max()), 1e-30), err_msg=tag)


@pytest.mark.parametrize("sparse_rows", [False, True], ids=["dense", "row-sparse"])
def test_three_lazy_adam_steps_match_jax(sparse_rows):
    import jax
    import jax.numpy as jnp
    jmodel, model, ours, _ = _models("sparse_adam")
    _inject_negatives(jmodel, model, ROWS, ours[0].num_items)
    batch = _batch(ours[0])
    opt = jmodel._make_optax("sparse_adam", 1e-3)
    params, state = jmodel.params, opt.init(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel._sparse_rows_flag = sparse_rows
    with jax.default_matmul_precision("float32"):
        for i in range(3):
            params, state, _ = jmodel._grad_step(opt, params, state, jbatch,
                                                 jax.random.PRNGKey(i), jmodel.states)
    model.optimizer = model._get_optimizer()
    model._sparse_rows_flag = sparse_rows
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.net.train()
    for _ in range(3):
        model._grad_step(tbatch)
    model.net.eval()
    (inner,) = state
    assert model.optimizer.param_groups[0]["count"] == int(inner.count) == 3
    for tower in ("query_encoder", "item_encoder"):
        p = getattr(model, tower).weight
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[tower]["embedding"]),
                                   rtol=0, atol=1e-6, err_msg=tower)
        mu, nu = model.optimizer.moments(p)
        _assert_moments(mu.numpy(), np.asarray(inner.mu[tower]["embedding"]), f"mu {tower}")
        _assert_moments(nu.numpy(), np.asarray(inner.nu[tower]["embedding"]), f"nu {tower}")
        assert float(p[0].abs().max()) == 0.0 and float(nu[0].abs().max()) == 0.0


def _row_case(seed=0, N=50, D=8, K=16):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    mu = (rng.normal(size=(N, D)) * 0.1).astype(np.float32)
    nu = (rng.random((N, D)) * 0.01).astype(np.float32)
    ids = rng.integers(0, N, size=K).astype(np.int64)
    ids[3] = ids[7]                      # a duplicate id
    ids[0] = 0                           # the [PAD] row
    g = rng.normal(size=(K, D)).astype(np.float32)
    g[5] = 0.0                           # a row whose gradient is zero
    return table, mu, nu, ids, g


def test_row_lazy_adam_matches_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.optim import row_lazy_adam as jax_row_lazy_adam
    from recstudio_torch.models.optim import row_lazy_adam
    table, mu, nu, ids, g = _row_case()
    assert ids[5] not in np.delete(ids, 5)
    want = jax_row_lazy_adam(jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu),
                             jnp.asarray(ids, jnp.int32), jnp.asarray(g),
                             jnp.asarray(4, jnp.int32), 1e-2)
    outs = []
    for _ in range(2):
        got = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
        row_lazy_adam(*got, torch.from_numpy(ids), torch.from_numpy(g), 4, 1e-2)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)                      # the step repeats bit for bit
    for tag, a, w in zip(("table", "mu", "nu"), outs[0], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=tag)
    t2, mu2, nu2 = outs[0]
    untouched = [0, ids[5]] + [i for i in range(50) if i not in ids]
    for i in untouched:                                 # PAD, zero row, absent rows
        assert torch.equal(t2[i], torch.from_numpy(table[i])), i
        assert torch.equal(mu2[i], torch.from_numpy(mu[i])), i


def test_lazy_adam_matches_jax_on_dense_gradients():
    """``LazyAdam.step`` against optax ``lazy_adam`` on gradients with zero
    rows, from given moments and count."""
    import jax.numpy as jnp
    from recstudio_tpu.models.optim import lazy_adam
    from recstudio_torch.models.optim import LazyAdam
    table, mu, nu, ids, g = _row_case(1)
    gd = np.zeros_like(table)
    np.add.at(gd, ids, g)
    gd[0] = 0.0
    opt = lazy_adam(1e-2)
    state = opt.init(jnp.asarray(table))._replace(count=jnp.asarray(3, jnp.int32),
                                                  mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    upd, new = opt.update(jnp.asarray(gd), state)
    p = torch.nn.Parameter(torch.from_numpy(table.copy()))
    topt = LazyAdam([p], lr=1e-2)
    topt.moments(p)
    topt.state[p]["mu"], topt.state[p]["nu"] = torch.from_numpy(mu.copy()), torch.from_numpy(nu.copy())
    topt.param_groups[0]["count"] = 3
    p.grad = torch.from_numpy(gd)
    topt.step()
    np.testing.assert_allclose(p.detach().numpy(), table + np.asarray(upd), rtol=0, atol=1e-7)
    np.testing.assert_allclose(topt.state[p]["mu"].numpy(), np.asarray(new.mu), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(topt.state[p]["nu"].numpy(), np.asarray(new.nu), rtol=1e-6, atol=1e-9)


def test_segment_rows_sums_in_sorted_order():
    from recstudio_torch.models.optim import segment_rows
    ids = torch.tensor([5, 2, 5, 0, 9, 2, 5])
    g = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    seg_ids, agg = segment_rows(ids, g)
    assert seg_ids.tolist() == [0, 2, 5, 9, 0, 0, 0]
    want = torch.stack([g[3], g[1] + g[5], (g[0] + g[2]) + g[6], g[4]])
    assert torch.equal(agg[:4], want) and not agg[4:].any()


# ---------------------------------------------------------------------------
def _port_bpr(tmp_path, sparse_rows="auto", **train):
    from recstudio_torch.utils import get_model
    ours, _ = _splits(SPLITS["user_entry-shuffle"])
    cls, conf = get_model("BPR")
    conf["train"].update(learner="sparse_adam", sparse_rows=sparse_rows, **train)
    conf["eval"]["save_path"] = str(tmp_path)
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(ours[0])
    return model, ours


def _state(model):
    opt = model.optimizer
    out = {n: p.detach().clone() for n, p in model.net.named_parameters()}
    for n, p in model.net.named_parameters():
        mu, nu = opt.moments(p)
        out[n + ".mu"], out[n + ".nu"] = mu.clone(), nu.clone()
    return out


def _restore(model, snap):
    with torch.no_grad():
        for n, p in model.net.named_parameters():
            p.copy_(snap[n])
            mu, nu = model.optimizer.moments(p)
            mu.copy_(snap[n + ".mu"])
            nu.copy_(snap[n + ".nu"])


def test_row_sparse_path_follows_dense_path(tmp_path):
    """From the same parameters, moments and generator states, the
    row-sparse step and the dense lazy-Adam step draw the same negatives
    and agree (rtol 1e-5, atol 1e-7); over 3 steps, to 1e-6."""
    model, _ = _port_bpr(tmp_path)
    assert model._sparse_rows_enabled()
    batches = model._epoch_batches()
    model.net.train()
    for _ in range(2):                                  # moments away from zero
        model._grad_step(next(batches))
    steps = [next(batches) for _ in range(3)]
    snap, count = _state(model), model.optimizer.param_groups[0]["count"]
    gens = (model.generator.get_state(), model.device_generator.get_state())
    runs = {}
    for flag in (True, False):
        _restore(model, snap)
        for group in model.optimizer.param_groups:
            group["count"] = count
        model.generator.set_state(gens[0])
        model.device_generator.set_state(gens[1])
        model._sparse_rows_flag = flag
        losses = [float(model._grad_step(steps[0]))]
        first = _state(model)
        losses += [float(model._grad_step(b)) for b in steps[1:]]
        runs[flag] = (losses, first, _state(model))
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for key, want in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][key].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for key, want in runs[False][2].items():
        np.testing.assert_allclose(runs[True][2][key].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * max(float(want.abs().max()), 1e-30), err_msg=key)


def test_sparse_gate_rejects_ineligible(tmp_path):
    """The JAX gate's cases (``tests/test_sparse_rows.py``): each of these
    configurations disengages the row-sparse step."""
    from recstudio_torch.ann.sampler import Sampler
    model, _ = _port_bpr(tmp_path)
    for key, val in (("learner", "adam"), ("weight_decay", 0.01),
                     ("grad_clip_norm", 1.0), ("scheduler", "exponential"),
                     ("sampler", "other"), ("sampling_method", "dns"),
                     ("sparse_rows", "false")):
        model._sparse_rows_flag = None
        old = model.config["train"].get(key)
        model.config["train"][key] = val
        if key == "sampler":
            old_sampler, model.sampler = model.sampler, Sampler(100)
        assert not model._sparse_rows_enabled(), key
        model.config["train"][key] = old
        if key == "sampler":
            model.sampler = old_sampler
    model._sparse_rows_flag = None
    assert model._sparse_rows_enabled()


def test_sparse_fit_keeps_pad_rows(tmp_path):
    """One epoch through the row-sparse step, the tail batch wrapped: the
    [PAD] rows and their moments stay 0, and the loss falls."""
    model, ours = _port_bpr(tmp_path, epochs=2)
    model.fit(ours[0])
    assert model._sparse_rows_enabled()
    losses = [e["train_loss"] for e in model.epoch_log]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert len(ours[0].data_index) % 512                # the tail batch wraps
    for p in model.net.parameters():
        mu, nu = model.optimizer.moments(p)
        assert float(p[0].abs().max()) == float(mu[0].abs().max()) == 0.0
        assert float(nu[0].abs().max()) == 0.0
    assert model.optimizer.param_groups[0]["count"] == 2 * -(-len(ours[0].data_index) // 512)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def eval_pair():
    jmodel, model, ours, theirs = _models()
    return jmodel, model, ours[2], theirs[2]


def test_evaluate_matches_jax(eval_pair):
    import jax
    jmodel, model, tst, jtst = eval_pair
    assert model.config["eval"]["batch_size"] == 20
    assert model._cutoffs() == [5, 10, 20]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
    got = model.evaluate(tst, verbose=False)
    assert sorted(got) == sorted(want) and len(got) == 18
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5, atol=1e-7, err_msg=key)


def test_served_lists_match_jax(eval_pair):
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    jmodel, model, tst, jtst = eval_pair
    pred = Predictor(model, max_batch=128, k=20, train_data=tst).warm()
    assert pred._dummy() == {"user_id": pytest.approx(np.zeros(128, np.int32))}
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=20, train_data=jtst).warm()
        for offset, n in ((0, 128), (900, 43)):
            users = tst.data_index[offset:offset + n, 0].astype(np.int32)
            s, i = pred({"user_id": users})
            js, ji = jpred({"user_id": users})
            assert s.shape == (n, 20)
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0
            hist = tst.user_hist[users]
            assert not any(np.isin(i[r], hist[r][hist[r] > 0]).any() for r in range(n))


def test_weights_and_lazy_adam_state_from_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.optim import LazyAdamState
    from recstudio_torch.models.optim import LazyAdam
    from recstudio_torch.utils.convert import (lazy_adam_state_from_jax, params_from_jax,
                                               params_to_jax)
    tree = random_bpr_params(1, 10, 12, 4)
    sd = params_from_jax(tree)
    assert sorted(sd) == ["item_encoder.weight", "query_encoder.weight"]
    back = params_to_jax(sd)
    for tower in tree:
        np.testing.assert_array_equal(back[tower]["embedding"], tree[tower]["embedding"])
    from recstudio_torch.models.basemodel import TwoTowerNet
    from recstudio_torch.models.module import Embedding
    net = TwoTowerNet(Embedding(12, 4), Embedding(10, 4), None)
    net.load_state_dict(sd)
    opt = LazyAdam(net.parameters(), lr=1e-3)
    mu = random_bpr_params(2, 10, 12, 4)
    nu = random_bpr_params(3, 10, 12, 4)
    state = (LazyAdamState(count=jnp.asarray(7, jnp.int32), mu=mu, nu=nu),)
    lazy_adam_state_from_jax(net, opt, state)
    assert opt.param_groups[0]["count"] == 7
    got_mu, got_nu = opt.moments(net.item_encoder.weight)
    np.testing.assert_array_equal(got_mu.numpy(), mu["item_encoder"]["embedding"])
    np.testing.assert_array_equal(got_nu.numpy(), nu["item_encoder"]["embedding"])


# ---------------------------------------------------------------------------
def jax_training_run(seed: int, epochs: int = EPOCHS):
    """One JAX ``quickstart.run("BPR", "ml-100k")`` at the repo's config."""
    from recstudio_tpu.quickstart import run
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model, _, out = run("BPR", "ml-100k", verbose=False,
                        model_config={"train": {"epochs": epochs, "seed": seed},
                                      "eval": {"save_path": tmp}})
    return {"seed": seed, "fit_s": time.time() - t0, "best_epoch": model.callback.best_epoch,
            "ndcg@5": float(out["ndcg@5"]),
            "recall@5": float(out["recall@5"]), "ndcg@20": float(out["ndcg@20"])}


def test_training_reference_file():
    with open(TRAIN_REFERENCE) as f:
        ref = json.load(f)
    ndcg = [r["ndcg@5"] for r in ref["runs"]]
    assert ref["epochs"] == EPOCHS and [r["seed"] for r in ref["runs"]] == list(REF_SEEDS)
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@5_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert 0 < ref["ndcg@5_band"][0] < ref["ndcg@5_band"][1] < 1


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
    ndcg = [r["ndcg@5"] for r in runs]
    spread = max(ndcg) - min(ndcg)
    ref = {"about": "recstudio_tpu BPR on ml-100k at the repo's config (d 64, ratio split "
                    "[0.8, 0.1, 0.1], batch 512, one uniform negative, adam 1e-3, early "
                    "stopping on val NDCG@5 with patience 10), quickstart.run: fit(train, "
                    "val) then evaluate(test), JAX on the CPU; band = seeds' range widened "
                    "by their spread",
           "epochs": EPOCHS, "runs": runs,
           "ndcg@5_band": [min(ndcg) - spread, max(ndcg) + spread]}
    with open(TRAIN_REFERENCE, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {TRAIN_REFERENCE}")
