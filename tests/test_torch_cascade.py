"""The two-stage cascade: a fitted retriever attached to a ranker
(``BaseRanker(config, retriever=..., loss=...)``), the port against the
JAX package.

Two pairs, each on the same numpy weights in both packages: BPR -> FM on
ml-100k as a ``TripletDataset`` (the pair of ``tests/test_two_stage.py``),
and SASRec -> DIN on ml-100k as a ``SeqDataset`` (L 8, d 16, DIN with
Dice and calibrated batch norms, dropout off):

- ``topk``: the retriever's top ``eval.topk`` reranked by the ranker, the
  same lists as JAX's (up to ties of equal scores) and scores to 1e-5;
- one cascaded training step with the same injected negatives and log
  probabilities: the pairwise loss (``BinaryCrossEntropyLoss``) to 1e-5
  relative and the ranker's gradients to 1e-4 of the largest + 1e-3
  relative; no gradient reaches the retriever, whose weights stay put;
- ``evaluate``'s rank metrics (recall@5, ndcg@5) equal to JAX's;
- ``Predictor`` over the cascade serves ``topk``'s lists;
- the ranker reads the retriever as it was attached: weights put into the
  live retriever afterwards move ``topk`` neither after a catalog refresh
  nor after ``states`` is cleared (as a restore clears it);
- ``k`` above the retriever's ``eval.topk`` and an unfitted retriever
  raise (a multitask ranker with a retriever: ``test_torch_multitask.py``).
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42
WEIGHT_SEED = 9
RETR_K, K = 30, 10
TOL_GRAD = (1e-4, 1e-3)


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


PAIRS = {
    "BPR->FM": ("BPR", {}, "FM", {}, "TripletDataset", {}),
    "SASRec->DIN": ("SASRec", {"embed_dim": 16, "hidden_size": 16, "layer_num": 1,
                               "dropout_rate": 0.0},
                    "DIN", {"embed_dim": 16, "attention_mlp": [8], "fc_mlp": [8, 4],
                            "dropout": 0.0},
                    "SeqDataset", {"low_rating_thres": 0.0, "max_seq_len": 8}),
}


def _draw(tree, seed):
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "count":
            return np.float32(4.0)
        if name == "var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        scale = name in ("scale",) or name.endswith("norm1_scale") or name.endswith("_scale")
        a = rng.normal(1.0 if scale else 0.0, 0.2, leaf.shape).astype(np.float32)
        if name == "embedding" or (name.endswith("_embedding") and name != "dense_embedding"):
            a[0] = 0.0
        return a
    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, tree))


_BUILT = {}


def _cascade(pair):
    """The JAX and the port's cascade of ``pair`` on the same splits and
    weights: ``(jax ranker, port ranker, (port splits), (jax splits))``."""
    if pair in _BUILT:
        return _BUILT[pair]
    import jax
    import jax.numpy as jnp
    from recstudio_tpu import data as jdata
    from recstudio_tpu.models.loss_func import BinaryCrossEntropyLoss as JaxBCE
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch import data
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import cascade_params_from_jax
    rname, rmodel, name, model_conf, kind, data_conf = PAIRS[pair]
    confs = []
    for getter in (jax_get_model, get_model):
        rcls, rconf = getter(rname)
        rconf["model"].update(rmodel)
        rconf["eval"].update(topk=RETR_K)
        cls, conf = getter(name)
        conf["model"].update(model_conf)
        conf["data"].update(fmeval=False, binarized_rating_thres=0.0)
        conf["train"].update(batch_size=64, negative_count=2, sampling_method="none")
        conf["eval"].update(topk=K, cutoff=[5], batch_size=64, val_metrics=["ndcg"],
                            test_metrics=["recall", "ndcg"])
        confs.append((rcls, rconf, cls, conf))
    built = []
    for module, (rcls, rconf, cls, conf), kw, loss in (
            (jdata, confs[0], {}, JaxBCE()), (data, confs[1], {"device": "cpu"},
                                              BinaryCrossEntropyLoss())):
        np.random.seed(SPLIT_SEED)
        splits = getattr(module, kind)("ml-100k", config=dict(data_conf)).build(**conf["data"])
        retriever = rcls(rconf, **kw)
        retriever._init_model(splits[0])
        retriever._init_parameter(splits[0])
        built.append((splits, retriever, cls, conf, kw, loss))
    (jsplits, jretr, jcls, jconf, _, jloss), (splits, retr, cls, conf, kw, loss) = built
    jretr.params = jax.tree_util.tree_map(jnp.asarray, _draw(jretr.params, WEIGHT_SEED))
    jranker = jcls(jconf, retriever=jretr, loss=jloss)
    jranker._init_model(jsplits[0])
    jranker._init_parameter(jsplits[0])
    jranker.val_check = False
    stats = jranker.states.get("net", {}).get("batch_stats", {})
    params, stats = _draw(jranker.params, WEIGHT_SEED + 1), _draw(stats, WEIGHT_SEED + 2)
    jranker.params = jax.tree_util.tree_map(jnp.asarray, params)
    if stats:
        jranker.states["net"] = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    jranker._epoch_refresh(-1)
    # the JAX cascade's nested retriever parameters load into the port's
    # retriever before the ranker freezes it (its net, built once before,
    # gives the converter the ranker's layout)
    ranker = cls(conf, retriever=retr, loss=loss, **kw)
    ranker._init_model(splits[0])
    ranker_sd, retr_sd = cascade_params_from_jax(params, jranker.states, ranker.net, stats)
    retr.load_state_dict(retr_sd)
    ranker._init_model(splits[0])
    ranker._init_parameter(splits[0])
    ranker.load_state_dict(ranker_sd)
    _BUILT[pair] = (jranker, ranker, splits, jsplits)
    return _BUILT[pair]


def _eval_batch(split, model, n=64):
    split.use_field = model.fields
    return next(iter(split.eval_loader(n)))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_topk_matches_jax(pair):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.parity import topk_mismatches
    jranker, ranker, splits, jsplits = _cascade(pair)
    batch = _eval_batch(splits[2], ranker)
    jbatch = _eval_batch(jsplits[2], jranker)
    assert sorted(batch) == sorted(jbatch)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    with jax.default_matmul_precision("float32"):
        want_s, want_i = jranker.topk(jranker.params, jb, K, user_hist=jb["user_hist"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got_s, got_i = ranker.topk(tb, K, tb["user_hist"])
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)
    assert topk_mismatches(got_i.numpy(), got_s.numpy(), want_i, want_s, 1e-5) == 0
    assert (got_i.numpy() > 0).all()


def _inject(pair, monkeypatch, batch_size):
    """Patch both retrievers' ``sampling`` to give the same negatives and
    log probabilities."""
    import jax.numpy as jnp
    jranker, ranker, _, _ = _cascade(pair)
    rng = np.random.default_rng(3)
    n = ranker.retriever.num_items
    neg = rng.integers(1, n, (batch_size, 2)).astype(np.int32)
    lpp = rng.normal(-3.0, 0.5, batch_size).astype(np.float32)
    lnp = rng.normal(-3.0, 0.5, (batch_size, 2)).astype(np.float32)
    monkeypatch.setattr(jranker.retriever, "sampling", lambda *a, **k: (
        jnp.asarray(lpp), jnp.asarray(neg), jnp.asarray(lnp)))
    monkeypatch.setattr(ranker.retriever, "sampling", lambda *a, **k: (
        torch.from_numpy(lpp), torch.from_numpy(neg), torch.from_numpy(lnp)))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_cascade_step_matches_jax_and_leaves_the_retriever(pair, monkeypatch):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import ranker_params_to_jax
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    jranker, ranker, splits, _ = _cascade(pair)
    trn = splits[0]
    trn.use_field = ranker.fields
    batch = trn._get_pos_batch(np.arange(0, 64 * 37, 37) % len(trn.data_index))
    _inject(pair, monkeypatch, 64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jranker._loss_and_aux, has_aux=True)(
            jranker.params, jb, jax.random.PRNGKey(0), jranker.states)
    before = {k: v.clone() for k, v in ranker.retriever.net.state_dict().items()}
    ranker.net.train()
    ranker.net.zero_grad(set_to_none=True)
    loss = ranker.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(ranker.net)
    ranker.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ranker_params_to_jax({n: p.grad for n, p in ranker.net.named_parameters()}, ranker.net)
    want = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    if "dense_mlp" in want:                 # DIN: dense_{i} feeds bn_{i} in training
        for i in range(2):
            for tree in (grads, want):
                assert float(np.abs(tree["dense_mlp"][f"dense_{i}"].pop("bias")).max()) \
                    < 1e-6 * largest
    for key, w in jax.tree_util.tree_leaves_with_path(want):
        node = grads
        for p in key:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=str(key))
    rs = ranker.states["retriever"]
    assert all(not p.requires_grad and p.grad is None for p in rs["net"].parameters())
    assert all(p.grad is None for p in ranker.retriever.net.parameters())
    assert all(torch.equal(before[k], v) for k, v in ranker.retriever.net.state_dict().items())
    assert not set(map(id, ranker.optimizer.param_groups[0]["params"]
                       if ranker.optimizer else [])) & set(map(id, rs["net"].parameters()))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_rank_metrics_of_evaluate_match_jax(pair):
    import jax
    jranker, ranker, splits, jsplits = _cascade(pair)
    jranker._train_data, ranker._train_data = jsplits[0], splits[0]
    with jax.default_matmul_precision("float32"):
        want = jranker.evaluate(jsplits[2], verbose=False)
    got = ranker.evaluate(splits[2], verbose=False)
    assert sorted(got) == sorted(want) == ["ndcg@5", "recall@5"]
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_predictor_serves_the_cascade(pair):
    from recstudio_torch.serving import Predictor
    _, ranker, splits, _ = _cascade(pair)
    batch = _eval_batch(splits[2], ranker, 40)
    pred = Predictor(ranker, max_batch=48, k=K, train_data=splits[2]).warm()
    request = {f: batch[f] for f in pred._fields}
    scores, items = pred(request)
    tb = {k: torch.from_numpy(v) for k, v in request.items()}
    want_s, want_i = ranker.topk(tb, K, torch.from_numpy(splits[2].user_hist[batch["user_id"]]))
    assert items.shape == (40, K)
    np.testing.assert_array_equal(items, want_i.numpy())
    np.testing.assert_allclose(scores, want_s.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_cascade_reads_the_retriever_as_attached(pair):
    _, ranker, splits, _ = _cascade(pair)
    tb = {k: torch.from_numpy(v) for k, v in _eval_batch(splits[2], ranker, 16).items()}
    want_s, want_i = ranker.topk(tb, K, tb["user_hist"])
    live = ranker.retriever.net
    saved = {k: v.clone() for k, v in live.state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    try:
        with torch.no_grad():
            for p in live.parameters():
                p.add_(torch.randn(p.shape, generator=gen))
        moved_s, _ = ranker.retriever.topk(tb, K, tb["user_hist"])
        ranker._epoch_refresh(-1)
        refreshed = ranker.topk(tb, K, tb["user_hist"])
        ranker.states.clear()
        rebuilt = ranker.topk(tb, K, tb["user_hist"])
    finally:
        live.load_state_dict(saved)
    assert not torch.allclose(moved_s, ranker.retriever.topk(tb, K, tb["user_hist"])[0])
    for got_s, got_i in (refreshed, rebuilt):
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_s, want_s)


def test_cascade_raises_where_the_jax_package_does():
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    from recstudio_torch.utils import get_model
    _, ranker, splits, _ = _cascade("BPR->FM")
    batch = {k: torch.from_numpy(v) for k, v in _eval_batch(splits[2], ranker, 8).items()}
    with pytest.raises(ValueError, match="eval.topk"):
        ranker.topk(batch, RETR_K + 1)
    bpr_cls, bpr_conf = get_model("BPR")
    fm_cls, fm_conf = get_model("FM")
    fm_conf["data"].update(fmeval=False, binarized_rating_thres=0.0)
    unfitted = fm_cls(fm_conf, device="cpu", retriever=bpr_cls(bpr_conf, device="cpu"),
                      loss=BinaryCrossEntropyLoss())
    with pytest.raises(ValueError, match="must be fitted"):
        unfitted._init_model(splits[0])
    plain = fm_cls(fm_conf, device="cpu")
    plain._init_model(splits[0])
    with pytest.raises(NotImplementedError, match="cascaded retriever"):
        plain.topk(batch, 5)
