"""The mining methods (``train.sampling_method``) against the JAX package's.

Both BPR models hold the same seeded tables and the same cached catalog
(``states["item_vector"]``); the queries are the batch's user rows. The
draws cannot be shared (threefry against Philox), so each method is held
through its deterministic parts:

- ``toprand`` and ``top&rand``: the history-masked top-k of the catalog
  scores (ids exactly); ``top&rand``'s first ``n // 2`` are JAX's; every
  ``toprand`` pick lies in its row's top ``pool``;
- ``brute``: from JAX's own categorical draws, the ids and the log
  probabilities (the draws' from the masked softmax, the positives' from
  the unmasked one, ``-inf`` at a padded positive) to rtol 1e-5;
- ``dns`` and ``sir``: from the same pool (JAX's uniform draw, fed to
  the port's sampler), ``dns``'s picks exactly; ``sir``'s positive log
  probabilities are the positives' scores (the JAX quirk) and each
  pick's log probability is its score, its pick in its row's pool;
- the port's draws against their law: ``brute``'s never hit the masked
  history, ``sir``'s follow the softmax of the pool's scores.
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 48
SPLIT_SEED = 42


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
def pair():
    """JAX and port BPR on the same split with the same tables, the port's
    batch and states and the JAX package's."""
    import jax.numpy as jnp
    from recstudio_tpu.data import TripletDataset as JaxTriplet
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax
    from test_torch_bpr import random_bpr_params
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    np.random.seed(SPLIT_SEED)
    theirs = JaxTriplet("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    jcls, jconf = jax_get_model("BPR")
    jmodel = jcls(jconf)
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    tree = random_bpr_params(5, theirs[0].num_users, theirs[0].num_items, 64)
    jmodel.params = {k: {"embedding": jnp.asarray(v["embedding"])} for k, v in tree.items()}
    cls, conf = get_model("BPR")
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    model.load_state_dict(params_from_jax(tree))
    idx = np.arange(ROWS) * 97
    batch = ours[0]._get_pos_batch(idx)
    batch["user_hist"] = ours[0].user_hist[batch["user_id"]].astype(np.int32)
    item_vector = tree["item_encoder"]["embedding"][1:]
    query = tree["query_encoder"]["embedding"][batch["user_id"]]
    return dict(jmodel=jmodel, model=model, batch=batch, item_vector=item_vector, query=query,
                num_items=ours[0].num_items)


def _jax_sampling(p, method, num_neg, key, excluding_hist=True, batch=None):
    import jax.numpy as jnp
    batch = p["batch"] if batch is None else batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = p["jmodel"].sampling(p["jmodel"].params, jb, key,
                               {"item_vector": jnp.asarray(p["item_vector"])}, num_neg,
                               method=method, excluding_hist=excluding_hist,
                               query=jnp.asarray(p["query"]))
    return [None if o is None else np.asarray(o) for o in out]


def _port_sampling(p, method, num_neg, excluding_hist=True, batch=None, seed=0):
    model = p["model"]
    model.device_generator.manual_seed(seed)
    batch = p["batch"] if batch is None else batch
    return model.sampling({k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                          num_neg, torch.from_numpy(p["query"]), method=method,
                          excluding_hist=excluding_hist,
                          states={"item_vector": torch.from_numpy(p["item_vector"])})


@pytest.mark.parametrize("excluding_hist", [True, False])
def test_topk_candidates_match_jax(pair, excluding_hist):
    import jax.numpy as jnp
    scores = pair["query"] @ pair["item_vector"].T
    hist = pair["batch"]["user_hist"] if excluding_hist else None
    _, jtop = pair["jmodel"]._topk_from_scores(jnp.asarray(scores), 30,
                                              None if hist is None else jnp.asarray(hist))
    _, top = pair["model"]._topk_from_scores(torch.from_numpy(scores), 30,
                                             None if hist is None else torch.from_numpy(hist))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))


def test_toprand_and_top_and_rand(pair):
    import jax
    scores = torch.from_numpy(pair["query"] @ pair["item_vector"].T)
    hist = torch.from_numpy(pair["batch"]["user_hist"])
    _, top = pair["model"]._topk_from_scores(scores, 20, hist)
    lpp, neg, lnp = _port_sampling(pair, "toprand", [20, 8])
    assert neg.shape == (ROWS, 8) and torch.all(lnp == 0) and torch.all(lpp == 0)
    assert all(set(neg[r].tolist()) <= set(top[r].tolist()) for r in range(ROWS))
    _, jneg, _ = _jax_sampling(pair, "top&rand", [20, 8], jax.random.PRNGKey(1))
    _, neg, lnp = _port_sampling(pair, "top&rand", [20, 8])
    np.testing.assert_array_equal(neg[:, :4].numpy(), jneg[:, :4])
    assert int(neg[:, 4:].min()) >= 1 and int(neg[:, 4:].max()) <= pair["num_items"] - 1


def test_brute_log_probs_from_jax_draws(pair):
    """Two positives a row, one padded; history excluded from the draws."""
    import jax
    import jax.numpy as jnp
    batch = dict(pair["batch"])
    pos = np.stack([batch["item_id"], batch["item_id"]], 1).astype(np.int32)
    pos[::3, 1] = 0
    batch["item_id"] = pos
    key = jax.random.PRNGKey(3)
    jlpp, jneg, jlnp = _jax_sampling(pair, "brute", [0, 5], key, batch=batch)
    all_score = torch.from_numpy(pair["query"] @ pair["item_vector"].T)
    logits = pair["model"]._mask_hist_scores(all_score, torch.from_numpy(batch["user_hist"]))
    jl = pair["jmodel"]._mask_hist_scores(jnp.asarray(all_score.numpy()),
                                          jnp.asarray(batch["user_hist"]))
    draws = np.array(jax.random.categorical(key, jl, axis=-1, shape=(10, ROWS))).T
    neg, lnp, lpp = pair["model"]._brute_log_probs(all_score, logits, torch.from_numpy(draws),
                                                   torch.from_numpy(pos))
    np.testing.assert_array_equal(neg.numpy(), jneg)
    np.testing.assert_allclose(lnp.numpy(), jlnp, **TOL)
    np.testing.assert_allclose(lpp.numpy(), jlpp, **TOL)
    assert np.isneginf(lpp.numpy()[::3, 1]).all()
    # the port's own draws: never in the history, log probabilities consistent
    _, neg, lnp = _port_sampling(pair, "brute", [0, 64], batch=batch)
    hist = batch["user_hist"]
    assert not any(np.isin(neg[r].numpy(), hist[r][hist[r] > 0]).any() for r in range(ROWS))
    want = torch.log_softmax(logits, -1).gather(1, neg - 1)
    np.testing.assert_allclose(lnp.numpy(), want.numpy(), **TOL)


class _PoolSampler:
    """A sampler stub returning a fixed pool (the JAX draw); it keeps no
    state."""

    def __init__(self, pool):
        self.pool = torch.from_numpy(pool).long()

    def __call__(self, query, n, gen, pos_items=None, state=None, **kwargs):
        zeros = torch.zeros(pos_items.shape) if pos_items is not None else None
        return zeros, self.pool, torch.zeros(self.pool.shape)


@pytest.mark.parametrize("method", ["dns", "sir"])
def test_pool_methods_from_the_jax_pool(pair, method):
    import jax
    key = jax.random.PRNGKey(7)
    jlpp, jneg, _ = _jax_sampling(pair, method, [24, 6], key, excluding_hist=False)
    # the JAX pool: UniformSampler's draw with the same key (sampler.py:77)
    pool = np.array(jax.random.randint(key, (ROWS, 24), 1, pair["num_items"]))
    model = pair["model"]
    sampler, model.sampler = model.sampler, _PoolSampler(pool)
    try:
        lpp, neg, lnp = _port_sampling(pair, method, [24, 6], excluding_hist=False)
    finally:
        model.sampler = sampler
    if method == "dns":
        np.testing.assert_array_equal(neg.numpy(), jneg)
        assert torch.all(lnp == 0) and torch.all(lpp == 0)
        return
    pos_scores = (pair["query"] * pair["item_vector"][pair["batch"]["item_id"] - 1]).sum(-1)
    np.testing.assert_allclose(lpp.numpy(), jlpp, **TOL)
    np.testing.assert_allclose(lpp.numpy(), pos_scores, **TOL)
    assert all(set(neg[r].tolist()) <= set(pool[r].tolist()) for r in range(ROWS))
    got = np.einsum("bd,bnd->bn", pair["query"], pair["item_vector"][neg.numpy() - 1])
    np.testing.assert_allclose(lnp.numpy(), got, **TOL)
    assert np.all(np.isin(jneg, pool))


def test_sir_resamples_by_the_pool_softmax(pair):
    """2^14 ``sir`` picks of one row from a fixed pool follow the softmax of
    the pool's scores (total variation below twice its expected noise plus
    0.005)."""
    import math
    model = pair["model"]
    pool = np.arange(1, 17)[None, :].repeat(ROWS, 0)
    sampler, model.sampler = model.sampler, _PoolSampler(pool)
    try:
        _, neg, _ = _port_sampling(pair, "sir", [16, 2 ** 14], excluding_hist=False, seed=5)
    finally:
        model.sampler = sampler
    s = pair["query"][0] @ pair["item_vector"][:16].T
    probs = np.exp(s - s.max()) / np.exp(s - s.max()).sum()
    counts = np.bincount(neg[0].numpy() - 1, minlength=16).astype(np.float64)
    n = counts.sum()
    tv = 0.5 * np.abs(counts / n - probs).sum()
    noise = 0.5 * np.sum(np.sqrt(2 * probs * (1 - probs) / (math.pi * n)))
    assert tv <= 2 * noise + 0.005, (tv, noise)


def test_unknown_method_raises():
    from recstudio_torch.utils import get_model
    cls, conf = get_model("BPR")
    conf["train"]["sampling_method"] = "hardest"
    with pytest.raises(ValueError, match="sampling_method"):
        cls(conf, device="cpu")
