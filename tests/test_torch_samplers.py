"""The port's samplers against the JAX package's.

JAX's draws (threefry, Gumbel-max categoricals) cannot be reproduced by a
``torch.Generator``, so each sampler is held to the JAX one through its
deterministic parts, and its random parts to their distributions:

- ``update`` states, built by the port from the JAX k-means result
  (``build_state``) or, for LSH, from the JAX hyperplanes: index arrays
  exactly, floats to rtol 1e-5 (atol 1e-6), but the in-bucket CDF ``cp``
  to atol 1e-4: the JAX package takes it from one float32 cumulative sum
  over the whole catalog less each bucket's start, whose rounding at the
  catalog's total is divided by a bucket's weight (the port sums each
  bucket alone);
- ``compute_item_p`` for queries ``[B, D]`` (one positive, a row of
  several) and ``[B, L, D]`` (a row of negatives per position), to rtol
  1e-5 (atol 1e-5);
- the maps from draws to ids (``ids_from_noise``, ``ids_from_uniform``),
  fed the JAX sampler's own draws (the Gumbel noise and uniforms it draws
  from the same key): ids exactly, log probabilities to rtol 1e-5;
- each out-of-range gather JAX clamps (a CDF search past the end, an
  empty last bucket in both in-bucket draws, an LSH query with no
  candidate) gives the JAX result;
- the port's draws, 2^17 of them, against the sampler's own proposal at
  the bucket or item level: total variation below twice its expected
  noise plus 0.005.

Two pinned differences: ``PopularSamplerModel``'s last item keeps its
probability (JAX gives it 1, ``sampler.py:129``), and a popularity-weighted
in-bucket draw reports the drawn item's weight (JAX reads the weight at
the draw's place in the index, ``sampler.py:255``), so the port's
``log_neg_prob`` is ``compute_item_p`` of its draws.
"""
import math

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_P = dict(rtol=1e-5, atol=1e-5)
TOL_CP = dict(rtol=0.0, atol=1e-4)
N_ITEMS = 201                # includes [PAD]
D = 8
K = 4
DRAWS = 2 ** 17


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _embs(seed=0, n=N_ITEMS - 1, d=D):
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, (6, d))
    return (c[rng.integers(0, 6, n)] + rng.normal(0.0, 0.3, (n, d))).astype(np.float32)


def _pop(seed=1, n=N_ITEMS):
    return np.random.default_rng(seed).integers(0, 50, n).astype(np.int64)


def _queries(seed, shape):
    return np.random.default_rng(seed).normal(0.0, 0.5, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(kind, scorer=None):
    """(JAX sampler, port sampler) of ``kind`` with the same settings."""
    from recstudio_tpu.ann import sampler as J
    from recstudio_tpu.models import scorer as JS
    from recstudio_torch.ann import sampler as P
    from recstudio_torch.models import scorer as PS
    js = {None: None, "cos": JS.CosineScorer(), "euc": JS.EuclideanScorer()}[scorer]
    ps = {None: None, "cos": PS.CosineScorer(), "euc": PS.EuclideanScorer()}[scorer]
    if kind == "midx-uni":
        return J.MIDXSamplerUniform(N_ITEMS, K, js), P.MIDXSamplerUniform(N_ITEMS, K, ps)
    if kind == "midx-pop":
        return J.MIDXSamplerPop(_pop(), K, js), P.MIDXSamplerPop(_pop(), K, ps)
    if kind == "cluster-uni":
        return J.ClusterSamplerUniform(N_ITEMS, K, js), P.ClusterSamplerUniform(N_ITEMS, K, ps)
    if kind == "cluster-pop":
        return J.ClusterSamplerPop(_pop(), K, js), P.ClusterSamplerPop(_pop(), K, ps)
    raise ValueError(kind)


def _states(kind, scorer=None, seed=3):
    """The JAX sampler's state and the port's, built from the JAX k-means."""
    import jax
    import jax.numpy as jnp
    jsam, psam = _pair(kind, scorer)
    embs = _embs()
    with jax.default_matmul_precision("float32"):
        jstate = jsam.update(jax.random.PRNGKey(seed), jnp.asarray(embs))
    x = torch.from_numpy(embs)
    if scorer == "cos":
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    if kind.startswith("midx"):
        pstate = psam.build_state(x, _t(jstate["c0"]), _t(jstate["cd0"][1:] - 1).long(),
                                  _t(jstate["c1"]), _t(jstate["cd1"][1:] - 1).long())
    else:
        pstate = psam.build_state(x, _t(jstate["c"]), _t(jstate["cd"][1:] - 1).long())
    return jsam, psam, jstate, pstate


KINDS = [("midx-uni", None), ("midx-uni", "euc"), ("midx-uni", "cos"), ("midx-pop", None),
         ("midx-pop", "euc"), ("cluster-uni", None), ("cluster-uni", "euc"),
         ("cluster-pop", None)]
KIND_IDS = [k + ("" if s is None else "-" + s) for k, s in KINDS]


@pytest.mark.parametrize("kind,scorer", KINDS, ids=KIND_IDS)
def test_update_state_matches_jax(kind, scorer):
    _, _, jstate, pstate = _states(kind, scorer)
    assert sorted(jstate) == sorted(pstate)
    for key, want in jstate.items():
        want, got = np.asarray(want), pstate[key].numpy()
        assert got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **(TOL_CP if key == "cp" else TOL))


@pytest.mark.parametrize("kind,scorer", KINDS, ids=KIND_IDS)
def test_compute_item_p_matches_jax(kind, scorer):
    import jax.numpy as jnp
    jsam, psam, jstate, pstate = _states(kind, scorer)
    rng = np.random.default_rng(4)
    q2 = _queries(5, (6, D))
    one = rng.integers(1, N_ITEMS, 6).astype(np.int32)
    row = rng.integers(1, N_ITEMS, (6, 5)).astype(np.int32)
    q3 = _queries(6, (3, 4, D))
    per_pos = rng.integers(1, N_ITEMS, (3, 4, 5)).astype(np.int32)
    for q, items in ((q2, one), (q2, row), (q3, per_pos)):
        want = np.asarray(jsam.compute_item_p(jstate, jnp.asarray(q), jnp.asarray(items)))
        got = psam.compute_item_p(_t(q), _t(items).long(), pstate).numpy()
        assert got.shape == want.shape == items.shape
        np.testing.assert_allclose(got, want, **TOL_P)


@pytest.mark.parametrize("kind", ["midx-uni", "cluster-uni"])
def test_sequence_positives_scored_by_position(kind):
    """A query ``[B, L, D]`` with positives ``[B, L]``: the JAX einsum
    gives ``[B, L, L]`` and raises; the port scores each position with its
    own query, as the same positive in a row of one does."""
    import jax.numpy as jnp
    jsam, psam, jstate, pstate = _states(kind)
    q = _queries(7, (3, 4, D))
    pos = np.random.default_rng(8).integers(1, N_ITEMS, (3, 4)).astype(np.int32)
    with pytest.raises(TypeError):
        jsam.compute_item_p(jstate, jnp.asarray(q), jnp.asarray(pos))
    got = psam.compute_item_p(_t(q), _t(pos).long(), pstate)
    want = psam.compute_item_p(_t(q), _t(pos[..., None]).long(), pstate)[..., 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_P)


def _jax_noise(kind, key, n_query, num_neg):
    """The draws the JAX sampler makes from ``key`` (``sampler.py:220-226``,
    ``:333-336``): Gumbel noise ``[Q, neg, K]`` and uniforms ``[Q, neg]``."""
    import jax
    if kind.startswith("midx"):
        k0key, k1key, ikey = jax.random.split(key, 3)
        g0 = np.moveaxis(np.asarray(jax.random.gumbel(k0key, (num_neg, n_query, K))), 0, 1)
        g1 = np.asarray(jax.random.gumbel(k1key, (1, n_query, num_neg, K)))[0]
        u = np.asarray(jax.random.uniform(ikey, (n_query, num_neg)))
        return [_t(g0), _t(g1), _t(u)]
    kkey, ikey = jax.random.split(key)
    g = np.moveaxis(np.asarray(jax.random.gumbel(kkey, (num_neg, n_query, K))), 0, 1)
    return [_t(g), _t(np.asarray(jax.random.uniform(ikey, (n_query, num_neg))))]


@pytest.mark.parametrize("kind,scorer", KINDS, ids=KIND_IDS)
def test_draw_map_matches_jax_on_jax_draws(kind, scorer):
    import jax
    import jax.numpy as jnp
    jsam, psam, jstate, pstate = _states(kind, scorer)
    q = _queries(9, (16, D))
    key = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("float32"):
        jneg, jprob = jsam(jstate, key, jnp.asarray(q), 12)
        jq = jnp.asarray(q)
        if scorer == "cos":
            jq = jq / (jnp.linalg.norm(jq, axis=-1, keepdims=True) + 1e-12)
        j_item_p = np.asarray(jsam.compute_item_p(jstate, jq, jneg))
    pq = psam._queries(_t(q))
    neg, prob = psam.ids_from_noise(pstate, pq, *_jax_noise(kind, key, 16, 12))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    if "p" not in pstate:       # uniform in the bucket: both report the bucket's score
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **TOL_P)
    # the port's log_neg_prob is compute_item_p of its draws (JAX's is not
    # when items carry weights)
    np.testing.assert_allclose(prob.numpy(), j_item_p, **TOL_P)
    np.testing.assert_allclose(prob.numpy(), psam.compute_item_p(pq, neg, pstate).numpy(),
                               **TOL_P)
    if "p" in pstate:
        assert not np.allclose(np.asarray(jprob), j_item_p, **TOL_P)


@pytest.mark.parametrize("kind", ["midx-uni", "midx-pop"])
def test_empty_last_bucket_clamps_as_jax(kind):
    """A draw of the last bucket when it holds no item reads past the index
    (``sampler.py:245``, ``:250-255``); JAX clamps, so must the port."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.ops.kmeans import construct_index as jax_index
    from recstudio_tpu.ann import sampler as J
    from recstudio_torch.ann import sampler as P
    jsam, psam, jstate, pstate = _states(kind)
    jstate, pstate = dict(jstate), dict(pstate)
    # re-index with no item in the last bucket (k0 = k1 = K - 1 moved to 0)
    cd01 = (np.asarray(jstate["cd0"][1:]) - 1) * K + np.asarray(jstate["cd1"][1:]) - 1
    cd01[cd01 == K * K - 1] = 0
    ji, jp = jax_index(jnp.asarray(cd01, jnp.int32), K * K)
    jstate["indices"], jstate["indptr"] = ji, jp
    pstate["indices"], pstate["indptr"] = _t(ji).long(), _t(jp).long()
    if "cp" in jstate:
        norm = jstate["p"][1:]
        J.MIDXSamplerUniform._attach_pop_cdf(jsam, jstate, norm)
        P.MIDXSamplerUniform._attach_pop_cdf(psam, pstate, _t(norm))
    assert int(jp[-1]) == int(jp[-2])                           # the last bucket is empty
    k01 = jnp.asarray(np.array([[K * K - 1, 0, K * K - 1]], np.int32))
    p01 = jnp.zeros((1, 3))
    key = jax.random.PRNGKey(2)
    jneg, jprob = jsam._sample_in_bucket(jstate, key, k01, p01)
    u = _t(np.asarray(jax.random.uniform(key, (1, 3))))
    neg, prob = psam._sample_in_bucket(pstate, u, _t(k01).long(), torch.zeros(1, 3))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    if "cp" not in jstate:
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **TOL_P)
    assert int(neg.max()) <= N_ITEMS - 1


def test_bisect_clamps_a_probe_past_the_end():
    """``_bisect`` from an empty last bucket (start = len) probes ``cdf[len]``,
    which JAX clamps to the last entry (``sampler.py:45-53``)."""
    import jax.numpy as jnp
    from recstudio_tpu.ann.sampler import _bisect as jax_bisect
    from recstudio_torch.ann.sampler import _bisect
    cdf = np.array([0.2, 0.7, 1.0, 0.5, 1.0], np.float32)
    lo = np.array([0, 0, 3, 5, 5, 3])
    hi = np.array([2, 2, 4, 5, 5, 4])
    u = np.array([0.1, 0.75, 0.6, 0.3, 0.99, 1.0], np.float32)
    want = np.asarray(jax_bisect(jnp.asarray(cdf), jnp.asarray(lo), jnp.asarray(hi),
                                 jnp.asarray(u)))
    got = _bisect(_t(cdf), _t(lo), _t(hi), _t(u))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
def test_popular_sampler_state_and_map_against_jax():
    """The CDF and the map from uniforms (JAX's own) to ids; the last
    item's probability kept (the pinned difference)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.ann.sampler import PopularSamplerModel as JaxPop
    from recstudio_torch.ann.sampler import PopularSamplerModel
    pop = _pop()
    for mode in (0, 1, 2):
        js, ps = JaxPop(pop, mode=mode), PopularSamplerModel(pop, mode=mode)
        jstate, pstate = js.update(None, None), ps.update(torch.zeros(1), None)
        jt, pt = np.asarray(jstate["table"]), pstate["table"].numpy()
        np.testing.assert_allclose(pt[:-1], jt[:-1], **TOL)
        assert pt[-1] == 1.0 and jt[-1] < 1.0 + 1e-6
        jp, pp = np.asarray(jstate["pop_prob"]), pstate["pop_prob"].numpy()
        np.testing.assert_allclose(pp[:-1], jp[:-1], **TOL)
        assert jp[-1] == 1.0                                   # JAX: log p = 0 for the last item
        np.testing.assert_allclose(pp[-1], 1.0 - pt[-2], rtol=1e-3)  # its own mass
        key = jax.random.PRNGKey(mode)
        q = jnp.zeros((64, D))
        jneg, _ = js(jstate, key, q, 30)
        u = _t(np.asarray(jax.random.uniform(key, (64, 30))))
        np.testing.assert_array_equal(ps.ids_from_uniform(pstate, u).numpy(), np.asarray(jneg))
        items = torch.arange(N_ITEMS - 1)
        np.testing.assert_allclose(ps.compute_item_p(None, items, pstate).numpy(),
                                   np.asarray(js.compute_item_p(jstate, None,
                                                                jnp.arange(N_ITEMS - 1))),
                                   **TOL)


def test_popular_sampler_search_past_the_end_clamps():
    """A uniform above a CDF that ends below 1 searches to ``N``: JAX's
    gather clamps it to the last item, and so does the port's map."""
    from recstudio_tpu.ann.sampler import PopularSamplerModel as JaxPop
    from recstudio_torch.ann.sampler import PopularSamplerModel
    pop = _pop()
    js, ps = JaxPop(pop), PopularSamplerModel(pop)
    jstate = js.update(None, None)
    state = {"table": _t(jstate["table"]) * 0.999, "pop_prob": _t(jstate["pop_prob"])}
    u = torch.tensor([[0.9995, 0.99999994, 0.0]])
    ids = ps.ids_from_uniform(state, u)
    want = np.minimum(np.searchsorted(state["table"].numpy(), u.numpy().ravel()), N_ITEMS - 1)
    np.testing.assert_array_equal(ids.numpy().ravel(), want)
    assert int(ids[0, 0]) == N_ITEMS - 1 and int(ids[0, 1]) == N_ITEMS - 1


# ---------------------------------------------------------------------------
def _lsh_pair(n_bits=3, n_table=4, embs=None):
    import jax.numpy as jnp
    from recstudio_tpu.ann.sampler import LSHSampler as JaxLSH
    from recstudio_torch.ann.sampler import LSHSampler
    from recstudio_torch.utils.convert import lsh_weight_vectors_from_jax
    js = JaxLSH(N_ITEMS, D, n_bits=n_bits, n_table=n_table, seed=4)
    ps = LSHSampler(N_ITEMS, D, n_bits=n_bits, n_table=n_table)
    lsh_weight_vectors_from_jax(ps, js)
    embs = _embs() if embs is None else embs
    return js, ps, js.update(None, jnp.asarray(embs)), ps.update(_t(embs), None)


def test_lsh_update_and_map_match_jax():
    """Tables and draws on JAX's uniforms, with a row of every kind: many
    candidates, and none (all-negative query against all-positive items:
    the uniform fallback, and the clamped table and slot)."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import sampler_state_from_jax
    embs = np.abs(_embs())
    js, ps, jstate, pstate = _lsh_pair(embs=embs)
    for key in ("indices", "indptr"):
        np.testing.assert_array_equal(pstate[key].numpy(), np.asarray(jstate[key]), err_msg=key)
    q = _queries(12, (10, D))
    q[3] = -np.abs(q[3])                                       # no candidate in any table
    key = jax.random.PRNGKey(13)
    jneg, jprob = js(jstate, key, jnp.asarray(q), 9)
    ukey, fkey = jax.random.split(key)
    u = _t(np.asarray(jax.random.uniform(ukey, (10, 9))))
    uni = _t(np.asarray(jax.random.randint(fkey, (10, 9), 1, N_ITEMS))).long()
    neg, prob = ps.ids_from_uniform(pstate, _t(q), u, uni)
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), **TOL_P)
    assert np.all(prob[3].numpy() == 0.0) and torch.equal(neg[3], uni[3])
    # the state JAX built, carried over, maps the same
    again, _ = ps.ids_from_uniform(sampler_state_from_jax(jstate), _t(q), u, uni)
    assert torch.equal(again, neg)


def test_lsh_weights_come_from_a_seeded_generator():
    from recstudio_torch.ann.sampler import LSHSampler
    w = LSHSampler(N_ITEMS, D, seed=3).weight_vectors
    assert w.shape == (D, 4, 16) and torch.equal(w, LSHSampler(N_ITEMS, D, seed=3).weight_vectors)
    assert not torch.equal(w, LSHSampler(N_ITEMS, D, seed=4).weight_vectors)
    np.testing.assert_allclose(torch.linalg.vector_norm(w, dim=0).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
def _tv(counts, probs):
    """Total variation of the draws' frequencies from ``probs``, and its
    expected value under the proposal itself."""
    n = counts.sum()
    tv = 0.5 * np.abs(counts / n - probs).sum()
    noise = 0.5 * np.sum(np.sqrt(2.0 * probs * (1.0 - probs) / (math.pi * n)))
    return tv, noise


def _midx_bucket_probs(state, q):
    """The MIDX proposal over the ``K^2`` buckets of one query, from its
    definition (numpy, float64)."""
    c0, c1, wkk = (state[k].double().numpy() for k in ("c0", "c1", "wkk"))
    half = q.shape[-1] // 2
    q = q.astype(np.float64)
    sm = lambda r: np.exp(r - r.max()) / np.exp(r - r.max()).sum()
    r0s, r1s = sm(c0 @ q[:half]), sm(c1 @ q[half:])
    s0 = (wkk @ r1s) * r0s + 1e-12
    p0 = s0 / s0.sum()
    s1 = wkk * r1s[None, :] + 1e-12
    return (p0[:, None] * s1 / s1.sum(-1, keepdims=True)).reshape(-1)


@pytest.mark.parametrize("kind", ["midx-uni", "midx-pop", "cluster-uni", "cluster-pop"])
def test_draws_follow_the_proposal(kind):
    """2^17 draws for one query: the buckets' frequencies against the
    proposal; inside the likeliest bucket, the items' against its in-bucket
    law (uniform, or the weights ``p``)."""
    _, psam, _, state = _states(kind)
    q = _queries(14, (1, D))
    gen = torch.Generator().manual_seed(15)
    _, neg, _ = psam(_t(q), DRAWS, gen, state=state)
    neg = neg.numpy().ravel()
    if kind.startswith("midx"):
        bucket_of_item = np.r_[0, (state["cd0"][1:].numpy() - 1) * K + state["cd1"][1:].numpy() - 1]
        probs = _midx_bucket_probs(state, q[0])
    else:
        bucket_of_item = np.r_[0, state["cd"][1:].numpy() - 1]
        r = state["c"].double().numpy() @ q[0].astype(np.float64)
        probs = np.exp(r - r.max()) / np.exp(r - r.max()).sum()
    counts = np.bincount(bucket_of_item[neg], minlength=len(probs)).astype(np.float64)
    tv, noise = _tv(counts, probs)
    assert tv <= 2 * noise + 0.005, (tv, noise)
    top = int(np.argmax(probs))
    members = state["indices"].numpy()[state["indptr"][top]:state["indptr"][top + 1]] + 1
    w = state["p"].numpy()[members] if "p" in state else np.ones(len(members))
    inside = neg[bucket_of_item[neg] == top]
    counts = np.array([(inside == m).sum() for m in members], np.float64)
    tv, noise = _tv(counts, w / w.sum())
    assert tv <= 2 * noise + 0.005, (tv, noise)


def test_popular_draws_follow_the_weights():
    from recstudio_torch.ann.sampler import PopularSamplerModel
    ps = PopularSamplerModel(_pop(), mode=2)
    state = ps.update(torch.zeros(1), None)
    _, neg, _ = ps(torch.zeros(1, D), DRAWS, torch.Generator().manual_seed(16), state=state)
    counts = np.bincount(neg.numpy().ravel(), minlength=N_ITEMS).astype(np.float64)
    tv, noise = _tv(counts, state["pop_prob"].double().numpy())
    assert tv <= 2 * noise + 0.005, (tv, noise)


def test_lsh_draws_follow_the_candidates():
    """An item's share is the number of tables whose bucket it shares with
    the query over the candidates' count."""
    _, ps, _, state = _lsh_pair()
    q = _queries(17, (1, D))
    _, neg, _ = ps(_t(q), DRAWS, torch.Generator().manual_seed(18), state=state)
    code_q = ps._hash(_t(q))[0]
    code_i = ps._hash(state["item_embs"])
    shares = np.r_[0, (code_i == code_q[None, :]).sum(1).numpy()].astype(np.float64)
    assert shares.sum() > 0
    counts = np.bincount(neg.numpy().ravel(), minlength=N_ITEMS).astype(np.float64)
    tv, noise = _tv(counts, shares / shares.sum())
    assert tv <= 2 * noise + 0.005, (tv, noise)


def test_sampler_repeats_from_the_same_generator_state():
    _, psam, _, state = _states("midx-pop")
    q = _t(_queries(19, (5, D)))
    a = psam(q, 7, torch.Generator().manual_seed(20), state=state)
    b = psam(q, 7, torch.Generator().manual_seed(20), state=state)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_update_repeats_bit_for_bit():
    """``update`` (two k-means runs and the index) from the same generator
    state gives the same state, tensor for tensor."""
    from recstudio_torch.ann.sampler import LSHSampler, MIDXSamplerPop, ClusterSamplerUniform
    x = _t(_embs())
    for s in (MIDXSamplerPop(_pop(), K), ClusterSamplerUniform(N_ITEMS, K),
              LSHSampler(N_ITEMS, D)):
        a = s.update(x, torch.Generator().manual_seed(21))
        b = s.update(x, torch.Generator().manual_seed(21))
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a), type(s).__name__
