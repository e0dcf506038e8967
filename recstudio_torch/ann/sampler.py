"""Negative samplers, on the device, from an explicit generator.

Counterpart of ``recstudio_tpu/ann/sampler.py``. A sampler is a pair:

- ``update(item_embs, generator) -> state``: (re)builds its index from
  the catalog encoding ``item_embs [N - 1, D]`` (the ``[PAD]`` row
  excluded): k-means codebooks, CSR inverted indices, popularity CDFs,
  LSH tables, as a dict of tensors on ``item_embs``' device. The
  retriever calls it before each training epoch and keeps the state in
  ``states["sampler"]``; a sampler with no index returns ``None``.
- ``sampler(query, num_neg, generator, pos_items, user_hist, state) ->
  (log_pos_prob, neg_ids, log_neg_prob)``: negatives for each query row
  with the proposal log probabilities the losses correct by. Ids are
  1-based; 0 is ``[PAD]``.

Every draw comes from the ``torch.Generator`` passed in, on the query's
device; each sampler's map from those uniforms (or Gumbel noise) to ids
is a function of its own (``ids_from_uniform``, ``ids_from_noise``), so a
test feeds it the JAX package's draws. Categorical draws are Gumbel-max,
as ``jax.random.categorical``. Where the JAX sampler gathers out of range
and relies on JAX's clamp (an empty last bucket, a search past the
table's end, an empty LSH candidate set), the index is clamped here.

Two differences from the JAX package, on purpose (``ROADMAP.md`` §3):
``PopularSamplerModel`` keeps the last item's probability and sets the
CDF's end to 1 (the JAX class sets ``pop_prob[-1] = 1``, which gives the
last item log probability 0); and a popularity-weighted in-bucket draw
reports the drawn item's weight, ``p[item]`` (the JAX class reads
``p[flat + 1]``, the weight of the item at that place of the *id* order,
so its ``log_neg_prob`` is not ``compute_item_p`` of its own draws).
The MIDX and cluster log probabilities are unnormalised, as there: the
per-query offset cancels in the corrected softmax. A query ``[B, L, D]``
with positives ``[B, L]`` is scored position by position in
``compute_item_p`` (the JAX einsum gives ``[B, L, L]`` there and raises).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.scorer import CosineScorer, EuclideanScorer
from ..ops.kmeans import construct_index, kmeans

EPS = 1e-12
State = Dict[str, torch.Tensor]


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` in ``[tiny, 1)``
    (``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)


def _bucket_weights(state: State, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each bucket's item count, or its items' summed weights ``norm``
    (the one-hot products ``m0.T @ (m1 * norm)`` of the JAX sampler), by
    ordered sums over the index."""
    counts = state["indptr"][1:] - state["indptr"][:-1]
    if norm is None:
        return counts.to(torch.float32)
    return torch.segment_reduce(norm[state["indices"]], "sum", lengths=counts, axis=0)


def _pop_weights(pop_count, mode: int) -> torch.Tensor:
    pop = torch.as_tensor(np.asarray(pop_count), dtype=torch.float32)
    if mode == 0:
        return torch.log(pop + 1.0)
    if mode == 1:
        return torch.log(pop + 1.0) + 1e-6
    if mode == 2:
        return pop ** 0.75
    return pop


class Sampler:
    """Base sampler. ``num_items`` includes the ``[PAD]`` slot (index 0)."""

    def __init__(self, num_items: int, scorer_fn=None):
        self.num_items = num_items - 1  # real items live in [1, num_items - 1]
        self.scorer = scorer_fn

    def update(self, item_embs: torch.Tensor, generator: torch.Generator) -> Optional[State]:
        return None

    def compute_item_p(self, query: torch.Tensor, items: torch.Tensor,
                       state: Optional[State] = None) -> torch.Tensor:
        return torch.zeros(items.shape, dtype=torch.float32, device=items.device)

    def _out(self, query, neg_items, pos_items, state=None):
        neg_prob = self.compute_item_p(query, neg_items, state)
        pos_prob = None if pos_items is None else self.compute_item_p(query, pos_items, state)
        return pos_prob, neg_items, neg_prob

    def __call__(self, query: torch.Tensor, num_neg: int, generator: torch.Generator,
                 pos_items: Optional[torch.Tensor] = None,
                 user_hist: Optional[torch.Tensor] = None, state: Optional[State] = None):
        raise NotImplementedError


class UniformSampler(Sampler):
    """Uniform ids over ``[1, num_items - 1]`` (``sampler.py:74``)."""

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None):
        neg = torch.randint(1, self.num_items + 1, (*query.shape[:-1], num_neg),
                            generator=generator, device=query.device)
        return self._out(query, neg, pos_items)


class MaskedUniformSampler(Sampler):
    """Uniform over the items not in the user's history (``sampler.py:87``):
    draw ``u`` among the ``n_free`` free ids, then shift it past the sorted
    history with a right-searchsorted. ``user_hist`` ``[B, H]`` holds
    distinct ids, 0 = pad."""

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None):
        if user_hist is None:
            raise ValueError("MaskedUniformSampler requires user_hist")
        qshape = query.shape[:-1]
        bsz, hist_len = user_hist.shape
        n_draw = math.prod(qshape[1:]) * num_neg
        u = torch.rand((bsz, n_draw), generator=generator, device=query.device)
        hist = user_hist.to(torch.int64)
        nonzero = (hist != 0).sum(-1)                                   # [B]
        neg = torch.floor(u * (self.num_items - nonzero)[:, None]).to(torch.int64) + 1
        # drop the zero padding out of the sorted order
        offset = torch.clamp_min(torch.arange(hist_len, device=hist.device)[None, :]
                                 - (hist_len - nonzero)[:, None], 0)
        sorted_hist = torch.sort(hist, dim=-1).values - offset
        shift = torch.searchsorted(sorted_hist, neg, right=True)
        neg = neg + shift - (hist_len - nonzero)[:, None]
        return self._out(query, neg.reshape(*qshape, num_neg), pos_items)


class PopularSamplerModel(Sampler):
    """Popularity-proportional ids by inverse CDF (``sampler.py:114-144``):
    weights ``log(pop + 1)`` (``mode`` 0), that plus 1e-6 (1) or
    ``pop ** 0.75`` (2), the ``[PAD]`` weight set to 1. The CDF's last
    entry is set to 1, so a uniform never searches past it; the last item
    keeps its own probability (the JAX class gives it 1)."""

    def __init__(self, pop_count, scorer_fn=None, mode: int = 0):
        super().__init__(len(pop_count), scorer_fn)
        pop = _pop_weights(pop_count, mode)
        pop[0] = 1.0
        prob = pop / pop.sum()
        table = torch.cumsum(prob, 0)
        table[-1] = 1.0
        self._state = {"pop_prob": prob, "table": table}

    def update(self, item_embs, generator):
        device = item_embs.device if item_embs is not None else "cpu"
        if self._state["table"].device != torch.device(device):
            self._state = {k: v.to(device) for k, v in self._state.items()}
        return self._state

    def compute_item_p(self, query, items, state=None):
        return torch.log(state["pop_prob"][items])

    def ids_from_uniform(self, state: State, u: torch.Tensor) -> torch.Tensor:
        """Item ids of uniforms ``u`` (a left search in the CDF, clamped to
        the last item where JAX's gather clamps)."""
        table = state["table"]
        ids = torch.searchsorted(table, u.reshape(-1).contiguous()).reshape(u.shape)
        return torch.clamp_max(ids, table.shape[0] - 1)

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None):
        u = torch.rand((*query.shape[:-1], num_neg), generator=generator, device=query.device)
        return self._out(query, self.ids_from_uniform(state, u), pos_items, state)


# ---------------------------------------------------------------------------
# quantization-based samplers
# ---------------------------------------------------------------------------
def _bisect(cdf: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """Lower-bound search of ``u`` in ``cdf[lo..hi]`` (``sampler.py:45-53``),
    row by row. The JAX loop runs 32 rounds; every round past convergence
    is a no-op, so ``bit_length(len(cdf)) + 2`` rounds give its result.
    A probe past the end (an empty last bucket) reads the last entry, as
    JAX's clamped gather does."""
    last = cdf.shape[0] - 1
    for _ in range(int(cdf.shape[0]).bit_length() + 2):
        mid = (lo + hi) // 2
        go_right = cdf[torch.clamp_max(mid, last)] < u
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    return lo


class MIDXSamplerUniform(Sampler):
    """MIDX (``sampler.py:150-273``): two half-space codebooks from two
    k-means runs; a query draws a bucket pair ``(k0, k1)`` from its
    softmax scores against the centres, weighted by the bucket sizes
    (``wkk``), then an item inside the bucket, uniformly. The proposal log
    probability is the unnormalised ``r0[k0] + r1[k1]``."""

    def __init__(self, num_items: int, num_clusters: int, scorer_fn=None):
        super().__init__(num_items, scorer_fn)
        self.K = num_clusters

    # ---- index building ------------------------------------------------
    def update(self, item_embs, generator, max_iter: int = 30):
        if isinstance(self.scorer, CosineScorer):
            item_embs = _normalize(item_embs)
        half = item_embs.shape[-1] // 2
        c0, cd0 = kmeans(item_embs[:, :half].contiguous(), self.K, max_iter, generator)
        c1, cd1 = kmeans(item_embs[:, half:].contiguous(), self.K, max_iter, generator)
        return self.build_state(item_embs, c0, cd0, c1, cd1)

    def build_state(self, item_embs, c0, cd0, c1, cd1) -> State:
        """The state from the k-means results: padded codebooks and
        assignments (item id indexing, ``[PAD]`` = 0), the CSR index over
        ``cd0 * K + cd1``, the bucket weights and, with weights per item,
        each bucket's CDF. ``item_embs`` are the (normalised) vectors the
        k-means ran on."""
        pad = lambda c: torch.cat([torch.zeros_like(c[:1]), c])
        state = {"c0": c0, "c1": c1, "c0_": pad(c0), "c1_": pad(c1),
                 "cd0": torch.cat([cd0.new_full((1,), -1), cd0]) + 1,
                 "cd1": torch.cat([cd1.new_full((1,), -1), cd1]) + 1}
        state["indices"], state["indptr"] = construct_index(cd0 * self.K + cd1, self.K ** 2)
        self._update(state, item_embs)
        return state

    def _update(self, state, item_embs):
        """``wkk [K, K]``: the buckets' sizes, or their summed weights."""
        if not isinstance(self.scorer, EuclideanScorer):
            state["wkk"] = _bucket_weights(state).reshape(self.K, self.K)
        else:
            norm = torch.exp(-0.5 * (item_embs ** 2).sum(-1))
            state["wkk"] = _bucket_weights(state, norm).reshape(self.K, self.K)
            self._attach_pop_cdf(state, norm)

    def _attach_pop_cdf(self, state, norm):
        """Per-bucket normalised cumulative weights in ``indices`` order
        (``cp``) and the weights by item id (``p``, 1 for ``[PAD]``).
        Each bucket's items are summed in order, one column of a padded
        ``[max bucket, buckets]`` grid scanned down its rows: a 1-D
        ``torch.cumsum`` on the card is a single-pass scan whose float
        rounding varies from run to run (the JAX package takes one
        cumulative sum over the whole catalog and subtracts each bucket's
        start)."""
        indices, indptr = state["indices"], state["indptr"]
        n, buckets = indices.shape[0], indptr.shape[0] - 1
        rows = torch.arange(n, device=indptr.device)
        bucket_of = torch.searchsorted(indptr, rows, right=True) - 1
        place = rows - indptr[bucket_of]
        grid = norm.new_zeros(int((indptr[1:] - indptr[:-1]).max()), buckets)
        grid[place, bucket_of] = norm[indices]
        grid = torch.cumsum(grid, dim=0)
        state["cp"] = grid[place, bucket_of] / torch.clamp_min(grid[-1][bucket_of], EPS)
        state["p"] = torch.cat([norm.new_ones(1), norm])

    # ---- sampling --------------------------------------------------------
    def draw_noise(self, n_query: int, num_neg: int, generator, device):
        """The draws of one call: Gumbel noise for k0 and k1 ``[Q, neg, K]``
        and the in-bucket uniforms ``[Q, neg]``."""
        return (gumbel((n_query, num_neg, self.K), generator, device),
                gumbel((n_query, num_neg, self.K), generator, device),
                torch.rand((n_query, num_neg), generator=generator, device=device))

    def ids_from_noise(self, state, q, g0, g1, u):
        """``(neg_items, log_neg_prob)`` ``[Q, neg]`` of queries ``q [Q, D]``
        (normalised already under a cosine scorer) from the draws."""
        half = q.shape[-1] // 2
        q0, q1 = q[:, :half], q[:, half:]
        r1 = q1 @ state["c1"].t()
        r1s = torch.softmax(r1, dim=-1)
        r0 = q0 @ state["c0"].t()
        r0s = torch.softmax(r0, dim=-1)
        s0 = (r1s @ state["wkk"].t()) * r0s                              # [Q, K0]
        k0 = torch.argmax(torch.log(s0 + EPS)[:, None, :] + g0, dim=-1)  # [Q, neg]
        p0 = torch.gather(r0, 1, k0)
        s1 = state["wkk"][k0] * r1s[:, None, :]                          # [Q, neg, K1]
        k1 = torch.argmax(torch.log(s1 + EPS) + g1, dim=-1)
        p1 = torch.gather(r1, 1, k1)
        return self._sample_in_bucket(state, u, k0 * self.K + k1, p0 + p1)

    def _sample_in_bucket(self, state, u, k01, p01):
        indices, indptr = state["indices"], state["indptr"]
        last_row = indices.shape[0] - 1
        if "cp" not in state:
            cnt = (indptr[k01 + 1] - indptr[k01]).to(torch.float32)
            item_idx = torch.floor(cnt * u).to(torch.int64)
            item_idx = torch.minimum(item_idx, torch.clamp_min(cnt.to(torch.int64) - 1, 0))
            flat = torch.clamp_max(item_idx + indptr[k01], last_row)   # empty last bucket
            return indices[flat] + 1, p01
        # popularity-weighted within the bucket: bisect its normalised CDF
        start = indptr[k01]
        last = torch.maximum(indptr[k01 + 1] - 1, start)
        flat = _bisect(state["cp"], start.reshape(-1), last.reshape(-1),
                       u.reshape(-1)).reshape(k01.shape)
        flat = torch.clamp_max(torch.minimum(flat, last), last_row)
        neg_items = indices[flat] + 1
        return neg_items, p01 + torch.log(state["p"][neg_items])

    def _queries(self, query):
        if isinstance(self.scorer, CosineScorer):
            query = _normalize(query)
        return query

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None):
        query = self._queries(query)
        qshape = query.shape[:-1]
        q = query.reshape(-1, query.shape[-1])
        noise = self.draw_noise(q.shape[0], num_neg, generator, q.device)
        neg_items, neg_prob = self.ids_from_noise(state, q, *noise)
        neg_items = neg_items.reshape(*qshape, num_neg)
        neg_prob = neg_prob.reshape(*qshape, num_neg)
        pos_prob = None if pos_items is None else self.compute_item_p(query, pos_items, state)
        return pos_prob, neg_items, neg_prob

    def compute_item_p(self, query, items, state=None):
        """The unnormalised proposal log probability of ``items`` for
        ``query`` (``sampler.py:258-273``): ``q0 . c0[cd0[i]] + q1 .
        c1[cd1[i]]`` (plus ``log p[i]`` with weights). ``items`` has the
        query's batch shape (one item a query row) or one more dimension
        (several)."""
        c0 = state["c0_"][state["cd0"][items]]
        c1 = state["c1_"][state["cd1"][items]]
        half = query.shape[-1] // 2
        q0, q1 = query[..., :half], query[..., half:]
        if items.dim() == query.dim() - 1:
            r = (c0 * q0).sum(-1) + (c1 * q1).sum(-1)
        else:
            r = torch.einsum("...ld,...d->...l", c0, q0) \
                + torch.einsum("...ld,...d->...l", c1, q1)
        if "p" in state:
            r = r + torch.log(state["p"][items])
        return r


class MIDXSamplerPop(MIDXSamplerUniform):
    """MIDX with popularity-weighted buckets and in-bucket draws
    (``sampler.py:275-296``), weights ``log(pop + 1) + 1e-6`` (``mode`` 1)."""

    def __init__(self, pop_count, num_clusters: int, scorer_fn=None, mode: int = 1):
        super().__init__(len(pop_count), num_clusters, scorer_fn)
        self.pop_count = _pop_weights(pop_count, mode)

    def _update(self, state, item_embs):
        norm = self.pop_count[1:].to(item_embs.device)  # item_embs excludes the pad row
        if isinstance(self.scorer, EuclideanScorer):
            norm = norm * torch.exp(-0.5 * (item_embs ** 2).sum(-1))
        state["wkk"] = _bucket_weights(state, norm).reshape(self.K, self.K)
        self._attach_pop_cdf(state, norm)


class ClusterSamplerUniform(MIDXSamplerUniform):
    """PRIS cluster sampler (``sampler.py:298-357``): one codebook; a query
    draws a cluster from the softmax of its centre scores, then an item
    inside it."""

    def update(self, item_embs, generator, max_iter: int = 30):
        if isinstance(self.scorer, CosineScorer):
            item_embs = _normalize(item_embs)
        c, cd = kmeans(item_embs, self.K, max_iter, generator)
        return self.build_state(item_embs, c, cd)

    def build_state(self, item_embs, c, cd) -> State:
        state = {"c": c, "c_": torch.cat([torch.zeros_like(c[:1]), c]),
                 "cd": torch.cat([cd.new_full((1,), -1), cd]) + 1}
        state["indices"], state["indptr"] = construct_index(cd, self.K)
        self._update(state, item_embs)
        return state

    def _update(self, state, item_embs):
        if not isinstance(self.scorer, EuclideanScorer):
            state["wkk"] = _bucket_weights(state)
        else:
            norm = torch.exp(-0.5 * (item_embs ** 2).sum(-1))
            state["wkk"] = _bucket_weights(state, norm)
            self._attach_pop_cdf(state, norm)

    def draw_noise(self, n_query, num_neg, generator, device):
        """Gumbel noise for the cluster ``[Q, neg, K]`` and the in-bucket
        uniforms ``[Q, neg]``."""
        return (gumbel((n_query, num_neg, self.K), generator, device),
                torch.rand((n_query, num_neg), generator=generator, device=device))

    def ids_from_noise(self, state, q, g, u):
        r = q @ state["c"].t()
        k = torch.argmax(r[:, None, :] + g, dim=-1)                     # softmax(r) draws
        return self._sample_in_bucket(state, u, k, torch.gather(r, 1, k))

    def compute_item_p(self, query, items, state=None):
        c = state["c_"][state["cd"][items]]
        if items.dim() == query.dim() - 1:
            r = (c * query).sum(-1)
        else:
            r = torch.einsum("...ld,...d->...l", c, query)
        if "p" in state:
            r = r + torch.log(state["p"][items])
        return r


class ClusterSamplerPop(ClusterSamplerUniform):
    """The cluster sampler with popularity weights (``sampler.py:359-378``)."""

    def __init__(self, pop_count, num_clusters: int, scorer_fn=None, mode: int = 1):
        super().__init__(len(pop_count), num_clusters, scorer_fn)
        self.pop_count = _pop_weights(pop_count, mode)

    def _update(self, state, item_embs):
        norm = self.pop_count[1:].to(item_embs.device)
        if isinstance(self.scorer, EuclideanScorer):
            norm = norm * torch.exp(-0.5 * (item_embs ** 2).sum(-1))
        state["wkk"] = _bucket_weights(state, norm)
        self._attach_pop_cdf(state, norm)


class LSHSampler(Sampler):
    """Multi-table SimHash sampler with the collision-probability
    correction (``sampler.py:380-450``). A query draws uniformly among the
    items that share its code in any table (counted once a table), and a
    row with no candidate draws uniformly from the catalog. The hyperplanes
    ``weight_vectors [n_dims, n_bits, n_table]`` come from a
    ``torch.Generator`` seeded with ``seed`` (JAX's ``PRNGKey(seed)``
    stream cannot be reproduced; ``utils.convert`` carries JAX's over)."""

    def __init__(self, num_items: int, n_dims: int, n_bits: int = 4, n_table: int = 16,
                 scorer_fn=None, seed: int = 0):
        super().__init__(num_items, scorer_fn)
        self.n_dims, self.n_bits, self.n_table = n_dims, n_bits, n_table
        gen = torch.Generator().manual_seed(seed)
        w = torch.rand((n_dims, n_bits, n_table), generator=gen)
        self.weight_vectors = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
        self.base = 2.0 ** torch.arange(n_bits - 1, -1, -1, dtype=torch.float32)

    def _hash(self, x: torch.Tensor) -> torch.Tensor:
        """SimHash codes ``[N, n_table]`` (int64) of rows ``x [N, D]``."""
        w = self.weight_vectors.to(x.device)
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-10)
        y = (xn @ w.reshape(self.n_dims, -1)).reshape(x.shape[0], self.n_bits, self.n_table)
        bits = (y > 0).to(torch.float32)
        return torch.einsum("nkl,k->nl", bits, self.base.to(x.device)).to(torch.int64)

    def update(self, item_embs, generator):
        """One CSR index a table over the codes: ``indices [n_table, N]``,
        ``indptr [n_table, 2 ** n_bits + 1]``."""
        code = self._hash(item_embs).t().contiguous()                    # [L, N]
        indices = torch.argsort(code, dim=1, stable=True)
        bounds = torch.arange(2 ** self.n_bits + 1, device=code.device)
        indptr = torch.searchsorted(torch.gather(code, 1, indices).contiguous(),
                                    bounds.expand(self.n_table, -1).contiguous())
        return {"indices": indices, "indptr": indptr, "item_embs": item_embs}

    def ids_from_uniform(self, state, query, u, uni):
        """``(neg_id, log_neg_prob)`` ``[B, neg]`` from the in-candidate
        uniforms ``u`` and the fallback ids ``uni`` (used where a row has
        no candidate)."""
        code = self._hash(query).t()                                     # [L, B]
        indptr = state["indptr"]
        start = torch.gather(indptr, 1, code)
        end = torch.gather(indptr, 1, code + 1)
        n_cand = end - start                                             # [L, B]
        len_item = n_cand.sum(0)                                         # [B]
        cum_len = torch.cumsum(n_cand, 0).t().contiguous()               # [B, L]
        rand_idx = torch.floor(u * torch.clamp_min(len_item, 1)[:, None]).to(torch.int64)
        rand_idx = torch.minimum(rand_idx, torch.clamp_min(len_item[:, None] - 1, 0))
        table_id = torch.searchsorted(cum_len, rand_idx.contiguous(), right=True)
        table_id = torch.clamp_max(table_id, self.n_table - 1)           # no candidate
        prev = torch.where(table_id > 0,
                           torch.gather(cum_len, 1, torch.clamp_min(table_id - 1, 0)), 0)
        flat = torch.gather(start.t(), 1, table_id) + rand_idx - prev
        flat = torch.clamp_max(flat, state["indices"].shape[1] - 1)      # an empty last bucket
        item_id = state["indices"][table_id, flat]                       # [B, neg]
        emb = state["item_embs"][item_id]
        qn = query / (torch.linalg.vector_norm(query, dim=-1, keepdim=True) + 1e-10)
        en = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-10)
        cos = torch.clamp(torch.einsum("bd,bnd->bn", qn, en), -1.0, 1.0)
        coll = 1.0 - torch.arccos(cos) / math.pi
        weight = 1.0 - (1.0 - coll ** self.n_bits) ** self.n_table
        prob = weight / torch.clamp_min(len_item, 1)[:, None]
        empty = (len_item == 0)[:, None]
        neg_id = torch.where(empty, uni, item_id + 1)
        log_neg_prob = torch.where(empty, 0.0, torch.log(prob + EPS))
        return neg_id, log_neg_prob

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None):
        if query.dim() != 2:
            raise ValueError("LSHSampler takes queries [B, D] (as the JAX sampler does)")
        shape = (query.shape[0], num_neg)
        u = torch.rand(shape, generator=generator, device=query.device)
        uni = torch.randint(1, self.num_items + 1, shape, generator=generator,
                            device=query.device)
        neg_id, log_neg_prob = self.ids_from_uniform(state, query, u, uni)
        pos_prob = None if pos_items is None else \
            torch.zeros(pos_items.shape, dtype=torch.float32, device=pos_items.device)
        return pos_prob, neg_id, log_neg_prob


class RetrieverSampler(Sampler):
    """A trained retriever as the proposal (``sampler.py:452-469``): its
    state is the retriever's frozen snapshot (``make_sampling_state``), and
    a draw is its ``sampling_from_state`` with ``method`` and temperature
    ``t``."""

    def __init__(self, num_items: int, retriever=None, method: str = "brute", t: float = 1.0):
        super().__init__(num_items)
        self.retriever = retriever
        self.method = method
        self.T = t

    def update(self, item_embs, generator):
        return self.retriever.make_sampling_state()

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None, state=None,
                 batch=None):
        return self.retriever.sampling_from_state(
            state, generator, batch if batch is not None else query, num_neg,
            method=self.method, t=self.T, pos_items=pos_items, user_hist=user_hist)

