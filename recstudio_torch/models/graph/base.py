"""BaseGraphRetriever: retrievers whose user and item vectors come from
propagation over the whole user-item graph.

Counterpart of ``recstudio_tpu/models/graph/base.py``. The graph is the
training split's interactions as bidirectional edges with symmetric
normalization ``w_uv = deg_u^-1/2 deg_v^-1/2``, in dst-sorted order
(``_build_graph``). One propagation layer ``A @ x`` takes one of three
routes, all kept and held to each other by the tests:

- the dense normalized adjacency ``_adj [n, n]`` and one ``torch.matmul``,
  when it fits ``_DENSE_ADJ_BYTES`` (the JAX package's budget, so both
  packages take the same route at the same size);
- past the budget, the degree-bucketed padded neighbour lists
  (ELLPACK, ``_build_ell``): per bucket one padded gather
  ``emb[src_pad] * w_pad`` summed over its K slots, hub nodes split into
  virtual rows whose partials are summed in order through a padded
  index table, and one gather back to node order. There is no scatter and
  no atomic addition, so a step repeats bit for bit. ``_SymPropagate``
  is its ``torch.autograd.Function``: the normalized bidirectional
  adjacency is symmetric (``w_uv = w_vu``, both directions present), so
  the backward of ``A @ x`` applied to a cotangent ``g`` is ``A @ g``, the
  same operator, and the Function saves nothing for the backward;
- the edge list, ``segment_sum(emb[src] * w, dst)`` with the sum taken
  over each node's sorted run of edges (``torch.segment_reduce``), the
  fallback when neither of the others is held.

The graph's index, weight and operator tensors live on the model's device
as attributes of the model, outside ``self.net``'s state dict, so
snapshots, checkpoints and ``load_state_dict`` carry the parameters alone.
The parameters are ``GraphNet``'s two tables, ``user_embedding`` and
``item_embedding`` (initialised by role as every table is: the JAX
package's N(0, 0.02) draws of ``_init_variables`` are re-drawn by
``init_parameters`` there too). Propagation yields both towers, so
``_epoch_refresh(-1)`` caches ``user_all`` beside ``item_vector`` and an
evaluation pass propagates once, not once a batch; both caches are
dropped wherever the weights change. The JAX block-fit hook
(``_device_epoch_refresh_fn``) has no counterpart: the port has no
block-fit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..basemodel.baseretriever import BaseRetriever
from ..basemodel.recommender import Recommender
from ..loss_func import BPRLoss
from ..module import Embedding
from ..scorer import InnerProductScorer


class GraphNet(nn.Module):
    """A graph model's parameters: the user table, the item table and the
    layer weights a subclass adds (NGCF's ``layer_{i}``)."""

    def __init__(self, num_users: int, num_items: int, embed_dim: int):
        super().__init__()
        self.user_embedding = Embedding(num_users, embed_dim)
        self.item_embedding = Embedding(num_items, embed_dim)

    def node_embeddings(self) -> torch.Tensor:
        """``[n, D]``: the users' rows, then the items'."""
        return torch.cat([self.user_embedding.weight, self.item_embedding.weight])


def segment_sum_sorted(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Rows of ``x [E, D]`` summed over consecutive runs of ``lengths [n]``
    (which sum to E), each run in order; an empty run gives a zero row."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True)


class _SymPropagate(torch.autograd.Function):
    """``A @ x`` for a symmetric operator ``A`` given as ``apply``; the
    backward is ``A @ g``."""

    @staticmethod
    def forward(ctx, emb, apply):
        ctx.op = apply
        return apply(emb)

    @staticmethod
    def backward(ctx, grad):
        return ctx.op(grad.contiguous()), None


class BaseGraphRetriever(BaseRetriever):
    """Subclasses implement ``propagate() -> (user_all [U, D'], item_all
    [N, D'])`` from ``self.net``'s parameters."""

    # the dense normalized adjacency is held when n * n * 4 bytes fit this
    # budget (base.py:49); larger graphs take the ELL layout
    _DENSE_ADJ_BYTES = 512 << 20

    # degree buckets of the ELL layout; nodes of larger degree split into
    # virtual rows of the last width
    _ELL_BUCKETS = (4, 8, 16, 32, 64, 128)

    # caches of the current weights, dropped when they change
    _weight_caches = ("item_vector", "user_all")

    @staticmethod
    def _get_dataset_class():
        from ...data.dataset import TripletDataset
        return TripletDataset

    def _get_loss_func(self):
        return BPRLoss()

    def _get_net(self) -> nn.Module:
        return GraphNet(self.num_users, self.num_items, self.embed_dim)

    def _init_model(self, train_data):
        # the two-tower net is bypassed: a graph model owns its tables
        Recommender._init_model(self, train_data)
        self._sparse_rows_flag = None
        self.num_users = train_data.num_users
        self.num_items = train_data.num_items
        self.query_fields = {self.fuid}
        self.item_fields = {self.fiid}
        self.net = self._get_net()
        self.score_func = InnerProductScorer()
        self.sampler = self._get_sampler(train_data)
        if self.config["train"].get("sampling_method", "none") != "none":
            raise NotImplementedError("mining methods (train.sampling_method) are not ported "
                                      "for graph models")
        self._build_graph(train_data)

    # ------------------------------------------------------------------
    # the graph
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _build_graph(self, train_data):
        """Bidirectional user-item edges with symmetric normalization, in
        dst-sorted order (``base.py:57-83``)."""
        sub = train_data.inter_feat_subset
        users = np.asarray(train_data.inter_feat.get_col(self.fuid))[sub].astype(np.int32)
        items = np.asarray(train_data.inter_feat.get_col(self.fiid))[sub].astype(np.int32)
        n = self.num_users + self.num_items
        src = np.concatenate([users, items + self.num_users])
        dst = np.concatenate([items + self.num_users, users])
        deg = np.bincount(src, minlength=n).astype(np.float32)
        norm = np.zeros_like(deg)
        np.power(deg, -0.5, out=norm, where=deg > 0)
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        w = norm[src] * norm[dst]
        self._num_nodes = n
        self._edges = (self._tensor(src), self._tensor(dst))
        self._edge_norm = self._tensor(norm)
        self._edge_w = self._tensor(w)
        self._deg_in = self._tensor(np.bincount(dst, minlength=n).astype(np.int64))
        self._adj = None
        self._ell = None
        self._sym_spmm = None
        if n * n * 4 <= self._DENSE_ADJ_BYTES:
            adj = np.zeros((n, n), np.float32)
            np.add.at(adj, (dst, src), w)
            self._adj = self._tensor(adj)
        else:
            self._build_ell(src, dst, w, n)

    def _build_ell(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int):
        """Degree-bucketed padded neighbour lists (``base.py:85-147``):
        ``_ell = (tables, hub, slot)``. ``tables`` holds ``(src_pad [r, K]
        int32, w_pad [r, K])`` per bucket, the hubs' virtual rows last;
        ``hub`` is None or ``(hub_rows [n_hub, max_nv] int32, n_virtual)``,
        each hub's virtual rows in order, padded with ``n_virtual`` (a zero
        row); ``slot [n] int32`` maps a node to its row of the concatenated
        partials, a node with no edge to the zero row past them."""
        E = len(src)
        deg_in = np.bincount(dst, minlength=n)
        row_start = np.concatenate([[0], np.cumsum(deg_in)])
        kmax = self._ELL_BUCKETS[-1]
        tables, row_node = [], []
        lo = 0
        for K in self._ELL_BUCKETS:
            sel = np.where((deg_in > lo) & (deg_in <= K))[0]
            lo = K
            if not len(sel):
                continue
            idx = row_start[sel][:, None] + np.arange(K)[None, :]
            mask = np.arange(K)[None, :] < deg_in[sel][:, None]
            idx = np.minimum(idx, E - 1)
            tables.append((self._tensor(np.where(mask, src[idx], 0).astype(np.int32)),
                           self._tensor(np.where(mask, w[idx], 0.0).astype(np.float32))))
            row_node.append(sel)
        hubs = np.where(deg_in > kmax)[0]
        hub = None
        if len(hubs):
            nv = -(-deg_in[hubs] // kmax)                # virtual rows per hub
            vnode = np.repeat(hubs, nv)                  # hub id per virtual row
            first = np.cumsum(nv) - nv                   # each hub's first virtual row
            voff = (np.arange(len(vnode)) - np.repeat(first, nv)) * kmax
            starts = row_start[vnode] + voff
            idx = starts[:, None] + np.arange(kmax)[None, :]
            mask = idx < row_start[vnode][:, None] + deg_in[vnode][:, None]
            idx = np.minimum(idx, E - 1)
            tables.append((self._tensor(np.where(mask, src[idx], 0).astype(np.int32)),
                           self._tensor(np.where(mask, w[idx], 0.0).astype(np.float32))))
            width = int(nv.max())
            rows = first[:, None] + np.arange(width)[None, :]
            rows = np.where(np.arange(width)[None, :] < nv[:, None], rows, len(vnode))
            hub = (self._tensor(rows.astype(np.int32)), len(vnode))
            row_node.append(hubs)
        order = np.concatenate(row_node) if row_node else np.zeros(0, np.int64)
        slot = np.full(n, len(order), np.int64)
        slot[order] = np.arange(len(order))
        self._ell = (tables, hub, self._tensor(slot.astype(np.int32)))
        self._sym_spmm = lambda emb: _SymPropagate.apply(emb, self._ell_apply)

    def ell_stats(self) -> Dict[str, int]:
        """Padded slots, edges and the tables' bytes of the ELL layout."""
        tables, hub, slot = self._ell
        nbytes = sum(t.numel() * t.element_size() for pair in tables for t in pair)
        nbytes += slot.numel() * slot.element_size()
        if hub is not None:
            nbytes += hub[0].numel() * hub[0].element_size()
        return {"slots": sum(s.numel() for s, _ in tables), "edges": int(self._edges[0].numel()),
                "rows": sum(s.shape[0] for s, _ in tables), "table_bytes": int(nbytes)}

    def _ell_apply(self, emb: torch.Tensor) -> torch.Tensor:
        """``A @ emb`` on the ELL layout (``base.py:149-165``)."""
        tables, hub, slot = self._ell
        d = emb.shape[-1]
        parts = []
        for src_pad, w_pad in tables:
            g = emb.index_select(0, src_pad.reshape(-1)).view(*src_pad.shape, d)   # [r, K, D]
            parts.append((g * w_pad.unsqueeze(-1)).sum(1))
        if hub is not None:
            rows, _ = hub
            vpart = torch.cat([parts.pop(), emb.new_zeros(1, d)])
            parts.append(vpart.index_select(0, rows.reshape(-1)).view(*rows.shape, d).sum(1))
        allp = torch.cat(parts + [emb.new_zeros(1, d)])
        return allp.index_select(0, slot)

    def _edge_apply(self, emb: torch.Tensor) -> torch.Tensor:
        """``A @ emb`` over the edge list, summed by sorted segments."""
        src, _ = self._edges
        return segment_sum_sorted(F.embedding(src, emb) * self._edge_w[:, None], self._deg_in)

    def _gcn_layer(self, emb: torch.Tensor) -> torch.Tensor:
        """One normalized propagation layer (``base.py:176-187``)."""
        if self._adj is not None:
            return self._adj @ emb
        if self._sym_spmm is not None:
            return self._sym_spmm(emb)
        return self._edge_apply(emb)

    # ------------------------------------------------------------------
    # propagation, training and retrieval
    # ------------------------------------------------------------------
    def propagate(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def _compute_item_vector(self) -> torch.Tensor:
        return self.propagate()[1][1:]

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int):
        """For inference, propagate once and cache both towers:
        ``item_vector`` (items 1..N-1) and ``user_all`` (``base.py:
        210-217``); before a training epoch, ``BaseRetriever``'s refresh
        (a stateful sampler re-indexed from the propagated items)."""
        if nepoch < 0:
            user_all, item_all = self.propagate()
            self.states["item_vector"] = item_all[1:]
            self.states["user_all"] = user_all
        else:                       # a stateful sampler indexes the propagated items
            super()._epoch_refresh(nepoch)

    def _encode_query_from(self, user_all: torch.Tensor,
                           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return F.embedding(batch[self.fuid], user_all)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """Propagate, score the positives and the sampler's negatives, drawn
        from the detached query (``base.py:240-256``): the loss's keyword
        arguments under ``score`` and the negatives' ids under ``neg_id``.
        Rows are gathered through ``F.embedding``, whose backward sums by
        sorted index."""
        user_all, item_all = self.propagate()
        query = self._encode_query_from(user_all, batch)
        pos_score = self.score_func(query, F.embedding(batch[self.fiid], item_all))
        log_pos_prob, neg_ids, log_neg_prob = self.sampling(batch, self.neg_count,
                                                            query.detach())
        neg_score = self.score_func(query, F.embedding(neg_ids, item_all))
        return {"score": {"pos_score": pos_score, "log_pos_prob": log_pos_prob,
                          "neg_score": neg_score, "log_neg_prob": log_neg_prob},
                "neg_id": neg_ids}

    def _reg_rows(self, batch: Dict[str, torch.Tensor], neg_ids: torch.Tensor):
        """The raw (layer-0) rows of the batch's users, positives and
        negatives, which the L2 penalty reads."""
        net = self.net
        return (net.user_embedding(batch[self.fuid]), net.item_embedding(batch[self.fiid]),
                net.item_embedding(neg_ids.reshape(-1)))

    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int, user_hist=None,
             return_query: bool = False):
        """Top-k catalog items of the batch's users from the cached towers,
        or from one propagation when they are not cached (``base.py:258-272``)."""
        item_vector = self.states.get("item_vector")
        user_all = self.states.get("user_all")
        if item_vector is None or user_all is None:
            user_all, item_all = self.propagate()
            item_vector = item_all[1:]
        query = self._encode_query_from(user_all, batch)
        scores = self.score_func.catalog(query, item_vector)
        score_k, topk_items = self._topk_from_scores(scores, k, user_hist)
        if return_query:
            return score_k, topk_items, query
        return score_k, topk_items
