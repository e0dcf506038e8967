"""NGCF: neural graph collaborative filtering.

Counterpart of ``recstudio_tpu/models/graph/ngcf.py``: per layer the
bi-aggregation ``LeakyReLU(W1 (x + n)) + LeakyReLU(W2 (x * n))`` of each
node's row ``x`` and its left-normalized neighbourhood ``n = D^-1 A x``
(summed over the dst-sorted edge list by sorted segments), message dropout
``mess_dropout[i]`` through ``seeded_dropout`` (seeds from
``self.generator``), each layer's output L2-normalized, and the
concatenation of the L + 1 layer outputs as the readout. The BPR loss on
uniform negatives plus ``l2_reg_weight`` times the L2 penalty on the raw
rows. ``layer_{i}.W1`` and ``W2`` are ``nn.Linear`` (``weight [out, in]``,
the flax ``kernel [in, out]`` transposed). ``node_dropout`` is read by
neither package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..loss_func import l2_reg_loss_fn
from ..module.layers import seeded_dropout
from .base import BaseGraphRetriever, GraphNet, segment_sum_sorted


class NGCFLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.W1 = nn.Linear(d_in, d_out)
        self.W2 = nn.Linear(d_in, d_out)

    def forward(self, x: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.W1(x + neigh)) + F.leaky_relu(self.W2(x * neigh))


class NGCF(BaseGraphRetriever):

    def _get_net(self) -> nn.Module:
        net = GraphNet(self.num_users, self.num_items, self.embed_dim)
        sizes = self.config["model"]["layer_size"]
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            net.add_module(f"layer_{i}", NGCFLayer(d_in, d_out))
        return net

    def _build_graph(self, train_data):
        super()._build_graph(train_data)
        # left normalization D^-1 A, one weight an edge (ngcf.py:20-27)
        src = self._edges[0].cpu().numpy()
        deg = np.bincount(src, minlength=self._num_nodes).astype(np.float32)
        with np.errstate(divide="ignore"):
            left = np.where(deg > 0, 1.0 / deg, 0.0).astype(np.float32)
        self._left_w = self._tensor(left[src])

    def _left_conv(self, emb: torch.Tensor) -> torch.Tensor:
        src, _ = self._edges
        return segment_sum_sorted(F.embedding(src, emb) * self._left_w[:, None], self._deg_in)

    def propagate(self, training: bool = False, rng: Optional[torch.Generator] = None):
        mc = self.config["model"]
        emb = self.net.node_embeddings()
        outs = [emb]
        x = emb
        for i in range(len(mc["layer_size"]) - 1):
            h = getattr(self.net, f"layer_{i}")(x, self._left_conv(x))
            if training and mc.get("mess_dropout"):
                h = seeded_dropout(h, float(mc["mess_dropout"][i]), True, rng)
            x = h
            outs.append(x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12))
        out = torch.cat(outs, dim=-1)
        return out[: self.num_users], out[self.num_users:]

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``ngcf.py:73-88``: propagation with message dropout, BPR on the
        sampler's negatives, the L2 penalty."""
        user_all, item_all = self.propagate(training=True, rng=self.generator)
        query = self._encode_query_from(user_all, batch)
        pos_score = self.score_func(query, F.embedding(batch[self.fiid], item_all))
        log_pos_prob, neg_ids, log_neg_prob = self.sampling(batch, self.neg_count,
                                                            query.detach())
        neg_score = self.score_func(query, F.embedding(neg_ids, item_all))
        loss = self.loss_fn(batch[self.frating], pos_score, log_pos_prob, neg_score,
                            log_neg_prob)
        reg = l2_reg_loss_fn(*self._reg_rows(batch, neg_ids))
        return loss + self.config["model"]["l2_reg_weight"] * reg
