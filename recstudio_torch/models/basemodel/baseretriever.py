"""BaseRetriever: the two-tower retrieval abstraction.

Counterpart of ``recstudio_tpu/models/basemodel/baseretriever.py``: the
two-tower net (``TwoTowerNet``, a query tower and an item tower of their
own, as BPR's two embedding tables) and the shared-item-tower net of
sequence models, with the score function registered in the net when it
has parameters (NCF's); the slots ``item_encoder``, ``query_encoder``,
``scorer``, ``sampler`` and ``loss`` can be given to the constructor
(compositional building, ``baseretriever.py:83-95``). Training
(``forward``: positive and sampled negative scores; ``sampling``: the
sampler named by ``train.sampler``, or a mining method of
``train.sampling_method``, ``toprand``, ``top&rand``, ``brute``, ``sir``
or ``dns``, ``baseretriever.py:391-488``; with no sampler the positive
scores and, for a full-score loss, the differentiable scores on the whole
catalog; ``training_step``: the loss, through ``_fused_softmax_step`` for
a softmax loss when ``train.fused_softmax`` allows it). Before each
training epoch that reads them (``_epoch_refresh``), the catalog encoding
is cached in ``states["item_vector"]`` and a stateful sampler re-indexed
into ``states["sampler"]`` (``baseretriever.py:274-327``); evaluation
caches the encoding of the current weights (``_epoch_refresh(-1)``),
dropped whenever the weights change (``fit``, ``load_state_dict``).
Full-catalog top-k masks the user's history inside the score matrix
(``baseretriever.py:493-543``), which is exactly the reference's
``topk(k + len(hist))``-then-filter; evaluation gives the rank metrics of
the served top-k lists (``_make_eval_step``, ``baseretriever.py:
726-752``). Pure-embedding two-tower models under ``learner:
sparse_adam`` take the row-sparse step (``_sparse_rows_enabled``,
``_sparse_grad_step``), which differentiates with respect to the gathered
rows and updates only those rows (``optim.row_lazy_adam``). A retriever
freezes itself into another model's proposal with
``make_sampling_state`` and ``sampling_from_state`` (``ann.sampler.
RetrieverSampler``). Approximate and sharded retrieval are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ... import eval as eval_mod
from ...ann.sampler import (MaskedUniformSampler, PopularSamplerModel, RetrieverSampler,
                            Sampler, UniformSampler)
from ...ops.topk import topk as topk_op
from ...ops.softmax_z import catalog_logsumexp
from ..loss_func import FullScoreLoss, PairwiseLoss, SoftmaxLoss, softmax_loss_from_logz
from ..module import Embedding
from ..optim import row_lazy_adam
from ..scorer import InnerProductScorer
from .recommender import Recommender, batch_to_device


class TwoTowerNet(nn.Module):
    """The query tower, the item tower and the score function as one
    module (``baseretriever.py:38-57``); its parameters are the towers'."""

    def __init__(self, item_encoder: nn.Module, query_encoder: nn.Module, score_func):
        super().__init__()
        self.item_encoder = item_encoder
        self.query_encoder = query_encoder
        self.score_func = score_func

    def encode_query(self, query_feat, rng: Optional[torch.Generator] = None):
        return self.query_encoder(query_feat, rng)

    def encode_item(self, item_feat):
        return self.item_encoder(item_feat)


class SharedItemTowerNet(nn.Module):
    """Two-tower net where the query encoder OWNS the item embedding table
    (sequence models: the same table embeds history items and scores
    targets). ``encode_item`` routes through the query encoder's
    ``item_encoder`` so the parameters are shared."""

    def __init__(self, query_encoder: nn.Module, score_func):
        super().__init__()
        self.query_encoder = query_encoder
        self.score_func = score_func

    def encode_query(self, query_feat, rng: Optional[torch.Generator] = None):
        return self.query_encoder(query_feat, rng)

    def encode_item(self, item_feat):
        return self.query_encoder.item_encoder(item_feat)


# train.sampling_method values (baseretriever.py:406-483)
SAMPLING_METHODS = ("none", "toprand", "top&rand", "brute", "sir", "dns")


def _is_stateful(sampler) -> bool:
    """Whether ``sampler`` keeps an index that ``update`` builds."""
    return isinstance(sampler, Sampler) and type(sampler).update is not Sampler.update


class BaseRetriever(Recommender):
    def __init__(self, config: Dict = None, device="cuda", **kwargs):
        super().__init__(config, device, **kwargs)
        self.query_fields = None
        self.sampler = None
        self._sparse_rows_flag: Optional[bool] = None
        for key in ("ann", "mesh"):
            if self.config["train"].get(key):
                raise NotImplementedError(f"train.{key} is not ported yet")
        method = self.config["train"].get("sampling_method", "none")
        if method not in SAMPLING_METHODS:
            raise ValueError(f"unknown train.sampling_method {method!r}: {SAMPLING_METHODS}")

    def _get_sampler(self, train_data):
        """The sampler named by ``train.sampler`` (``baseretriever.py:105-131``):
        ``uniform``, ``masked_uniform``, ``pop``, ``midx-uni``, ``midx-pop``,
        ``cluster-uni``, ``cluster-pop`` or ``lsh`` (``train.lsh_bits``,
        default 4, and ``train.lsh_tables``, default 8); k-means samplers
        take ``train.sampler_num_clusters`` (default 32). An unknown name
        raises."""
        from ...ann import sampler as S
        tc = self.config["train"]
        name = str(tc.get("sampler") or "uniform").lower()
        n, k = train_data.num_items, int(tc.get("sampler_num_clusters", 32))
        if name in ("uniform", "none"):
            return S.UniformSampler(n)
        if name == "masked_uniform":
            return S.MaskedUniformSampler(n)
        if name == "pop":
            return S.PopularSamplerModel(train_data.item_freq)
        if name == "midx-uni":
            return S.MIDXSamplerUniform(n, k)
        if name == "midx-pop":
            return S.MIDXSamplerPop(train_data.item_freq, k)
        if name == "cluster-uni":
            return S.ClusterSamplerUniform(n, k)
        if name == "cluster-pop":
            return S.ClusterSamplerPop(train_data.item_freq, k)
        if name == "lsh":
            return S.LSHSampler(n, self.embed_dim, n_bits=int(tc.get("lsh_bits", 4)),
                                n_table=int(tc.get("lsh_tables", 8)))
        raise ValueError(f"unknown train.sampler: {name}")

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        raise NotImplementedError

    def _get_score_func(self):
        return InnerProductScorer()

    def _init_model(self, train_data):
        super()._init_model(train_data)
        self._sparse_rows_flag = None                  # gate again on a new fit
        self.num_items = train_data.num_items
        self.num_users = train_data.num_users
        given = self._kwargs_modules

        def part(name, build):                             # a constructor part, or the model's
            return given[name] if given.get(name) is not None else build()

        self.item_encoder = part("item_encoder", lambda: self._get_item_encoder(train_data))
        self.query_encoder = part("query_encoder",         # may share item_encoder
                                  lambda: self._get_query_encoder(train_data))
        self.score_func = part("scorer", self._get_score_func)
        self.sampler = part("sampler", lambda: self._get_sampler(train_data))
        if getattr(self.query_encoder, "item_encoder", None) is self.item_encoder:
            self.net = SharedItemTowerNet(self.query_encoder, self.score_func)
        else:
            self.net = TwoTowerNet(self.item_encoder, self.query_encoder, self.score_func)
        # query-side fields: user feats + in_-prefixed item fields (+ seqlen);
        # ``history_width``: the width of an ``in_`` field (a sequence
        # model's length, a user model's widest training history)
        from ...data.dataset import SeqDataset, UserDataset
        self.query_fields = set(train_data.user_feat.fields).intersection(self.fields)
        if isinstance(train_data, (SeqDataset, UserDataset)):
            self.query_fields |= {"in_" + f for f in self.item_fields}
        if isinstance(train_data, SeqDataset):
            self.query_fields.add("seqlen")
            self.max_seq_len = self.history_width = train_data.max_seq_len
        elif isinstance(train_data, UserDataset):
            self.history_width = train_data._in_width()

    def _get_query_feat(self, batch: Dict[str, torch.Tensor]):
        """The query tower's input (``baseretriever.py:186-193``): the one
        query field's tensor itself (BPR's user ids), else a dict of them."""
        if len(self.query_fields) == 1:
            return batch[next(iter(self.query_fields))]
        return {f: v for f, v in batch.items() if f in self.query_fields}

    # ------------------------------------------------------------------
    def _item_vectors(self) -> torch.Tensor:
        """Encode the full catalog, items 1..N-1 (the [PAD] row excluded),
        differentiably: the training step's catalog."""
        ids = torch.arange(1, self.num_items, device=self.device)
        return self.net.encode_item(ids)

    @torch.no_grad()
    def _compute_item_vector(self) -> torch.Tensor:
        """The catalog encoding for inference."""
        return self._item_vectors()

    def _train_needs_item_vector(self) -> bool:
        """Whether the training step reads ``states["item_vector"]``: the
        mining methods, which score the catalog (``baseretriever.py:
        274-279``). The port's full-score step encodes its catalog itself,
        differentiably, and reads no cache."""
        return self.config["train"].get("sampling_method", "none") != "none"

    def _sampler_is_stateful(self) -> bool:
        return _is_stateful(self.sampler)

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int):
        """Before a training epoch (``nepoch >= 0``, ``baseretriever.py:
        313-327``): when the step reads them, encode the catalog into
        ``states["item_vector"]`` and rebuild a stateful sampler's index
        into ``states["sampler"]`` from it, its draws from the device
        generator. For inference (``nepoch = -1``): the catalog encoding of
        the current weights; the sampler, which inference does not read, is
        left as it is."""
        if nepoch >= 0 and not (self._train_needs_item_vector() or self._sampler_is_stateful()):
            return
        item_vector = self._compute_item_vector()
        self.states["item_vector"] = item_vector
        if nepoch >= 0 and self._sampler_is_stateful():
            state = self.sampler.update(item_vector, self.device_generator)
            if state is not None:
                self.states["sampler"] = state

    # ------------------------------------------------------------------
    def sampling(self, batch: Dict[str, torch.Tensor], num_neg, query: torch.Tensor,
                 method: str = "none", excluding_hist: bool = False, t: float = 1.0,
                 states: Optional[Dict] = None, net: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None):
        """Negatives for a batch (``baseretriever.py:391-488``):
        ``(log_pos_prob, neg_ids, log_neg_prob)``. ``num_neg`` is ``n`` or
        ``[pool, n]``. ``method``:

        - ``none``: the sampler's draw (``MaskedUniformSampler`` when
          ``excluding_hist`` asks for it and the sampler is another);
        - ``toprand``: ``n`` uniform picks among the ``pool`` best-scored
          catalog items; ``top&rand``: the ``n // 2`` best and uniform ids;
        - ``brute``: ``n`` draws a positive from the softmax of the catalog
          scores over ``t``, with their log probabilities (the positives'
          from the softmax with no history mask, as there);
        - ``dns``: the ``n`` best-scored of a ``pool`` from the sampler;
          ``sir``: ``n`` draws from the softmax of the pool's scores, whose
          scores are the log probabilities, the positives' their scores.

        The catalog is ``states["item_vector"]`` and the pool is encoded by
        ``net`` (this model's by default; a frozen snapshot's from
        ``sampling_from_state``). Draws come from ``generator``, the device
        generator by default."""
        states = self.states if states is None else states
        net = self.net if net is None else net
        gen = self.device_generator if generator is None else generator
        pos_items = batch.get(self.fiid)
        pos_2d = pos_items[:, None] if pos_items is not None and pos_items.dim() == 1 \
            else pos_items
        user_hist = batch.get("user_hist", pos_items)
        if isinstance(num_neg, int):
            num_neg = [num_neg, num_neg]
        n_pool, n = int(num_neg[0]), int(num_neg[1])
        hist = user_hist if excluding_hist else None
        zeros_like_pos = None if pos_items is None else \
            torch.zeros(pos_items.shape, dtype=torch.float32, device=query.device)
        if method not in ("none", "dns") and query.dim() != 2:
            raise ValueError(f"sampling method {method!r} takes queries [B, D] "
                             "(as the JAX package does)")

        if method == "none":
            sampler = self.sampler
            if excluding_hist and not isinstance(sampler, MaskedUniformSampler):
                sampler = MaskedUniformSampler(self.num_items)
            kwargs = {"user_hist": user_hist} if isinstance(sampler, MaskedUniformSampler) else {}
            if isinstance(sampler, RetrieverSampler):
                kwargs["batch"] = batch        # the proposal encodes its own query
            state = states.get("sampler")
            if state is None and _is_stateful(sampler):
                raise RuntimeError(f"{type(sampler).__name__} has no index: a training epoch "
                                   "builds it (_epoch_refresh(nepoch >= 0))")
            log_pos_prob, neg_id, log_neg_prob = sampler(
                query, n, gen, pos_items=pos_items, state=state, **kwargs)
        elif method in ("toprand", "top&rand", "brute"):
            scores = net.score_func.catalog(query, states["item_vector"])
            if method == "toprand":
                _, top = self._topk_from_scores(scores, n_pool, hist)
                ridx = torch.randint(0, n_pool, (top.shape[0], n), generator=gen,
                                     device=query.device)
                neg_id = torch.gather(top, 1, ridx)
                log_neg_prob, log_pos_prob = torch.zeros(neg_id.shape, device=query.device), \
                    zeros_like_pos
            elif method == "top&rand":
                k0 = n // 2
                _, top = self._topk_from_scores(scores, max(k0, 1), hist)
                rand = torch.randint(1, self.num_items, (top.shape[0], n - k0), generator=gen,
                                     device=query.device)
                neg_id = torch.cat([top[:, :k0], rand], dim=-1)
                log_neg_prob, log_pos_prob = torch.zeros(neg_id.shape, device=query.device), \
                    zeros_like_pos
            else:
                all_score = scores / t
                logits = self._mask_hist_scores(all_score, hist)
                num_pos = pos_2d.shape[-1] if pos_2d is not None else 1
                draws = torch.multinomial(torch.softmax(logits, dim=-1), n * num_pos,
                                          replacement=True, generator=gen)
                neg_id, log_neg_prob, log_pos_prob = self._brute_log_probs(
                    all_score, logits, draws, pos_2d)
        else:                                              # sir, dns
            log_pos_prob, pool_ids, _ = self.sampling(
                batch, [n_pool, n_pool], query, method="none", excluding_hist=excluding_hist,
                states=states, net=net, generator=gen)
            pool_scores = net.score_func(query, net.encode_item(pool_ids))
            if method == "dns":
                top_idx = torch.topk(pool_scores, n, dim=-1).indices
                neg_id = torch.gather(pool_ids, -1, top_idx)
                log_neg_prob, log_pos_prob = torch.zeros(neg_id.shape, device=query.device), \
                    zeros_like_pos
            else:
                if pos_items is not None:
                    log_pos_prob = net.score_func(query, net.encode_item(pos_items))
                resampled = torch.multinomial(torch.softmax(pool_scores, dim=-1), n,
                                              replacement=True, generator=gen)
                neg_id = torch.gather(pool_ids, 1, resampled)
                log_neg_prob = torch.gather(pool_scores, 1, resampled)

        if pos_items is not None and log_pos_prob is not None:
            log_pos_prob = log_pos_prob.reshape(pos_items.shape).detach()
        return log_pos_prob, neg_id, log_neg_prob.detach()

    @staticmethod
    def _brute_log_probs(all_score: torch.Tensor, logits: torch.Tensor, draws: torch.Tensor,
                         pos_2d: Optional[torch.Tensor]):
        """``brute``'s ids and log probabilities from its draws (catalog
        columns ``[B, n P]``): the draws' from the masked softmax, the
        positives' from the unmasked one, ``-inf`` at padded positives."""
        neg_id = draws + 1
        log_neg_prob = torch.gather(torch.log_softmax(logits, dim=-1), 1, draws)
        log_pos_prob = None
        if pos_2d is not None:
            log_prob_all = torch.log_softmax(all_score, dim=-1)
            col = torch.clamp_min(pos_2d.long() - 1, 0)
            log_pos_prob = torch.where(pos_2d > 0, torch.gather(log_prob_all, 1, col),
                                       float("-inf"))
        return neg_id, log_neg_prob, log_pos_prob

    def forward(self, batch: Dict[str, torch.Tensor],
                full_score: bool = False) -> Dict[str, torch.Tensor]:
        """Training scores (``baseretriever.py:342-389``): the positive
        item's score and, from the sampler, the negatives' scores with the
        proposal log probabilities; with no sampler and ``full_score``, the
        differentiable scores on the whole catalog (``all_score``). Dropout
        seeds come from ``self.generator``."""
        pos_vec = self.net.encode_item(batch[self.fiid])
        query = self.net.encode_query(self._get_query_feat(batch), self.generator)
        pos_score = self.score_func(query, pos_vec)
        if batch[self.fiid].dim() > 1:
            pos_score = torch.where(batch[self.fiid] == 0, float("-inf"), pos_score)
        if self.sampler is None:
            if not full_score:
                return {"pos_score": pos_score}
            return {"pos_score": pos_score,
                    "all_score": self.score_func.catalog(query, self._item_vectors())}
        tc = self.config["train"]
        if not self.neg_count:
            raise ValueError("`negative_count` is required when a sampler is used")
        with torch.no_grad():
            log_pos_prob, neg_ids, log_neg_prob = self.sampling(
                batch, self.neg_count, query.detach(),
                method=tc.get("sampling_method", "none"),
                excluding_hist=tc.get("excluding_hist", False))
        neg_score = self.score_func(query, self.net.encode_item(neg_ids))
        return {"pos_score": pos_score, "log_pos_prob": log_pos_prob,
                "neg_score": neg_score, "log_neg_prob": log_neg_prob}

    def _use_fused_softmax(self) -> bool:
        """The fused step's gate (``baseretriever.py:577-587``): a softmax
        loss with no sampler and inner-product scores, unless
        ``train.fused_softmax`` is ``false``. ``auto`` and ``true`` both take
        it: ``catalog_logsumexp`` launches its kernels on the card and uses
        their plain versions on the CPU."""
        if str(self.config["train"].get("fused_softmax", "auto")).lower() == "false":
            return False
        return (type(self.loss_fn) is SoftmaxLoss and self.sampler is None
                and type(self.score_func) is InnerProductScorer)

    # ------------------------------------------------------------------
    # the row-sparse step of pure-embedding two-tower models
    # ------------------------------------------------------------------
    def _sparse_rows_enabled(self) -> bool:
        """The row-sparse step's gate (``baseretriever.py:599-636``): lazy
        Adam with nothing that touches every row (weight decay, clipping, a
        schedule), a pairwise loss on uniform or popularity negatives, inner products of
        two plain embedding towers keyed by the user id and the item id, and
        ``train.sparse_rows`` not ``false``. It only changes how the update
        is executed: the trajectory is dense lazy Adam's."""
        if self._sparse_rows_flag is not None:
            return self._sparse_rows_flag
        tc = self.config["train"]
        ok = (str(tc.get("sparse_rows", "auto")).lower() != "false"
              and str(tc.get("learner", "adam")).lower() == "sparse_adam"
              and not tc.get("weight_decay")
              and not tc.get("grad_clip_norm")
              and not tc.get("scheduler")
              and str(tc.get("sampling_method", "none")) == "none"
              and isinstance(self.loss_fn, PairwiseLoss)
              and isinstance(self.sampler, (UniformSampler, MaskedUniformSampler,
                                            PopularSamplerModel))
              and type(self.net) is TwoTowerNet
              and type(self.item_encoder) is Embedding
              and type(self.query_encoder) is Embedding
              and not isinstance(self.score_func, nn.Module)
              and len(self.item_fields) == 1
              and self.query_fields == {self.fuid})
        if ok:
            ok = {n for n, _ in self.net.named_parameters()} == \
                {"item_encoder.weight", "query_encoder.weight"}
        self._sparse_rows_flag = bool(ok)
        return self._sparse_rows_flag

    def _grad_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self._sparse_rows_enabled() and batch[self.fiid].dim() == 1:
            return self._sparse_grad_step(batch)
        return super()._grad_step(batch)

    def _sparse_grad_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One lazy-Adam step through the gathered rows
        (``baseretriever.py:644-689``): the loss is differentiated with
        respect to the user rows and the positive and negative item rows,
        and ``row_lazy_adam`` updates those rows alone. The negatives come
        from ``sampling`` on the same generator as ``forward``'s, so a step
        from the same state draws the same ones on either path."""
        opt = self.optimizer
        tc = self.config["train"]
        Wq, Wi = self.query_encoder.weight, self.item_encoder.weight
        uid, iid = batch[self.fuid].long(), batch[self.fiid].long()
        q_rows = Wq.detach()[uid].requires_grad_()
        log_pos_prob, neg_ids, log_neg_prob = self.sampling(
            batch, self.neg_count, q_rows.detach(), method="none",
            excluding_hist=tc.get("excluding_hist", False))
        pos_rows = Wi.detach()[iid].requires_grad_()
        neg_rows = Wi.detach()[neg_ids].requires_grad_()
        loss = self.loss_fn(label=batch[self.frating],
                            pos_score=self.score_func(q_rows, pos_rows),
                            log_pos_prob=log_pos_prob,
                            neg_score=self.score_func(q_rows, neg_rows),
                            log_neg_prob=log_neg_prob)
        dq, dpos, dneg = torch.autograd.grad(loss, (q_rows, pos_rows, neg_rows))
        count = opt.advance()
        group = opt.param_groups[0]
        hyper = dict(lr=group["lr"], b1=group["betas"][0], b2=group["betas"][1],
                     eps=group["eps"])
        row_lazy_adam(Wq.data, *opt.moments(Wq), uid, dq, count, **hyper)
        item_ids = torch.cat([iid, neg_ids.reshape(-1)])
        item_g = torch.cat([dpos, dneg.reshape(-1, dneg.shape[-1])])
        row_lazy_adam(Wi.data, *opt.moments(Wi), item_ids, item_g, count, **hyper)
        return loss.detach()

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of one batch (``baseretriever.py:691-698``)."""
        if self._use_fused_softmax():
            return self._fused_softmax_step(batch)
        score = self.forward(batch, full_score=isinstance(self.loss_fn, FullScoreLoss))
        return self.loss_fn(label=batch[self.frating], **score)

    def _fused_softmax_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``SoftmaxLoss`` with the log-partition from ``catalog_logsumexp``
        (K7, and K8 and K9 in the backward) instead of the ``[B(, L), N]``
        score matrix (``baseretriever.py:700-724``). Every query row goes to
        the kernels, padded or not, as on the TPU."""
        query = self.net.encode_query(self._get_query_feat(batch), self.generator)
        pos_score = self.score_func(query, self.net.encode_item(batch[self.fiid]))
        if batch[self.fiid].dim() > 1:
            pos_score = torch.where(batch[self.fiid] == 0, float("-inf"), pos_score)
        d = query.shape[-1]
        logz = catalog_logsumexp(query.reshape(-1, d), self._item_vectors())
        return softmax_loss_from_logz(logz.reshape(query.shape[:-1]), pos_score)

    @torch.no_grad()
    def _eval_epoch(self, data, metric_names, cutoffs) -> Dict[str, float]:
        """Rank metrics of the served top-``eval.topk`` lists over a split
        (``_make_eval_step``): per-sample values summed over the true rows of
        each padded batch on the device, read once at the end."""
        for name in metric_names:
            if not eval_mod.get_rank_metrics(name):
                raise NotImplementedError(f"metric {name!r} is not ported yet for a retriever")
        self._epoch_refresh(-1)            # the catalog of the current weights
        topk = int(self.config["eval"]["topk"])
        sums: Dict[str, torch.Tensor] = {}
        weight = 0
        for host in data.eval_loader(int(self.config["eval"]["batch_size"])):
            batch = batch_to_device(host, self.device)
            size = int(host["_size"])
            valid = (torch.arange(batch[self.fiid].shape[0], device=self.device) < size).float()
            _, items = self.topk(batch, topk, batch.get("user_hist"))
            target, rating = batch[self.fiid], batch[self.frating]
            if target.dim() == 1:
                target, rating = target[:, None], rating[:, None]
            hit = eval_mod.hit_matrix(items, target)
            for cutoff in cutoffs:
                for name in metric_names:
                    key = f"{name}@{cutoff}"
                    val = (eval_mod.metric_dict[name](hit, rating, cutoff) * valid).sum()
                    sums[key] = sums[key] + val if key in sums else val
            weight += size
        return {k: float(v) / max(weight, 1) for k, v in sums.items()}

    # ------------------------------------------------------------------
    def _mask_hist_scores(self, scores: torch.Tensor,
                          user_hist: Optional[torch.Tensor]) -> torch.Tensor:
        """Set scores of history items to -inf. Column j of ``scores`` is item
        j + 1; pad entries (0) of ``user_hist`` are dropped."""
        if user_hist is None:
            return scores
        n_cols = scores.shape[-1]
        col = torch.where(user_hist > 0, user_hist.to(torch.long) - 1, n_cols)
        # one spare column takes the dropped pad entries
        ext = torch.cat([scores, scores.new_zeros(scores.shape[0], 1)], dim=-1)
        ext.scatter_(1, col, float("-inf"))
        return ext[:, :n_cols]

    def _topk_from_scores(self, scores: torch.Tensor, k: int,
                          user_hist: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        score_k, idx = topk_op(self._mask_hist_scores(scores, user_hist), k)
        return score_k, idx + 1

    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int,
             user_hist: Optional[torch.Tensor] = None,
             return_query: bool = False):
        """Top-k catalog items per query: ``(scores [B, k], item ids [B, k])``,
        ids 1-based; ``user_hist`` [B, H] (0 = pad) items are excluded."""
        item_vector = self.states.get("item_vector")
        if item_vector is None:
            item_vector = self._compute_item_vector()
        query = self.net.encode_query(self._get_query_feat(batch))
        scores = self.score_func.catalog(query, item_vector)
        score_k, topk_items = self._topk_from_scores(scores, k, user_hist)
        if return_query:
            return score_k, topk_items, query
        return score_k, topk_items

    # ------------------------------------------------------------------
    # the proposal protocol of ann.sampler.RetrieverSampler
    # ------------------------------------------------------------------
    @torch.no_grad()
    def make_sampling_state(self) -> Dict[str, object]:
        """A frozen snapshot of this retriever as a proposal
        (``baseretriever.py:766-775``): a copy of its net and the catalog
        encoding of its current weights."""
        import copy
        net = copy.deepcopy(self.net).eval()
        for p in net.parameters():
            p.requires_grad_(False)
        return {"net": net, "item_vector": self._compute_item_vector()}

    @torch.no_grad()
    def sampling_from_state(self, state, generator, batch_or_query, num_neg,
                            method: str = "brute", t: float = 1.0, pos_items=None,
                            user_hist=None):
        """Negatives from a snapshot of ``make_sampling_state``
        (``baseretriever.py:777-796``): ``batch_or_query`` is a batch (its
        query encoded by the snapshot) or a query; ``user_hist`` given
        excludes the history. Draws come from ``generator``."""
        net = state["net"]
        if isinstance(batch_or_query, dict):
            batch = dict(batch_or_query)
            query = net.encode_query(self._get_query_feat(batch))
        else:
            batch, query = {}, batch_or_query
        if pos_items is not None:
            batch.setdefault(self.fiid, pos_items)
        if user_hist is not None:
            batch.setdefault("user_hist", user_hist)
        return self.sampling(batch, num_neg, query, method=method, t=t,
                             excluding_hist=user_hist is not None,
                             states={"item_vector": state["item_vector"]}, net=net,
                             generator=generator)

    def predict(self, batch: Dict[str, np.ndarray], k: int) -> Tuple[np.ndarray, np.ndarray]:
        """numpy batch in, numpy ``(scores, item ids)`` out; ``batch`` may
        carry ``user_hist``."""
        dev = batch_to_device(batch, self.device)
        if "item_vector" not in self.states:
            self._epoch_refresh(-1)
        score, items = self.topk(dev, k, dev.get("user_hist"))
        return score.cpu().numpy(), items.cpu().numpy()
