"""BaseRanker: pointwise CTR / feature-interaction models, multitask
rankers and the two-stage cascade.

Counterpart of ``recstudio_tpu/models/basemodel/baseranker.py``. A ranker
scores one feature row (user, item and context fields, or the id-less
fields of a criteo-layout dataset) pointwise: ``self.net(batch, rng)``
returns logits ``[B]``, trained with ``BCEWithLogitLoss`` against
binarized ratings. Every field of the dataset is a feature
(``_set_data_field``). Evaluation is per row (``fmeval``): ``logloss``,
``mse``, ``mae`` and ``accuracy`` as masked per-row sums, and ``auc`` once
over the whole split's scores, labels and weights, all kept on the device
(``recommender.py:1159-1188``).

Several rating fields (multitask, ``baseranker.py:417-434``): the net
returns a dict of logits, one a rating; the loss is each rating's loss
weighted by ``softmax(train.weights)`` (equal weights when it is null);
the metrics are named ``{rating}_{metric}``, one global AUC a rating.

A cascade (``BaseRanker(config, retriever=fitted, loss=...)``,
``baseranker.py:46-118``): the fitted retriever is frozen into
``states["retriever"]`` (a copy of its net that takes no gradient, its
catalog encoding and, for a stateful sampler, its index, refreshed before
each epoch). In training it proposes ``negative_count`` negatives for each
positive (``train.sampling_method``, ``excluding_hist``), scored through
``_multi_item_batch``, and the pairwise loss takes the proposal's log
probabilities. ``topk`` reranks the retriever's top ``eval.topk`` with the
ranker's scores, and the rank metrics of such a ranker are computed on
those lists exactly as a retriever computes them.

The packed row-sparse CTR step (``baseranker.py:150-385``): with
``learner: sparse_adam`` and ``train.sparse_rows`` ``auto`` or ``true``,
no weight decay, no clip, no scheduler, no mesh and no retriever
(``_ctr_sparse_config_ok``), the net is built with packed fused token
tables (``module/ctr.packed_tables``: ``[N, 3D]`` rows of params, mu and
nu, the moment columns zeroed after initialisation and the tables taking
no gradient, ``_prepare_sparse_state``), and each step
(``_ctr_sparse_grad_step``) takes every lookup's gradient on the gathered
``[B, T, D]`` rows, updates the dense leaves by lazy Adam, and each packed
table by ``fused_table_lazy_adam_packed``: one gather of the candidate
rows and one write back, no ``[N, D]`` gradient. ``sparse_rows: false``
trains the same trajectory with the dense ``LazyAdam``. A net's batch
norms are calibrated by ``_calibration_forward`` (``baseranker.py:387``).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import eval as eval_mod
from ..init import zero_pad_rows_in_grads
from ..loss_func import BCEWithLogitLoss
from ..module.ctr import Embeddings, packed_tables
from ..optim import fused_table_lazy_adam_packed, unpack_table_params
from .recommender import Recommender, batch_to_device

class BaseRanker(Recommender):
    def __init__(self, config: Dict = None, device="cuda", retriever=None, **kwargs):
        """``retriever``: a fitted retriever to cascade (two-stage);
        ``kwargs``: ``loss`` (a pairwise loss for a cascade)."""
        super().__init__(config, device, **kwargs)
        self.retriever = retriever
        self._eval_cache: Dict[Tuple[int, int], Tuple[object, List[Dict[str, torch.Tensor]]]] = {}
        self._item_feat_cols: Dict[str, torch.Tensor] = {}

    def _set_data_field(self, data) -> None:
        """Every declared field is a feature (``baseranker.py:30-44``); in a
        cascade only the id, rating and entity fields, the ones a candidate
        of the retriever has."""
        if self.retriever is None:
            data.use_field = set(data.field2type.keys())
            return
        fields = {data.fuid, data.fiid, *data._rating_fields()}
        for frame in (data.user_feat, data.item_feat):
            if frame is not None:
                fields |= set(frame.fields)
        data.use_field = fields & set(data.field2type.keys())

    def _init_model(self, train_data):
        self._set_data_field(train_data)
        super()._init_model(train_data)
        if self.retriever is not None:
            if isinstance(self.frating, list):      # baseranker.py:398-399
                raise ValueError("a multitask ranker takes no retriever")
            if getattr(self.retriever, "net", None) is None:
                raise ValueError("the attached retriever must be fitted (or at least "
                                 "initialized by fit) before the ranker")
            # the stored copy: later changes to the live retriever reach
            # neither the queries nor the catalog (baseranker.py:89-99)
            self._retriever_net = copy.deepcopy(self.retriever.net).eval()
            for p in self._retriever_net.parameters():
                p.requires_grad_(False)
        with packed_tables(self._ctr_sparse_config_ok()):
            self.net = self._get_score_net(train_data)
        self._eval_cache.clear()
        self._item_feat_cols.clear()

    def _multitask_ratings(self, model_name: str) -> Tuple[str, ...]:
        """The rating fields of a multitask model, which needs several."""
        if not isinstance(self.frating, list):
            raise ValueError(f"{model_name} expects a list-valued rating_field")
        return tuple(self.frating)

    # ------------------------------------------------------------------
    # the cascaded retriever (baseranker.py:46-118)
    # ------------------------------------------------------------------
    def _retriever_state(self) -> Dict[str, object]:
        """``states["retriever"]``: the retriever's net as ``_init_model``
        copied it (eval mode, no gradient) and the catalog encoded by that
        copy, put back when ``states`` was cleared (new weights, a
        restore), with the sampler's index when ``_epoch_refresh`` built
        one."""
        rs = self.states.get("retriever")
        if rs is None or "net" not in rs:
            rs = self.states["retriever"] = {
                **(rs or {}), "net": self._retriever_net,
                "item_vector": self._retriever_catalog()}
        return rs

    @torch.no_grad()
    def _retriever_catalog(self) -> torch.Tensor:
        """The catalog encoded by the stored copy of the retriever's net,
        as JAX encodes it from the stored parameters."""
        return self.retriever._item_vectors(self._retriever_net)

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int) -> None:
        """Re-encode the retriever's catalog into ``states["retriever"]``
        and, before a training epoch (``nepoch >= 0``), re-index a stateful
        sampler from it with the ranker's device generator
        (``baseranker.py:101-118``)."""
        if self.retriever is None:
            return
        rs = self._retriever_state()
        rs["item_vector"] = self._retriever_catalog()
        if nepoch >= 0 and self.retriever._sampler_is_stateful():
            state = self.retriever.sampler.update(rs["item_vector"], self.device_generator)
            if state is not None:
                rs["sampler"] = state

    def _init_parameter(self, train_data=None):
        super()._init_parameter(train_data)
        self._prepare_sparse_state()

    def _get_score_net(self, train_data) -> torch.nn.Module:
        raise NotImplementedError

    def _get_loss_func(self):
        return BCEWithLogitLoss()

    # ------------------------------------------------------------------
    # the packed row-sparse CTR step
    # ------------------------------------------------------------------
    def _ctr_sparse_config_ok(self) -> bool:
        """The config's half of the gate (``baseranker.py:150-171``), known
        before the net is built: it decides whether the fused tables are
        declared packed."""
        tc = self.config["train"]
        return (str(tc.get("sparse_rows", "auto")).lower() != "false"
                and str(tc.get("learner", "adam")).lower() == "sparse_adam"
                and not tc.get("weight_decay") and not tc.get("grad_clip_norm")
                and not tc.get("scheduler") and not tc.get("mesh")
                and self.retriever is None)

    def _packed_embeddings(self) -> List[Embeddings]:
        return [m for m in self.net.modules() if isinstance(m, Embeddings) and m.packed]

    def _ctr_sparse_enabled(self) -> bool:
        """The packed step runs (``baseranker.py:173-205``): the config
        qualifies and the net holds packed fused tables."""
        return self.net is not None and self._ctr_sparse_config_ok() \
            and bool(self._packed_embeddings())

    @torch.no_grad()
    def _prepare_sparse_state(self) -> None:
        """After initialisation (``baseranker.py:207-278``): a packed table's
        moment columns are set to 0 (the initialisation drew the whole
        leaf) and the table takes no gradient (the packed step updates it);
        a packed table whose gate is off is unpacked to its first D columns,
        so the dense path trains it."""
        enabled = self._ctr_sparse_enabled()
        for m in self._packed_embeddings():
            w = m.token_embedding.weight
            if enabled:
                w[:, m.embed_dim:].zero_()
                w.requires_grad_(False)
            else:
                m.token_embedding.weight = torch.nn.Parameter(
                    unpack_table_params(w).contiguous())

    def _grad_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self._ctr_sparse_enabled():
            return self._ctr_sparse_grad_step(batch)
        return super()._grad_step(batch)

    def _ctr_sparse_grad_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One lazy-Adam step (``baseranker.py:287-356``): the loss is
        differentiated with respect to the dense leaves and to the rows
        each packed table's read gathered (``Embeddings.probe``); the dense
        leaves take ``LazyAdam``'s update, each packed table
        ``fused_table_lazy_adam_packed`` from its per-lookup gradients."""
        tables = self._packed_embeddings()
        self.optimizer.zero_grad(set_to_none=True)
        for m in tables:
            m.probe, m.probed = True, None
        try:
            loss = self.training_step(batch)
        finally:
            for m in tables:
                m.probe = False
        probed = [m.probed for m in tables]
        for m in tables:
            m.probed = None
        loss.backward()
        zero_pad_rows_in_grads(self.net)
        self.optimizer.step()
        group = self.optimizer.param_groups[0]
        count = group["count"]
        for m, (ids, rows) in zip(tables, probed):
            fused_table_lazy_adam_packed(m.sizes, m.token_embedding.weight, ids, rows.grad,
                                         count, group["lr"], group["betas"][0],
                                         group["betas"][1], group["eps"])
        return loss.detach()

    def _calibration_forward(self, batch: Dict[str, torch.Tensor]) -> None:
        self.net(batch, self.generator)

    # ------------------------------------------------------------------
    def score(self, batch: Dict[str, torch.Tensor]):
        """Logits ``[B]``, or a dict of them a rating (multitask); dropout
        (training mode) draws its seeds from ``self.generator``."""
        return self.net(batch, self.generator)

    @torch.no_grad()
    def predict(self, batch: Dict[str, np.ndarray]):
        """numpy feature batch in, numpy probabilities out
        (``baseranker.py:373-385``); a multitask ranker gives a dict of
        them, one a rating."""
        self.net.eval()
        out = self.score(batch_to_device(batch, self.device))
        if isinstance(out, dict):
            return {r: torch.sigmoid(v).cpu().numpy() for r, v in out.items()}
        return torch.sigmoid(out).cpu().numpy()

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """``baseranker.py:393-422``: the positives' scores; in a cascade
        (training mode) also the retriever's negatives' and the proposal's
        log probabilities; a multitask ranker's scores and labels a
        rating."""
        if self.retriever is not None and self.net.training:
            return self._cascade_scores(batch)
        scores = self.score(batch)
        if isinstance(self.frating, list):
            return {r: {"pos_score": scores[r], "label": batch[r]} for r in self.frating}
        return {"pos_score": scores, "label": batch[self.frating]}

    def _cascade_scores(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Pairwise scores of a cascade's training step (``baseranker.py:
        394-416``): the positives pointwise, then ``negative_count``
        negatives a row from the frozen retriever's ``sampling`` (its query
        encoded by the frozen net, draws from the device generator), scored
        through ``_multi_item_batch``."""
        if not self.neg_count:
            raise ValueError("`negative_count` is required with a retriever")
        tc = self.config["train"]
        pos_score = self.score(batch)
        rs = self._retriever_state()
        with torch.no_grad():
            query = rs["net"].encode_query(self.retriever._get_query_feat(batch))
            log_pos_prob, neg_ids, log_neg_prob = self.retriever.sampling(
                batch, self.neg_count, query, method=tc.get("sampling_method", "none"),
                excluding_hist=tc.get("excluding_hist", False), states=rs, net=rs["net"],
                generator=self.device_generator)
        neg_score = self.score(self._multi_item_batch(batch, neg_ids)).reshape(
            -1, int(self.neg_count))
        return {"pos_score": pos_score, "log_pos_prob": log_pos_prob, "neg_score": neg_score,
                "log_neg_prob": log_neg_prob, "label": batch[self.frating]}

    def _multitask_loss(self, out: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
        """Each rating's loss weighted by ``softmax(train.weights)``
        (``baseranker.py:426-430``)."""
        weights = self.config["train"].get("weights") or [1.0] * len(self.frating)
        w = torch.softmax(torch.tensor(weights, dtype=torch.float32, device=self.device), 0)
        return sum(w[i] * self.loss_fn(out[r]["label"], out[r]["pos_score"])
                   for i, r in enumerate(self.frating))

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.forward(batch)
        if isinstance(self.frating, list):
            return self._multitask_loss(out)
        if "neg_score" in out:                 # a cascade's pairwise loss
            return self.loss_fn(**out)
        return self.loss_fn(out["label"], out["pos_score"])

    # ------------------------------------------------------------------
    # two-stage retrieval (baseranker.py:523-556)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int,
             user_hist: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The retriever's top ``eval.topk`` candidates (``user_hist``
        excluded) reranked by the ranker's scores: ``(scores [B, k], item
        ids [B, k])``. ``k`` above the retriever's ``eval.topk`` raises."""
        if self.retriever is None:
            raise NotImplementedError("topk requires a cascaded retriever")
        retr_k = int(self.retriever.config["eval"]["topk"])
        if k > retr_k:
            raise ValueError(f"ranker topk {k} must be <= the retriever's eval.topk {retr_k}")
        rs = self._retriever_state()
        _, cand = self.retriever.topk(batch, retr_k, user_hist, states=rs, net=rs["net"])
        scores = self.score(self._multi_item_batch(batch, cand)).reshape(cand.shape[0], -1)
        top, idx = torch.topk(scores, k, dim=-1)
        return top, torch.gather(cand, 1, idx)

    def _item_feat_col(self, f: str) -> torch.Tensor:
        if f not in self._item_feat_cols:
            self._item_feat_cols[f] = torch.as_tensor(
                np.ascontiguousarray(self.item_feat.get_col(f))).to(self.device)
        return self._item_feat_cols[f]

    def _multi_item_batch(self, batch: Dict[str, torch.Tensor],
                          item_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``item_ids [B, K]`` as a batch of ``B K`` rows
        (``baseranker.py:538-556``): the item id and its item features are
        the candidates' (also where the batch has none, as a served
        request), every other field of a batch row (``seqlen`` and
        the ``in_`` histories too) is repeated once a candidate. The
        ``user_hist`` table of an evaluation batch, which no score net
        reads, is left out."""
        num_item = item_ids.shape[-1]
        flat = item_ids.reshape(-1)
        item_values = {self.fiid: flat}
        if self.item_feat is not None:
            for f in self.item_feat.fields:
                if f in self.fields and f != self.fiid:
                    item_values[f] = self._item_feat_col(f)[flat.long()]
        out = dict(item_values)                # a served request has no item fields
        for key, v in batch.items():
            if key in item_values:
                continue
            elif key == "user_hist":
                continue
            elif v.dim() >= 1 and v.shape[0] == item_ids.shape[0]:
                out[key] = torch.repeat_interleave(v, num_item, dim=0)
            else:
                out[key] = v
        return out

    # ------------------------------------------------------------------
    def _eval_batches(self, data) -> List[Dict[str, torch.Tensor]]:
        """A split's padded eval batches, staged on the device once and
        kept for the split's later evaluations (``_eval_scan_parts``)."""
        bs = int(self.config["eval"]["batch_size"])
        key = (id(data), bs)
        if key not in self._eval_cache:
            data.use_field = self.fields
            batches = [batch_to_device(b, self.device) for b in data.eval_loader(bs)]
            self._eval_cache[key] = (data, batches)
        return self._eval_cache[key][1]

    @torch.no_grad()
    def _eval_epoch(self, data, metric_names, cutoffs) -> Dict[str, float]:
        """``_make_eval_step`` and ``_global_metrics`` (``baseranker.py:
        436-520``) over a split: per-row metrics summed over the true rows
        of each batch, ``auc`` over all of the split's rows at once (padded
        rows weigh 0); every number stays on the device until the end."""
        if eval_mod.get_rank_metrics(metric_names):
            if self.retriever is None:
                raise NotImplementedError("rank metrics of a ranker need a cascaded retriever")
            return self._rank_eval_epoch(data, metric_names, cutoffs)
        unknown = [m for m in metric_names if not eval_mod.get_pred_metrics(m)]
        if unknown:
            raise NotImplementedError(f"metrics {unknown} are not ported for a ranker")
        global_names = {m for m, _ in eval_mod.get_global_metrics(metric_names)}
        pred_m = [(m, fn) for m, fn in eval_mod.get_pred_metrics(metric_names)
                  if m not in global_names and m in ("logloss", "accuracy", "mse", "mae")]
        thres = self.config["eval"].get("binarized_prob_thres", 0.5)
        multitask = isinstance(self.frating, list)
        ratings = self.frating if multitask else [self.frating]
        self.net.eval()
        sums: Dict[str, torch.Tensor] = {}
        weight = torch.zeros((), device=self.device)
        glob: Dict[str, List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = {
            r: [] for r in ratings}
        for batch in self._eval_batches(data):
            valid = (torch.arange(batch[ratings[0]].shape[0], device=self.device)
                     < batch["_size"]).float()
            scores_all = self.score(batch)
            for r in ratings:
                scores, label = (scores_all[r] if multitask else scores_all), batch[r]
                prefix = f"{r}_" if multitask else ""
                for name, fn in pred_m:
                    if name == "logloss":
                        per = fn(scores, label)
                    elif name == "accuracy":
                        per = fn(torch.sigmoid(scores), label, thres)
                    else:
                        per = fn(torch.sigmoid(scores), label)
                    key, val = prefix + name, (per * valid).sum()
                    sums[key] = sums[key] + val if key in sums else val
                if global_names:
                    glob[r].append((scores, label, valid))
            weight = weight + batch["_size"].float()
        out = {k: float(v) / max(float(weight), 1.0) for k, v in sums.items()}
        if global_names:
            for r in ratings:
                scores, labels, weights = (torch.cat(x) for x in zip(*glob[r]))
                for name, fn in eval_mod.get_global_metrics(metric_names):
                    out[(f"{r}_" if multitask else "") + name] = float(fn(scores, labels, weights))
        return out

    @torch.no_grad()
    def _rank_eval_epoch(self, data, metric_names, cutoffs) -> Dict[str, float]:
        """A cascade's rank metrics (``_make_rank_eval_step``,
        ``baseranker.py:477-505``): each batch's reranked top ``eval.topk``
        against its targets, exactly as a retriever scores its lists, summed
        over the true rows on the device and read once at the end."""
        other = [m for m in metric_names if not eval_mod.get_rank_metrics(m)]
        if other:
            raise NotImplementedError(f"metrics {other} beside rank metrics in one evaluation")
        self._epoch_refresh(-1)
        self.net.eval()
        topk = int(self.config["eval"]["topk"])
        sums: Dict[str, torch.Tensor] = {}
        weight = torch.zeros((), device=self.device)
        for batch in self._eval_batches(data):
            target, rating = batch[self.fiid], batch[self.frating]
            valid = (torch.arange(target.shape[0], device=self.device) < batch["_size"]).float()
            _, items = self.topk(batch, topk, batch.get("user_hist"))
            if target.dim() == 1:
                target, rating = target[:, None], rating[:, None]
            hit = eval_mod.hit_matrix(items, target)
            for cutoff in cutoffs:
                for name in metric_names:
                    key = f"{name}@{cutoff}"
                    val = (eval_mod.metric_dict[name](hit, rating, cutoff) * valid).sum()
                    sums[key] = sums[key] + val if key in sums else val
            weight = weight + batch["_size"].float()
        return {k: float(v) / max(float(weight), 1.0) for k, v in sums.items()}
