"""Rank metrics over served top-k lists, and prediction metrics.

Counterpart of ``recstudio_tpu/eval/__init__.py``. Each rank metric takes
a boolean hit matrix ``pred [B, topk]`` (column j True iff the j-th ranked
item is a target), the padded target ratings ``target [B, T]`` (> 0 marks
a real target) and a cutoff ``k``, and returns per-sample values ``[B]``.
Each prediction metric (``logloss``, ``mse``, ``mae``, ``accuracy``)
takes scores ``[B]`` and labels ``[B]`` and returns per-sample values;
``auc`` is global, over a whole split's scores, labels and weights.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import torch


def recall(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    count = (target > 0).sum(-1)
    return pred[:, :k].sum(-1).float() / torch.clamp_min(count, 1)


def precision(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    return pred[:, :k].sum(-1).float() / k


def map_(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    count = (target > 0).sum(-1)
    p = pred[:, :k].float()
    prec_at_i = p.cumsum(-1) / torch.arange(1, k + 1, dtype=torch.float32, device=p.device)
    return (prec_at_i * p).sum(-1) / torch.clamp_min(torch.clamp_max(count, k), 1)


def _dcg(rel: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, rel.shape[1])
    denom = torch.log2(torch.arange(k, dtype=torch.float32, device=rel.device) + 2.0)
    return (rel[:, :k] / denom).sum(-1)


def ndcg(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    pred_dcg = _dcg(pred.float(), k)
    rel_sorted = torch.sort((target > 0).float(), dim=-1, descending=True).values
    ideal = _dcg(rel_sorted, k)
    all_irrelevant = torch.all(target <= torch.finfo(torch.float32).eps, dim=-1)
    return torch.where(all_irrelevant, torch.zeros_like(pred_dcg),
                       pred_dcg / torch.where(ideal > 0, ideal, torch.ones_like(ideal)))


def mrr(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    p = pred[:, :k]
    pos = torch.arange(1, k + 1, dtype=torch.float32, device=p.device)
    first = torch.where(p, pos, torch.full_like(pos, float("inf"))).amin(-1)
    return torch.where(torch.isinf(first), torch.zeros_like(first), 1.0 / first)


def hits(pred: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    return pred[:, :k].any(-1).float()


# ---------------------------------------------------------------------------
# prediction metrics: pred [B] scores/logits, target [B] labels
# ---------------------------------------------------------------------------
def logloss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy of logits, per sample (softplus exactly, as
    ``jax.nn.softplus``)."""
    return torch.logaddexp(pred, torch.zeros_like(pred)) - pred * target


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - target)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target)


def accuracy(pred: torch.Tensor, target: torch.Tensor, thres: float = 0.5) -> torch.Tensor:
    return ((pred > thres) == (target > 0.5)).float()


def auc(pred: torch.Tensor, target: torch.Tensor,
        weight: Union[torch.Tensor, None] = None) -> torch.Tensor:
    """Global AUC (Mann-Whitney), tie-aware, weighted (``eval/__init__.py:
    95-121``): P(pos > neg) + 0.5 P(pos == neg) over the weighted pairs, 0
    when a class has no weight. Rows of weight 0 (padding) drop out. One
    sort of the scores; each tie group's negative mass before it and inside
    it come from one cumulative sum, read at the group's first and last
    row (no scatter, so the result does not depend on the order of atomic
    adds). The sums are taken in float64, which holds integer weights
    exactly at any split size the card holds. A 0-dim float64 tensor."""
    if weight is None:
        weight = torch.ones_like(pred)
    order = torch.argsort(pred, stable=True)
    p = pred[order]
    t = (target[order] > 0).double()
    w = weight[order].double()
    pos_w, neg_w = w * t, w * (1.0 - t)
    n = p.shape[0]
    is_new = torch.ones(n, dtype=torch.bool, device=p.device)
    is_new[1:] = p[1:] != p[:-1]
    starts = torch.nonzero(is_new).squeeze(-1)
    ends = torch.cat([starts[1:] - 1, starts.new_full((1,), n - 1)])
    gid = torch.cumsum(is_new, 0) - 1
    cum_neg = torch.cumsum(neg_w, 0)
    neg_before = (cum_neg - neg_w)[starts][gid]        # negatives below the group
    group_neg = cum_neg[ends][gid] - neg_before        # negatives tied with the row
    contrib = (pos_w * (neg_before + 0.5 * group_neg)).sum()
    n_pos, n_neg = pos_w.sum(), neg_w.sum()
    value = contrib / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), value, torch.zeros_like(value))


metric_dict = {"ndcg": ndcg, "precision": precision, "recall": recall,
               "map": map_, "hit": hits, "mrr": mrr,
               "mse": mse, "mae": mae, "auc": auc, "logloss": logloss, "accuracy": accuracy}

# the JAX package's metric families (``eval/__init__.py:142-144``); its
# ``f1`` rank metric is not ported yet
_TOPK_METRICS = {"ndcg", "precision", "recall", "map", "mrr", "hit", "f1"}
_PRED_METRICS = {"mae", "mse", "auc", "logloss", "accuracy", "precision", "recall", "f1"}
_GLOBAL_METRICS = {"auc"}


def _as_list(metric) -> List[str]:
    return metric if isinstance(metric, (list, tuple)) else [metric]


def get_rank_metrics(metric) -> List[Tuple[str, callable]]:
    return [(m, metric_dict[m]) for m in _as_list(metric)
            if m in _TOPK_METRICS and m in metric_dict]


def get_pred_metrics(metric) -> List[Tuple[str, callable]]:
    return [(m, metric_dict[m]) for m in _as_list(metric)
            if m in _PRED_METRICS and m in metric_dict]


def get_global_metrics(metric) -> List[Tuple[str, callable]]:
    return [(m, metric_dict[m]) for m in _as_list(metric)
            if m in _GLOBAL_METRICS and m in metric_dict]


def get_eval_metrics(metric_names, cutoffs, validation: bool = False) -> List[str]:
    """The keys an evaluation reports (``eval/__init__.py:165-177``): rank
    metrics at each cutoff (the first alone in validation), the others as
    they are; with no cutoff, the prediction metrics alone."""
    metric_names = _as_list(metric_names)
    rank_m = {m for m, _ in get_rank_metrics(metric_names)}
    if cutoffs is not None:
        cutoffs = _as_list(cutoffs)
        if validation:
            cutoffs = cutoffs[:1]
        return [f"{m}@{cut}" if m in rank_m else m for cut in cutoffs for m in metric_names]
    return [m for m, _ in get_pred_metrics(metric_names)]


def hit_matrix(topk_items: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """``[B, k]`` bool: served item equals one of the (non-pad) targets
    ``[B, T]`` (``baseretriever.py:743-745``)."""
    return ((topk_items[:, :, None] == target_ids[:, None, :])
            & (target_ids[:, None, :] > 0)).any(-1)
