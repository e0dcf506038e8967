"""Rank metrics over served top-k lists.

Counterpart of ``recstudio_tpu/eval/__init__.py:26-76``: each metric takes
a boolean hit matrix ``pred [B, topk]`` (column j True iff the j-th ranked
item is a target), the padded target ratings ``target [B, T]`` (> 0 marks
a real target) and a cutoff ``k``, and returns per-sample values ``[B]``.
"""
from __future__ import annotations

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


metric_dict = {"ndcg": ndcg, "precision": precision, "recall": recall,
               "map": map_, "hit": hits, "mrr": mrr}


def hit_matrix(topk_items: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """``[B, k]`` bool: served item equals one of the (non-pad) targets
    ``[B, T]`` (``baseretriever.py:743-745``)."""
    return ((topk_items[:, :, None] == target_ids[:, None, :])
            & (target_ids[:, None, :] > 0)).any(-1)
