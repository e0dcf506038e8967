"""Losses with the sampled-softmax contract.

Counterpart of ``recstudio_tpu/models/loss_func.py``: a pairwise loss takes
``(label, pos_score, log_pos_prob, neg_score, log_neg_prob)``, the log
probabilities being the sampler's proposal, and padding positions carry
``pos_score == -inf`` and drop out of every reduction; a full-score loss
takes ``(label, pos_score, all_score)``, the scores on the whole catalog.
A pointwise loss takes ``(label, pos_score)``. Ported so far: the binary
cross-entropy of SASRec, the softmax of BERT4Rec, the BPR loss of BPR and
the graph models, the rankers' ``BCEWithLogitLoss``, and
``l2_reg_loss_fn``, the graph models' penalty on the raw embedding rows of
a batch; the other losses come with their models.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` exactly, as ``jax.nn.softplus`` (torch's own
    switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class FullScoreLoss:
    """Needs scores on every item (``loss_func.py:19-23``)."""

    def __call__(self, label, pos_score, all_score):
        raise NotImplementedError


class SoftmaxLoss(FullScoreLoss):
    """``loss_func.py:39-54``: ``logsumexp(all_score) - pos_score`` over the
    positions whose ``pos_score`` is finite. With one softmax per position
    (``all_score [..., N]`` beside ``pos_score [...]``) it is the global mean
    over those positions; with one softmax per row shared by several
    positives (``pos_score [B, P]`` against ``all_score [B, N]``) it is the
    mean over rows of each row's mean."""

    def __call__(self, label, pos_score, all_score):
        logz = torch.logsumexp(all_score, dim=-1)
        return softmax_loss_from_logz(logz, pos_score)


def softmax_loss_from_logz(logz: torch.Tensor, pos_score: torch.Tensor) -> torch.Tensor:
    """``SoftmaxLoss`` from the log-partition ``logz`` (the materialized
    path's ``logsumexp(all_score)``, or the fused step's
    ``catalog_logsumexp``, ``baseretriever.py:715-724``)."""
    valid = ~torch.isinf(pos_score)
    zero = torch.zeros((), dtype=pos_score.dtype, device=pos_score.device)
    if logz.shape == pos_score.shape:
        out = torch.where(valid, logz - pos_score, zero)
        return out.sum() / torch.clamp_min(valid.sum(), 1)
    out = torch.where(valid, logz[..., None] - pos_score, zero)
    return (out.sum(-1) / torch.clamp_min(valid.sum(-1), 1)).mean()


class PairwiseLoss:
    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        raise NotImplementedError


class BPRLoss(PairwiseLoss):
    """``loss_func.py:57-66``: ``-mean log sigmoid(pos - neg)``, averaged
    over the negatives of each positive, then over the positives; with
    ``dns``, against each row's hardest negative only. Like the JAX loss it
    masks no position: a ``pos_score`` of ``-inf`` (a padded target) gives
    an infinite loss on both sides, and the flat batches BPR trains on have
    none."""

    def __init__(self, dns: bool = False):
        self.dns = dns

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        if not self.dns:
            return -F.logsigmoid(pos_score[..., None] - neg_score).mean(-1).mean()
        return -F.logsigmoid(pos_score - neg_score.amax(-1)).mean()


class BinaryCrossEntropyLoss(PairwiseLoss):
    """``loss_func.py:108-129``: ``-mean log sigmoid(pos) + mean_neg
    softplus(neg)``, over the positions whose ``pos_score`` is finite (the
    ``dns`` variant is not ported yet)."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        weight = 1.0 / neg_score.shape[-1]
        pad = torch.isinf(pos_score)
        zero = torch.zeros((), dtype=pos_score.dtype, device=pos_score.device)
        denom = torch.clamp_min((~pad).sum(), 1)
        pos_loss = torch.where(pad, zero, F.logsigmoid(pos_score)).sum() / denom
        neg_loss = (softplus(neg_score) * weight).sum(-1)
        if pos_score.dim() == neg_score.dim() - 1:
            neg_loss = torch.where(pad, zero, neg_loss).sum() / denom
        else:
            neg_loss = neg_loss.mean()
        return -pos_loss + neg_loss


class PointwiseLoss:
    def __call__(self, label, pos_score):
        raise NotImplementedError


class BCEWithLogitLoss(PointwiseLoss):
    """``loss_func.py:182-188``: ``softplus(score) - score * label``, its
    mean (``reduction="mean"``) or per sample."""

    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, label, pos_score):
        loss = softplus(pos_score) - pos_score * label
        return loss.mean() if self.reduction == "mean" else loss


def l2_reg_loss_fn(*embs: torch.Tensor) -> torch.Tensor:
    """``loss_func.py:214-218``: the sum over ``embs`` of each one's mean
    squared row norm."""
    loss = 0.0
    for emb in embs:
        loss = loss + (emb * emb).sum(-1).mean()
    return loss
