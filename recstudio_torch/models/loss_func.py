"""Losses with the sampled-softmax contract.

Counterpart of ``recstudio_tpu/models/loss_func.py``: a pairwise loss takes
``(label, pos_score, log_pos_prob, neg_score, log_neg_prob)``, the log
probabilities being the sampler's proposal, and padding positions carry
``pos_score == -inf`` and drop out of the reductions that the JAX loss
masks (``_not_pad``; a loss that masks nothing there masks nothing here);
a full-score loss takes ``(label, pos_score, all_score)``, the scores on
the whole catalog. A pointwise loss takes ``(label, pos_score)``. Every
loss of the JAX module is here, in its order of operations, and
``l2_reg_loss_fn``, the graph models' penalty on the raw embedding rows
of a batch.
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


def _not_pad(pos_score: torch.Tensor) -> torch.Tensor:
    return ~torch.isinf(pos_score)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


class Top1Loss(BPRLoss):
    """``loss_func.py:68-76``: ``sigmoid(neg - pos) + sigmoid(neg^2)``,
    averaged as BPR's; with ``dns``, the hardest negative's."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        if not self.dns:
            loss = torch.sigmoid(neg_score - pos_score[..., None])
            loss = loss + torch.sigmoid(neg_score ** 2)
            return loss.mean(-1).mean()
        max_neg = neg_score.amax(-1)
        return (torch.sigmoid(max_neg - pos_score) + torch.sigmoid(max_neg ** 2)).mean()


class SampledSoftmaxLoss(PairwiseLoss):
    """``loss_func.py:79-92``: softmax over the positive and the negatives,
    each score less its proposal log probability (the log-Q correction);
    per row, the mean over its finite positives; then the mean over rows
    (padded positions count as rows of 0)."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        new_pos = pos_score - log_pos_prob
        new_neg = neg_score - log_neg_prob
        if new_pos.dim() < new_neg.dim():
            new_pos = new_pos[..., None]
        full = torch.cat([new_pos, new_neg], dim=-1)
        out = torch.logsumexp(full, dim=-1, keepdim=True) - new_pos
        valid = _not_pad(new_pos)
        out = torch.where(valid, out, torch.zeros_like(out))
        return (out.sum(-1) / torch.clamp_min(valid.sum(-1), 1)).mean()


class InfoNCELoss(SampledSoftmaxLoss):
    """``loss_func.py:95-100``: the sampled softmax with no correction."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        return super().__call__(label, pos_score, torch.zeros_like(pos_score),
                                neg_score, torch.zeros_like(neg_score))


class WeightedBPRLoss(PairwiseLoss):
    """``loss_func.py:103-107``: BPR's terms weighted by the softmax of the
    corrected negative scores (the weights carry gradient, as there)."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        diff = F.logsigmoid(pos_score[..., None] - neg_score)
        weight = torch.softmax(neg_score - log_neg_prob, dim=-1)
        return -(diff * weight).sum(-1).mean()


class BinaryCrossEntropyLoss(PairwiseLoss):
    """``loss_func.py:108-129``: ``-mean log sigmoid(pos) + mean_neg
    softplus(neg)``, over the positions whose ``pos_score`` is finite; with
    ``dns``, against each row's hardest negative, unmasked. The negatives'
    weights are uniform (``_weight``)."""

    def __init__(self, dns: bool = False):
        self.dns = dns

    def _weight(self, neg_score, log_neg_prob):
        return torch.ones_like(neg_score) / neg_score.shape[-1]

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        if self.dns:
            return (-F.logsigmoid(pos_score) + softplus(neg_score.amax(-1))).mean()
        weight = self._weight(neg_score, log_neg_prob)
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


class WeightedBinaryCrossEntropyLoss(BinaryCrossEntropyLoss):
    """``loss_func.py:132-134``: the negatives weighted by the softmax of
    their corrected scores."""

    def _weight(self, neg_score, log_neg_prob):
        return torch.softmax(neg_score - log_neg_prob, dim=-1)


class HingeLoss(PairwiseLoss):
    """``loss_func.py:137-148``: ``relu(max neg - pos + margin)``; with
    ``num_items``, weighted by ``log(1 + rank)``, the rank estimated from
    the share of negatives inside the margin."""

    def __init__(self, margin: float = 2.0, num_items=None):
        self.margin = margin
        self.n_items = num_items

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        loss = _relu(neg_score.amax(-1) - pos_score + self.margin)
        if self.n_items is not None:
            impostors = (neg_score - pos_score[..., None] + self.margin) > 0
            rank = impostors.to(neg_score.dtype).mean(-1) * self.n_items
            return (loss * torch.log(rank + 1.0)).mean()
        return loss.mean()


class NCELoss(PairwiseLoss):
    """``loss_func.py:151-156``: ``log sigmoid(pos') + sum (neg' -
    softplus(neg'))`` of the corrected scores, negated and averaged."""

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        new_pos = pos_score - log_pos_prob
        new_neg = neg_score - log_neg_prob
        loss = F.logsigmoid(new_pos) + (new_neg - softplus(new_neg)).sum(-1)
        return -loss.mean()


class CCLLoss(PairwiseLoss):
    """``loss_func.py:159-172``: ``1 - sigmoid(pos) + w mean relu(sigmoid(neg)
    - margin)`` over the finite positives."""

    def __init__(self, margin: float = 0.8, neg_weight: float = 0.3):
        self.margin = margin
        self.neg_weight = neg_weight

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        pad = torch.isinf(pos_score)
        pos = torch.sigmoid(pos_score)
        neg = torch.sigmoid(neg_score)
        neg_mean = _relu(neg - self.margin).mean(-1)
        loss = (1.0 - pos) + self.neg_weight * neg_mean
        loss = torch.where(pad, torch.zeros_like(loss), loss)
        return loss.sum() / torch.clamp_min((~pad).sum(), 1)


class PointwiseLoss:
    def __call__(self, label, pos_score):
        raise NotImplementedError


class SquareLoss(PointwiseLoss):
    """``loss_func.py:175-180``: the mean squared error to the label, per
    row first for ``[B, W]`` labels."""

    def __call__(self, label, pos_score):
        sq = (label - pos_score) ** 2
        if label.dim() > 1:
            return sq.mean(-1).mean()
        return sq.mean()


class BCEWithLogitLoss(PointwiseLoss):
    """``loss_func.py:182-188``: ``softplus(score) - score * label``, its
    mean (``reduction="mean"``) or per sample."""

    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, label, pos_score):
        loss = softplus(pos_score) - pos_score * label
        return loss.mean() if self.reduction == "mean" else loss


class BCELoss(PointwiseLoss):
    """``loss_func.py:191-200``: binary cross-entropy of probabilities
    clipped to ``[eps, 1 - eps]``."""

    def __init__(self, reduction: str = "mean", eps: float = 1e-7):
        self.reduction = reduction
        self.eps = eps

    def __call__(self, label, pos_score):
        p = torch.clamp(pos_score, self.eps, 1.0 - self.eps)
        loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
        return loss.mean() if self.reduction == "mean" else loss


class MSELoss(PointwiseLoss):
    """``loss_func.py:203-211``: the squared error to the label, binarized
    at ``threshold`` when one is given."""

    def __init__(self, threshold=None, reduction: str = "mean"):
        self.threshold = threshold
        self.reduction = reduction

    def __call__(self, label, pos_score):
        if self.threshold is not None:
            label = (label > self.threshold).to(pos_score.dtype)
        loss = (pos_score - label) ** 2
        return loss.mean() if self.reduction == "mean" else loss


def l2_reg_loss_fn(*embs: torch.Tensor) -> torch.Tensor:
    """``loss_func.py:214-218``: the sum over ``embs`` of each one's mean
    squared row norm."""
    loss = 0.0
    for emb in embs:
        loss = loss + (emb * emb).sum(-1).mean()
    return loss
