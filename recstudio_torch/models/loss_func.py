"""Losses with the sampled-softmax contract.

Counterpart of ``recstudio_tpu/models/loss_func.py``: a pairwise loss takes
``(label, pos_score, log_pos_prob, neg_score, log_neg_prob)``, the log
probabilities being the sampler's proposal, and padding positions carry
``pos_score == -inf`` and drop out of every reduction. Ported so far: the
binary cross-entropy of SASRec; the other losses come with their models.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` exactly, as ``jax.nn.softplus`` (torch's own
    switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class PairwiseLoss:
    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        raise NotImplementedError


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
