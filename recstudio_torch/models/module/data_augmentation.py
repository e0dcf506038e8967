"""Contrastive-learning toolkit: the InfoNCE loss.

Counterpart of the part of ``recstudio_tpu/models/module/data_augmentation.py``
that the graph models use: ``_normalize`` (``:17``) and ``info_nce``
(``:22``), the contrastive loss with the reference's three negative
strategies. The sequence augmentations wait for CL4SRec.
"""
from __future__ import annotations

from typing import Optional

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit norm; the rsqrt form gives a zero row zero output
    and a zero (not NaN) gradient."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def info_nce(rep_i: torch.Tensor, rep_j: torch.Tensor, temperature: float = 1.0,
             sim_method: str = "inner_product", neg_type: str = "batch_both",
             all_reps: Optional[torch.Tensor] = None,
             instance_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InfoNCE of the positive pairs ``(rep_i[b], rep_j[b])``. Negatives:
    ``all`` every row of ``all_reps``; ``batch_both`` the other rows of
    ``rep_j`` and of ``rep_i``; ``batch_single`` the other rows of
    ``rep_j``. ``instance_labels`` marks rows of one instance, which are
    not each other's negatives."""
    if sim_method == "cosine":
        rep_i, rep_j = _normalize(rep_i), _normalize(rep_j)
        if all_reps is not None:
            all_reps = _normalize(all_reps)
    B = rep_i.shape[0]
    if neg_type == "all":
        sim_ij = rep_i @ all_reps.t() / temperature                 # [B, N]
        sim_ii = (rep_i * rep_j).sum(-1) / temperature              # [B]
        return (torch.logsumexp(sim_ij, dim=-1) - sim_ii).mean()
    sim_ij = rep_i @ rep_j.t() / temperature                        # [B, B]
    eye = torch.eye(B, dtype=torch.bool, device=rep_i.device)
    neg_inf = torch.tensor(float("-inf"), dtype=sim_ij.dtype, device=sim_ij.device)
    if neg_type == "batch_both":
        sim_ii = rep_i @ rep_i.t() / temperature
        if instance_labels is not None:
            same = instance_labels[:, None] == instance_labels[None, :]
            sim_ii = torch.where(same, neg_inf, sim_ii)
            sim_ij = torch.where(same & ~eye, neg_inf, sim_ij)
        else:
            sim_ii = torch.where(eye, neg_inf, sim_ii)
        logits = torch.cat([sim_ij, sim_ii], dim=-1)                # [B, 2B]
    elif neg_type == "batch_single":
        if instance_labels is not None:
            same = instance_labels[:, None] == instance_labels[None, :]
            sim_ij = torch.where(same & ~eye, neg_inf, sim_ij)
        logits = sim_ij
    else:
        raise ValueError(f"unknown neg_type {neg_type}")
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.diagonal(log_probs[:, :B]).mean()
