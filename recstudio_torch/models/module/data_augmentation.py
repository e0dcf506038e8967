"""Contrastive-learning toolkit: InfoNCE and the sequence augmentations.

Counterpart of ``recstudio_tpu/models/module/data_augmentation.py``:
``_normalize`` (``:17``), ``info_nce`` (``:22``), the contrastive loss with
the reference's three negative strategies, and the six sequence
augmentations (``:62-142``), each returning ``(seq, seqlen)`` at the input's
static shape ``[B, L]``. An augmentation is a draw and a deterministic map:
``*_draws`` takes its random numbers from a ``torch.Generator`` on the
batch's device, and the map turns ``(seq, seqlen, draws)`` into the view,
so a test can feed it the JAX package's own draws and get its view bit
for bit. The arithmetic follows the JAX package's types: lengths times a
ratio in float32, truncated to int32; sorts stable.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Draws = Dict[str, torch.Tensor]
View = Tuple[torch.Tensor, torch.Tensor]


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


# ---------------------------------------------------------------------------
# sequence augmentations: draws, then a deterministic map
# ---------------------------------------------------------------------------
def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _ratio_len(seqlen: torch.Tensor, ratio: float) -> torch.Tensor:
    """``max(int32(ratio * seqlen), 1)`` with the product in float32."""
    return torch.clamp_min((_f32(ratio, seqlen) * seqlen.float()).to(torch.int32), 1)


def _window_start(seqlen: torch.Tensor, length: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A window's start, ``int32(u (max(seqlen - length, 0) + 1))``."""
    room = torch.clamp_min(seqlen.to(torch.int32) - length, 0) + 1
    return (u * room.float()).to(torch.int32)


def _real(seq: torch.Tensor, seqlen: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(seq.shape[1], device=seq.device)[None, :]
    return pos < seqlen[:, None]


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def crop_map(seq: torch.Tensor, seqlen: torch.Tensor, u: torch.Tensor,
             eta: float = 0.6) -> View:
    """``item_crop`` (``:62``): a contiguous crop of ``max(int(eta len), 1)``
    items from the start ``int(u (len - crop + 1))``, left-aligned; ``u``
    ``[B]`` uniforms."""
    L = seq.shape[1]
    crop_len = _ratio_len(seqlen, eta)
    start = _window_start(seqlen, crop_len, u)
    pos = torch.arange(L, device=seq.device)[None, :]
    gather = torch.clamp_max(start[:, None].long() + pos, L - 1)
    cropped = torch.gather(seq, 1, gather)
    return torch.where(pos < crop_len[:, None], cropped, torch.zeros_like(seq)), crop_len


def mask_map(seq: torch.Tensor, seqlen: torch.Tensor, u: torch.Tensor, gamma: float = 0.3,
             mask_id: int = 0) -> View:
    """``item_mask`` (``:75``): each true position whose uniform ``u``
    ``[B, L]`` is under ``gamma`` becomes ``mask_id``."""
    masked = (u < _f32(gamma, u)) & _real(seq, seqlen)
    return torch.where(masked, torch.full_like(seq, mask_id), seq), seqlen


def reorder_map(seq: torch.Tensor, seqlen: torch.Tensor, u: torch.Tensor, noise: torch.Tensor,
                beta: float = 0.6) -> View:
    """``item_reorder`` (``:142``): the window of ``max(int(beta len), 1)``
    items from ``int(u (len - window + 1))`` shuffled by the stable order of
    ``start + noise`` (``noise`` ``[B, L]`` uniforms), every other position
    keyed by its index."""
    L = seq.shape[1]
    reorder_len = _ratio_len(seqlen, beta)
    start = _window_start(seqlen, reorder_len, u)
    pos = torch.arange(L, device=seq.device)[None, :]
    in_window = (pos >= start[:, None]) & (pos < (start + reorder_len)[:, None])
    key = torch.where(in_window, start[:, None].float() + noise, pos.float())
    perm = torch.argsort(key, dim=1, stable=True)
    return torch.gather(seq, 1, perm), seqlen


def _forced(u: torch.Tensor, real: torch.Tensor, rate: float) -> torch.Tensor:
    """The positions to change: a true position whose uniform is under
    ``rate``, and always the true position of the smallest uniform."""
    forced_idx = torch.argmin(u + (~real).float() * 2.0, dim=1)
    picks = (u < _f32(rate, u)) & real
    return picks.scatter(1, forced_idx[:, None], True)


def substitute_map(seq: torch.Tensor, seqlen: torch.Tensor, u: torch.Tensor,
                   top1_sim: torch.Tensor, rate: float = 0.1) -> View:
    """``item_substitute`` (``:99``): the picked true positions (``rate`` of
    them, at least one) take their item's most similar item
    ``top1_sim[item]``."""
    real = _real(seq, seqlen)
    subs = _forced(u, real, rate) & real
    return torch.where(subs, top1_sim[seq.long()].to(seq.dtype), seq), seqlen


def insert_map(seq: torch.Tensor, seqlen: torch.Tensor, u: torch.Tensor,
               top1_sim: torch.Tensor, rate: float = 0.4) -> View:
    """``item_insert`` (``:114``): each picked true position (``rate`` of
    them, at least one) gets its item's most similar item inserted before
    it; the sequence is left-compacted in order and, past L items, keeps
    the last L."""
    B, L = seq.shape
    real = _real(seq, seqlen)
    ins = _forced(u, real, rate)
    zero = torch.zeros_like(seq)
    doubled = torch.stack([torch.where(ins, top1_sim[seq.long()].to(seq.dtype), zero),
                           torch.where(real, seq, zero)], dim=2).reshape(B, 2 * L)
    idx = torch.arange(2 * L, device=seq.device)[None, :]
    keys = torch.where(doubled != 0, idx, 2 * L + 1)
    compact = torch.gather(doubled, 1, torch.argsort(keys, dim=1, stable=True))
    new_len = seqlen.to(torch.int32) + ins.sum(1).to(torch.int32)
    shift = torch.clamp_min(new_len - L, 0)
    gather = torch.clamp_max(shift[:, None].long() + idx[:, :L], 2 * L - 1)
    return torch.gather(compact, 1, gather), torch.clamp_max(new_len, L)


def random_map(seq: torch.Tensor, seqlen: torch.Tensor, draws: Draws, mask_id: int = 0,
               eta: float = 0.6, gamma: float = 0.3, beta: float = 0.6) -> View:
    """``item_random`` (``:85``): each row's view is its crop (choice 0),
    mask (1) or reorder (2) view."""
    crop_s, crop_l = crop_map(seq, seqlen, draws["crop"], eta)
    mask_s, mask_l = mask_map(seq, seqlen, draws["mask"], gamma, mask_id)
    reord_s, reord_l = reorder_map(seq, seqlen, draws["reorder"], draws["reorder_noise"], beta)
    c = draws["choice"]
    out_seq = torch.where(c[:, None] == 0, crop_s, torch.where(c[:, None] == 1, mask_s, reord_s))
    out_len = torch.where(c == 0, crop_l, torch.where(c == 1, mask_l, reord_l))
    return out_seq, out_len


def random_draws(shape, generator: Optional[torch.Generator], device) -> Draws:
    """The draws of ``random_map``: the crop's, mask's and reorder's
    uniforms, and a choice in {0, 1, 2} a row."""
    B = shape[0]
    return {"crop": _uniform((B,), generator, device), "mask": _uniform(shape, generator, device),
            "reorder": _uniform((B,), generator, device),
            "reorder_noise": _uniform(shape, generator, device),
            "choice": torch.randint(0, 3, (B,), generator=generator, device=device)}


def item_crop(seq, seqlen, eta: float = 0.6, generator=None) -> View:
    return crop_map(seq, seqlen, _uniform(seq.shape[:1], generator, seq.device), eta)


def item_mask(seq, seqlen, gamma: float = 0.3, mask_id: int = 0, generator=None) -> View:
    return mask_map(seq, seqlen, _uniform(seq.shape, generator, seq.device), gamma, mask_id)


def item_reorder(seq, seqlen, beta: float = 0.6, generator=None) -> View:
    return reorder_map(seq, seqlen, _uniform(seq.shape[:1], generator, seq.device),
                       _uniform(seq.shape, generator, seq.device), beta)


def item_random(seq, seqlen, mask_id: int = 0, eta: float = 0.6, gamma: float = 0.3,
                beta: float = 0.6, generator=None) -> View:
    return random_map(seq, seqlen, random_draws(seq.shape, generator, seq.device), mask_id,
                      eta, gamma, beta)


def item_substitute(seq, seqlen, top1_sim, rate: float = 0.1, generator=None) -> View:
    return substitute_map(seq, seqlen, _uniform(seq.shape, generator, seq.device), top1_sim,
                          rate)


def item_insert(seq, seqlen, top1_sim, rate: float = 0.4, generator=None) -> View:
    return insert_map(seq, seqlen, _uniform(seq.shape, generator, seq.device), top1_sim, rate)
