"""Negative samplers, on the device, from an explicit generator.

Counterpart of the uniform samplers of ``recstudio_tpu/ann/sampler.py``:
a sampler is called as ``sampler(query, num_neg, generator, pos_items,
user_hist)`` and returns ``(log_pos_prob, neg_ids, log_neg_prob)``, the
proposal log probabilities consumed by the losses (identically 0 for the
uniform proposals here). Ids are 1-based; 0 is ``[PAD]``. Draws come from
the ``torch.Generator`` passed in, on the query's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class Sampler:
    """Base sampler. ``num_items`` includes the ``[PAD]`` slot (index 0)."""

    def __init__(self, num_items: int):
        self.num_items = num_items - 1  # real items live in [1, num_items - 1]

    def compute_item_p(self, query: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return torch.zeros(items.shape, dtype=torch.float32, device=items.device)

    def _out(self, query, neg_items, pos_items):
        neg_prob = self.compute_item_p(query, neg_items)
        pos_prob = None if pos_items is None else self.compute_item_p(query, pos_items)
        return pos_prob, neg_items, neg_prob

    def __call__(self, query: torch.Tensor, num_neg: int, generator: torch.Generator,
                 pos_items: Optional[torch.Tensor] = None,
                 user_hist: Optional[torch.Tensor] = None):
        raise NotImplementedError


class UniformSampler(Sampler):
    """Uniform ids over ``[1, num_items - 1]`` (``sampler.py:74``)."""

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None):
        neg = torch.randint(1, self.num_items + 1, (*query.shape[:-1], num_neg),
                            generator=generator, device=query.device)
        return self._out(query, neg, pos_items)


class MaskedUniformSampler(Sampler):
    """Uniform over the items not in the user's history (``sampler.py:87``):
    draw ``u`` among the ``n_free`` free ids, then shift it past the sorted
    history with a right-searchsorted. ``user_hist`` ``[B, H]`` holds
    distinct ids, 0 = pad."""

    def __call__(self, query, num_neg, generator, pos_items=None, user_hist=None):
        if user_hist is None:
            raise ValueError("MaskedUniformSampler requires user_hist")
        qshape = query.shape[:-1]
        bsz, hist_len = user_hist.shape
        n_draw = math.prod(qshape[1:]) * num_neg
        u = torch.rand((bsz, n_draw), generator=generator, device=query.device)
        hist = user_hist.to(torch.int64)
        nonzero = (hist != 0).sum(-1)                                   # [B]
        neg = torch.floor(u * (self.num_items - nonzero)[:, None]).to(torch.int64) + 1
        # drop the zero padding out of the sorted order
        offset = torch.clamp_min(torch.arange(hist_len, device=hist.device)[None, :]
                                 - (hist_len - nonzero)[:, None], 0)
        sorted_hist = torch.sort(hist, dim=-1).values - offset
        shift = torch.searchsorted(sorted_hist, neg, right=True)
        neg = neg + shift - (hist_len - nonzero)[:, None]
        return self._out(query, neg.reshape(*qshape, num_neg), pos_items)
