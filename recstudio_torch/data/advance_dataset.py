"""ALSDataset: one training row per user holding all of that user's items.

Counterpart of ``recstudio_tpu/data/advance_dataset.py``: the training
split is grouped per user, a row of ``data_index`` being ``(uid, start,
end)`` into ``_row_pool``, the split's interaction rows sorted by user;
a training batch is the users ``[B]`` with their items and ratings
``[B, W]`` (0 for padding, ``W = _pool_width()``, the most items of one
user). ``transpose()`` groups by item instead (one row an item holding
its users). Evaluation splits batch as a ``TripletDataset``'s.
``device_epoch_arrays`` stages the grouped split for device-resident
epochs, as ``UserDataset``'s does. Dataset-side negatives are not
ported and raise.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .dataset import TripletDataset, _int32_column, _refuse_dataset_negatives


def _group(col: np.ndarray, rows: np.ndarray):
    """``rows`` sorted stably by ``col[rows]`` and the ``(key, start, end)``
    runs of equal keys."""
    key = col[rows]
    order = np.argsort(key, kind="stable")
    seg = key[order]
    bounds = np.hstack([[0], np.flatnonzero(seg[1:] != seg[:-1]) + 1]).astype(np.int64)
    ends = np.hstack([bounds[1:], [len(seg)]]).astype(np.int64)
    return rows[order], np.stack([seg[bounds], bounds, ends], axis=1).astype(np.int64)


class ALSDataset(TripletDataset):

    def build(self, binarized_rating_thres=None, fmeval: bool = False, neg_count=None,
              sampler=None, shuffle: bool = True, split_mode: str = "user_entry",
              split_ratio=None, **kwargs):
        """``advance_dataset.py:17-32``: the splits of a ``TripletDataset``
        (not shuffled within users, as there), the training split grouped
        per user."""
        _refuse_dataset_negatives(neg_count, sampler)
        if split_ratio is None:
            split_ratio = [0.8, 0.1, 0.1]
        self.fmeval = fmeval
        self.split_mode = split_mode
        datasets = self._build(split_ratio, False, split_mode, False, binarized_rating_thres)
        train = datasets[0]
        train._row_pool, train.data_index = _group(
            np.asarray(train.inter_feat.get_col(train.fuid)), train.data_index)
        return datasets

    def transpose(self) -> "ALSDataset":
        """A view of the grouped split grouped by item instead of user
        (and back)."""
        out = copy.copy(self)
        out._row_pool, out.data_index = _group(
            np.asarray(self.inter_feat.get_col(self.fiid)), self._row_pool)
        out._transposed = not getattr(self, "_transposed", False)
        out.__dict__.pop("_target_width", None)
        return out

    def _fields_kv(self) -> Tuple[str, str]:
        if getattr(self, "_transposed", False):
            return self.fiid, self.fuid
        return self.fuid, self.fiid

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if getattr(self, "_row_pool", None) is None or getattr(self, "eval_mode", False):
            return super()._get_pos_batch(idx)
        rows = self.data_index[idx]
        key_field, val_field = self._fields_kv()
        batch = {key_field: rows[:, 0].astype(np.int32)}
        gather = rows[:, 1][:, None] + np.arange(self._pool_width())[None, :]
        valid = gather < rows[:, 2][:, None]
        pool_rows = self._row_pool[np.where(valid, gather, 0)]
        batch[val_field] = np.where(valid, self.inter_feat.get_col(val_field)[pool_rows],
                                    0).astype(np.int32)
        if self.frating is not None:
            rcol = self.inter_feat.get_col(self.frating)
            batch[self.frating] = np.where(valid, rcol[pool_rows], 0).astype(np.float32)
        return batch

    def _pool_width(self) -> int:
        """The most items of one row of the grouped split."""
        key = "_pool_width_t" if getattr(self, "_transposed", False) else "_pool_width_u"
        if not hasattr(self, key):
            setattr(self, key, int((self.data_index[:, 2] - self.data_index[:, 1]).max()))
        return getattr(self, key)

    def device_epoch_arrays(self) -> Tuple[Dict[str, np.ndarray], Callable]:
        """Compact staging of the grouped split for device-resident epochs:
        ``data_index`` and the pooled value (and rating) column, padded with
        ``_pool_width()`` zeros so every row's read stays in bounds;
        ``batch_fn(arrays, sel)`` returns ``_get_pos_batch(sel)``'s batch
        as tensors, gathered on the device."""
        key_field, val_field = self._fields_kv()
        frating = self.frating
        width = self._pool_width()
        pad = np.zeros(width, np.int32)
        compact = {"_rows": _int32_column("data_index", self.data_index),
                   "_val": np.concatenate([_int32_column(
                       val_field, self.inter_feat.get_col(val_field)[self._row_pool]), pad])}
        if frating is not None:
            rcol = self.inter_feat.get_col(frating)[self._row_pool].astype(np.float32)
            compact["_rating"] = np.concatenate([rcol, np.zeros(width, np.float32)])

        def batch_fn(arrays: Dict[str, torch.Tensor], sel: torch.Tensor) -> Dict[str, torch.Tensor]:
            rows = arrays["_rows"][sel].long()
            pos = rows[:, 1, None] + torch.arange(width, device=sel.device)[None, :]
            valid = pos < rows[:, 2, None]
            batch = {key_field: rows[:, 0].int(),
                     val_field: torch.where(valid, arrays["_val"][pos], 0)}
            if frating is not None:
                batch[frating] = torch.where(valid, arrays["_rating"][pos], 0.0)
            return batch

        return compact, batch_fn
