"""Dataset layer: host-side ETL -> fixed-shape numpy batches.

The subset of ``recstudio_tpu/data/dataset.py`` that the ported models
need, in numpy and plain Python (no pandas):

- files are parsed as delimited text, vectorised over the file's bytes
  (``_read_table``); token columns are interned in order
  of first appearance in the file as read, as the JAX package's native CSV
  path interns them (``recstudio_tpu/native/__init__.py:fast_read_csv``);
- the rating threshold (``low_rating_thres``) and the duplicate-pair drop
  are applied, then float preprocessing; ratings are binarized at
  ``binarized_rating_thres`` when a split is built. A list-valued
  ``rating_field`` (multitask) gives several rating columns, carried by
  every split and batch; no rating threshold applies to them, and a
  binarization applies to each;
- ids are factorized per shared id space by first appearance over the
  columns in file order (inter, user, item), with ``[PAD]`` = 0
  (``dataset.py:388-508``);
- rows are sorted by (user, time) with a stable sort (``dataset.py:601``)
  and split by ratio (``split_ratio`` a list of floats), by count (a list
  of ints) or leave-one-out (an int), per user (``user_entry``), over all
  rows (``entry``) or by whole users (``user``), shuffled from numpy's
  global stream as the JAX package shuffles;
- split views expose ``data_index``, ``user_hist``, a ``train_loader``
  and an ``eval_loader`` of fixed-shape batches that carry ``_size``;
  with ``fmeval`` every split is a flat array of interaction rows (the
  rankers' pointwise evaluation), and a dataset with no user or item id
  (the criteo layout) has no ``user_hist``;
- ``UserDataset`` gives one row per user: the training items as the
  history window, the split's items as the target window;
  ``advance_dataset.ALSDataset`` one training row per user with all of
  that user's training items;
- ``item_freq`` counts the items of a split (the popularity samplers'
  weights);
- ``SeqDataset.device_epoch_arrays`` and ``UserDataset.device_epoch_arrays``
  stage a split's raw columns, and the user and item feature columns in
  use, for a device-resident epoch, with a ``batch_fn`` that gathers the
  windows of a batch and their features on the device.

K-core filtering, sequence and network features and dataset-side
negatives are not ported yet; a build that asks for dataset-side negatives
(``neg_count`` or ``sampler``) raises.
"""
from __future__ import annotations

import copy
import os
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import deep_update, get_dataset_default_config
from .fields import PAD_TOKEN, parse_field
from .frame import Frame

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bundled demo data of the JAX package, read by path (data, not code)
_DEMO_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "recstudio_tpu")


def _apply_scaler(col: np.ndarray, spec: str) -> np.ndarray:
    """Float preprocessing, as ``recstudio_tpu/data/dataset.py:_apply_scaler``."""
    x = col.astype(np.float64)
    name = spec.split("(")[0]
    if name == "StandardScaler":
        mu, sd = x.mean(), x.std()
        return (x - mu) / (sd if sd > 0 else 1.0)
    if name == "MinMaxScaler":
        lo, hi = x.min(), x.max()
        rng = hi - lo
        return (x - lo) / (rng if rng > 0 else 1.0)
    if name == "MaxAbsScaler":
        m = np.abs(x).max()
        return x / (m if m > 0 else 1.0)
    if name == "RobustScaler":
        med = np.median(x)
        q1, q3 = np.percentile(x, 25), np.percentile(x, 75)
        iqr = q3 - q1
        return (x - med) / (iqr if iqr > 0 else 1.0)
    if name == "LogTransformer":
        return np.log1p(x)
    if name == "Binarizer":
        return (x > 0).astype(np.float64)
    raise ValueError(f"unsupported float preprocessor: {spec}")


def _first_appearance(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(uniques in order of first appearance, int64 codes) — ``pd.factorize``."""
    if len(values) == 0:
        return values[:0], np.zeros(0, np.int64)
    uniq, first, inv = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], rank[inv.reshape(-1)]


class _Tokens:
    """An interned token column: ``pool[codes]`` are the row values."""

    def __init__(self, values: np.ndarray):
        self.pool, self.codes = _first_appearance(values)

    def take(self, keep: np.ndarray) -> "_Tokens":
        out = copy.copy(self)
        out.codes = self.codes[keep]
        return out

    def compact(self) -> "_Tokens":
        """Drop pool entries no row uses, keeping the pool's order."""
        used = np.zeros(len(self.pool), bool)
        used[self.codes] = True
        out = copy.copy(self)
        if not used.all():
            new_pos = np.cumsum(used) - 1
            out.pool, out.codes = self.pool[used], new_pos[self.codes]
        return out


# the line boundaries of ``str.splitlines`` besides "\n" ("\r" and "\r\n"
# already read as "\n" in text mode)
_LINE_BREAKS = "\r\x0b\x0c\x1c\x1d\x1e\x85\u2028\u2029"


def _field_bytes(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The fields ``buf[starts[i]:ends[i]]`` as a fixed-width bytes array,
    built one byte position at a time (no ``[rows, width]`` index array)."""
    lengths = ends - starts
    width = max(int(lengths.max(initial=0)), 1)
    mat = np.zeros((len(starts), width), np.uint8)
    last = max(len(buf) - 1, 0)
    for k in range(width):
        live = lengths > k
        mat[:, k] = np.where(live, buf[np.minimum(starts + k, last)], 0)
    return mat.view(f"S{width}").reshape(-1)


def _read_table(path: str, header, sep: str, field_decls: List[str],
                encoding: str) -> Tuple[Dict[str, object], Dict[str, str]]:
    """Parse a delimited file into ``{name: _Tokens | float64 array}``.

    The rows are the file's non-empty lines (``str.splitlines``) after
    ``header + 1`` skipped lines, split at ``sep``. The parse runs in numpy
    over the file's UTF-8 bytes: the positions of the line breaks and the
    separators give every field's bounds, and a row with another number of
    fields raises with its row number. Token columns keep their text, in
    order of first appearance in the file; float columns parse as numpy's
    ``astype(np.float64)`` of the text."""
    specs = [parse_field(d) for d in field_decls]
    if any(s.is_seq for s in specs):
        raise NotImplementedError("sequence fields are not ported yet")
    with open(path, "r", encoding=encoding) as f:
        text = f.read()
    if any(c in text for c in _LINE_BREAKS):
        text = text.translate({ord(c): "\n" for c in _LINE_BREAKS})
    if len(sep) != 1 or ord(sep) > 127:
        # one byte stands for a longer separator, matched as str.split does
        mark = next(c for c in map(chr, range(1, 32)) if c != "\n" and c not in text)
        text = text.replace(sep, mark)
        sep = mark
    buf = np.frombuffer(text.encode("utf-8"), np.uint8)
    breaks = np.flatnonzero(buf == 10)
    starts = np.r_[0, breaks + 1]
    ends = np.r_[breaks, len(buf)]
    skip = 0 if header is None else int(header) + 1
    starts, ends = starts[skip:], ends[skip:]
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    seps = np.flatnonzero(buf == ord(sep))
    nfields = np.searchsorted(seps, ends) - np.searchsorted(seps, starts) + 1
    bad = np.flatnonzero(nfields != len(specs))
    if len(bad):
        raise ValueError(f"{path}: row {int(bad[0]) + skip} has {int(nfields[bad[0]])} "
                         f"fields, expected {len(specs)}")
    # every row holds len(specs) - 1 separators, in order
    seps = seps[np.searchsorted(seps, starts[0]):] if len(starts) else seps[:0]
    seps = seps.reshape(len(starts), len(specs) - 1)
    out: Dict[str, object] = {}
    for j, s in enumerate(specs):
        lo = starts if j == 0 else seps[:, j - 1] + 1
        hi = ends if j == len(specs) - 1 else seps[:, j]
        col = _field_bytes(buf, lo, hi)
        if s.dtype == "float":
            out[s.name] = col.astype(np.float64)
        else:
            tokens = _Tokens(col)
            tokens.pool = np.asarray([t.decode("utf-8") for t in tokens.pool], dtype=str)
            out[s.name] = tokens
    return out, {s.name: s.dtype for s in specs}


def _refuse_dataset_negatives(neg_count, sampler) -> None:
    """Dataset-side negatives (``neg_count`` rating-0 rows appended to each
    batch, ``dataset.py:564-579``) are not ported: raise rather than build
    batches without them."""
    if neg_count or sampler:
        raise NotImplementedError("dataset-side negatives (data.neg_count, data.sampler) "
                                  "are not ported yet")


class TripletDataset:
    r"""Core interaction dataset: ``<user, item, rating, [time]>`` triplets.

    Loading pipeline as ``recstudio_tpu/data/dataset.py:101-133``:
    load -> filter -> float preprocess -> map ids -> per-entity feature
    tables; then :meth:`build` splits into train/val/test views.
    """

    def __init__(self, name: str = "ml-100k", config: Union[None, Dict] = None,
                 data_dir: Optional[str] = None):
        self.name = name
        conf = get_dataset_default_config(name)
        if isinstance(config, dict):
            conf = deep_update(conf, config)
        elif config is not None:
            raise TypeError("config must be a dict (the port reads no YAML)")
        self.config = conf
        self.data_dir = data_dir
        self._init_common_field()
        self._load_all_data()
        self._filter()
        self._float_preprocess()
        self._map_all_ids()
        self._prepare_user_item_feat()
        self.eval_mode = False
        self.fmeval = False
        self.data_index: Optional[np.ndarray] = None
        self._use_field = {f for f in (self.fuid, self.fiid, *self._rating_fields())
                           if f is not None}

    # ------------------------------------------------------------------
    def _init_common_field(self):
        self.field2type: Dict[str, str] = {}
        self.field2tokens: Dict[str, np.ndarray] = {}
        c = self.config
        self.fuid = parse_field(c["user_id_field"]).name if c.get("user_id_field") else None
        self.fiid = parse_field(c["item_id_field"]).name if c.get("item_id_field") else None
        self.ftime = parse_field(c["time_field"]).name if c.get("time_field") else None
        rf = c.get("rating_field")
        if isinstance(rf, list):            # multitask: one label a task (dataset.py:154-160)
            self.frating = [parse_field(r).name for r in rf]
        else:
            self.frating = parse_field(rf).name if rf else None

    def _rating_fields(self) -> List[str]:
        """The rating fields as a list (``dataset.py:866-867``)."""
        return self.frating if isinstance(self.frating, list) else [self.frating]

    @property
    def drop_dup(self) -> bool:
        return bool(self.config.get("drop_dup", True))

    @property
    def use_field(self):
        return self._use_field

    @use_field.setter
    def use_field(self, fields):
        self._use_field = {f for f in fields if f is not None}

    def _resolve_dir(self) -> str:
        if self.data_dir:
            return self.data_dir
        url = self.config.get("url") or ""
        if url.startswith("recstudio:"):
            return os.path.join(_DEMO_ROOT, url.split(":", 1)[1])
        if url and os.path.isdir(url):
            return url
        raise FileNotFoundError(
            f"cannot locate data files for dataset '{self.name}' (url={url!r}); "
            "pass data_dir= or set `url` to a directory")

    def _load_all_data(self):
        c = self.config
        d = self._resolve_dir()
        sep = c.get("field_separator", "\t")
        enc = c.get("encoding_method") or "utf-8"
        if c.get("network_feat_name"):
            raise NotImplementedError("network features are not ported yet")
        self.inter_feat, types = _read_table(
            os.path.join(d, c["inter_feat_name"]), c.get("inter_feat_header"), sep,
            c["inter_feat_field"], enc)
        self.field2type.update(types)
        self.user_feat = self.item_feat = None
        for kind in ("user", "item"):
            names = c.get(f"{kind}_feat_name")
            if not names:
                continue
            if len(names) > 1:
                raise NotImplementedError("merging several feature files is not ported yet")
            header = (c.get(f"{kind}_feat_header") or [0])
            header = header[0] if isinstance(header, list) else header
            feat, types = _read_table(os.path.join(d, names[0]), header, sep,
                                      c[f"{kind}_feat_field"][0], enc)
            self.field2type.update(types)
            setattr(self, f"{kind}_feat", feat)

    def _column(self, field: str) -> np.ndarray:
        col = self.inter_feat[field]
        return col.codes if isinstance(col, _Tokens) else col

    def _keep_inter_rows(self, keep: np.ndarray):
        self.inter_feat = {k: (v.take(keep) if isinstance(v, _Tokens) else v[keep])
                           for k, v in self.inter_feat.items()}

    def _first_pair(self) -> np.ndarray:
        """True where a (user, item) pair occurs for the first time."""
        u = self._column(self.fuid).astype(np.int64)
        i = self._column(self.fiid).astype(np.int64)
        keep = np.zeros(len(u), bool)
        _, first = np.unique(u * (int(i.max(initial=0)) + 1) + i, return_index=True)
        keep[first] = True
        return keep

    def _filter(self):
        thres = self.config.get("low_rating_thres")
        # no rating threshold on several ratings (dataset.py:338)
        if thres is not None and self.frating is not None and not isinstance(self.frating, list):
            self._keep_inter_rows(self.inter_feat[self.frating] >= thres)
        if self.drop_dup and self.fuid is not None and self.fiid is not None:
            self._keep_inter_rows(self._first_pair())
        if (self.config.get("min_user_inter") or 0) > 0 or (self.config.get("min_item_inter") or 0) > 0:
            raise NotImplementedError("k-core filtering is not ported yet")

    def _float_preprocess(self):
        for decl in self.config.get("float_field_preprocess") or []:
            field, proc = decl.split(":", 1)
            for feat in self._feat_list():
                if field in feat:
                    feat[field] = _apply_scaler(feat[field], proc)

    def _feat_list(self) -> List[Dict[str, object]]:
        return [f for f in (self.inter_feat, self.user_feat, self.item_feat) if f is not None]

    def _map_all_ids(self):
        """Factorize every token field over the columns that hold it, in the
        order inter, user, item; ``[PAD]`` takes id 0."""
        token_fields = [f for f, t in self.field2type.items() if t.startswith("token")]
        for field in token_fields:
            columns = [feat for feat in self._feat_list() if field in feat]
            parts = [feat[field].compact() for feat in columns]
            uniques, pool2global = _first_appearance(
                np.concatenate([p.pool for p in parts]))
            self.field2tokens[field] = np.insert(uniques.astype(object), 0, PAD_TOKEN)
            off = 0
            for feat, p in zip(columns, parts):
                feat[field] = pool2global[off + p.codes] + 1
                off += len(p.pool)

    def _prepare_user_item_feat(self):
        """Reindex the user/item tables by id so row i = entity id i."""
        for kind, key in (("user", self.fuid), ("item", self.fiid)):
            feat = getattr(self, f"{kind}_feat")
            if key is None:                 # no such id: no entity table
                setattr(self, f"{kind}_feat", None)
                continue
            n = self.num_values(key)
            if feat is None:
                cols = {key: np.arange(n)}
            else:
                ids = feat[key]
                cols = {}
                for col, values in feat.items():
                    out = np.zeros(n, values.dtype)
                    out[ids] = values
                    cols[col] = out
                cols[key] = np.arange(n)
            setattr(self, f"{kind}_feat", Frame.from_columns(cols, self.field2type))

    # ------------------------------------------------------------------
    def num_values(self, field: str) -> int:
        if field in self.field2tokens:
            return len(self.field2tokens[field])
        return 1

    @property
    def num_users(self) -> int:
        return self.num_values(self.fuid)

    @property
    def num_items(self) -> int:
        return self.num_values(self.fiid)

    @property
    def num_inters(self) -> int:
        if isinstance(self.inter_feat, dict):
            return len(self._column(self.fiid or self.frating))
        return len(self.inter_feat)

    def __len__(self) -> int:
        return len(self.data_index) if self.data_index is not None else self.num_inters

    # ------------------------------------------------------------------
    # build / split
    # ------------------------------------------------------------------
    def build(self, split_ratio=None, shuffle: bool = True, split_mode: str = "user_entry",
              fmeval: bool = False, binarized_rating_thres=None, neg_count=None, sampler=None,
              **kwargs):
        """Split into train/val/test views (``dataset.py:562-570``):
        ``split_ratio`` a list of floats (ratio split), a list of ints (count
        split) or an int (leave-one-out); ``split_mode`` ``user_entry``
        (per user), ``entry`` (over all rows) or ``user`` (whole users).
        Dataset-side negatives (a truthy ``neg_count`` or ``sampler``) are
        not ported and raise."""
        _refuse_dataset_negatives(neg_count, sampler)
        if split_ratio is None:
            split_ratio = [0.8, 0.1, 0.1]
        self.fmeval = fmeval
        return self._build(split_ratio, shuffle, split_mode, False, binarized_rating_thres)

    def _build(self, ratio_or_num, shuffle: bool, split_mode: str, rep: bool,
               binarized_rating_thres=None):
        """``dataset.py:586-656``. Every draw comes from numpy's global
        stream, in the JAX package's order, so one seed gives the same rows.
        A dataset with no user or item id keeps every row (no duplicate
        pairs to find) and gets no ``user_hist``."""
        if binarized_rating_thres is not None:
            self._binarize_rating(binarized_rating_thres)
        has_ids = self.fuid is not None and self.fiid is not None
        if not hasattr(self, "first_item_idx"):
            self.first_item_idx = self._first_pair() if has_ids \
                else np.ones(self.num_inters, bool)
        if self.drop_dup and not rep and has_ids:
            keep = self.first_item_idx
            self._keep_inter_rows(keep)
            self.first_item_idx = self.first_item_idx[keep]

        if split_mode in ("user_entry", "user"):
            if self.fuid is None:
                raise ValueError("split_mode user/user_entry requires a user id field")
            # stable sort by (user, time): the order of pandas' mergesort
            keys = [self.inter_feat[self.fuid]]
            if self.ftime and self.ftime in self.inter_feat:
                keys.insert(0, self.inter_feat[self.ftime])
            self._take_rows(np.lexsort(keys))

        count_split = isinstance(ratio_or_num, list) and len(ratio_or_num) \
            and isinstance(ratio_or_num[0], int)
        if split_mode in ("user_entry", "user"):
            # users in order of first appearance (ascending after the sort)
            counts, user_ids = self._user_counts()
            if split_mode == "user_entry" and shuffle:
                starts = np.r_[0, counts.cumsum()[:-1]]
                self._take_rows(np.concatenate([np.random.permutation(c) + s
                                                for s, c in zip(starts, counts)]))
        elif split_mode == "entry":
            if count_split and self.fuid is not None:
                user_ids, counts = np.unique(self.inter_feat[self.fuid], return_counts=True)
            else:
                if shuffle:         # DataFrame.sample(frac=1) draws this permutation
                    self._take_rows(np.random.permutation(self.num_inters))
                counts, user_ids = np.array([self.num_inters]), None
        else:
            raise ValueError(f"unknown split_mode {split_mode}")
        if user_ids is not None and len(counts) < 2:
            user_ids = None

        if isinstance(ratio_or_num, int):
            splits = self._split_by_leave_one_out(ratio_or_num, counts, rep)
        elif isinstance(ratio_or_num, list) and len(ratio_or_num) \
                and isinstance(ratio_or_num[0], float):
            splits = self._split_by_ratio(ratio_or_num, counts, split_mode == "user")
        else:
            splits = self._split_by_num(ratio_or_num, counts)
        self.inter_feat = Frame.from_columns(self.inter_feat, self.field2type)
        datasets = [self._copy(idx) for idx in self._get_data_idx((splits, user_ids))]
        if not has_ids:
            return datasets
        # user history: train hist for train/val; train+val hist for test
        user_hist, user_count = datasets[0].get_hist(True)
        for d in datasets[:2]:
            d.user_hist, d.user_count = user_hist, user_count
        if len(datasets) > 2:
            uh, uc = datasets[1].get_hist(True)
            merged = np.zeros((user_hist.shape[0], user_hist.shape[1] + uh.shape[1]),
                              dtype=user_hist.dtype)
            merged[:, :user_hist.shape[1]] = user_hist
            merged[:, user_hist.shape[1]:] = uh
            merged = -np.sort(-merged, axis=-1)
            maxlen = int((merged > 0).sum(axis=1).max()) if merged.size else 1
            datasets[-1].user_hist = merged[:, :max(maxlen, 1)]
            datasets[-1].user_count = user_count + uc
        return datasets

    def _binarize_rating(self, thres: float) -> None:
        """``dataset.py:581-584``: a rating below ``thres`` becomes 0.0,
        every other rating (NaN too) 1.0; each rating column alike when
        there are several (the JAX package's frame indexing raises there)."""
        for r in self._rating_fields():
            self.inter_feat[r] = np.where(self.inter_feat[r] < thres, 0.0, 1.0)

    def _take_rows(self, order: np.ndarray) -> None:
        self._keep_inter_rows(order)
        self.first_item_idx = self.first_item_idx[order]

    def _user_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows per user, user ids) over consecutive runs of the user column
        (``groupby(sort=False).count()`` on rows sorted by user)."""
        uids = self.inter_feat[self.fuid]
        bounds = np.flatnonzero(np.r_[True, uids[1:] != uids[:-1]])
        return np.diff(np.r_[bounds, len(uids)]), uids[bounds]

    def _split_by_ratio(self, ratio: List[float], counts: np.ndarray,
                        user_mode: bool) -> np.ndarray:
        """``dataset.py:658-679``: per user (or, in ``user`` mode, whole users
        drawn by one permutation) the rows cut by ``ratio``; rows
        ``[start, train_end, val_end, end]``."""
        m = len(counts)
        if not user_mode:
            splits = np.outer(counts, ratio).astype(np.int32)
            splits[:, 0] = counts - splits[:, 1:].sum(axis=1)
            for i in range(1, len(ratio)):
                idx = (splits[:, -i] == 0) & (splits[:, 0] > 1)
                splits[idx, -i] += 1
                splits[idx, 0] -= 1
        else:
            idx = np.random.permutation(m)
            sp_ = (m * np.asarray(ratio)).astype(np.int32)
            sp_[0] = m - sp_[1:].sum()
            splits = np.zeros((m, len(ratio)), dtype=np.int32)
            for part_i, p in enumerate(np.split(idx, sp_.cumsum()[:-1])):
                splits[p, part_i] = counts[p]
        splits = np.hstack([np.zeros((m, 1), dtype=np.int64), np.cumsum(splits, axis=1)])
        return np.r_[0, counts.cumsum()[:-1]].reshape(-1, 1) + splits

    def _split_by_num(self, nums: List[int], counts: np.ndarray) -> np.ndarray:
        """``dataset.py:681-686``: one row of cumulative counts over all rows."""
        splits = np.hstack([0, nums]).cumsum().reshape(1, -1)
        if splits[0][-1] != counts.sum():
            raise ValueError(f"split nums {nums} must sum to {counts.sum()}")
        return splits

    def _split_by_leave_one_out(self, leave_one_num: int, counts: np.ndarray,
                                rep: bool = True) -> np.ndarray:
        """``dataset.py:688-713``: per-user [start, train_end, val_end, end]."""
        m = len(counts)
        cum = counts.cumsum()[:-1]
        if rep:
            splits = np.ones((m, leave_one_num + 1), dtype=np.int64)
            splits[:, 0] = counts - leave_one_num
            for j in range(leave_one_num):
                idx = splits[:, 0] < 1
                splits[idx, 0] += 1
                splits[idx, j] -= 1  # same correction order as the reference
            splits = np.hstack([np.zeros((m, 1), dtype=np.int64), np.cumsum(splits, axis=1)])
        else:
            rows = []
            for seg in np.split(self.first_item_idx, cum):
                idx = seg.nonzero()[0]
                if len(idx) > 2:
                    rows.append([0, idx[-2], idx[-1], len(seg)])
                elif len(idx) == 2:
                    rows.append([0, idx[-1], idx[-1], len(seg)])
                else:
                    rows.append([0, len(seg), len(seg), len(seg)])
            splits = np.asarray(rows, dtype=np.int64)
        return np.hstack([[0], cum]).reshape(-1, 1) + splits

    def _get_data_idx(self, splits):
        """``dataset.py:715-740``: train view -> flat interaction indices;
        eval views -> ``(uid, start, end)`` rows, one per user with rows in
        the split, or, with no per-user split, one per run of a user's rows.
        With ``fmeval`` every view is flat."""
        splits, uids = splits
        if self.fmeval:
            return [np.concatenate([np.arange(s, e) for s, e in zip(splits[:, i - 1], splits[:, i])]
                                   + [np.zeros(0, np.int64)]).astype(np.int64)
                    for i in range(1, splits.shape[1])]
        out = [np.concatenate([np.arange(s, e) for s, e in zip(splits[:, 0], splits[:, 1])]
                              + [np.zeros(0, np.int64)]).astype(np.int64)]
        for i in range(2, splits.shape[1]):
            if uids is not None:
                k = min(len(uids), len(splits))      # zip(uids, pairs)
                s, e = splits[:k, i - 1], splits[:k, i]
                keep = e > s
                out.append(np.stack([uids[:k][keep], s[keep], e[keep]], axis=1)
                           .astype(np.int64).reshape(-1, 3))
                continue
            s, e = splits[0, i - 1], splits[0, i]
            seg = self.inter_feat.get_col(self.fuid)[s:e]
            bounds = np.r_[0, np.flatnonzero(seg[1:] != seg[:-1]) + 1]
            ends = np.r_[bounds[1:], len(seg)]
            out.append(np.stack([seg[bounds], bounds + s, ends + s], axis=1).astype(np.int64))
        return out

    def _copy(self, idx: np.ndarray):
        d = copy.copy(self)
        d.data_index = idx
        return d

    # ------------------------------------------------------------------
    # histories
    # ------------------------------------------------------------------
    @property
    def inter_feat_subset(self) -> np.ndarray:
        if self.data_index is not None and self.data_index.ndim > 1:
            return np.concatenate([np.arange(s, e)
                                   for s, e in zip(self.data_index[:, 1], self.data_index[:, 2])])
        return self.data_index

    def get_hist(self, is_user: bool = True):
        """Padded per-entity history matrix + counts over this split's rows."""
        sub = self.inter_feat_subset
        users = self.inter_feat.get_col(self.fuid)[sub]
        items = self.inter_feat.get_col(self.fiid)[sub]
        key, val = (users, items) if is_user else (items, users)
        n = self.num_users if is_user else self.num_items
        order = np.argsort(key, kind="stable")
        key_s, val_s = key[order], val[order]
        counts = np.bincount(key_s, minlength=n)
        width = max(int(counts.max()) if counts.size else 1, 1)
        hist = np.zeros((n, width), dtype=np.int32)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        pos = np.arange(len(key_s)) - offs[key_s]
        hist[key_s, pos] = val_s
        return hist, counts.astype(np.int64)

    @property
    def item_freq(self) -> np.ndarray:
        """Each item's count among this split's rows, ``[num_items]``
        (``dataset.py:791-795``), read by the popularity samplers."""
        items = self.inter_feat.get_col(self.fiid)[self.inter_feat_subset]
        return np.bincount(items, minlength=self.num_items).astype(np.int64)

    def get_graph(self, idx=0, form: str = "coo", value_fields=None, bidirectional: bool = False,
                  row_offset: int = 0, col_offset: int = 0, shape=None) -> torch.Tensor:
        """This split's user-item interaction graph (``dataset.py:814-846``)
        as a coalesced sparse COO tensor (``form="coo"``), a sparse CSR one
        (``"csr"``) or a dense one (``"dense"``), float32 on the CPU: one 1
        a (user, item) row, duplicates summed. ``bidirectional`` adds the
        transposed pairs; the offsets shift rows and columns, and ``shape``
        defaults to ``(num_users + row_offset, num_items + col_offset)``.
        Network graphs (``idx >= 1``) and ``value_fields`` are not ported
        and raise."""
        if value_fields is not None:
            raise NotImplementedError("get_graph's value_fields is not ported (every value is 1)")
        if form not in ("coo", "csr", "dense"):
            raise ValueError(f"get_graph form {form!r}: coo, csr or dense")
        idx = [idx] if isinstance(idx, int) else list(idx)
        if any(g != 0 for g in idx):
            raise NotImplementedError("network graphs (get_graph idx >= 1) are not ported: the "
                                      "port loads no network features")
        sub = self.inter_feat_subset
        rows = np.asarray(self.inter_feat.get_col(self.fuid))[sub].astype(np.int64)
        cols = np.asarray(self.inter_feat.get_col(self.fiid))[sub].astype(np.int64)
        rows, cols = np.tile(rows, len(idx)) + row_offset, np.tile(cols, len(idx)) + col_offset
        if bidirectional:
            rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
        if shape is None:
            shape = (self.num_users + row_offset, self.num_items + col_offset)
        mat = torch.sparse_coo_tensor(torch.from_numpy(np.stack([rows, cols])),
                                      torch.ones(len(rows), dtype=torch.float32),
                                      tuple(int(s) for s in shape),
                                      check_invariants=False).coalesce()
        if form == "csr":
            with warnings.catch_warnings():          # sparse CSR's "beta" notice
                warnings.simplefilter("ignore", UserWarning)
                return mat.to_sparse_csr()
        return mat.to_dense() if form == "dense" else mat

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------
    def _fields_of(self, frame: Frame) -> List[str]:
        return [f for f in frame.fields if f in self._use_field]

    def _gather_entity_feats(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Join the user and item features of the ids already in ``batch``
        (``dataset.py:854-865``)."""
        for frame, key in ((self.user_feat, self.fuid), (self.item_feat, self.fiid)):
            if frame is None or key not in batch:
                continue
            for f in self._fields_of(frame):
                if f != key and f not in batch:
                    batch[f] = frame.get_col(f)[batch[key]]
        return batch

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self.data_index.ndim == 1:
            rows = self.data_index[idx]
            batch = {f: self.inter_feat.get_col(f)[rows] for f in self._fields_of(self.inter_feat)}
            return self._gather_entity_feats(batch)
        rows = self.data_index[idx]
        batch = {self.fuid: rows[:, 0].astype(np.int32)}
        for f in self._fields_of(self.user_feat):
            if f != self.fuid:
                batch[f] = self.user_feat.get_col(f)[rows[:, 0]]
        starts, ends = rows[:, 1], rows[:, 2]
        gather = starts[:, None] + np.arange(self._eval_target_width())[None, :]
        valid = gather < ends[:, None]
        gather = np.where(valid, gather, 0)
        batch[self.fiid] = np.where(valid, self.inter_feat.get_col(self.fiid)[gather], 0).astype(np.int32)
        for r in self._rating_fields():
            batch[r] = np.where(valid, self.inter_feat.get_col(r)[gather], 0).astype(np.float32)
        return batch

    def _stage_entity_feats(self, compact: Dict[str, np.ndarray]
                            ) -> List[Tuple[str, str, bool]]:
        """Stage the user and item feature columns in use for a device epoch
        (``dataset.py:1114-1121``, ``:1297-1304``): ``compact["_user_" + f]``
        and ``compact["_item_" + f]`` as int32 words (``_int32_column``,
        which raises on a column that would not survive). Returns ``(kind,
        field, is_float)`` of each."""
        staged = []
        for kind, frame, key in (("user", self.user_feat, self.fuid),
                                 ("item", self.item_feat, self.fiid)):
            if frame is None:
                continue
            for f in self._fields_of(frame):
                if f != key:
                    col = frame.get_col(f)
                    compact[f"_{kind}_{f}"] = _int32_column(f, col)
                    staged.append((kind, f, bool(np.issubdtype(col.dtype, np.floating))))
        return staged

    def _eval_target_width(self) -> int:
        """Targets per row of an eval batch, ``[B, T]`` (``dataset.py:895``):
        the split's most rows for one user."""
        if not hasattr(self, "_target_width"):
            self._target_width = int((self.data_index[:, 2] - self.data_index[:, 1]).max())
        return self._target_width

    def train_loader(self, batch_size: int, shuffle: bool = True,
                     rng: Optional[np.random.Generator] = None) -> "_BatchIterator":
        """Fixed-shape training batches; the tail batch wraps to the epoch's
        head, so every batch has ``batch_size`` rows."""
        self.eval_mode = False
        return _BatchIterator(self, batch_size, shuffle, rng or np.random.default_rng())

    def eval_loader(self, batch_size: int) -> "_BatchIterator":
        """Fixed-shape evaluation batches in data order; the tail batch is
        padded with row 0 and ``_size`` holds its true row count."""
        self.eval_mode = True
        return _BatchIterator(self, batch_size, False, None)

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self._get_pos_batch(idx)
        if self.eval_mode and self.fuid is not None and not self.fmeval \
                and "user_hist" not in batch:
            batch["user_hist"] = self.user_hist[batch[self.fuid]].astype(np.int32)
        return batch


class _BatchIterator:
    """Fixed-shape batch iterator over a split view (``dataset.py:974-1016``).

    Training: the tail batch is filled by wrapping to the epoch's head (all
    batches have exactly ``batch_size`` rows). Evaluation: the tail is
    padded with row 0 and ``_size`` records the true row count.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 rng: Optional[np.random.Generator]):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng

    def __len__(self):
        return -(-len(self.dataset.data_index) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset.data_index)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        eval_mode = self.dataset.eval_mode
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            true_size = len(idx)
            if true_size < bs:
                pad = np.zeros(bs - true_size, dtype=idx.dtype) if eval_mode \
                    else order[:bs - true_size]
                idx = np.concatenate([idx, pad])
            batch = self.dataset._make_batch(idx)
            batch["_size"] = np.asarray(true_size if eval_mode else bs, dtype=np.int32)
            yield batch


def _int32_column(name: str, col: np.ndarray) -> np.ndarray:
    """``col`` as int32 words for device staging: integers must fit int32,
    floats must survive float32 (their bits are stored). Raises instead of
    truncating (the JAX stager casts silently, ``dataset.py:1288-1291``)."""
    if np.issubdtype(col.dtype, np.floating):
        c32 = col.astype(np.float32)
        if not np.array_equal(c32.astype(col.dtype), col, equal_nan=True):
            raise ValueError(f"column {name!r} ({col.dtype}) is not exact in float32")
        return c32.view(np.int32)
    if np.issubdtype(col.dtype, np.integer):
        if col.size and (int(col.min()) < -2 ** 31 or int(col.max()) >= 2 ** 31):
            raise ValueError(f"column {name!r} has values outside int32")
        return col.astype(np.int32)
    raise TypeError(f"column {name!r} has dtype {col.dtype}, which cannot be staged")


def _from_words(words: torch.Tensor, is_float: bool) -> torch.Tensor:
    """The staged int32 words of a column back in its dtype."""
    return words.view(torch.float32) if is_float else words


def _masked(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``valid``, else 0 of ``x``'s dtype."""
    return torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))


class UserDataset(TripletDataset):
    """One row per user (``dataset.py:1024-1163``): the ``in_`` fields are
    the user's training items (the history window), the targets the items
    of the split (the target window), both zero-padded to the split's
    widest. A row of ``data_index`` is ``[uid, train start, train end, uid,
    split start, split end]``. At evaluation ``user_hist`` is the history
    window (``dataset.py:1090-1096``), not the split's ``user_hist`` table.
    Dataset-side negatives are not ported yet."""

    def _init_common_field(self):
        super()._init_common_field()
        if self.fuid is None:
            raise ValueError("UserDataset requires a user id field")

    def build(self, binarized_rating_thres=None, fmeval: bool = False, neg_count=None,
              sampler=None, shuffle: bool = True, split_mode: str = "user_entry",
              split_ratio=None, **kwargs):
        _refuse_dataset_negatives(neg_count, sampler)
        if split_ratio is None:
            split_ratio = [0.8, 0.1, 0.1]
        self.split_mode = split_mode
        self.fmeval = fmeval
        return self._build(split_ratio, shuffle, split_mode, False, binarized_rating_thres)

    def _get_data_idx(self, splits):
        """``dataset.py:1039-1049``: per user, the training window then the
        split's window; ``user_entry`` drops users whose validation window
        is empty. A split with no per-user rows (``entry`` mode) has no
        history to give, and raises (the JAX ``np.stack`` fails there)."""
        splits, uids = splits
        if uids is None or len(uids) != len(splits):
            raise ValueError("UserDataset needs one split row per user "
                             "(split_mode 'user_entry' or 'user')")
        if self.split_mode == "user_entry":
            keep = splits[:, 1] < splits[:, 2]
            splits, uids = splits[keep], uids[keep]
        first = np.stack([uids, splits[:, 0], splits[:, 1]], axis=1)
        return [np.concatenate([first, np.stack([uids, splits[:, i - 1], splits[:, i]], axis=1)],
                               axis=1).astype(np.int64)
                for i in range(1, splits.shape[1])]

    def _in_width(self) -> int:
        """The widest history window of the split."""
        if not hasattr(self, "_in_width_"):
            self._in_width_ = int((self.data_index[:, 2] - self.data_index[:, 1]).max())
        return self._in_width_

    def _eval_target_width(self) -> int:
        if not hasattr(self, "_target_width"):
            self._target_width = int((self.data_index[:, 5] - self.data_index[:, 4]).max())
        return self._target_width

    def _windows(self):
        """(field prefix, start column, end column, width) of the history
        window and the target window."""
        return (("in_", 1, 2, self._in_width()), ("", 4, 5, self._eval_target_width()))

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        rows = self.data_index[idx]
        batch = {self.fuid: rows[:, 0].astype(np.int32)}
        for f in self._fields_of(self.user_feat):
            if f != self.fuid:
                batch[f] = self.user_feat.get_col(f)[rows[:, 0]]
        fiid_col = self.inter_feat.get_col(self.fiid)
        for prefix, cs, ce, width in self._windows():
            gather = rows[:, cs, None] + np.arange(width)[None, :]
            valid = gather < rows[:, ce, None]
            gather = np.where(valid, gather, 0)
            iid = np.where(valid, fiid_col[gather], 0).astype(np.int32)
            batch[prefix + self.fiid] = iid
            if self.frating is not None:
                for r in self._rating_fields():
                    rcol = self.inter_feat.get_col(r)
                    batch[prefix + r] = np.where(valid, rcol[gather], 0).astype(np.float32)
            for f in self._fields_of(self.item_feat):
                if f != self.fiid:          # joined by the windowed item ids (0 = pad row)
                    batch[prefix + f] = np.where(valid, self.item_feat.get_col(f)[iid], 0)
        return batch

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self._get_pos_batch(idx)
        if self.eval_mode and "user_hist" not in batch:
            batch["user_hist"] = batch["in_" + self.fiid]
        return batch

    @property
    def inter_feat_subset(self) -> np.ndarray:
        di = self.data_index
        return np.concatenate([np.arange(s, e) for s, e in zip(di[:, -2], di[:, -1])]
                              + [np.zeros(0, np.int64)])

    def device_epoch_arrays(self) -> Tuple[Dict[str, np.ndarray], Callable]:
        """Compact staging for device-resident epochs (``dataset.py:
        1098-1158``): ``data_index``, the item id column and each rating
        column, padded with ``max(history width, target width)`` zeros so
        every window read stays in bounds, and the user and item feature
        columns in use (``_stage_entity_feats``); ``batch_fn(arrays, sel)``
        returns ``_get_pos_batch(sel)``'s batch as tensors, each row's two
        windows read from the padded columns on the device, the user
        features by the user id and the item features of each window by its
        item ids (0 at pads)."""
        fuid, fiid = self.fuid, self.fiid
        ratings = self._rating_fields() if self.frating is not None else []
        pad = max(self._in_width(), self._eval_target_width())
        compact = {"_rows": _int32_column("data_index", self.data_index),
                   "_fiid": np.concatenate([_int32_column(fiid, self.inter_feat.get_col(fiid)),
                                            np.zeros(pad, np.int32)])}
        # ``_rating``, or ``_rating_{r}`` a rating of several
        rkeys = {r: f"_rating_{r}" if isinstance(self.frating, list) else "_rating"
                 for r in ratings}
        for r, key in rkeys.items():
            rcol = self.inter_feat.get_col(r).astype(np.float32)
            compact[key] = np.concatenate([rcol, np.zeros(pad, np.float32)])
        feats = self._stage_entity_feats(compact)
        windows = self._windows()

        def batch_fn(arrays: Dict[str, torch.Tensor], sel: torch.Tensor) -> Dict[str, torch.Tensor]:
            rows = arrays["_rows"][sel].long()
            batch = {fuid: rows[:, 0].int()}
            for kind, f, is_float in feats:
                if kind == "user":
                    batch[f] = _from_words(arrays["_user_" + f][rows[:, 0]], is_float)
            for prefix, cs, ce, width in windows:
                pos = rows[:, cs, None] + torch.arange(width, device=sel.device)[None, :]
                valid = pos < rows[:, ce, None]
                iid = torch.where(valid, arrays["_fiid"][pos], 0)
                batch[prefix + fiid] = iid
                for r, key in rkeys.items():
                    batch[prefix + r] = torch.where(valid, arrays[key][pos], 0.0)
                for kind, f, is_float in feats:
                    if kind == "item":
                        got = _from_words(arrays["_item_" + f][iid.long()], is_float)
                        batch[prefix + f] = _masked(valid, got)
            return batch

        return compact, batch_fn


class SeqDataset(TripletDataset):
    """Sliding-window causal sequences (``dataset.py:1169-1255``)."""

    @property
    def drop_dup(self):
        return False

    def build(self, split_ratio=2, split_mode: str = "user_entry", test_rep: bool = True,
              train_rep: bool = True, fmeval: bool = False, binarized_rating_thres=None,
              neg_count=None, sampler=None, **kwargs):
        _refuse_dataset_negatives(neg_count, sampler)
        self.test_rep = test_rep
        self.train_rep = train_rep and test_rep
        self.fmeval = fmeval
        return self._build(split_ratio, False, split_mode, test_rep, binarized_rating_thres)

    @property
    def max_seq_len(self) -> int:
        return int(self.config.get("max_seq_len") or 20)

    def _get_data_idx(self, splits):
        """One row ``[uid, max(start, i - L), i]`` per target position i > start,
        assigned to the split whose range holds i (vectorised form of
        ``dataset.py:1193-1212``)."""
        splits, uids = splits
        if uids is None:
            raise NotImplementedError("a single-user split is not ported yet")
        maxlen = self.max_seq_len
        starts = splits[:, 0]
        n_rows = np.maximum(splits[:, -1] - starts - 1, 0)
        owner = np.repeat(np.arange(len(starts)), n_rows)
        offs = np.cumsum(n_rows) - n_rows
        i = starts[owner] + 1 + (np.arange(len(owner)) - offs[owner])
        rows = np.stack([uids[owner], np.maximum(starts[owner], i - maxlen), i],
                        axis=1).astype(np.int64)
        part = (i[:, None] >= splits[owner, 1:-1]).sum(axis=1)
        outs = [rows[part == k] for k in range(splits.shape[1] - 1)]
        fii = self.first_item_idx
        return [p if (self.train_rep if k == 0 else self.test_rep) else p[fii[p[:, -1]]]
                for k, p in enumerate(outs)]

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        rows = self.data_index[idx]
        starts, ends = rows[:, 1], rows[:, 2]
        lens = (ends - starts).astype(np.int32)
        batch = {self.fuid: rows[:, 0].astype(np.int32), "seqlen": lens}
        for f in self._fields_of(self.user_feat):
            if f != self.fuid:
                batch[f] = self.user_feat.get_col(f)[rows[:, 0]]
        L = self.max_seq_len
        gather = starts[:, None] + np.arange(L)[None, :]
        valid = gather < ends[:, None]
        gather = np.where(valid, gather, 0)
        fields = [f for f in self._fields_of(self.inter_feat) if f != self.fuid]
        for f in fields:
            col = self.inter_feat.get_col(f)
            batch["in_" + f] = np.where(valid, col[gather], 0).astype(col.dtype)
        in_iid = batch.get("in_" + self.fiid)
        for f in self._fields_of(self.item_feat):
            if f != self.fiid and in_iid is not None:
                batch["in_" + f] = np.where(valid, self.item_feat.get_col(f)[in_iid], 0)
        for f in fields:
            batch[f] = self.inter_feat.get_col(f)[ends]
        for f in self._fields_of(self.item_feat):
            if f != self.fiid:
                batch[f] = self.item_feat.get_col(f)[batch[self.fiid]]
        return batch

    @property
    def inter_feat_subset(self):
        di = self.data_index
        user_first = di[di[:, 2] - di[:, 1] == 1][:, 1]
        return np.concatenate([user_first, di[:, 2]])

    def device_epoch_arrays(self) -> Tuple[Dict[str, np.ndarray], Callable]:
        """Compact staging for device-resident epochs (``dataset.py:1257-1352``).

        Returns ``(host_arrays, batch_fn)``: the split's ``data_index`` and
        raw interaction columns packed into one ``[n + L, C]`` int32 matrix
        (floats as their bits, L rows of zeros so every window read stays in
        bounds); ``batch_fn(arrays, sel)`` takes those arrays as tensors on
        the device and a ``[B]`` index tensor and returns
        ``_get_pos_batch(sel)``'s batch as tensors, gathering each row's
        history window on the device. The user and item feature columns in
        use are staged whole (``_stage_entity_feats``) and read by the user
        id, the window's item ids (0 at pads) and the target item id.
        Columns that would not survive int32/float32, or a split with no
        interaction column to stage, raise.
        """
        L = self.max_seq_len
        fuid, fiid = self.fuid, self.fiid
        fields = [f for f in self._fields_of(self.inter_feat) if f != fuid]
        if not fields:
            raise ValueError("device_epoch_arrays: no interaction column besides the user id")
        is_float = {f: np.issubdtype(self.inter_feat.get_col(f).dtype, np.floating)
                    for f in fields}
        packed = np.stack([_int32_column(f, self.inter_feat.get_col(f)) for f in fields], axis=1)
        compact = {"_rows": _int32_column("data_index", self.data_index),
                   "_interpack": np.concatenate([packed, np.zeros((L, len(fields)), np.int32)])}
        feats = self._stage_entity_feats(compact)

        def batch_fn(arrays: Dict[str, torch.Tensor], sel: torch.Tensor) -> Dict[str, torch.Tensor]:
            rows = arrays["_rows"][sel].long()
            u, starts, ends = rows[:, 0], rows[:, 1], rows[:, 2]
            batch = {fuid: u.int(), "seqlen": (ends - starts).int()}
            for kind, f, isf in feats:
                if kind == "user":
                    batch[f] = _from_words(arrays["_user_" + f][u], isf)
            pos = starts[:, None] + torch.arange(L, device=sel.device)[None, :]
            valid = pos < ends[:, None]
            wins = arrays["_interpack"][pos]                    # [B, L, C]
            tgt = arrays["_interpack"][ends]                    # [B, C]
            for c, f in enumerate(fields):
                batch["in_" + f] = _masked(valid, _from_words(wins[:, :, c], is_float[f]))
            for c, f in enumerate(fields):
                batch[f] = _from_words(tgt[:, c], is_float[f])
            for kind, f, isf in feats:
                if kind == "item":
                    col = arrays["_item_" + f]
                    if "in_" + fiid in batch:
                        batch["in_" + f] = _masked(
                            valid, _from_words(col[batch["in_" + fiid].long()], isf))
                    if fiid in batch:
                        batch[f] = _from_words(col[batch[fiid].long()], isf)
            return batch

        return compact, batch_fn


def _user_splits(splits) -> Tuple[np.ndarray, np.ndarray]:
    """The per-user split bounds and user ids, paired as ``zip`` pairs them;
    a single-user split raises."""
    splits, uids = splits
    if uids is None:
        raise NotImplementedError("a single-user split is not ported yet")
    k = min(len(uids), len(splits))
    return splits[:k], uids[:k]


class FullSeqDataset(SeqDataset):
    """One truncated sequence a user a split (``dataset.py:1359-1372``): the
    training row ends at the last training item, an evaluation row at the
    split's last item, each at most ``max_seq_len`` long."""

    def _get_data_idx(self, splits):
        sp, uids = _user_splits(splits)
        sp = sp.copy()
        sp[:, 1:] -= 1
        maxlen = self.max_seq_len
        outs = [np.stack([uids, np.maximum(sp[:, 0], sp[:, 1] - maxlen), sp[:, 1]], axis=1)]
        for k in range(2, sp.shape[1]):
            outs.append(np.stack([uids, np.maximum(sp[:, k] - maxlen, sp[:, 0]), sp[:, k]], axis=1))
        return [o.astype(np.int64).reshape(-1, 3) for o in outs]


class SeqToSeqDataset(SeqDataset):
    """A source window and its target window shifted by one
    (``dataset.py:1378-1500``), for the contrastive sequence models: a
    split's row ``[uid, max(start, i - 1 - L), i - 1]`` (i its end) holds
    the items before the split's last one. In training the batch carries
    the source window ``in_*`` and, at every true position, the next item
    (``[B, L]`` targets, 0 at padding); in evaluation the single target at
    the window's end. Item features are not joined, as there."""

    def _get_data_idx(self, splits):
        sp, uids = _user_splits(splits)
        maxlen = self.max_seq_len
        outs = []
        for k in range(1, sp.shape[1]):
            i = sp[:, k]
            s = np.maximum(sp[:, 0], i - 1 - maxlen)
            keep = i - 1 > s
            outs.append(np.stack([uids[keep], s[keep], i[keep] - 1], axis=1)
                        .astype(np.int64).reshape(-1, 3))
        fii = self.first_item_idx
        return [p if (self.train_rep if k == 0 else self.test_rep) else p[fii[p[:, -1]]]
                for k, p in enumerate(outs)]

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        rows = self.data_index[idx]
        starts, ends = rows[:, 1], rows[:, 2]
        batch = {self.fuid: rows[:, 0].astype(np.int32),
                 "seqlen": (ends - starts).astype(np.int32)}
        for f in self._fields_of(self.user_feat):
            if f != self.fuid:
                batch[f] = self.user_feat.get_col(f)[rows[:, 0]]
        gather = starts[:, None] + np.arange(self.max_seq_len)[None, :]
        valid = gather < ends[:, None]
        fields = [f for f in self._fields_of(self.inter_feat) if f != self.fuid]
        for f in fields:
            col = self.inter_feat.get_col(f)
            batch["in_" + f] = np.where(valid, col[np.where(valid, gather, 0)], 0).astype(col.dtype)
        for f in fields:
            col = self.inter_feat.get_col(f)
            batch[f] = col[ends] if self.eval_mode else \
                np.where(valid, col[np.where(valid, gather + 1, 0)], 0).astype(col.dtype)
        return batch

    @property
    def inter_feat_subset(self):
        di = self.data_index
        return np.concatenate([np.arange(s, e + 1) for s, e in zip(di[:, 1], di[:, 2])]
                              + [np.zeros(0, np.int64)])

    def device_epoch_arrays(self) -> Tuple[Dict[str, np.ndarray], Callable]:
        """Training staging (``dataset.py:1438-1500``): the interaction
        columns packed into one ``[n + L + 1, C]`` int32 matrix (floats as
        their bits, L + 1 rows of zeros), so one ``[L + 1, C]`` slice an
        example, gathered at once, serves the source window (its first L
        rows) and the target window (its last L) of every field."""
        L = self.max_seq_len
        fuid = self.fuid
        fields = [f for f in self._fields_of(self.inter_feat) if f != fuid]
        if not fields:
            raise ValueError("device_epoch_arrays: no interaction column besides the user id")
        is_float = {f: np.issubdtype(self.inter_feat.get_col(f).dtype, np.floating)
                    for f in fields}
        packed = np.stack([_int32_column(f, self.inter_feat.get_col(f)) for f in fields], axis=1)
        compact = {"_rows": _int32_column("data_index", self.data_index),
                   "_interpack": np.concatenate([packed,
                                                 np.zeros((L + 1, len(fields)), np.int32)])}
        users = [f for f in self._fields_of(self.user_feat) if f != fuid]
        for f in users:
            compact["_user_" + f] = _int32_column(f, self.user_feat.get_col(f))
        user_float = {f: np.issubdtype(self.user_feat.get_col(f).dtype, np.floating)
                      for f in users}

        def batch_fn(arrays: Dict[str, torch.Tensor], sel: torch.Tensor) -> Dict[str, torch.Tensor]:
            rows = arrays["_rows"][sel].long()
            u, starts, ends = rows[:, 0], rows[:, 1], rows[:, 2]
            batch = {fuid: u.int(), "seqlen": (ends - starts).int()}
            for f in users:
                batch[f] = _from_words(arrays["_user_" + f][u], user_float[f])
            pos = starts[:, None] + torch.arange(L + 1, device=sel.device)[None, :]
            valid = pos[:, :L] < ends[:, None]
            wins = arrays["_interpack"][pos]                    # [B, L + 1, C]
            for c, f in enumerate(fields):
                win = _from_words(wins[:, :, c], is_float[f])
                batch["in_" + f] = _masked(valid, win[:, :L])
                batch[f] = _masked(valid, win[:, 1:])
            return batch

        return compact, batch_fn
