"""Dataset layer: host-side ETL -> fixed-shape numpy batches.

The subset of ``recstudio_tpu/data/dataset.py`` that serving SASRec on
ml-100k needs, in numpy and plain Python (no pandas):

- files are parsed as delimited text; token columns are interned in order
  of first appearance in the file as read, as the JAX package's native CSV
  path interns them (``recstudio_tpu/native/__init__.py:fast_read_csv``);
- the rating threshold (``low_rating_thres``) and the duplicate-pair drop
  are applied, then float preprocessing;
- ids are factorized per shared id space by first appearance over the
  columns in file order (inter, user, item), with ``[PAD]`` = 0
  (``dataset.py:388-508``);
- rows are sorted by (user, time) with a stable sort (``dataset.py:601``)
  and split leave-one-out (``split_ratio`` an int);
- split views expose ``data_index``, ``user_hist`` and an ``eval_loader``
  of fixed-shape batches that carry ``_size``.

Ratio and count splits, k-core filtering, sequence and network features,
training loaders and device-resident epochs are not ported yet.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

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


def _read_table(path: str, header, sep: str, field_decls: List[str],
                encoding: str) -> Tuple[Dict[str, object], Dict[str, str]]:
    """Parse a delimited file into ``{name: _Tokens | float64 array}``."""
    specs = [parse_field(d) for d in field_decls]
    if any(s.is_seq for s in specs):
        raise NotImplementedError("sequence fields are not ported yet")
    with open(path, "r", encoding=encoding) as f:
        lines = f.read().splitlines()
    skip = 0 if header is None else int(header) + 1
    rows = [ln.split(sep) for ln in lines[skip:] if ln]
    bad = [i for i, r in enumerate(rows) if len(r) != len(specs)]
    if bad:
        raise ValueError(f"{path}: row {bad[0] + skip} has {len(rows[bad[0]])} fields, "
                         f"expected {len(specs)}")
    cols = list(zip(*rows)) if rows else [()] * len(specs)
    out: Dict[str, object] = {}
    for s, col in zip(specs, cols):
        arr = np.asarray(col, dtype=str)
        out[s.name] = arr.astype(np.float64) if s.dtype == "float" else _Tokens(arr)
    return out, {s.name: s.dtype for s in specs}


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
        self._use_field = {f for f in (self.fuid, self.fiid, self.frating) if f is not None}

    # ------------------------------------------------------------------
    def _init_common_field(self):
        self.field2type: Dict[str, str] = {}
        self.field2tokens: Dict[str, np.ndarray] = {}
        c = self.config
        self.fuid = parse_field(c["user_id_field"]).name if c.get("user_id_field") else None
        self.fiid = parse_field(c["item_id_field"]).name if c.get("item_id_field") else None
        self.ftime = parse_field(c["time_field"]).name if c.get("time_field") else None
        rf = c.get("rating_field")
        if isinstance(rf, list):
            raise NotImplementedError("multiple rating fields are not ported yet")
        self.frating = parse_field(rf).name if rf else None

    @property
    def drop_dup(self) -> bool:
        return bool(self.config.get("drop_dup", True))

    @property
    def use_field(self):
        return self._use_field

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
        if thres is not None and self.frating is not None:
            self._keep_inter_rows(self.inter_feat[self.frating] >= thres)
        if self.drop_dup:
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
        for kind, key, n in (("user", self.fuid, self.num_users),
                             ("item", self.fiid, self.num_items)):
            feat = getattr(self, f"{kind}_feat")
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
        return len(self._column(self.fiid)) if isinstance(self.inter_feat, dict) \
            else len(self.inter_feat)

    def __len__(self) -> int:
        return len(self.data_index) if self.data_index is not None else self.num_inters

    # ------------------------------------------------------------------
    # build / split
    # ------------------------------------------------------------------
    def build(self, split_ratio=2, shuffle: bool = True, split_mode: str = "user_entry",
              fmeval: bool = False, binarized_rating_thres=None, **kwargs):
        self.fmeval = fmeval
        return self._build(split_ratio, shuffle, split_mode, False, binarized_rating_thres)

    def _build(self, ratio_or_num, shuffle: bool, split_mode: str, rep: bool,
               binarized_rating_thres=None):
        if binarized_rating_thres is not None:
            raise NotImplementedError("rating binarization is not ported yet")
        if split_mode != "user_entry" or not isinstance(ratio_or_num, int):
            raise NotImplementedError(
                "only leave-one-out splits (split_ratio an int) in user_entry mode are ported")
        if self.fmeval:
            raise NotImplementedError("fmeval splits are not ported yet")
        feat = self.inter_feat
        if not hasattr(self, "first_item_idx"):
            self.first_item_idx = self._first_pair()
        if self.drop_dup and not rep:
            keep = self.first_item_idx
            self._keep_inter_rows(keep)
            feat = self.inter_feat
            self.first_item_idx = self.first_item_idx[keep]

        # stable sort by (user, time): the order of pandas' mergesort
        keys = [feat[self.fuid]]
        if self.ftime and self.ftime in feat:
            keys.insert(0, feat[self.ftime])
        order = np.lexsort(keys)
        self._keep_inter_rows(order)
        self.first_item_idx = self.first_item_idx[order]
        uids = self.inter_feat[self.fuid]
        # users in order of first appearance (ascending after the sort)
        bounds = np.flatnonzero(np.r_[True, uids[1:] != uids[:-1]])
        counts = np.diff(np.r_[bounds, len(uids)])
        user_ids = uids[bounds]
        if shuffle:
            idx = np.concatenate([np.random.permutation(c) + s
                                  for s, c in zip(bounds, counts)])
            self._keep_inter_rows(idx)
            self.first_item_idx = self.first_item_idx[idx]

        splits = self._split_by_leave_one_out(ratio_or_num, counts, user_ids, rep)
        self.inter_feat = Frame.from_columns(self.inter_feat, self.field2type)
        datasets = [self._copy(idx) for idx in self._get_data_idx(splits)]
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

    def _split_by_leave_one_out(self, leave_one_num: int, counts: np.ndarray,
                                user_ids: np.ndarray, rep: bool = True):
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
        cum0 = np.hstack([[0], cum])
        return cum0.reshape(-1, 1) + splits, (user_ids if m > 1 else None)

    def _get_data_idx(self, splits):
        """Train view -> flat interaction indices; eval views -> (uid, start, end) rows."""
        splits, uids = splits
        if uids is None:
            raise NotImplementedError("a single-user split is not ported yet")
        out = [np.concatenate([np.arange(s, e) for s, e in zip(splits[:, 0], splits[:, 1])])]
        for i in range(2, splits.shape[1]):
            s, e = splits[:, i - 1], splits[:, i]
            keep = e > s
            out.append(np.stack([uids[keep], s[keep], e[keep]], axis=1).astype(np.int64))
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

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------
    def _fields_of(self, frame: Frame) -> List[str]:
        return [f for f in frame.fields if f in self._use_field]

    def _get_pos_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        if self.data_index.ndim == 1:
            rows = self.data_index[idx]
            batch = {f: self.inter_feat.get_col(f)[rows] for f in self._fields_of(self.inter_feat)}
            for frame, key in ((self.user_feat, self.fuid), (self.item_feat, self.fiid)):
                for f in self._fields_of(frame):
                    if f != key and f not in batch:
                        batch[f] = frame.get_col(f)[batch[key]]
            return batch
        rows = self.data_index[idx]
        batch = {self.fuid: rows[:, 0].astype(np.int32)}
        for f in self._fields_of(self.user_feat):
            if f != self.fuid:
                batch[f] = self.user_feat.get_col(f)[rows[:, 0]]
        starts, ends = rows[:, 1], rows[:, 2]
        width = int((self.data_index[:, 2] - self.data_index[:, 1]).max())
        gather = starts[:, None] + np.arange(width)[None, :]
        valid = gather < ends[:, None]
        gather = np.where(valid, gather, 0)
        batch[self.fiid] = np.where(valid, self.inter_feat.get_col(self.fiid)[gather], 0).astype(np.int32)
        rcol = self.inter_feat.get_col(self.frating)
        batch[self.frating] = np.where(valid, rcol[gather], 0).astype(np.float32)
        return batch

    def eval_loader(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape evaluation batches in data order; the tail batch is
        padded with row 0 and ``_size`` holds its true row count."""
        self.eval_mode = True
        return _EvalBatches(self, batch_size)

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = self._get_pos_batch(idx)
        if self.eval_mode and self.fuid is not None and "user_hist" not in batch:
            batch["user_hist"] = self.user_hist[batch[self.fuid]].astype(np.int32)
        return batch


class _EvalBatches:
    """Evaluation batch iterator over a split view (``dataset.py:974-1016``)."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset.data_index) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset.data_index)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            true_size = len(idx)
            if true_size < bs:
                idx = np.concatenate([idx, np.zeros(bs - true_size, dtype=idx.dtype)])
            batch = self.dataset._make_batch(idx)
            batch["_size"] = np.asarray(true_size, dtype=np.int32)
            yield batch


class SeqDataset(TripletDataset):
    """Sliding-window causal sequences (``dataset.py:1169-1255``)."""

    @property
    def drop_dup(self):
        return False

    def build(self, split_ratio=2, split_mode: str = "user_entry", test_rep: bool = True,
              train_rep: bool = True, fmeval: bool = False, binarized_rating_thres=None,
              **kwargs):
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
