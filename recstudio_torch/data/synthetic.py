"""Synthetic interaction datasets at the shape of public ones.

Port of ``recstudio_tpu/data/synthetic.py`` in numpy and plain Python:
the interaction generator (``generate``) and the criteo-shape CTR
generator (``generate_ctr``). With the same seed each writes the same
``<name>.inter`` file, byte for byte, as the JAX package's copy.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT_DIR = os.path.join(_REPO_ROOT, "build", "recstudio_torch", "synthetic")

# (n_users, n_items, n_inters) of well-known public datasets
SHAPES = {
    "ml-1m-shape": (6040, 3706, 1_000_209),
    "ml-10m-shape": (69878, 10677, 10_000_054),
    "ml-20m-shape": (138493, 26744, 20_000_263),
    "amazon-book-shape": (52643, 91599, 2_984_108),
}


def generate(name: str, n_users: int, n_items: int, n_inters: int,
             out_dir: Optional[str] = None, seed: int = 0,
             max_user_inters: int = 2000, force: bool = False
             ) -> Tuple[str, Dict]:
    """Write ``<name>.inter`` (TSV with a header) under ``out_dir`` (by
    default ``build/recstudio_torch/synthetic/<name>`` of the checkout) and
    return ``(name, data_config)`` for ``SeqDataset(name, config)``."""
    base = out_dir or os.path.join(DEFAULT_OUT_DIR, name)
    os.makedirs(base, exist_ok=True)
    inter_path = os.path.join(base, f"{name}.inter")
    if force or not os.path.isfile(inter_path):
        write_inter(inter_path, n_users, n_items, n_inters, seed, max_user_inters)
    config = {
        "url": base,
        "user_id_field": "user_id:token",
        "item_id_field": "item_id:token",
        "rating_field": "rating:float",
        "time_field": "timestamp:float",
        "inter_feat_name": f"{name}.inter",
        "inter_feat_field": ["user_id:token", "item_id:token",
                             "rating:float", "timestamp:float"],
        "inter_feat_header": 0,
        "user_feat_name": None,
        "item_feat_name": None,
        "network_feat_name": None,
        "low_rating_thres": None,
        "min_user_inter": 0,
        "min_item_inter": 0,
        "drop_dup": False,  # with-replacement draws model repeat consumption
        "save_cache": True,
    }
    return name, config


def write_inter(path: str, n_users: int, n_items: int, n_inters: int,
                seed: int, max_user_inters: int = 2000) -> None:
    rng = np.random.default_rng(seed)

    # heterogeneous user activity: lognormal, clipped, scaled to n_inters
    act = rng.lognormal(mean=0.0, sigma=1.1, size=n_users)
    counts = np.clip(act / act.sum() * n_inters, 3, max_user_inters)
    counts = counts.astype(np.int64)
    diff = n_inters - int(counts.sum())
    # distribute the rounding remainder over users with headroom
    room = (max_user_inters - counts) if diff > 0 else (counts - 3)
    idx = rng.permutation(np.repeat(np.arange(n_users), room))
    take = np.minimum(abs(diff), len(idx))
    np.add.at(counts, idx[:take], 1 if diff > 0 else -1)
    n_total = int(counts.sum())

    users = np.repeat(np.arange(1, n_users + 1, dtype=np.int64), counts)

    # Zipf-ish item popularity (shuffled so id order carries no signal)
    pop = 1.0 / np.arange(10.0, n_items + 10.0) ** 0.8
    pop = rng.permutation(pop / pop.sum())
    items = rng.choice(np.arange(1, n_items + 1, dtype=np.int64),
                       size=n_total, p=pop)

    # positively-skewed explicit ratings (MovieLens-like 1..5)
    ratings = rng.choice([1.0, 2.0, 3.0, 4.0, 5.0], size=n_total,
                         p=[0.05, 0.10, 0.25, 0.35, 0.25])

    # per-user increasing timestamps so time-ordered splits are meaningful
    ts = np.cumsum(rng.integers(1, 1000, size=n_total)).astype(np.float64)

    # the text pandas' to_csv writes: ints as ints, floats by repr
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("user_id\titem_id\trating\ttimestamp\n")
        f.writelines(f"{u}\t{i}\t{r!r}\t{t!r}\n"
                     for u, i, r, t in zip(users.tolist(), items.tolist(),
                                           ratings.tolist(), ts.tolist()))


# criteo-like categorical vocabulary spread: 2 huge hashed fields, a few
# mid-cardinality, a long tail of small enums (sums to ~720k embedding rows)
CTR_VOCABS = (300_000, 200_000, 80_000, 40_000, 20_000, 10_000, 5_000,
              2_500, 1_200, 600, 300, 150, 100, 80, 60, 50, 40, 30, 25, 20,
              15, 12, 10, 8, 5, 3)
CTR_SHAPES = {
    "criteo-1m-shape": 1_000_000,
    "criteo-10m-shape": 10_000_000,
    "criteo-10m-bigvocab-shape": 10_000_000,
    "criteo-10m-hugevocab-shape": 10_000_000,
}
# per-shape multiplier applied to the >1024 vocabularies (small enums keep
# their natural sizes)
CTR_VOCAB_MULT = {"criteo-10m-bigvocab-shape": 16,
                  "criteo-10m-hugevocab-shape": 256}


def ctr_shape_vocabs(shape_name: str) -> Tuple[int, ...]:
    mult = CTR_VOCAB_MULT.get(shape_name, 1)
    return tuple(v * mult if v > 1024 else v for v in CTR_VOCABS)


def generate_ctr(name: str, n_rows: int, out_dir: Optional[str] = None,
                 seed: int = 0, n_float: int = 13,
                 vocabs: Tuple[int, ...] = CTR_VOCABS,
                 force: bool = False) -> Tuple[str, Dict]:
    """Criteo-shape CTR rows (``synthetic.py:135-164``): ``rating`` = the
    binary label, ``I1..I{n_float}`` floats, ``C1..`` Zipf-distributed
    tokens, with a planted logistic signal. Returns ``(name, data_config)``
    for ``TripletDataset``; the dataset has no user or item id."""
    base = out_dir or os.path.join(DEFAULT_OUT_DIR, name)
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"{name}.inter")
    if force or not os.path.isfile(path):
        write_ctr(path, n_rows, seed, n_float, vocabs)
    fields = (["rating:float"]
              + [f"I{i + 1}:float" for i in range(n_float)]
              + [f"C{j + 1}:token" for j in range(len(vocabs))])
    config = {
        "url": base,
        "user_id_field": None, "item_id_field": None,
        "rating_field": "rating:float", "time_field": None,
        "inter_feat_name": f"{name}.inter",
        "inter_feat_field": fields,
        "inter_feat_header": 0,
        "user_feat_name": None, "item_feat_name": None,
        "network_feat_name": None, "low_rating_thres": None,
        "min_user_inter": 0, "min_item_inter": 0, "drop_dup": False,
        "save_cache": True,
    }
    return name, config


def write_ctr(path: str, n_rows: int, seed: int, n_float: int,
              vocabs: Tuple[int, ...]) -> None:
    """``synthetic.py:167-196``: the same draws from the same generator in
    the same order, written as pandas' ``to_csv`` writes the JAX package's
    frame (float32 columns by numpy's shortest float32 text)."""
    rng = np.random.default_rng(seed)

    cols = {}
    logit = np.full(n_rows, -1.4)              # base CTR ~20%
    for i in range(n_float):
        x = rng.lognormal(mean=0.0, sigma=1.0, size=n_rows).astype(np.float32)
        w = rng.normal(0.0, 0.25)
        logit += w * np.log1p(x)
        cols[f"I{i + 1}"] = np.round(x, 3)
    for j, V in enumerate(vocabs):
        # Zipf token draw via inverse-CDF; a per-field random permutation
        # decouples popularity from id order
        pop = 1.0 / np.arange(2.0, V + 2.0) ** 0.9
        cdf = np.cumsum(pop / pop.sum())
        ranks = np.searchsorted(cdf, rng.random(n_rows), side="right")
        ids = rng.permutation(V)[np.minimum(ranks, V - 1)]
        # deterministic per-token effect (hash -> centered uniform), scaled
        # down for huge vocabs so rare tokens don't dominate the signal
        eff = (((ids.astype(np.uint64) * np.uint64(2654435761)
                 + np.uint64(j)) % np.uint64(1000)).astype(np.float32)
               / 1000.0 - 0.5) * (1.2 if V <= 1000 else 0.4)
        logit += eff
        cols[f"C{j + 1}"] = ids
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    frame = {"rating": y, **cols}
    text = [col.astype(str).tolist() for col in frame.values()]
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("\t".join(frame) + "\n")
        f.writelines("\t".join(row) + "\n" for row in zip(*text))
