"""KuaiRand-Pure-shaped multitask data with a planted signal.

The fields are those of ``recstudio_tpu/data/config/kuairand-pure.yaml``:
an interaction log (user, video, date, the six ``is_*`` labels and the
other columns of ``log_standard_4_22_to_5_08_pure.csv``) and a user
feature file (the 30 columns of ``user_features_pure.csv``). The counts of
the public log are 27,285 users, 7,583 videos and 1,436,609 rows
(kuairand.com; Gao et al., CIKM 2022): ``SHAPES["kuairand-pure-shape"]``.

Each label has a planted logistic signal: a video effect, a user effect
read from the user features, and a latent user-video product, each
weighted per task. ``is_click`` is drawn first; every later label can be 1
only where the click is, as AITM's calibrator assumes. Float columns are
written at unit scale, the date too (the real log's dates and
milliseconds would need a float preprocessor, which the repo's config does
not set, and every field of a multitask ranker is a feature). The file depends on
the seed and the counts alone.

    from multitask_data import write_kuairand
    name, config = write_kuairand("kuairand-pure-shape", out_dir, seed=7)

``config`` is the dataset config of both packages (a dict: the port reads
no YAML; the JAX package takes the same dict).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

SHAPES = {
    "kuairand-pure-shape": (27285, 7583, 1_436_609),
    # the small file the ml-100k-sized quickstart runs train on
    "kuairand-pure-small": (2000, 800, 60_000),
}
RATINGS = ("is_click", "is_like", "is_follow", "is_comment", "is_forward", "is_hate")
# base rate of the click, and of each later label given a click
BASE_RATES = (0.35, 0.35, 0.2, 0.2, 0.2, 0.15)
INTER_FLOATS = ("hourmin", "time_ms") + RATINGS + (
    "long_view", "play_time_ms", "duration_ms", "profile_stay_time", "comment_stay_time",
    "is_probfile_enter", "is_rand", "tab")
USER_TOKENS = {"user_active_degree": 4, "follow_user_num_range": 8,
               "fans_user_num_range": 9, "friend_user_num_range": 7,
               "register_days_range": 7}
USER_FIELDS = ("user_active_degree", "is_lowactive_period", "is_live_streamer",
               "is_video_author", "follow_user_num", "follow_user_num_range",
               "fans_user_num", "fans_user_num_range", "friend_user_num",
               "friend_user_num_range", "register_days", "register_days_range") + tuple(
    f"onehot_feat{k}" for k in range(18))
INTER_FILE = "log_standard_4_22_to_5_08_pure.csv"
USER_FILE = "user_features_pure.csv"


def dataset_config(base: str) -> Dict:
    """The dataset config of the files under ``base`` (kuairand-pure.yaml's
    fields and files, ``url`` the directory)."""
    tok = lambda f: f"{f}:{'token' if f in USER_TOKENS else 'float'}"
    return {
        "url": base,
        "user_id_field": "user_id:token",
        "item_id_field": "video_id_id:token",
        "rating_field": [f"{r}:float" for r in RATINGS],
        "time_field": "date:float",
        "inter_feat_name": INTER_FILE,
        "inter_feat_field": ["user_id:token", "video_id_id:token", "date:float"]
                            + [f"{f}:float" for f in INTER_FLOATS],
        "inter_feat_header": 0,
        "user_feat_name": [USER_FILE],
        "user_feat_field": [["user_id:token"] + [tok(f) for f in USER_FIELDS]],
        "user_feat_header": 0,
        "item_feat_name": None,
        "item_feat_field": None,
        "network_feat_name": None,
        "field_separator": ",",
        "min_user_inter": 0,
        "min_item_inter": 0,
        "low_rating_thres": None,
        "max_seq_len": None,
        "float_field_preprocess": None,
        "save_cache": False,
    }


def _text(col: np.ndarray) -> list:
    """``col`` as text, each distinct value converted once."""
    uniq, inv = np.unique(col, return_inverse=True)
    return np.asarray(uniq.astype(str).tolist(), dtype=object)[inv.reshape(-1)].tolist()


def _write(path: str, frame: Dict[str, np.ndarray], chunk: int = 200_000) -> None:
    n = len(next(iter(frame.values())))
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(",".join(frame) + "\n")
        for s in range(0, n, chunk):
            cols = [_text(c[s:s + chunk]) for c in frame.values()]
            f.writelines(",".join(row) + "\n" for row in zip(*cols))


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def write_files(base: str, n_users: int, n_items: int, n_rows: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    # user features: tokens with a per-value effect, binary onehot floats
    # with a per-column effect, unit-scale counts
    users = {"user_id": np.arange(1, n_users + 1)}
    user_eff = np.zeros(n_users)
    for f in USER_FIELDS:
        if f in USER_TOKENS:
            v = rng.integers(0, USER_TOKENS[f], n_users)
            user_eff += rng.normal(0.0, 0.5, USER_TOKENS[f])[v]
            users[f] = np.asarray([f"{f[:3]}{k}" for k in range(USER_TOKENS[f])])[v]
        elif f.startswith(("onehot", "is_")):
            v = (rng.random(n_users) < rng.uniform(0.1, 0.6)).astype(np.float32)
            user_eff += rng.normal(0.0, 0.3) * v
            users[f] = v
        else:
            users[f] = np.round(rng.lognormal(0.0, 0.5, n_users) / 4.0, 3).astype(np.float32)
    user_eff = (user_eff - user_eff.mean()) / max(user_eff.std(), 1e-6)
    # rows: lognormal user activity, Zipf video popularity
    act = rng.lognormal(0.0, 1.0, n_users)
    uid = rng.choice(n_users, size=n_rows, p=act / act.sum())
    pop = 1.0 / np.arange(5.0, n_items + 5.0) ** 0.8
    iid = rng.choice(n_items, size=n_rows, p=rng.permutation(pop / pop.sum()))
    item_eff = rng.normal(0.0, 1.0, n_items)
    U, V = rng.normal(0.0, 1.0, (n_users, 4)), rng.normal(0.0, 1.0, (n_items, 4))
    latent = (U[uid] * V[iid]).sum(-1) / 2.0
    inter: Dict[str, np.ndarray] = {
        "user_id": uid + 1, "video_id_id": iid + 1,
        # the log's 17 days as a fraction of its span (every field is a feature)
        "date": np.round(rng.integers(0, 17, n_rows) / 17.0, 4).astype(np.float32),
        "hourmin": np.round(rng.random(n_rows), 3).astype(np.float32),
        "time_ms": np.round(rng.random(n_rows), 4).astype(np.float32)}
    click = None
    for t, (r, p) in enumerate(zip(RATINGS, BASE_RATES)):
        w = rng.uniform(0.6, 1.2, 3)
        logit = _logit(p) + w[0] * item_eff[iid] + w[1] * user_eff[uid] + w[2] * latent
        y = rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))
        click = y if t == 0 else click
        inter[r] = (y & click).astype(np.float32)
    for f in INTER_FLOATS:
        if f not in inter:
            binary = f.startswith(("is_", "long", "tab"))
            inter[f] = ((rng.random(n_rows) < 0.3).astype(np.float32) if binary else
                        np.round(rng.lognormal(0.0, 0.5, n_rows) / 4.0, 3).astype(np.float32))
    _write(os.path.join(base, INTER_FILE), {k: inter[k] for k in
                                            ["user_id", "video_id_id", "date", *INTER_FLOATS]})
    _write(os.path.join(base, USER_FILE), users)


def write_kuairand(name: str, out_dir: str, seed: int = 7, force: bool = False
                   ) -> Tuple[str, Dict]:
    """Write ``name``'s files (a key of ``SHAPES``) under ``out_dir/name``
    unless they are there; return ``(name, dataset config)``."""
    n_users, n_items, n_rows = SHAPES[name]
    base = os.path.join(out_dir, name)
    os.makedirs(base, exist_ok=True)
    done = os.path.join(base, ".complete")
    if force or not os.path.isfile(done):
        write_files(base, n_users, n_items, n_rows, seed)
        with open(done, "w") as f:
            f.write(f"{seed}\n")
    return name, dataset_config(base)
