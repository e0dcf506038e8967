#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``recstudio_torch``) on one NVIDIA GPU.

Run from the root of a checkout with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``recstudio_torch/csrc`` (nvcc, first use),
then:

- phase A: SASRec at the repo's ml-100k config (d 64, F 128, 2 heads,
  2 layers, L 20), seeded numpy weights, ``Predictor(max_batch=128, k=20)``
  over every test user; latency, NDCG@10 and Recall@10 of the served lists,
  and the first 64 served lists held to the JAX package's reference
  (``recstudio_torch/assets/sasrec_ml100k_reference.json``);
- phase B: SASRec at L 200, d 128 on the synthetic ml-1m shape (6040
  users, 3706 items, 1,000,209 interactions, seed 7),
  ``Predictor(max_batch=256, k=20)``; latency, and the kernel path's top-k
  held against the plain path's on the same weights;
- phase C: one ``TransformerLayer`` at L 384 (outside the fused layer's
  gate, so its attention goes to the attention kernel) held against the
  plain layer;
- phase D: SASRec training at L 200, d 128, F 128, 2 heads, 2 layers,
  dropout 0.5, batch 1024 on the synthetic ml-1m shape: 20 timed
  optimizer steps on device-resident batches (each layer through K1 in
  training mode and K2), then one step's loss and gradients on the kernel
  path held against the plain path with the same seeds and batch;
- phase E: ``fit`` SASRec on ml-100k at the repo's config for the epochs
  of the JAX training reference, ``evaluate(test)``, test NDCG@10 held to
  the JAX seeds' band (``recstudio_torch/assets/
  sasrec_ml100k_train_reference.json``), then 8 requests served through
  ``Predictor`` from the trained model, whose lists must give the same
  NDCG@10 as ``evaluate``;
- phase F: BERT4Rec training and serving at the paper's ML-1m settings (L
  200, d 64, F 128, 2 heads, 2 layers, dropout 0.2, mask ratio 0.2, batch
  256) on the synthetic ml-1m shape: 20 timed optimizer steps (K1 and K2
  with no attention mask, the catalog log-partition kernels K7, K8, K9),
  one step's loss and gradients held against the plain path and its loss
  against the materialized path (``train.fused_softmax: false``), then
  every user served through ``Predictor(max_batch=256, k=20)`` with the
  first two requests held to the plain path;
- phase G: ``fit`` BERT4Rec on ml-100k at the repo's config for the epochs
  of its JAX training reference, ``evaluate(test)``, test NDCG@10 held to
  the JAX seeds' band (``recstudio_torch/assets/
  bert4rec_ml100k_train_reference.json``), then 8 served requests whose
  lists must give ``evaluate``'s NDCG@10;
- phase H: long-sequence SASRec at L 1024 (d 128, F 128, 2 heads, 2
  layers, dropout 0, batch 256) on the synthetic ml-1m shape: 20 timed
  optimizer steps whose attention runs the flash kernels K4 (forward), K5
  and K6 (backward), one step's loss and gradients held against the plain
  path (dense ``mha_plain``), then every user served through
  ``Predictor(max_batch=256, k=20)`` (K4 alone) with the first two
  requests held to the plain path;
- phase I: BPR on ml-100k the way users start it,
  ``quickstart.run("BPR", "ml-100k")`` at the repo's config (d 64, ratio
  split, batch 512, adam, early stopping) with the epoch cap of
  ``recstudio_torch/assets/bpr_ml100k_train_reference.json``: test NDCG@5
  held to the JAX seeds' band there; one training step held to the same
  model copied to the CPU (same batch, same negatives); the 8 requests of
  every test user served through ``Predictor``, whose lists must give
  ``evaluate``'s NDCG@5; epoch time, steps per epoch, examples/s, and the
  card's busy share of one profiled epoch (BPR runs no kernel of its own:
  its steps are small PyTorch launches, bound by the host);
- phase J: BPR at the JAX package's scale shape (``scripts/
  scale_bench.py``: the synthetic ml-1m shape, ratio split, batch 8192):
  one warm epoch, then timed epochs under adam, lazy Adam on the dense
  path (``train.sparse_rows: false``) and lazy Adam's row-sparse step;
  one row-sparse step held to one dense lazy-Adam step from the same
  state and negatives, and to a bitwise repeat of itself; a full-catalog
  evaluation of every test user; ``Predictor(max_batch=256, k=20)`` over
  all 6040 users, two requests held to the CPU copy's lists;
- phase K: NARM training and serving on the synthetic ml-1m shape (L 200,
  d 64, GRU hidden 128, one layer, dropout [0.25, 0.5], batch 512, Adam
  1e-3): 20 timed optimizer steps (the GRU through cuDNN in float32, the
  catalog log-partition kernels K7, K8, K9 at 512 query rows), one step's
  loss and gradients held to the plain path (the GRU's time loop,
  materialized scores) from the same generator states, the GRU's forward
  and backward through cuDNN held to its time loop and timed against it,
  then every user served through ``Predictor(max_batch=256, k=20)`` with
  the first two requests held to the plain path;
- phase L: STAMP at the same shape and batch (no dropout, no GRU): the
  same, its plain path the materialized scores, its first two requests
  held to the model copied to the CPU;
- phase M: GRU4Rec at the same shape (dropout 0.3, one uniform negative,
  ``BPRLoss``): 20 timed steps, which launch none of the kernels, and one
  step held to the model copied to the CPU with the same batch, negatives
  and dropout seeds;
- phase N: ``quickstart.run("NARM", "ml-100k")`` and ``("STAMP", ...)`` at
  the repo's config for the epochs of their JAX training references,
  test NDCG@10 held to the JAX seeds' bands (``recstudio_torch/assets/
  narm_ml100k_train_reference.json``, ``stamp_...``), 8 requests served
  whose lists must give ``evaluate``'s NDCG@10;
- phase O: MultiDAE training and serving at the repo's config (d 200,
  encoder [64, 32], decoder [32, 64], relu, dropout 0.5, batch 256, Adam
  1e-2, weight decay 1e-5) on the synthetic ml-1m shape as a
  ``UserDataset`` (one row a user, the training items as the history): 20
  timed steps through the catalog log-partition kernels K7, K8, K9 at 256
  query rows and D 200, one step held to the materialized scores from the
  same generator states, every user served with the first two requests
  held to the model copied to the CPU;
- phase P: MultiVAE there (d 600, encoder [200], decoder [200], tanh,
  batch 500, Adam 1e-3): 20 timed steps, which launch none of the
  kernels (its scores are a plain product at D 600, as in the JAX
  package), one step held to the model copied to the CPU with the same
  eps, dropout seed and the KL weight at its cap, every user served with
  two requests held to the CPU copy;
- phase Q: ``quickstart.run("MultiDAE", "ml-100k")`` and ``("MultiVAE",
  ...)`` at the repo's config (epoch caps 200 and 500, early stopping),
  test NDCG@10 held to the JAX seeds' bands (``recstudio_torch/assets/
  multidae_ml100k_train_reference.json``, ``multivae_...``), every test
  user served, masked by the history window as ``evaluate`` masks, whose
  lists must give ``evaluate``'s NDCG@10;
- phase R: DeepFM at the repo's config (embed_dim 10, MLP [256, 256,
  256], tanh, dropout 0.3) on ``generate_ctr("criteo-1m-shape")`` (1,000,000
  rows, 13 float and 26 token fields; 499,331 table rows, the ids the
  Zipf draws reach of 660,208 vocabulary slots; the JAX
  bench's ``ctr_scale`` setup), batch 8192, Adam 1e-3: ``fit(train,
  None)`` for one epoch, then four more, the test split evaluated after
  each; the test AUC and logloss after the fifth held to the JAX seeds'
  bands (``recstudio_torch/assets/deepfm_criteo1m_train_reference.json``),
  whose AUC band must clear the untrained AUC by ``AUC_MARGIN``; 20 timed steps, peak memory, an epoch and its busy share, the
  MLP's dropout masks a step; one step held to the model copied to the CPU
  (same batch and dropout seeds) and to a repeat of itself; eval rows/s;
  an epoch under ``sparse_adam`` (dense ``LazyAdam``); 8 requests of 8192
  rows through ``ScorePredictor`` held to ``predict``. No kernel;
- phase S: ``quickstart.run`` of DeepFM, FM and LR on ml-100k at the
  repo's config (fm family: ``fmeval``, ratings binarized at 3.0; early
  stopping on validation AUC, patience 10), test AUC held to each model's
  JAX band (``recstudio_torch/assets/{deepfm,fm,lr}_ml100k_train_
  reference.json``), one epoch profiled, every test row served through
  ``ScorePredictor(max_batch=256)``, whose probabilities must be
  ``evaluate``'s. No kernel;
- each kernel against its plain PyTorch version on the phases' shapes,
  with its time, the plain version's, PyTorch's own call where one exists,
  and the card's bound for the same work.

Launch counts are zeroed before each phase and read after it; a kernel of
a phase that was not launched in it fails the run. Every failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "recstudio_torch", "assets", "sasrec_ml100k_reference.json")
TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                               "sasrec_ml100k_train_reference.json")
BERT4REC_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "bert4rec_ml100k_train_reference.json")
BPR_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                   "bpr_ml100k_train_reference.json")
NARM_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                    "narm_ml100k_train_reference.json")
STAMP_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                     "stamp_ml100k_train_reference.json")
MULTIDAE_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "multidae_ml100k_train_reference.json")
MULTIVAE_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                        "multivae_ml100k_train_reference.json")
CRITEO_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                      "deepfm_criteo1m_train_reference.json")
RANKER_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
                                      "{}_ml100k_train_reference.json")
SAVE_DIR = os.path.join(REPO, "build", "recstudio_torch", "saved")

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth. Both kernels compute in float32 on the SIMT cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL_K1 = (1e-4, 1e-4)      # (atol, rtol): float32 sums of <= 1024 terms, then LayerNorm
TOL_K3 = (2e-5, 1e-4)      # float32 sums of <= 512 terms; outputs are averages of v
# K4: float32 sums of <= 2048 terms, outputs averages of v; its row
# statistics (max, sum) to 1e-4
TOL_K4 = (2e-5, 1e-4)
TOL_STATS = (1e-4, 1e-4)
TOL_SCORES = 1e-4          # served scores: dot products of O(1) vectors, d <= 128
# gradients (K2, phase D): float32 sums of up to B L = 204,800 terms in
# another order than cuBLAS's; per tensor, relative to its largest value
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)
TOL_LOSS = 1e-5            # phase D loss, relative
TOL_METRIC = 1e-6          # phase E: served NDCG@10 against evaluate()'s
# phase J: one row-sparse lazy-Adam step against the dense step, per
# tensor, relative to its largest magnitude: the two sum a row's duplicate
# lookups in other orders, float32
TOL_LAZY = (1e-6, 1e-5)    # (atol as a share of max |x|, rtol)
# logZ (K7): logsumexp of up to 500,000 float32 terms, each thread summing
# its share in order; values near 10
TOL_LOGZ = (1e-4, 1e-5)
# the GRU layer's outputs through cuDNN against its time loop (phase K):
# float32 sums in another order over 200 steps of |h| < 1; TF32 products
# (10-bit mantissas) miss it by orders of magnitude
TOL_GRU = (2e-5, 1e-4)     # (atol, rtol)
# served CTR probabilities against predict()'s or evaluate()'s: the same
# weights, the MLP's products at another batch size
TOL_PROB = 1e-5
# phase R: the JAX seeds' AUC band after its epochs must sit this far above
# the untrained model's AUC, or the gate could not tell a model that learns
AUC_MARGIN = 0.1
CLSE_KERNELS = ("catalog_logsumexp_fwd", "catalog_logsumexp_dq", "catalog_logsumexp_ditems")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload)}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attended_pairs(pad, attn=None) -> int:
    """(example, query, key) triples that attention must weigh on these
    masks (``attn`` None: no attention mask): the allowed keys of each
    query row, or all Lk keys of a row whose keys are all masked (it
    averages them). Masked-out pairs need no work."""
    L = pad.shape[1]
    allowed = ~pad[:, None, :].expand(-1, L, -1)         # [B, Lq, Lk]
    if attn is not None:
        allowed = allowed & ~attn[None]
    per_row = allowed.sum(-1)
    return int(per_row.masked_fill(per_row == 0, pad.shape[1]).sum())


def errors(got, want, tol):
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= tol[0] + tol[1] * want.abs()).all())
    return max_abs, max_rel, ok


def right_padding(rng, B: int, L: int, min_len: int = 1):
    """bool [B, L] key-padding mask of right-padded rows of length >= min_len."""
    import numpy as np
    lens = rng.integers(min_len, L + 1, size=B)
    return np.arange(L)[None, :] >= lens[:, None]


def layer_params(tree_layer, device):
    from recstudio_torch.utils.convert import layer_params_from_jax
    return {name: t.to(device) for name, t in layer_params_from_jax(tree_layer).items()}


def build_model(dataset_name, data_config, embed_dim, seed, device):
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
    cls, conf = get_model("SASRec")
    conf["model"]["embed_dim"] = embed_dim
    ds = cls._get_dataset_class()(dataset_name, config=data_config)
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    mc = conf["model"]
    tree = random_sasrec_params(seed, ds.num_items, embed_dim, ds.max_seq_len,
                                mc["hidden_size"], mc["layer_num"])
    model.load_state_dict(params_from_jax(tree))
    return model, conf, ds, tst, tree


def serve_split(pred, model, split, batch_size):
    """Serve every row of ``split`` in requests of ``batch_size``; returns
    (scores, ids, targets) as numpy over the true rows."""
    import numpy as np
    scores, ids, targets = [], [], []
    for batch in split.eval_loader(batch_size):
        n = int(batch["_size"])
        req = {f: batch[f][:n] for f in sorted(model.query_fields)}
        s, i = pred(req)
        scores.append(s)
        ids.append(i)
        targets.append(batch[model.fiid][:n])
    return np.concatenate(scores), np.concatenate(ids), np.concatenate(targets)


def rank_metrics(ids, targets):
    """NDCG@10 and Recall@10 of served lists against one target a row
    ``[n]`` or several ``[n, T]`` (0 = pad)."""
    import torch
    from recstudio_torch import eval as ev
    ids_t = torch.as_tensor(ids)
    tgt = torch.as_tensor(targets)
    if tgt.dim() == 1:
        tgt = tgt[:, None]
    hit = ev.hit_matrix(ids_t, tgt)
    rating = (tgt > 0).float()
    return {"ndcg@10": float(ev.ndcg(hit, rating, 10).mean()),
            "recall@10": float(ev.recall(hit, rating, 10).mean())}


def request_breakdown(pred, model, batch, p50_ms: float):
    """Device time (CUDA events) of each stage of one full request: copy in,
    query encoding (the transformer layers), catalog scores, history mask +
    top-k; and their sum's share of the request's host-clock p50."""
    import torch
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    padded, _ = pred._pad({f: batch[f] for f in sorted(model.query_fields)})
    dev = batch_to_device(padded, model.device)
    feat = model._get_query_feat(dev)
    user_hist = pred._hist[dev[model.fuid].to(torch.long)]
    items = model.states["item_vector"]
    with torch.no_grad():
        q = model.net.encode_query(feat)
        scores = model.score_func.catalog(q, items)
        out = {"copy_in_ms": time_ms(lambda: batch_to_device(padded, model.device)),
               "encode_ms": time_ms(lambda: model.net.encode_query(feat)),
               "score_ms": time_ms(lambda: model.score_func.catalog(q, items)),
               "mask_topk_ms": time_ms(lambda: model._topk_from_scores(scores, pred.k,
                                                                       user_hist))}
    out["device_share_of_p50"] = sum(out.values()) / p50_ms
    return out


def plain_serving_diffs(pred, model, split, layers, n_requests=2, batch_size=256):
    """Serve the first ``n_requests`` requests of ``split`` on the kernel path
    and on the plain path (``layer.plain``) with the same weights: (rows
    whose lists disagree, rows compared, largest score difference)."""
    import numpy as np
    from recstudio_torch.utils.parity import topk_mismatches
    bad = n_cmp = 0
    max_diff = 0.0
    for batch in itertools.islice(split.eval_loader(batch_size), n_requests):
        req = {f: batch[f] for f in sorted(model.query_fields)}
        s_k, i_k = pred(req)
        for layer in layers:
            layer.plain = True
        s_p, i_p = pred(req)
        for layer in layers:
            layer.plain = False
        bad += topk_mismatches(i_k, s_k, i_p, s_p, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_k - s_p).max()))
        n_cmp += len(i_k)
    return bad, n_cmp, max_diff


def counted(fn):
    """Run ``fn`` with every launch count zeroed first; return (result,
    counts): the kernels', and ``gru_layer_cudnn``, the GRU layers that went
    through cuDNN."""
    import torch
    from recstudio_torch import ops
    from recstudio_torch.models.module.layers import gru_layer
    ops.reset_launch_counts()
    gru_layer.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {**ops.launch_counts(), "gru_layer_cudnn": gru_layer.launches}


# ---------------------------------------------------------------------------
def phase_a(device):
    import numpy as np
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    with open(REFERENCE) as f:
        ref = json.load(f)
    model, conf, ds, tst, _ = build_model("ml-100k", None, 64, ref["seed"], device)
    mc = conf["model"]
    shape = dict(embed_dim=model.embed_dim, hidden=mc["hidden_size"], heads=mc["head_num"],
                 layers=mc["layer_num"], act=mc["activation"], eps=mc["layer_norm_eps"],
                 L=ds.max_seq_len, items=ds.num_items)
    check(shape == dict(embed_dim=64, hidden=128, heads=2, layers=2, act="gelu",
                        eps=1e-12, L=20, items=1575), f"phase A config {shape}")
    pred = Predictor(model, max_batch=128, k=20, train_data=tst).warm()
    (scores, ids, targets), counts = counted(lambda: serve_split(pred, model, tst, 128))
    n_ref = len(ref["user_ids"])
    check(np.array_equal(tst.data_index[:n_ref, 0], ref["user_ids"]), "reference users differ")
    bad = topk_mismatches(ids[:n_ref], scores[:n_ref], np.asarray(ref["item_ids"]),
                          np.asarray(ref["scores"]), TOL_SCORES)
    max_diff = float(np.abs(scores[:n_ref] - np.asarray(ref["scores"])).max())
    out = {"phase": "A", "dataset": "ml-100k", "config": shape, "users": len(ids),
           "launches": counts, **pred.stats(), **rank_metrics(ids, targets),
           "breakdown": request_breakdown(pred, model, next(iter(tst.eval_loader(128))),
                                        pred.stats()["p50_ms"]),
           "reference_rows": n_ref, "reference_rows_disagreeing": bad,
           "reference_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase A launched no fused layer")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase A scores")
    check(bad == 0, f"phase A: {bad} of {n_ref} lists disagree with the JAX reference")
    return out


def phase_b(device):
    import numpy as np
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.serving import Predictor
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = 200
    model, conf, ds, tst, _ = build_model(name, config, 128, 7, device)
    etl_s = time.perf_counter() - t0
    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    # the same weights through the plain path, on the first two requests
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst,
                                               model.query_encoder.transformer.layers)
    out = {"phase": "B", "dataset": name, "users": ds.num_users - 1, "items": ds.num_items - 1,
           "inters": int(ds.num_inters), "L": ds.max_seq_len, "embed_dim": model.embed_dim,
           "etl_s": etl_s, "served": len(ids), "launches": counts, **stats,
           **rank_metrics(ids, targets),
           "breakdown": request_breakdown(pred, model, next(iter(tst.eval_loader(256))),
                                        stats["p50_ms"]),
           "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase B launched no fused layer")
    check(np.isfinite(scores).all(), "phase B scores not finite")
    check(bad == 0, f"phase B: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def phase_c(device):
    import numpy as np
    import torch
    from recstudio_torch.models.module import TransformerLayer
    from recstudio_torch.utils.convert import random_sasrec_params
    B, L, D, F, H = 64, 384, 128, 128, 2
    tree = random_sasrec_params(11, 2, D, 1, F, 1)
    layer = TransformerLayer(D, H, F, 0.0, "gelu", 1e-12)
    with torch.no_grad():
        for name, value in layer_params(tree["query_encoder"]["transformer"]["layer_0"],
                                        "cpu").items():
            getattr(layer, name).copy_(value)
    layer.to(device).eval()
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device)
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1)
    with torch.no_grad():
        got, counts = counted(lambda: layer(x, pad, causal))
        layer.plain = True
        want = layer(x, pad, causal)
        layer.plain = False
    max_abs, max_rel, ok = errors(got, want, TOL_K1)
    out = {"phase": "C", "shape": dict(B=B, L=L, D=D, F=F, H=H), "launches": counts,
           "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K1}
    emit("PHASE", out)
    check(counts["fused_mha"] > 0, "phase C launched no attention kernel")
    check(counts["fused_transformer_layer"] == 0, "phase C went to the fused layer")
    check(ok and torch.isfinite(got).all(), f"phase C layer disagrees with plain: {max_abs}")
    return out


def grad_errors(got, want):
    """(max abs error, ok) of gradient tensors by name, each held to
    TOL_GRAD relative to its own largest magnitude."""
    max_abs, ok = 0.0, True
    for name, w in want.items():
        diff = (got[name] - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        ok &= bool((diff <= TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs()).all())
    return max_abs, ok


def training_model(device, model_name, batch_size, L=200, **model_conf):
    """``model_name`` on the synthetic ml-1m shape at ``max_seq_len`` L,
    seed 7, ready for optimizer steps on device-resident batches: (model,
    conf, dataset, test split, dataset name, ETL seconds)."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = L
    cls, conf = get_model(model_name)
    conf["model"].update(model_conf)
    conf["train"].update(batch_size=batch_size, seed=7)
    ds = cls._get_dataset_class()(name, config=config)
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device=device)
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    return model, conf, ds, tst, name, time.perf_counter() - t0


def epoch_stream(model):
    """Device-resident batches, one epoch after another (a split of users
    gives fewer batches an epoch than the timed steps take)."""
    while True:
        yield from model._epoch_batches()


def timed_steps(model, batches, n=20, warmup=3):
    """``warmup`` optimizer steps, then ``n`` timed ones (host clock around
    ``_grad_step`` and a synchronize): (the timed batches, sorted step ms,
    losses, launch counts of the timed steps)."""
    import torch
    model.net.train()
    for _ in range(warmup):                             # allocator, first launches
        model._grad_step(next(batches))
    torch.cuda.synchronize()
    steps = [next(batches) for _ in range(n)]

    def run():
        times, losses = [], []
        for batch in steps:
            t = time.perf_counter()
            losses.append(model._grad_step(batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times, torch.stack(losses)

    (times, losses), counts = counted(run)
    return steps, sorted(times), losses, counts


def path_loss_and_grads(model, batch, states, set_path, *path):
    """One training step's loss and gradients from the generator ``states``
    on the path that ``set_path(*path)`` selects."""
    model.generator.set_state(states[0])
    model.device_generator.set_state(states[1])
    set_path(*path)
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def steps_and_comparison(model, set_path, *plain_paths):
    """20 timed steps on device-resident batches (their peak memory alone),
    then the last timed batch's loss and gradients on the kernel path
    (``set_path(False)``) and on each of ``plain_paths`` (argument tuples of
    ``set_path``) from the same generator states, with those steps' own
    peak memory. Returns (metrics, losses of the timed steps, their launch
    counts, [(loss, max gradient error, gradients ok) per plain path]);
    the model is left on the kernel path, in eval mode."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = steps[-1]
    states = (model.generator.get_state(), model.device_generator.get_state())
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = path_loss_and_grads(model, batch, states, set_path, False)
    compared = []
    for path in plain_paths:
        loss, grads = path_loss_and_grads(model, batch, states, set_path, *path)
        compared.append((loss, *grad_errors(grads_k, grads)))
        del grads
    compare_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    set_path(False)
    model.net.eval()
    p50 = times[len(times) // 2]
    metrics = {"steps": len(times), "step_ms_p50": p50, "step_ms_max": times[-1],
               "examples_per_s": int(model.config["train"]["batch_size"]) / (p50 / 1e3),
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "kernel_loss": loss_k, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
               "peak_mem_gb": step_peak, "compare_peak_mem_gb": compare_peak}
    return metrics, losses, counts, compared


def input_mask_ms(device, B, L, D, p):
    """Time of the step's one plain-PyTorch mask: the embedded sequence's
    dropout (``ops/dropout.keep_scale``)."""
    from recstudio_torch.ops.dropout import SITE_INPUT, keep_scale
    return time_ms(lambda: keep_scale((B, L, D), p, 1, SITE_INPUT, device), iters=5)


def phase_d(device):
    """SASRec training at full width: timed steps, and one step held to the
    plain path."""
    import torch
    model, conf, ds, _, name, etl_s = training_model(device, "SASRec", 1024, embed_dim=128)
    mc = conf["model"]
    shape = dict(B=conf["train"]["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout_rate"])
    check(shape == dict(B=1024, L=200, D=128, F=128, H=2, layers=2, dropout=0.5),
          f"phase D config {shape}")
    batches = model._epoch_batches()
    _, times, losses, counts = timed_steps(model, batches)

    # one step's loss and gradients, kernel path against plain path
    batch = next(batches)
    layers = model.query_encoder.transformer.layers
    states = (model.generator.get_state(), model.device_generator.get_state())

    def set_path(plain):
        for layer in layers:
            layer.plain = plain

    loss_k, grads_k = path_loss_and_grads(model, batch, states, set_path, False)
    loss_p, grads_p = path_loss_and_grads(model, batch, states, set_path, True)
    set_path(False)
    model.net.eval()
    max_abs, ok = grad_errors(grads_k, grads_p)
    p50 = times[len(times) // 2]
    out = {"phase": "D", "dataset": name, "shape": shape, "etl_s": etl_s, "steps": len(times),
           "launches": counts, "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": 1024 / (p50 / 1e3),
           "input_dropout_mask_ms": input_mask_ms(device, 1024, shape["L"], shape["D"], 0.5),
           "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "plain_loss": loss_p, "kernel_loss": loss_k,
           "grad_max_abs_err": max_abs, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit("PHASE", out)
    check(counts["fused_transformer_layer"] > 0, "phase D launched no fused layer")
    check(counts["fused_transformer_layer_bwd"] > 0, "phase D launched no fused backward")
    check(bool(torch.isfinite(losses).all()), "phase D loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase D loss {loss_k} vs {loss_p}")
    check(ok, f"phase D gradients disagree with the plain path: {max_abs}")
    return out


TRANSFORMER_KEYS = {"hidden": "hidden_size", "heads": "head_num", "layers": "layer_num"}


def fit_phase(device, tag, model_name, reference, model_keys, expected, kernels,
              quickstart=False):
    """fit + evaluate on ml-100k at the repo's config for the reference's
    epochs (through ``quickstart.run`` with ``quickstart``), test NDCG@10
    held to the JAX seeds' band, then every test user served from the
    trained weights in requests of the eval batch (8 of 128 at ml-100k).
    ``model_keys`` names the ``model`` config keys checked against
    ``expected`` besides the width, L (a sequence model's), batch and
    epochs. With no ``kernels`` named, the phase must launch none."""
    import numpy as np
    from recstudio_torch.data import UserDataset
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model
    with open(reference) as f:
        ref = json.load(f)

    def serve(model, trn, tst):
        # requests of the eval batch, masked as evaluate() masks: the test
        # split's history table, or a user model's history window (its
        # training items: the train split's table)
        size = int(model.config["eval"]["batch_size"])
        hist = trn if isinstance(tst, UserDataset) else tst
        pred = Predictor(model, max_batch=size, k=20, train_data=hist).warm()
        return pred, serve_split(pred, model, tst, size)

    def drive():
        t0 = time.perf_counter()
        if quickstart:
            model, (trn, _, tst), result = run(
                model_name, "ml-100k", verbose=False, device=device,
                model_config={"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}})
        else:
            cls, conf = get_model(model_name)
            conf["train"]["epochs"] = ref["epochs"]
            conf["eval"]["save_path"] = SAVE_DIR
            trn, val, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
            model = cls(conf, device=device)
            model.fit(trn, val)
            result = model.evaluate(tst, verbose=False)
        run_s = time.perf_counter() - t0
        return (model, result, run_s, len(tst.data_index)) + serve(model, trn, tst)

    (model, result, run_s, users, pred, (scores, ids, targets)), counts = counted(drive)
    mc, tc = model.config["model"], model.config["train"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[v] for k, v in model_keys.items()},
                 batch=tc["batch_size"], epochs=tc["epochs"])
    if hasattr(model, "max_seq_len"):
        shape["L"] = model.max_seq_len
    shape.update({k: tc[k] for k in ("mask_ratio", "weight_decay") if k in expected})
    check(shape == dict(expected, epochs=ref["epochs"]), f"phase {tag} config {shape}")
    served = rank_metrics(ids, targets)
    lo, hi = ref["ndcg@10_band"]
    out = {"phase": tag, "model": model_name, "dataset": "ml-100k",
           "entry": "quickstart.run" if quickstart else "fit", "config": shape,
           "launches": counts, "run_s": run_s,
           "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
           "best_epoch": model.callback.best_epoch,
           "epochs": [{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in e.items()} for e in model.epoch_log],
           "test_ndcg@10": result["ndcg@10"], "test_recall@10": result["recall@10"],
           "jax_band_ndcg@10": [lo, hi], "jax_runs": ref["runs"],
           "requests": pred.stats()["requests"], "served_ndcg@10": served["ndcg@10"],
           "served_recall@10": served["recall@10"], **{"serve_" + k: v for k, v in
                                                       pred.stats().items()}}
    if "untrained_ndcg@10" in ref:
        out["jax_untrained_ndcg@10"] = ref["untrained_ndcg@10"]
    if quickstart:              # the card's busy share of one more epoch, profiled
        train_s = sorted(e["train_s"] for e in model.epoch_log)
        epoch_s = train_s[len(train_s) // 2]
        host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
        steps = -(-model._epoch_rows // tc["batch_size"])
        out.update(epoch_s_p50=epoch_s, steps_per_epoch=steps, step_ms_p50=epoch_s / steps * 1e3,
                   profiled_epoch_host_ms=host_ms, profiled_epoch_busy_ms=busy_ms,
                   busy_share_of_epoch=None if busy_ms is None else busy_ms / (epoch_s * 1e3))
    emit("PHASE", out)
    for name in kernels:
        check(counts[name] > 0, f"phase {tag} launched no {name}")
    if not kernels:
        check(not any(counts.values()), f"phase {tag} launched a kernel: {counts}")
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log), f"phase {tag} loss")
    check(lo <= result["ndcg@10"] <= hi,
          f"phase {tag} test NDCG@10 {result['ndcg@10']} outside the JAX band [{lo}, {hi}]")
    requests = -(-users // pred.max_batch)
    check(pred.stats()["requests"] == requests,
          f"phase {tag} served {pred.stats()['requests']} requests, not {requests}")
    check(abs(served["ndcg@10"] - result["ndcg@10"]) <= TOL_METRIC and
          abs(served["recall@10"] - result["recall@10"]) <= TOL_METRIC,
          f"phase {tag}: served lists do not come from the evaluated (trained) weights")
    return out


def phase_e(device):
    """SASRec: fit + evaluate on ml-100k at the repo's config, then serve."""
    return fit_phase(device, "E", "SASRec", TRAIN_REFERENCE,
                     dict(TRANSFORMER_KEYS, dropout="dropout_rate"),
                     dict(embed_dim=64, hidden=128, heads=2, layers=2, dropout=0.5, L=20,
                          batch=512), ["fused_transformer_layer_bwd"])


def phase_f(device):
    """BERT4Rec training and serving at full width: timed steps, one step
    held to the plain path and to the materialized path, every user served."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "BERT4Rec", 256)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim, F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout"],
                 mask_ratio=tc["mask_ratio"], items=ds.num_items - 1)
    check(shape == dict(B=256, L=200, D=64, F=128, H=2, layers=2, dropout=0.2, mask_ratio=0.2,
                        items=3706), f"phase F config {shape}")
    check(model._use_fused_softmax(), "phase F does not take the fused softmax step")
    layers = model.query_encoder.transformer.layers

    def set_path(plain, fused="auto"):
        for layer in layers:
            layer.plain = plain
        model.config["train"]["fused_softmax"] = fused

    # one step's loss and gradients on the kernel path, held to the plain
    # path (plain layers, materialized scores with their autograd backward)
    # and to the kernel layers with materialized scores
    metrics, losses, train_counts, ((loss_p, max_abs, ok), (loss_m, _, _)) = \
        steps_and_comparison(model, set_path, (True, "false"), (False, "false"))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, layers)
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": "F", "model": "BERT4Rec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "train_launches": train_counts, **metrics,
           "input_dropout_mask_ms": input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                  shape["dropout"]),
           "plain_loss": loss_p, "materialized_loss": loss_m, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    for kernel in ("fused_transformer_layer", "fused_transformer_layer_bwd",
                   "catalog_logsumexp_fwd", "catalog_logsumexp_dq", "catalog_logsumexp_ditems"):
        check(train_counts[kernel] > 0, f"phase F training launched no {kernel}")
    check(serve_counts["fused_transformer_layer"] > 0, "phase F serving launched no fused layer")
    check(bool(torch.isfinite(losses).all()), "phase F loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase F loss {loss_k} vs {loss_p}")
    check(abs(loss_k - loss_m) <= TOL_LOSS * abs(loss_m),
          f"phase F loss {loss_k} vs the materialized path's {loss_m}")
    check(ok, f"phase F gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase F scores")
    check(bad == 0, f"phase F: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def phase_g(device):
    """BERT4Rec: fit + evaluate on ml-100k at the repo's config, then serve."""
    return fit_phase(device, "G", "BERT4Rec", BERT4REC_TRAIN_REFERENCE,
                     dict(TRANSFORMER_KEYS, dropout="dropout"),
                     dict(embed_dim=64, hidden=128, heads=2, layers=2, dropout=0.2, L=20,
                          batch=512, mask_ratio=0.2, weight_decay=1e-5),
                     ["fused_transformer_layer", "fused_transformer_layer_bwd",
                      "catalog_logsumexp_fwd", "catalog_logsumexp_dq",
                      "catalog_logsumexp_ditems"])


def phase_h(device):
    """Long-sequence SASRec (L 1024, dropout 0): timed training steps whose
    attention runs K4, K5 and K6; one step held to the plain path; every
    user served through K4, two requests held to the plain path."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "SASRec", 256, L=1024,
                                                       embed_dim=128, dropout_rate=0.0)
    mc = conf["model"]
    shape = dict(B=conf["train"]["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 F=mc["hidden_size"], H=mc["head_num"], layers=mc["layer_num"],
                 act=mc["activation"], eps=mc["layer_norm_eps"], dropout=mc["dropout_rate"],
                 items=ds.num_items - 1)
    check(shape == dict(B=256, L=1024, D=128, F=128, H=2, layers=2, act="gelu", eps=1e-12,
                        dropout=0.0, items=3706), f"phase H config {shape}")
    layers = model.query_encoder.transformer.layers

    def set_path(plain):
        for layer in layers:
            layer.plain = plain

    # one step's loss and gradients, kernel path against plain path
    metrics, losses, train_counts, ((loss_p, max_abs, ok),) = \
        steps_and_comparison(model, set_path, (True,))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, layers)
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": "H", "model": "SASRec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "train_launches": train_counts, "serve_launches": serve_counts,
           **metrics, "plain_loss": loss_p, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "plain_rows": n_cmp, "plain_rows_disagreeing": bad,
           "plain_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    for kernel in ("flash_mha_fwd", "flash_mha_bwd_dq", "flash_mha_bwd_dkv"):
        check(train_counts[kernel] > 0, f"phase H training launched no {kernel}")
    check(serve_counts["flash_mha_fwd"] > 0, "phase H serving launched no flash_mha_fwd")
    for kernel in ("fused_transformer_layer", "fused_mha"):
        check(counts[kernel] == 0, f"phase H launched {kernel} at L 1024")
    check(bool(torch.isfinite(losses).all()), "phase H loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p), f"phase H loss {loss_k} vs {loss_p}")
    check(ok, f"phase H gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase H scores")
    check(bad == 0, f"phase H: {bad} of {n_cmp} lists differ between kernel and plain paths")
    return out


def busy_share(fn):
    """Run ``fn`` under ``torch.profiler``: (host ms, the card's busy ms,
    the union of its kernel and copy intervals). Busy ms is None when the
    profiler records no device activity. The intervals are read from the
    profiler's raw events (ns; ``kineto_results``, which torch 2.11 keeps
    and which is not public API): building its Python event tree takes
    about a minute for an epoch of a few hundred thousand events. A torch
    without them fails the run rather than measure another way."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    raw = getattr(prof.profiler, "kineto_results", None)
    check(raw is not None and hasattr(raw, "events"),
          f"torch {torch.__version__}'s profiler keeps no raw kineto results: busy_share "
          "reads them (torch 2.11 does)")
    spans = sorted((e.start_ns(), e.end_ns()) for e in raw.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return host_ms, (busy / 1e6 if spans else None)


def multi_target_ndcg(ids, targets, k):
    """NDCG@k of served lists against multi-target rows ``[n, T]`` (0 = pad)."""
    import torch
    from recstudio_torch import eval as ev
    tgt = torch.as_tensor(targets)
    return float(ev.ndcg(ev.hit_matrix(torch.as_tensor(ids), tgt), (tgt > 0).float(), k).mean())


def cpu_copy(model, train_split):
    """The same model on the CPU, holding the card's weights."""
    cpu = type(model)(model.config, device="cpu")
    cpu._init_model(train_split)
    cpu.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    return cpu


def step_on(model, batch, neg):
    """One training step's loss and gradients with the negatives ``neg``."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    import torch
    zeros = torch.zeros(neg.shape, device=neg.device)
    model.sampling = lambda *a, **k: (None, neg, zeros)
    try:
        model.net.train()
        model.net.zero_grad(set_to_none=True)
        loss = model.training_step(batch)
        loss.backward()
        zero_pad_rows_in_grads(model.net)
    finally:
        del model.sampling
        model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def phase_i(device):
    """BPR: quickstart.run on ml-100k at the repo's config, test NDCG@5 held
    to the JAX band, one step held to the CPU copy, 8 requests served."""
    import numpy as np
    import torch
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    with open(BPR_TRAIN_REFERENCE) as f:
        ref = json.load(f)
    overrides = {"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}}

    def drive():
        t0 = time.perf_counter()
        model, splits, result = run("BPR", "ml-100k", model_config=overrides, verbose=False,
                                    device=device)
        run_s = time.perf_counter() - t0
        pred = Predictor(model, max_batch=128, k=20, train_data=splits[2]).warm()
        return model, splits, result, run_s, pred, serve_split(pred, model, splits[2], 128)

    (model, (trn, val, tst), result, run_s, pred, (scores, ids, targets)), counts = \
        counted(drive)
    tc, mc = model.config["train"], model.config["model"]
    shape = dict(embed_dim=model.embed_dim, batch=tc["batch_size"], learner=tc["learner"],
                 negatives=tc["negative_count"], split=model.config["data"]["split_ratio"],
                 eval_batch=model.config["eval"]["batch_size"], epochs=tc["epochs"],
                 users=trn.num_users - 1, items=trn.num_items - 1)
    check(shape == dict(embed_dim=64, batch=512, learner="adam", negatives=1,
                        split=[0.8, 0.1, 0.1], eval_batch=20, epochs=ref["epochs"],
                        users=943, items=1574), f"phase I config {shape}")
    steps = -(-len(trn.data_index) // tc["batch_size"])
    train_s = sorted(e["train_s"] for e in model.epoch_log)
    epoch_s = train_s[len(train_s) // 2]
    # the card's busy share of one more epoch, profiled
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))

    # one step on the card held to the same model on the CPU
    batch = next(model._epoch_batches())
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    neg = torch.randint(1, trn.num_items, (tc["batch_size"], 1), generator=gen, device=device)
    loss_k, grads_k = step_on(model, batch, neg)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = step_on(cpu, {k: v.cpu() for k, v in batch.items()}, neg.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)

    served = multi_target_ndcg(ids, targets, 5)
    lo, hi = ref["ndcg@5_band"]
    out = {"phase": "I", "model": "BPR", "dataset": "ml-100k", "entry": "quickstart.run",
           "config": shape, "launches": counts, "run_s": run_s,
           "epochs_run": len(model.epoch_log), "best_epoch": model.callback.best_epoch,
           "steps_per_epoch": steps, "epoch_s_p50": epoch_s,
           "step_ms_p50": epoch_s / steps * 1e3,
           "examples_per_s": steps * tc["batch_size"] / epoch_s,
           "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
           "test_ndcg@5": result["ndcg@5"], "test_recall@5": result["recall@5"],
           "test_ndcg@20": result["ndcg@20"], "jax_band_ndcg@5": [lo, hi],
           "jax_runs": ref["runs"], "cpu_loss": loss_c, "card_loss": loss_k,
           "grad_max_abs_err": max_abs, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "requests": pred.stats()["requests"], "served_ndcg@5": served,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log), "phase I loss")
    check(lo <= result["ndcg@5"] <= hi,
          f"phase I test NDCG@5 {result['ndcg@5']} outside the JAX band [{lo}, {hi}]")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase I loss {loss_k} vs {loss_c}")
    check(ok, f"phase I gradients disagree with the CPU copy's: {max_abs}")
    check(pred.stats()["requests"] == 8, "phase I served other than 8 requests")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase I scores")
    check(abs(served - result["ndcg@5"]) <= TOL_METRIC,
          "phase I: served lists do not come from the evaluated (trained) weights")
    return out


def lazy_state(model):
    """Parameters, lazy-Adam moments and step count, cloned."""
    opt = model.optimizer
    out = {}
    for n, p in model.net.named_parameters():
        mu, nu = opt.moments(p)
        out[n], out[n + ".mu"], out[n + ".nu"] = p.detach().clone(), mu.clone(), nu.clone()
    return out, opt.param_groups[0]["count"]


def set_lazy_state(model, state):
    import torch
    tensors, count = state
    with torch.no_grad():
        for n, p in model.net.named_parameters():
            mu, nu = model.optimizer.moments(p)
            p.copy_(tensors[n])
            mu.copy_(tensors[n + ".mu"])
            nu.copy_(tensors[n + ".nu"])
    for group in model.optimizer.param_groups:
        group["count"] = count


def phase_j(device):
    """BPR at the scale shape: timed epochs under adam, dense lazy Adam and
    the row-sparse step; one row-sparse step held to the dense step and to
    itself; full-catalog evaluation; every user served."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model, seed_everything
    from recstudio_torch.utils.parity import topk_mismatches
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    cls, conf = get_model("BPR")
    seed_everything(2022)
    ds = cls._get_dataset_class()(name, config=config)
    trn, val, tst = ds.build(**conf["data"])
    etl_s = time.perf_counter() - t0
    conf["train"].update(batch_size=8192)
    conf["eval"].update(batch_size=512, cutoff=[20], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    n = len(trn.data_index)
    steps = -(-n // 8192)
    check((ds.num_users - 1, ds.num_items - 1, ds.num_inters) == (6040, 3706, 1_000_209),
          f"phase J dataset {ds.num_users - 1} x {ds.num_items - 1} x {ds.num_inters}")

    def build(learner, sparse_rows):
        c = json.loads(json.dumps(conf))
        c["train"].update(learner=learner, sparse_rows=sparse_rows)
        m = cls(c, device=device)
        m._init_model(trn)
        m._init_parameter(trn)
        m.optimizer = m._get_optimizer()
        m._setup_scan_epoch(trn)
        return m

    modes, models, counts = {}, {}, None
    for mode, learner, sparse_rows in (("adam", "adam", "auto"),
                                       ("lazy_dense", "sparse_adam", "false"),
                                       ("lazy_rows", "sparse_adam", "auto")):
        model = build(learner, sparse_rows)
        check(model._sparse_rows_enabled() == (mode == "lazy_rows"),
              f"phase J {mode}: row-sparse gate")

        def epochs(model=model):
            model.training_epoch(0)                         # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = [model.training_epoch(e) for e in range(3)]
            return (time.perf_counter() - t) / 3, losses

        (epoch_s, losses), c = counted(epochs)
        counts = c if counts is None else {k: counts[k] + c[k] for k in counts}
        host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
        modes[mode] = {"epoch_s": epoch_s, "examples_per_s": n / epoch_s,
                       "step_ms": epoch_s / steps * 1e3, "losses": losses,
                       "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
                       "busy_share_of_epoch": None if busy_ms is None
                       else busy_ms / (epoch_s * 1e3)}
        check(all(np.isfinite(losses)), f"phase J {mode} loss not finite")
        models[mode] = model

    # one row-sparse step against one dense lazy-Adam step from the same
    # parameters, moments, count and generator states (so the same negatives)
    model = models["lazy_rows"]
    batch = next(model._epoch_batches())
    state = lazy_state(model)
    gens = model.device_generator.get_state()
    after = {}
    for tag, flag in (("rows", True), ("dense", False), ("rows_again", True)):
        set_lazy_state(model, state)
        model.device_generator.set_state(gens)
        model._sparse_rows_flag = flag
        model._grad_step(batch)
        after[tag] = lazy_state(model)[0]
    model._sparse_rows_flag = True
    max_abs, ok = 0.0, True
    for key, want in after["dense"].items():
        diff = (after["rows"][key] - want).abs()
        max_abs = max(max_abs, float(diff.max()))
        ok &= bool((diff <= TOL_LAZY[0] * float(want.abs().max())
                    + TOL_LAZY[1] * want.abs()).all())
    bitwise = all(torch.equal(after["rows"][k], after["rows_again"][k]) for k in after["rows"])
    touched = int((after["rows"]["item_encoder.weight"] != state[0]["item_encoder.weight"])
                  .any(-1).sum())

    # full-catalog evaluation of every test user (adam's weights)
    model = models["adam"]
    model._eval_epoch(tst, ["ndcg", "recall"], [20])       # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [20])
    eval_s = time.perf_counter() - t

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    users = np.arange(1, ds.num_users, dtype=np.int32)
    served = [pred({"user_id": users[i:i + 256]}) for i in range(0, len(users), 256)]
    stats = pred.stats()
    cpu = cpu_copy(model, trn)
    cpu_pred = Predictor(cpu, max_batch=256, k=20, train_data=tst)
    bad = n_cmp = 0
    max_diff = 0.0
    for i, (s_k, i_k) in enumerate(served[:2]):
        s_c, i_c = cpu_pred({"user_id": users[i * 256:(i + 1) * 256]})
        bad += topk_mismatches(i_k, s_k, i_c, s_c, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_k - s_c).max()))
        n_cmp += len(i_k)
    scores = np.concatenate([s for s, _ in served])
    out = {"phase": "J", "model": "BPR", "dataset": name, "users": ds.num_users - 1,
           "items": ds.num_items - 1, "inters": int(ds.num_inters), "train_rows": n,
           "batch": 8192, "steps_per_epoch": steps, "etl_s": etl_s, "launches": counts,
           "modes": modes, "lazy_step_max_abs_err": max_abs, "lazy_tol": TOL_LAZY,
           "lazy_step_bitwise_repeat": bitwise, "lazy_step_item_rows_touched": touched,
           "eval_users": len(tst.data_index), "eval_s": eval_s,
           "eval_queries_per_s": len(tst.data_index) / eval_s, **ev,
           "served_users": len(scores), **{"serve_" + k: v for k, v in stats.items()},
           "serve_max_ms": max(pred._lat_ms), "cpu_rows": n_cmp, "cpu_rows_disagreeing": bad,
           "cpu_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(ok, f"phase J: the row-sparse step disagrees with the dense lazy step: {max_abs}")
    check(bitwise, "phase J: the row-sparse step does not repeat bit for bit")
    check(touched > 0, "phase J: the row-sparse step moved no item row")
    check(np.isfinite(ev["ndcg@20"]) and np.isfinite(ev["recall@20"]), "phase J eval")
    check(np.isfinite(scores).all() and scores.shape == (len(users), 20), "phase J scores")
    check(bad == 0, f"phase J: {bad} of {n_cmp} lists differ from the CPU copy's")
    return out


def gru_versus_plain(device, gru, B, L, D, seed=2032):
    """The first layer of ``gru`` (a ``GRULayer``) forward and backward
    through cuDNN (``gru_layer``) against its time loop (``gru_layer_plain``)
    at ``[B, L, D]``: the output's and every gradient's largest error, both
    times, and, for contrast, the largest output error of cuDNN with TF32
    allowed (the ``nn.GRU``'s own forward under PyTorch's default cuDNN
    setting)."""
    import numpy as np
    import torch
    from recstudio_torch.models.module.layers import gru_layer, gru_layer_plain
    rnn = gru.layers[0]
    w = list(rnn.all_weights[0])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    x.requires_grad_()
    cot = torch.from_numpy(rng.normal(size=(B, L, rnn.hidden_size)).astype(np.float32)).to(device)

    def run(fn):
        out = fn(x, *w)
        return [out, *torch.autograd.grad(out, [x, *w], cot)]

    got, want = run(gru_layer), run(gru_layer_plain)
    torch.cuda.synchronize()
    max_abs, max_rel, ok = errors(got[0].detach(), want[0].detach(), TOL_GRU)
    grad_abs, grad_ok = grad_errors(dict(enumerate(got[1:])), dict(enumerate(want[1:])))
    c = torch.backends.cudnn
    with torch.no_grad(), c.flags(enabled=True, benchmark=c.benchmark,
                                  deterministic=c.deterministic, allow_tf32=True):
        tf32 = rnn(x)[0]
    return {"shape": dict(B=B, L=L, D=D, H=rnn.hidden_size), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "grad_max_abs_err": grad_abs, "tol": TOL_GRU,
            "grad_tol": TOL_GRAD, "ok": ok and grad_ok,
            "tf32_allowed_max_abs_err": float((tf32 - want[0]).abs().max()),
            "fwd_bwd_ms": time_ms(lambda: run(gru_layer), iters=10),
            "plain_fwd_bwd_ms": time_ms(lambda: run(gru_layer_plain), iters=3, warmup=1),
            "fwd_ms": time_ms(lambda: gru_layer(x.detach(), *w), iters=10),
            "plain_fwd_ms": time_ms(lambda: gru_layer_plain(x.detach(), *w), iters=3,
                                    warmup=1)}


def served_diffs(pred_a, pred_b, split, fields, n_requests=2, batch_size=256):
    """The first ``n_requests`` requests of ``split`` through two predictors:
    (rows whose lists disagree, rows compared, largest score difference)."""
    import numpy as np
    from recstudio_torch.utils.parity import topk_mismatches
    bad = n_cmp = 0
    max_diff = 0.0
    for batch in itertools.islice(split.eval_loader(batch_size), n_requests):
        req = {f: batch[f] for f in fields}
        (s_a, i_a), (s_b, i_b) = pred_a(req), pred_b(req)
        bad += topk_mismatches(i_a, s_a, i_b, s_b, TOL_SCORES)
        max_diff = max(max_diff, float(np.abs(s_a - s_b).max()))
        n_cmp += len(i_a)
    return bad, n_cmp, max_diff


# the model config keys a catalog-softmax phase reports and checks
CATALOG_MODEL_KEYS = ("hidden_size", "layer_num", "dropout_rate", "dropout", "encoder_dims",
                      "decoder_dims", "activation")


def catalog_softmax_phase(device, tag, model_name, expected, batch_size=512):
    """NARM, STAMP or MultiDAE training and serving at full width on the
    synthetic ml-1m shape: 20 timed steps through ``_fused_softmax_step``
    (K7, K8, K9 at one query row a sequence or a user), one step held to
    the plain path (the GRU's time loop where there is a GRU, materialized
    scores), every user served, the first two requests held to the plain
    path (NARM) or to the model copied to the CPU (STAMP and MultiDAE, whose
    serving runs no kernel and no GRU). A user model (MultiDAE) reports its
    history width W, and the bytes of the ``[B, W, D]`` rows its history
    bag sums (``F.embedding_bag`` reads them without storing them)."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, model_name, batch_size)
    mc, tc = conf["model"], conf["train"]
    width = dict(L=ds.max_seq_len) if hasattr(ds, "max_seq_len") else \
        dict(W=model.history_width)
    shape = dict(B=tc["batch_size"], **width, D=model.embed_dim,
                 items=ds.num_items - 1, lr=tc["learning_rate"], learner=tc["learner"],
                 **{k: mc[k] for k in CATALOG_MODEL_KEYS if k in mc})
    if tc.get("weight_decay"):
        shape["weight_decay"] = tc["weight_decay"]
    check({k: v for k, v in shape.items() if k != "W"} == expected,
          f"phase {tag} config {shape}")
    check(model._use_fused_softmax(), f"phase {tag} does not take the fused softmax step")
    gru = getattr(model.query_encoder, "gru", None)

    def set_path(plain, fused="auto"):
        if gru is not None:
            gru.plain = plain
        model.config["train"]["fused_softmax"] = fused

    metrics, losses, train_counts, ((loss_p, max_abs, ok),) = \
        steps_and_comparison(model, set_path, (True, "false"))
    loss_k = metrics["kernel_loss"]

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    fields = sorted(model.query_fields)
    if gru is not None:
        bad, n_cmp, max_diff = plain_serving_diffs(pred, model, tst, [gru])
        held_to = "plain path (the GRU's time loop)"
    else:
        cpu_pred = Predictor(cpu_copy(model, tst), max_batch=256, k=20, train_data=tst)
        bad, n_cmp, max_diff = served_diffs(pred, cpu_pred, tst, fields)
        held_to = "the model copied to the CPU"
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    out = {"phase": tag, "model": model_name, "dataset": name, "shape": shape, "etl_s": etl_s,
           **({"bag_bytes": 4 * shape["B"] * shape["W"] * shape["D"]} if "W" in shape else {}),
           "launches": counts, "train_launches": train_counts, "serve_launches": serve_counts,
           **metrics, "plain_loss": loss_p, "grad_max_abs_err": max_abs,
           "served": len(ids), **{"serve_" + k: v for k, v in stats.items()},
           **rank_metrics(ids, targets), "served_held_to": held_to, "held_rows": n_cmp,
           "held_rows_disagreeing": bad, "held_max_score_diff": max_diff, "tol": TOL_SCORES}
    if gru is not None:
        out["gru"] = gru_versus_plain(device, gru, shape["B"], shape["L"], shape["D"])
        out["input_dropout_mask_ms"] = input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                     mc["dropout_rate"][0])
    emit("PHASE", out)
    for kernel in CLSE_KERNELS:
        check(train_counts[kernel] > 0, f"phase {tag} training launched no {kernel}")
    if gru is not None:
        check(train_counts["gru_layer_cudnn"] > 0, f"phase {tag} ran no GRU through cuDNN")
        check(serve_counts["gru_layer_cudnn"] > 0, f"phase {tag} served no GRU through cuDNN")
        check(out["gru"]["ok"], f"phase {tag}: the cuDNN GRU disagrees with its time loop: "
                                f"{out['gru']['max_abs_err']}, {out['gru']['grad_max_abs_err']}")
    check(bool(torch.isfinite(losses).all()), f"phase {tag} loss not finite")
    check(abs(loss_k - loss_p) <= TOL_LOSS * abs(loss_p),
          f"phase {tag} loss {loss_k} vs {loss_p}")
    check(ok, f"phase {tag} gradients disagree with the plain path: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          f"phase {tag} scores")
    check(bad == 0, f"phase {tag}: {bad} of {n_cmp} lists differ from the {held_to}'s")
    return out


def phase_k(device):
    """NARM at full width: the GRU through cuDNN, K7-K9 at 512 rows."""
    return catalog_softmax_phase(device, "K", "NARM", dict(
        B=512, L=200, D=64, items=3706, lr=1e-3, learner="adam", hidden_size=128, layer_num=1,
        dropout_rate=[0.25, 0.5]))


def phase_l(device):
    """STAMP at full width: K7-K9 at 512 rows."""
    return catalog_softmax_phase(device, "L", "STAMP", dict(
        B=512, L=200, D=64, items=3706, lr=1e-3, learner="adam"))


def phase_m(device):
    """GRU4Rec at full width: timed steps (the GRU through cuDNN, no kernel
    of the port), one step held to the model copied to the CPU."""
    import torch
    model, conf, ds, tst, name, etl_s = training_model(device, "GRU4Rec", 512)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim,
                 hidden_size=mc["hidden_size"], layer_num=mc["layer_num"],
                 dropout_rate=mc["dropout_rate"], negatives=tc["negative_count"],
                 items=ds.num_items - 1)
    check(shape == dict(B=512, L=200, D=64, hidden_size=128, layer_num=1, dropout_rate=0.3,
                        negatives=1, items=3706), f"phase M config {shape}")
    check(not model._use_fused_softmax(), "phase M takes the softmax step")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, model._epoch_batches())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one step on the card held to the same model on the CPU: same batch,
    # negatives and dropout seeds (the masks are a function of the seed)
    batch = steps[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    neg = torch.randint(1, ds.num_items, (tc["batch_size"], 1), generator=gen, device=device)
    state = model.generator.get_state()
    loss_k, grads_k = step_on(model, batch, neg)
    cpu = cpu_copy(model, tst)
    cpu.generator.set_state(state)
    loss_c, grads_c = step_on(cpu, {k: v.cpu() for k, v in batch.items()}, neg.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)
    p50 = times[len(times) // 2]
    out = {"phase": "M", "model": "GRU4Rec", "dataset": name, "shape": shape, "etl_s": etl_s,
           "launches": counts, "steps": len(times), "step_ms_p50": p50,
           "step_ms_max": times[-1], "examples_per_s": tc["batch_size"] / (p50 / 1e3),
           "input_dropout_mask_ms": input_mask_ms(device, shape["B"], shape["L"], shape["D"],
                                                  shape["dropout_rate"]),
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]), "peak_mem_gb": peak,
           "card_loss": loss_k, "cpu_loss": loss_c, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS}
    emit("PHASE", out)
    check(counts["gru_layer_cudnn"] > 0, "phase M ran no GRU through cuDNN")
    check(all(v == 0 for k, v in counts.items() if k != "gru_layer_cudnn"),
          f"phase M launched a kernel: {counts}")
    check(bool(torch.isfinite(losses).all()), "phase M loss not finite")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase M loss {loss_k} vs {loss_c}")
    check(ok, f"phase M gradients disagree with the CPU copy's: {max_abs}")
    return out


def phase_n(device):
    """NARM and STAMP the way users start them, ``quickstart.run`` on
    ml-100k, held to their JAX bands."""
    return [fit_phase(device, "N", "NARM", NARM_TRAIN_REFERENCE,
                      {"hidden": "hidden_size", "layers": "layer_num",
                       "dropout": "dropout_rate"},
                      dict(embed_dim=64, hidden=128, layers=1, dropout=[0.25, 0.5], L=20,
                           batch=512), CLSE_KERNELS + ("gru_layer_cudnn",), quickstart=True),
            fit_phase(device, "N", "STAMP", STAMP_TRAIN_REFERENCE, {},
                      dict(embed_dim=64, L=20, batch=512), CLSE_KERNELS, quickstart=True)]


def phase_o(device):
    """MultiDAE at full width: K7-K9 at 256 user rows, D 200."""
    return catalog_softmax_phase(device, "O", "MultiDAE", dict(
        B=256, D=200, items=3706, lr=1e-2, learner="adam", weight_decay=1e-5, dropout=0.5,
        encoder_dims=[64, 32], decoder_dims=[32, 64], activation="relu"), batch_size=256)


def vae_step(model, batch, eps):
    """One MultiVAE training step's loss and gradients with ``eps``."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch, eps=eps)
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def phase_p(device):
    """MultiVAE at full width: timed steps (materialized scores, no kernel
    of the port), one step held to the model copied to the CPU with the same
    eps, dropout seed and anneal at its cap, every user served."""
    import numpy as np
    import torch
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(device, "MultiVAE", 500)
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], W=model.history_width, D=model.embed_dim,
                 items=ds.num_items - 1, lr=tc["learning_rate"], learner=tc["learner"],
                 weight_decay=tc["weight_decay"],
                 **{k: mc[k] for k in CATALOG_MODEL_KEYS if k in mc})
    check({k: v for k, v in shape.items() if k != "W"} == dict(
        B=500, D=600, items=3706, lr=1e-3, learner="adam", weight_decay=1e-5, dropout_rate=0.5,
        encoder_dims=[200], decoder_dims=[200], activation="tanh"), f"phase P config {shape}")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one step on the card held to the same model on the CPU: same batch,
    # eps and dropout seed (the mask is a function of the seed), the KL
    # term at its largest weight
    batch = steps[-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    eps = torch.randn((tc["batch_size"], mc["encoder_dims"][-1]), generator=gen, device=device)
    state = model.generator.get_state()
    model.states["anneal"] = float(tc["anneal_max"])
    loss_k, grads_k = vae_step(model, batch, eps)
    cpu = cpu_copy(model, tst)
    cpu.generator.set_state(state)
    cpu.states["anneal"] = float(tc["anneal_max"])
    loss_c, grads_c = vae_step(cpu, {k: v.cpu() for k, v in batch.items()}, eps.cpu())
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)

    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), serve_counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    cpu_pred = Predictor(cpu, max_batch=256, k=20, train_data=tst)
    bad, n_cmp, max_diff = served_diffs(pred, cpu_pred, tst, sorted(model.query_fields))
    p50 = times[len(times) // 2]
    out = {"phase": "P", "model": "MultiVAE", "dataset": name, "shape": shape, "etl_s": etl_s,
           "bag_bytes": 4 * shape["B"] * shape["W"] * shape["D"],
           "launches": {k: counts[k] + serve_counts[k] for k in counts},
           "train_launches": counts, "serve_launches": serve_counts, "steps": len(times),
           "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": tc["batch_size"] / (p50 / 1e3), "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "peak_mem_gb": peak, "anneal": tc["anneal_max"],
           "card_loss": loss_k, "cpu_loss": loss_c, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "served": len(ids),
           **{"serve_" + k: v for k, v in stats.items()}, **rank_metrics(ids, targets),
           "served_held_to": "the model copied to the CPU", "held_rows": n_cmp,
           "held_rows_disagreeing": bad, "held_max_score_diff": max_diff, "tol": TOL_SCORES}
    emit("PHASE", out)
    check(not any(out["launches"].values()), f"phase P launched a kernel: {out['launches']}")
    check(bool(torch.isfinite(losses).all()), "phase P loss not finite")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase P loss {loss_k} vs {loss_c}")
    check(ok, f"phase P gradients disagree with the CPU copy's: {max_abs}")
    check(np.isfinite(scores).all() and scores.shape == (len(tst.data_index), 20),
          "phase P scores")
    check(bad == 0, f"phase P: {bad} of {n_cmp} lists differ from the CPU copy's")
    return out


def phase_q(device):
    """MultiDAE and MultiVAE the way users start them, ``quickstart.run`` on
    ml-100k, held to their JAX bands."""
    keys = {"encoder_dims": "encoder_dims", "decoder_dims": "decoder_dims",
            "activation": "activation"}
    return [fit_phase(device, "Q", "MultiDAE", MULTIDAE_TRAIN_REFERENCE,
                      dict(keys, dropout="dropout"),
                      dict(embed_dim=200, encoder_dims=[64, 32], decoder_dims=[32, 64],
                           activation="relu", dropout=0.5, batch=256, weight_decay=1e-5),
                      CLSE_KERNELS, quickstart=True),
            fit_phase(device, "Q", "MultiVAE", MULTIVAE_TRAIN_REFERENCE,
                      dict(keys, dropout="dropout_rate"),
                      dict(embed_dim=600, encoder_dims=[200], decoder_dims=[200],
                           activation="tanh", dropout=0.5, batch=500, weight_decay=1e-5),
                      (), quickstart=True)]


# ---------------------------------------------------------------------------
def ranker_step(model, batch, gen_state):
    """One training step's loss and gradients from the dropout generator
    state ``gen_state``: the same seeds, so the same masks, on any device."""
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    model.generator.set_state(gen_state)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step(batch)
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.net.named_parameters()}


def eval_probs(model, split):
    """``evaluate``'s scores of a split (its staged eval batches), as
    probabilities, true rows only."""
    import torch
    with torch.no_grad():
        return torch.cat([torch.sigmoid(model.score(b))[:int(b["_size"])]
                          for b in model._eval_batches(split)]).cpu().numpy()


def criteo_setup():
    """Phase R's data and DeepFM config (the JAX bench's ``ctr_scale``):
    ``(reference, dataset, (train, val, test), DeepFM class, config, gen s,
    ETL s)``."""
    import numpy as np
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.data.synthetic import ctr_shape_vocabs, generate_ctr
    from recstudio_torch.utils import get_model
    with open(CRITEO_TRAIN_REFERENCE) as f:
        ref = json.load(f)
    shape_name, rows, B = "criteo-1m-shape", ref["rows"], ref["batch_size"]
    t0 = time.perf_counter()
    name, config = generate_ctr(shape_name, rows, seed=11, vocabs=ctr_shape_vocabs(shape_name))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.random.seed(11)
    ds = TripletDataset(name, config=config)
    splits = ds.build(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
    etl_s = time.perf_counter() - t0
    check(ds.num_inters == rows and len(ds.field2type) == 40 and ds.fuid is None,
          f"phase R dataset {ds.num_inters} rows, {len(ds.field2type)} fields")
    cls, conf = get_model("DeepFM")
    conf["train"].update(epochs=1, batch_size=B, learner="adam", learning_rate=1e-3,
                         seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)
    return ref, ds, splits, cls, conf, gen_s, etl_s


def phase_r(device):
    """DeepFM at criteo-1m-shape (the JAX bench's ``ctr_scale``): a one-epoch
    fit and four more epochs, the test AUC and logloss after the fifth held
    to the JAX bands, 20 timed steps, one step held to the CPU copy, the
    epoch's busy share, dropout masks, a sparse_adam epoch, and
    ``ScorePredictor`` at 8192 rows a request."""
    import numpy as np
    import torch
    from recstudio_torch.ops.dropout import SITE_HIDDEN, keep_scale
    from recstudio_torch.serving import ScorePredictor
    ref, ds, (trn, val, tst), cls, conf, gen_s, etl_s = criteo_setup()
    name, rows, B = ds.name, ref["rows"], ref["batch_size"]
    emb_rows = sum(ds.num_values(f) for f, t in ds.field2type.items() if t == "token")

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        log = [{"epochs": 1, **model.evaluate(tst, verbose=False)}]
        for n in range(1, ref["epochs"]):
            model.training_epoch(n)
            log.append({"epochs": n + 1, **model.evaluate(tst, verbose=False)})
        return model, fit_s, log

    (model, fit_s, test_log), counts = counted(drive)
    result = test_log[-1]
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, mlp=mc["mlp_layer"], activation=mc["activation"],
                 dropout=mc["dropout"], fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, mlp=[256, 256, 256], activation="tanh", dropout=0.3,
                        fields=39, batch=8192), f"phase R config {shape}")
    n = len(trn.data_index)
    steps = -(-n // B)

    # 20 timed steps on device-resident batches, peak memory
    batches = list(itertools.islice(model._epoch_batches(), 23))
    torch.cuda.reset_peak_memory_stats(device)
    model.net.train()
    step_ms = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model._grad_step(batch)
        torch.cuda.synchronize()
        if i >= 3:
            step_ms.append((time.perf_counter() - t) * 1e3)
    model.net.eval()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_p50 = sorted(step_ms)[len(step_ms) // 2]

    # an epoch, then the same epoch profiled
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.training_epoch(1)
    epoch_s = time.perf_counter() - t
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(2))

    # the MLP's dropout masks of one step: one before each of its 4 layers
    widths = [model.net.mlp.dense_0.in_features] + list(mc["mlp_layer"])
    mask_ms = time_ms(lambda: [keep_scale((B, w), mc["dropout"], 12345, SITE_HIDDEN, device)
                               for w in widths])

    # one step on the card held to the CPU copy (same batch, same dropout
    # seeds), and repeated on the card
    batch = batches[0]
    gen = model.generator.get_state()
    loss_k, grads_k = ranker_step(model, batch, gen)
    loss_k2, grads_k2 = ranker_step(model, batch, gen)
    bitwise = loss_k == loss_k2 and all(torch.equal(grads_k[k], grads_k2[k]) for k in grads_k)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = ranker_step(cpu, {k: v.cpu() for k, v in batch.items()}, gen)
    max_abs, ok = grad_errors({k: v.cpu() for k, v in grads_k.items()}, grads_c)
    del cpu

    # evaluation rate (the split's batches are staged)
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    eval_s = time.perf_counter() - t

    # sparse_adam (dense lazy Adam): fit's epoch warms it; a timed one, a profiled one
    lconf = json.loads(json.dumps(conf))
    lconf["train"]["learner"] = "sparse_adam"
    lazy = cls(lconf, device=device).fit(trn, None)
    lazy_loss = lazy.epoch_log[0]["train_loss"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lazy.training_epoch(1)
    lazy_epoch_s = time.perf_counter() - t
    lazy_host_ms, lazy_busy_ms = busy_share(lambda: lazy.training_epoch(2))
    lazy_opt = type(lazy.optimizer).__name__
    del lazy

    # ScorePredictor at 8192 rows a request, held to predict()
    pred = ScorePredictor(model, max_batch=B, train_data=trn)
    fields = [f for f in tst.inter_feat.fields if f != model.frating]
    starts = range(0, min(8 * B, len(tst.data_index)), B)
    requests = [{f: tst.inter_feat.get_col(f)[tst.data_index[i:i + B]] for f in fields}
                for i in starts]
    pred.warm(requests[0])
    served = [pred(r) for r in requests]
    want = [model.predict(tst._get_pos_batch(np.arange(i, i + len(r)))) for i, r in zip(
        starts, served)]
    serve_diff = max(float(np.abs(a - b).max()) for a, b in zip(served, want))

    lo, hi = ref["auc_band"]
    llo, lhi = ref["logloss_band"]
    out = {"phase": "R", "model": "DeepFM", "dataset": name, "rows": rows,
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "emb_rows": emb_rows,
           "launches": counts, "gen_s": gen_s, "etl_s": etl_s, "fit_s": fit_s,
           "fit_epoch_s": model.epoch_log[0]["train_s"], "steps_per_epoch": steps,
           "step_ms_p50": step_p50, "step_ms_min": min(step_ms),
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "epoch_s": epoch_s, "epoch_examples_per_s": n / epoch_s,
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
           "dropout_mask_ms_per_step": mask_ms,
           "dropout_mask_elements_per_step": B * sum(widths),
           "dropout_mask_share_of_step": mask_ms / step_p50,
           "one_epoch_test_auc": test_log[0]["auc"],
           "one_epoch_test_logloss": test_log[0]["logloss"], "band_epochs": ref["epochs"],
           "test_auc": result["auc"], "test_logloss": result["logloss"], "test_log": test_log,
           "jax_band_auc": [lo, hi], "jax_band_logloss": [llo, lhi],
           "jax_untrained_auc": ref["untrained_auc"],
           "jax_runs": [{k: r[k] for k in ("seed", "auc", "logloss", "untrained_auc")}
                        for r in ref["runs"]], "eval_s": eval_s,
           "eval_rows_per_s": len(tst.data_index) / eval_s,
           "cpu_loss": loss_c, "card_loss": loss_k, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "step_bitwise_repeat": bitwise,
           "sparse_adam": {"optimizer": lazy_opt, "first_epoch_loss": lazy_loss,
                           "epoch_s": lazy_epoch_s, "profiled_epoch_host_ms": lazy_host_ms,
                           "profiled_epoch_busy_ms": lazy_busy_ms,
                           "busy_share_of_epoch": None if lazy_busy_ms is None
                           else lazy_busy_ms / (lazy_epoch_s * 1e3)},
           "serve_max_abs_diff_vs_predict": serve_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase R launched a kernel: {counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and np.isfinite(lazy_loss),
          "phase R loss not finite")
    check(lo > ref["untrained_auc"] + AUC_MARGIN,
          f"phase R: the JAX band [{lo}, {hi}] does not clear the untrained AUC "
          f"{ref['untrained_auc']} by {AUC_MARGIN}")
    check(lo <= result["auc"] <= hi,
          f"phase R test AUC {result['auc']} outside the JAX band [{lo}, {hi}]")
    check(llo <= result["logloss"] <= lhi,
          f"phase R test logloss {result['logloss']} outside the JAX band [{llo}, {lhi}]")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase R loss {loss_k} vs {loss_c}")
    check(ok, f"phase R gradients disagree with the CPU copy's: {max_abs}")
    check(lazy_opt == "LazyAdam", f"phase R sparse_adam ran {lazy_opt}")
    check(serve_diff <= TOL_PROB, f"phase R ScorePredictor differs from predict by {serve_diff}")
    check(pred.stats()["requests"] == len(starts) == min(8, -(-len(tst.data_index) // B)),
          "phase R served other than 8 requests")
    return out


def phase_s(device):
    """DeepFM, FM and LR the way users start them, ``quickstart.run`` on
    ml-100k to their early stop, test AUC held to the JAX bands, one epoch
    profiled, every test row served through ``ScorePredictor``."""
    import numpy as np
    from recstudio_torch import eval as ev
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import ScorePredictor
    import torch
    outs = []
    for model_name, expected in (("DeepFM", dict(embed_dim=10, mlp=[256, 256, 256],
                                                 dropout=0.3)),
                                 ("FM", dict(embed_dim=10)), ("LR", dict(embed_dim=1))):
        with open(RANKER_TRAIN_REFERENCE.format(model_name.lower())) as f:
            ref = json.load(f)

        def drive():
            t0 = time.perf_counter()
            model, (trn, _, tst), result = run(
                model_name, "ml-100k", verbose=False, device=device,
                model_config={"train": {"epochs": ref["epochs"]},
                              "eval": {"save_path": SAVE_DIR}})
            run_s = time.perf_counter() - t0
            size = 256
            fields = ("user_id", "item_id", "timestamp")
            rows = tst.data_index
            pred = ScorePredictor(model, max_batch=size, train_data=trn)
            requests = [{f: tst.inter_feat.get_col(f)[rows[i:i + size]] for f in fields}
                        for i in range(0, len(rows), size)]
            pred.warm(requests[0])
            probs = np.concatenate([pred(r) for r in requests])
            return model, trn, tst, result, run_s, pred, probs

        (model, trn, tst, result, run_s, pred, probs), counts = counted(drive)
        mc, tc = model.config["model"], model.config["train"]
        shape = dict(embed_dim=model.embed_dim, **{k: mc[v] for k, v in (
            ("mlp", "mlp_layer"), ("dropout", "dropout")) if v in mc},
            batch=tc["batch_size"], epochs=tc["epochs"],
            patience=tc["early_stop_patience"], fmeval=trn.fmeval)
        check(shape == dict(expected, batch=512, epochs=ref["epochs"],
                            patience=ref["early_stop_patience"], fmeval=True),
              f"phase S {model_name} config {shape}")
        want = eval_probs(model, tst)
        served_diff = float(np.abs(probs - want).max())
        served_auc = float(ev.auc(torch.from_numpy(probs),
                                  torch.from_numpy(tst.inter_feat.get_col("rating")[
                                      tst.data_index])))
        train_s = sorted(e["train_s"] for e in model.epoch_log)
        epoch_s = train_s[len(train_s) // 2]
        host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
        steps = -(-model._epoch_rows // tc["batch_size"])
        lo, hi = ref["auc_band"]
        out = {"phase": "S", "model": model_name, "dataset": "ml-100k",
               "entry": "quickstart.run", "config": shape, "launches": counts,
               "run_s": run_s, "epochs_run": len(model.epoch_log),
               "best_epoch": model.callback.best_epoch,
               "fit_s": sum(e["train_s"] + e["eval_s"] for e in model.epoch_log),
               "epoch_s_p50": epoch_s, "steps_per_epoch": steps,
               "step_ms_p50": epoch_s / steps * 1e3,
               "eval_s_p50": sorted(e["eval_s"] for e in model.epoch_log)[
                   len(model.epoch_log) // 2],
               "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
               "busy_share_of_epoch": None if busy_ms is None else busy_ms / (epoch_s * 1e3),
               "test_auc": result["auc"], "test_logloss": result["logloss"],
               "jax_band_auc": [lo, hi], "jax_untrained_auc": ref["untrained_auc"],
               "jax_runs": ref["runs"], "served_rows": len(probs),
               "served_auc": served_auc, "served_max_abs_diff_vs_evaluate": served_diff,
               **{"serve_" + k: v for k, v in pred.stats().items()}}
        emit("PHASE", out)
        check(not any(counts.values()), f"phase S {model_name} launched a kernel: {counts}")
        check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log),
              f"phase S {model_name} loss")
        check(lo <= result["auc"] <= hi, f"phase S {model_name} test AUC {result['auc']} "
                                         f"outside the JAX band [{lo}, {hi}]")
        check(len(probs) == len(tst.data_index) and served_diff <= TOL_PROB,
              f"phase S {model_name}: served probabilities differ from evaluate's by "
              f"{served_diff}")
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
def causal_mask(L, device, causal=True):
    """The causal attention mask (True = disallow), or None (bidirectional)."""
    import torch
    return torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1) if causal else None


def k1_versus_plain(device, B, L, D, F, H, causal=True):
    """K1 in eval mode against the plain layer, with a bitwise repeat and
    the output tile of each of its four products (sized to the card)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.transformer_layer import (forward_tiles, fused_transformer_layer,
                                                       transformer_layer_plain)
    from recstudio_torch.utils.convert import random_sasrec_params
    rng = np.random.default_rng(B + L)
    tree = random_sasrec_params(B + L, 2, D, 1, F, 1)
    params = layer_params(tree["query_encoder"]["transformer"]["layer_0"], device)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device)
    attn = causal_mask(L, device, causal)
    kern = lambda: fused_transformer_layer(x, params, pad, attn, H, 0.0, "gelu", 1e-12, False)
    plain = lambda: transformer_layer_plain(x, params, pad, attn, H, "gelu", 1e-12)
    with torch.no_grad():
        got, want = kern(), plain()
        bitwise = torch.equal(got, kern())
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K1)
        ms, plain_ms = time_ms(kern), time_ms(plain)
    flops = 2 * B * L * D * (3 * D + D + 2 * F) + 4 * attended_pairs(pad, attn) * D
    nbytes = 4 * (2 * B * L * D + 4 * D * D + 2 * D * F + 9 * D + F + B * L
                  + (L * L if causal else 0))
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, causal=causal), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K1, "ok": ok and bitwise,
            "bitwise_repeatable": bitwise, "tiles": forward_tiles(B, L, D, F, False, device),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": by, "gflop": flops / 1e9}


def k3_versus_plain(device, B, H, L, Dh, causal=True):
    """K3 through ``fused_mha`` against mha_plain with right padding,
    example 0 fully masked, and the causal mask (or none); with the kernel's
    time alone on masks made once (``kernel_only_ms``: ``fused_mha`` makes
    them from the boolean masks on every call), and the share of (query
    tile, key tile) pairs it computes and of query tiles that make the extra
    pass for rows with no allowed key (``mha_tiles``, the kernel's skip
    rule)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import (MHA_TILE, additive_masks, fused_mha, mha_fwd,
                                               mha_plain, mha_tiles)
    rng = np.random.default_rng(B + L + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
               for _ in range(3))
    pad_np = right_padding(rng, B, L)
    pad_np[0] = True                   # one example whose keys are all masked
    pad = torch.from_numpy(pad_np).to(device)
    attn = causal_mask(L, device, causal)
    pad_add, attn_add = additive_masks(pad, attn)
    mask = sdpa_mask(pad_add, attn_add)
    kern = lambda: fused_mha(q, k, v, pad, attn)
    kern_only = lambda: mha_fwd(q, k, v, pad_add, attn_add)
    plain = lambda: mha_plain(q, k, v, pad_add, attn_add)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K3)
        masked_row_ok = bool(torch.allclose(got[0], v[0].mean(dim=1, keepdim=True).expand_as(
            got[0]), atol=TOL_K3[0], rtol=TOL_K3[1]))
        bitwise = torch.equal(got, kern()) and torch.equal(got, kern_only())
        ms, kernel_ms = time_ms(kern), time_ms(kern_only)
        plain_ms, library_ms = time_ms(plain), time_ms(lib)
    tiles, extra = mha_tiles(pad, attn, L, L, *MHA_TILE)
    flops = 4 * H * attended_pairs(pad, attn) * Dh
    nbytes = 4 * (4 * B * H * L * Dh + B * L + (L * L if causal else 0))
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=causal), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K3, "ok": ok and masked_row_ok and bitwise,
            "all_masked_row_uniform": masked_row_ok, "bitwise_repeatable": bitwise,
            "tile": list(MHA_TILE), "tiles_computed_share": float(tiles.float().mean()),
            "extra_pass_share": float(extra.float().mean()), "ms": ms,
            "kernel_only_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def layer_inputs(device, B, L, D, F, seed, causal=True):
    """Seeded layer weights, x, an output gradient g, right padding and the
    attention mask (None unless ``causal``)."""
    import numpy as np
    import torch
    from recstudio_torch.utils.convert import random_sasrec_params
    rng = np.random.default_rng(seed)
    tree = random_sasrec_params(seed, 2, D, 1, F, 1)
    params = layer_params(tree["query_encoder"]["transformer"]["layer_0"], device)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device)
    return params, x, g, pad, causal_mask(L, device, causal)


def k1_train_versus_plain(device, B, L, D, F, H, p=0.5, seed=2026, causal=True):
    """K1 in training mode (dropout on) against the plain forward with the
    same masks, with a bitwise repeat of the output and of every residual
    K2 reads."""
    import torch
    from recstudio_torch.ops.transformer_layer import (forward_tiles, training_residuals,
                                                       transformer_layer_plain)
    params, x, _, pad, attn = layer_inputs(device, B, L, D, F, B + L + 2, causal)
    call = lambda: training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, seed)
    kern = lambda: call()[0]
    plain = lambda: transformer_layer_plain(x, params, pad, attn, H, "gelu", 1e-12, p, seed,
                                            True)
    with torch.no_grad():
        (got, res), want = call(), plain()
        got2, res2 = call()
        bitwise = torch.equal(got, got2) and all(torch.equal(res[k], res2[k]) for k in res)
        del res, res2, got2
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K1)
        ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
    M = B * L
    flops = 2 * M * D * (3 * D + D + 2 * F) + 4 * attended_pairs(pad, attn) * D
    weights = 4 * D * D + 2 * D * F + 9 * D + F
    # x, weights, masks in; out and the residuals of K2 out
    nbytes = 4 * (M * D + weights + B * L + (L * L if causal else 0) + M * D
                  + M * (3 * D + 4 * D + 2 * F + 2) + B * H * L * 2)
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, dropout=p, causal=causal),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K1,
            "ok": ok and bitwise, "bitwise_repeatable": bitwise,
            "tiles": forward_tiles(B, L, D, F, True, device), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k2_versus_plain(device, B, L, D, F, H, p=0.5, seed=2027, causal=True):
    """K2 (dropout on) against autograd through the plain forward with the
    same masks; the plain time is the autograd backward alone. Reports the
    share of its attention steps' tile pairs (``K2_ATTN_TILE``) K2 computes
    (``mha_tiles``: those holding an allowed pair, and every pair of a query
    tile that holds a row with no allowed key) and each weight gradient's
    row ranges (S, rows), sized to the card."""
    import torch
    from recstudio_torch.ops.attention import mha_tiles
    from recstudio_torch.ops.transformer_layer import (K2_ATTN_TILE, PARAM_NAMES,
                                                       fused_transformer_layer_bwd,
                                                       training_residuals,
                                                       transformer_layer_plain,
                                                       weight_grad_splits)
    params, x, g, pad, attn = layer_inputs(device, B, L, D, F, B + L + 3, causal)
    _, res = training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, seed)
    kern = lambda: fused_transformer_layer_bwd(g, x, params, pad, attn, H, p, "gelu", 1e-12,
                                               seed, res)
    dx, grads = kern()
    dx2, grads2 = kern()
    torch.cuda.synchronize()
    bitwise = torch.equal(dx, dx2) and all(torch.equal(grads[n], grads2[n]) for n in PARAM_NAMES)
    xs = x.detach().requires_grad_()
    ps = {n: params[n].detach().requires_grad_() for n in PARAM_NAMES}
    out = transformer_layer_plain(xs, ps, pad, attn, H, "gelu", 1e-12, p, seed, True)
    inputs = [xs, *(ps[n] for n in PARAM_NAMES)]
    plain = lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)
    want = plain()
    max_abs, ok = grad_errors({"x": dx, **grads}, {"x": want[0], **dict(zip(PARAM_NAMES,
                                                                            want[1:]))})
    ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
    M = B * L
    flops = 2 * 2 * M * D * (3 * D + D + 2 * F) + 8 * attended_pairs(pad, attn) * D
    weights = 4 * D * D + 2 * D * F + 9 * D + F
    # x, masks, weights, the residuals and g in; dx and the twelve gradients out
    nbytes = 4 * (M * D + B * L + (L * L if causal else 0) + weights
                  + M * (3 * D + 4 * D + 2 * F + 2) + B * H * L * 2 + M * D + M * D + weights)
    b_ms, by = bound(flops, nbytes)
    tiles, empty = mha_tiles(pad, attn, L, L, *K2_ATTN_TILE)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H, dropout=p, causal=causal),
            "max_abs_err": max_abs,
            "tol": TOL_GRAD, "ok": ok and bitwise, "bitwise_repeatable": bitwise, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "gflop": flops / 1e9, "tile": list(K2_ATTN_TILE),
            "tiles_computed_share": float((tiles | empty[:, :, None]).float().mean()),
            "weight_grad_splits": weight_grad_splits(B, L, D, F, device)}


def clse_inputs(device, M, N, D, seed, g_share=0.2):
    """Query rows and a catalog at the scale of a trained model's, and the
    cotangent of a batch: nonzero (1 / count) on a share ``g_share`` of the
    rows (a fifth: BERT4Rec's masked positions; 1: NARM's and STAMP's one
    row a sequence), zero on the rest."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, D)).astype(np.float32)
    items = rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)
    keep = rng.random(M) < g_share
    g = np.where(keep, 1.0 / max(int(keep.sum()), 1), 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (q, items, g))


def clse_versus_plain(device, M, N, D, seed=2028, g_share=0.2):
    """K7, K8 and K9 against their plain versions at one shape: rows for
    each, repeated bit for bit, with the ranges of each kernel's plan, the
    blocks of its grid and the card's resident blocks the plan was cut
    for. The plain versions are
    cuBLAS float32 (TF32 off) and ``torch.logsumexp``. K8's library time is
    float32 ``scaled_dot_product_attention`` of the query rows over the
    catalog as keys and values, ``softmax(q items^T) items``: all of K8's
    arithmetic but the scale by g. No single PyTorch call computes logZ
    alone (K7) or ``P^T (g o q)`` alone (K9)."""
    import torch
    from recstudio_torch.ops.softmax_z import (DITEMS_PLAN, DQ_PLAN, FWD_PLAN,
                                               catalog_logsumexp_ditems,
                                               catalog_logsumexp_ditems_plain,
                                               catalog_logsumexp_dq, catalog_logsumexp_dq_plain,
                                               catalog_logsumexp_fwd, catalog_logsumexp_plain,
                                               resident, splits)
    q, items, g = clse_inputs(device, M, N, D, seed, g_share)
    shape = dict(M=M, N=N, D=D, g_share=g_share)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None, None], items[None, None], items[None, None], scale=1.0)
    libraries = {"K8": sdpa, "K9": None}
    rows = {}
    with torch.no_grad():
        logz, again = catalog_logsumexp_fwd(q, items), catalog_logsumexp_fwd(q, items)
        want = catalog_logsumexp_plain(q, items)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(logz, want, TOL_LOGZ)
        bitwise = torch.equal(logz, again)
        b_ms, by = bound(2 * M * N * D, 4 * (M * D + N * D + M))
        rows["K7"] = {"shape": shape, "max_abs_err": max_abs, "max_rel_err": max_rel,
                      "tol": TOL_LOGZ,
                      "ok": ok and bitwise and bool(torch.isfinite(logz).all()),
                      "bitwise_repeatable": bitwise,
                      "ms": time_ms(lambda: catalog_logsumexp_fwd(q, items)),
                      "plain_ms": time_ms(lambda: catalog_logsumexp_plain(q, items)),
                      "library_ms": None, "bound_ms": b_ms, "bound_by": by,
                      "gflop": 2 * M * N * D / 1e9}
        for tag, kern, plain, nbytes in (
                ("K8", catalog_logsumexp_dq, catalog_logsumexp_dq_plain,
                 4 * (2 * M * D + N * D + 2 * M)),
                ("K9", catalog_logsumexp_ditems, catalog_logsumexp_ditems_plain,
                 4 * (M * D + 2 * N * D + 2 * M))):
            got, again = kern(q, items, logz, g), kern(q, items, logz, g)
            want = plain(q, items, logz, g)
            torch.cuda.synchronize()
            max_abs, ok = grad_errors({"grad": got}, {"grad": want})
            bitwise = torch.equal(got, again)
            b_ms, by = bound(4 * M * N * D, nbytes)
            rows[tag] = {"shape": shape, "max_abs_err": max_abs, "tol": TOL_GRAD,
                         "ok": ok and bitwise, "bitwise_repeatable": bitwise,
                         "ms": time_ms(lambda: kern(q, items, logz, g)),
                         "plain_ms": time_ms(lambda: plain(q, items, logz, g)),
                         "library_ms": time_ms(libraries[tag]) if libraries[tag] else None,
                         "bound_ms": b_ms, "bound_by": by,
                         "gflop": 4 * M * N * D / 1e9}
    # each grid: tiles of 64 of the axis a block owns (K9: items, else query
    # rows) times the ranges of its plan (sized to the card)
    for tag, kind, outer in (("K7", FWD_PLAN, M), ("K8", DQ_PLAN, M), ("K9", DITEMS_PLAN, N)):
        rows[tag]["splits"] = splits(M, N, D, kind)
        rows[tag]["grid_blocks"] = -(-outer // 64) * rows[tag]["splits"]
        rows[tag]["resident_blocks"] = resident(D, kind)
    return rows


def flash_inputs(device, B, H, L, Dh, causal, all_masked, seed):
    """q, k, v, an output gradient g [B, H, L, Dh], right padding (example 0
    fully masked if asked), the causal mask or None, and the additive masks."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import additive_masks
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
                  for _ in range(4))
    pad_np = right_padding(rng, B, L)
    if all_masked:
        pad_np[0] = True
    pad = torch.from_numpy(pad_np).to(device)
    attn = causal_mask(L, device, causal)
    return q, k, v, g, pad, attn, additive_masks(pad, attn)


def sdpa_mask(pad_add, attn_add):
    """The combined, clamped additive mask that SDPA takes: [B, 1, Lq, Lk],
    or [B, 1, 1, Lk] with no attention mask."""
    import torch
    mask = pad_add[:, None, None, :]
    if attn_add is not None:
        mask = attn_add[None, None] + mask
    return mask.clamp_min(torch.finfo(torch.float32).min)


def flash_bound(B, H, L, Dh, pairs, causal, ops_per_pair, tensors, row_floats):
    """The card's least time for a flash kernel: ``ops_per_pair`` Dh
    operations for each attended pair of each head, against each input read
    once and each output written once: ``tensors`` [B, H, L, Dh] tensors,
    ``row_floats`` floats of each query row (statistics, delta) and the
    masks. Returns ((ms, bound by), operations)."""
    flops = ops_per_pair * Dh * H * pairs
    nbytes = 4 * (B * H * L * (Dh * tensors + row_floats) + B * L + (L * L if causal else 0))
    return bound(flops, nbytes), flops


def k4_versus_plain(device, B, H, L, Dh, causal=True, all_masked=True, seed=2029):
    """K4 against its plain version (out and the row statistics), repeated
    bit for bit; with ``all_masked`` example 0 must come out as the average
    of its L values with statistics exactly (finfo.min, L). Reports the
    share of (query tile, key tile) pairs of ``FLASH_TILE`` K4 computes or
    passes over again: those holding an allowed pair (``mha_tiles``, the
    kernel's skip rule), and every pair of a query tile that holds a row with
    no allowed key (its one more pass over all L values), and the share of
    such query tiles. Library time: float32 SDPA with the combined clamped
    mask."""
    import torch
    from recstudio_torch.ops.attention import (FLASH_TILE, flash_mha_fwd, flash_mha_plain,
                                               mha_tiles)
    q, k, v, _, pad, attn, (pad_add, attn_add) = flash_inputs(device, B, H, L, Dh, causal,
                                                              all_masked, seed)
    kern = lambda: flash_mha_fwd(q, k, v, pad_add, attn_add)
    plain = lambda: flash_mha_plain(q, k, v, pad_add, attn_add)
    mask = sdpa_mask(pad_add, attn_add)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with torch.no_grad():
        (got, stats), (want, want_stats) = kern(), plain()
        again, again_stats = kern()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K4)
        _, _, stats_ok = errors(stats, want_stats, TOL_STATS)
        bitwise = torch.equal(got, again) and torch.equal(stats, again_stats)
        masked_ok = not all_masked or (bool(torch.allclose(
            got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]), atol=TOL_K4[0],
            rtol=TOL_K4[1])) and bool((stats[0, ..., 0] == torch.finfo(torch.float32).min).all())
            and bool((stats[0, ..., 1] == L).all()))
        del want, want_stats, again, again_stats
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain, iters=5), time_ms(lib, iters=5)
    pairs = attended_pairs(pad, attn)
    tiles, empty = mha_tiles(pad, attn, L, L, *FLASH_TILE)
    # q, k, v in, out out; stats (max, sum) out
    (b_ms, by), flops = flash_bound(B, H, L, Dh, pairs, causal, 4, 4, 2)
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=causal, all_masked_example=all_masked),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K4,
            "ok": ok and stats_ok and masked_ok and bitwise, "stats_ok": stats_ok,
            "all_masked_row_uniform": masked_ok, "bitwise_repeatable": bitwise,
            "tile": list(FLASH_TILE),
            "tiles_computed_share": float((tiles | empty[:, :, None]).float().mean()),
            "extra_pass_share": float(empty.float().mean()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k5_k6_versus_plain(device, B, H, L, Dh, causal=True, all_masked=False, seed=2030):
    """K5 and K6 on K4's out and statistics, held to their explicit plain
    versions and to autograd of ``mha_plain`` (TOL_GRAD relative to each
    tensor's largest value), each repeated bit for bit. Library time for
    both: SDPA's backward, one call that computes dq, dk and dv together.
    Each row reports the share of (query tile, key tile) pairs of
    ``FLASH_TILE`` the kernels compute: those holding an allowed pair, and
    every pair of a query tile that holds a row with no allowed key."""
    import torch
    from recstudio_torch.ops.attention import (FLASH_TILE, flash_mha_bwd_dkv,
                                               flash_mha_bwd_dkv_plain, flash_mha_bwd_dq,
                                               flash_mha_bwd_dq_plain, flash_mha_fwd, mha_plain,
                                               mha_tiles)
    q, k, v, g, pad, attn, (pad_add, attn_add) = flash_inputs(device, B, H, L, Dh, causal,
                                                              all_masked, seed)
    masks = (pad_add, attn_add)
    with torch.no_grad():
        out, stats = flash_mha_fwd(q, k, v, *masks)
    k5 = lambda: flash_mha_bwd_dq(q, k, v, *masks, out, stats, g)
    (dq, delta), (dq2, delta2) = k5(), k5()
    k6 = lambda: flash_mha_bwd_dkv(q, k, v, *masks, stats, g, delta)
    (dk, dv), (dk2, dv2) = k6(), k6()
    torch.cuda.synchronize()
    p5 = lambda: flash_mha_bwd_dq_plain(q, k, v, *masks, out, stats, g)
    p6 = lambda: flash_mha_bwd_dkv_plain(q, k, v, *masks, stats, g, delta)
    want_dq = p5()[0]
    want_dk, want_dv = p6()
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(mha_plain(qs, ks, vs, *masks), (qs, ks, vs), g)
    err5, ok5 = grad_errors({"dq": dq}, {"dq": want_dq})
    err6, ok6 = grad_errors({"dk": dk, "dv": dv}, {"dk": want_dk, "dv": want_dv})
    aerr5, aok5 = grad_errors({"dq": dq}, {"dq": auto[0]})
    aerr6, aok6 = grad_errors({"dk": dk, "dv": dv}, {"dk": auto[1], "dv": auto[2]})
    bit5 = torch.equal(dq, dq2) and torch.equal(delta, delta2)
    bit6 = torch.equal(dk, dk2) and torch.equal(dv, dv2)
    del want_dq, want_dk, want_dv, auto, dq2, dk2, dv2
    mask = sdpa_mask(pad_add, attn_add)
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    lib = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g, retain_graph=True)
    ms5, ms6 = time_ms(k5), time_ms(k6)
    plain5, plain6, library_ms = time_ms(p5, iters=5), time_ms(p6, iters=5), time_ms(lib, iters=5)
    pairs = attended_pairs(pad, attn)
    tiles, empty = mha_tiles(pad, attn, L, L, *FLASH_TILE)
    share = float((tiles | empty[:, :, None]).float().mean())
    shape = dict(B=B, H=H, L=L, Dh=Dh, causal=causal, all_masked_example=all_masked)
    # K5 reads q, k, v, dO, out and stats, writes dq and delta; K6 reads q,
    # k, v, dO, stats and delta, writes dk and dv
    (b5, by5), f5 = flash_bound(B, H, L, Dh, pairs, causal, 6, 6, 3)
    (b6, by6), f6 = flash_bound(B, H, L, Dh, pairs, causal, 8, 6, 3)
    row = lambda err, ok, aerr, aok, bit, ms, plain_ms, b_ms, by, flops: {
        "shape": shape, "max_abs_err": max(err, aerr), "plain_max_abs_err": err,
        "autograd_max_abs_err": aerr, "tol": TOL_GRAD, "ok": ok and aok and bit,
        "bitwise_repeatable": bit, "tile": list(FLASH_TILE), "tiles_computed_share": share,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "SDPA backward (dq, dk, dv together)", "bound_ms": b_ms, "bound_by": by,
        "gflop": flops / 1e9}
    return (row(err5, ok5, aerr5, aok5, bit5, ms5, plain5, b5, by5, f5),
            row(err6, ok6, aerr6, aok6, bit6, ms6, plain6, b6, by6, f6))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from recstudio_torch.ops import _native
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"GPU {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    lib = _native.load()
    ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("BUILD", {"seconds": lib.build_seconds, "library": os.path.relpath(lib.path, REPO)})
    for ln in ptxas:
        print(f"PTXAS {ln}", flush=True)

    phases = [phase_a(device), phase_b(device), phase_c(device), phase_d(device),
              phase_e(device), phase_f(device), phase_g(device), phase_h(device),
              phase_i(device), phase_j(device), phase_k(device), phase_l(device),
              phase_m(device), *phase_n(device), phase_o(device), phase_p(device),
              *phase_q(device), phase_r(device), *phase_s(device)]

    k1_a = k1_versus_plain(device, 128, 20, 64, 128, 2)
    k1_b = k1_versus_plain(device, 256, 200, 128, 128, 2)
    k3_b = k3_versus_plain(device, 256, 2, 200, 64)
    k3_c = k3_versus_plain(device, 64, 2, 384, 64)
    # BERT4Rec's attention through K1 at F: no attention mask, right padding
    k3_f = k3_versus_plain(device, 256, 2, 200, 32, causal=False)
    k1_d = k1_train_versus_plain(device, 1024, 200, 128, 128, 2)
    k2_d = k2_versus_plain(device, 1024, 200, 128, 128, 2)
    # phase F's shapes: BERT4Rec layers (no attention mask, dropout 0.2), and
    # the log-partition over B L = 51,200 rows and 3,706 items; then 512 rows
    # against a catalog of 500,000
    k1_f = k1_versus_plain(device, 256, 200, 64, 128, 2, causal=False)
    k1t_f = k1_train_versus_plain(device, 256, 200, 64, 128, 2, p=0.2, causal=False)
    k2_f = k2_versus_plain(device, 256, 200, 64, 128, 2, p=0.2, causal=False)
    clse_f = clse_versus_plain(device, 256 * 200, 3706, 64)
    clse_cat = clse_versus_plain(device, 512, 500_000, 64)
    # phases K and L: one query row a sequence, 512 rows by 3,706 items, every
    # row with a gradient
    clse_k = clse_versus_plain(device, 512, 3706, 64, seed=2033, g_share=1.0)
    # phase O: MultiDAE's one row a user, 256 rows by 3,706 items at D 200
    # (the kernels' DK = 16 instantiation), every row with a gradient
    clse_o = clse_versus_plain(device, 256, 3706, 200, seed=2034, g_share=1.0)
    rows = [("K1@A", k1_a), ("K1@B", k1_b), ("K3@B", k3_b), ("K3@C", k3_c),
            ("K3@F", k3_f),
            ("K1train@D", k1_d), ("K2@D", k2_d), ("K1@F", k1_f), ("K1train@F", k1t_f),
            ("K2@F", k2_f)]
    rows += [(f"{k}@F", clse_f[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@cat500k", clse_cat[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@K", clse_k[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@O", clse_o[k]) for k in ("K7", "K8", "K9")]
    # phase H's attention (B 256, L 1024, Dh 64, causal, example 0 fully
    # masked in K4's row), BERT4Rec's route at L 2048 (no attention mask),
    # and an Lk that is a multiple of no tile
    k4_h = k4_versus_plain(device, 256, 2, 1024, 64)
    k4_bidir = k4_versus_plain(device, 64, 2, 2048, 64, causal=False)
    k4_odd = k4_versus_plain(device, 64, 2, 600, 32)
    k5_h, k6_h = k5_k6_versus_plain(device, 256, 2, 1024, 64)
    k5_m, k6_m = k5_k6_versus_plain(device, 16, 2, 1024, 64, all_masked=True)
    rows += [("K4@H", k4_h), ("K4@bidir", k4_bidir), ("K4@odd", k4_odd), ("K5@H", k5_h),
             ("K6@H", k6_h), ("K5@masked", k5_m), ("K6@masked", k6_m)]
    for name, res in rows:
        emit("KERNEL_VS_PLAIN", {"kernel": name, "gpu": gpu, **res})
        check(res["ok"], f"{name} disagrees with its plain version: {res['max_abs_err']}")

    def launches(name):
        return sum(p["launches"][name] for p in phases)

    row = lambda res: {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
    kernels = [
        {"name": "fused_transformer_layer", "route": "cuda",
         "source": "recstudio_torch/csrc/transformer_layer.cu",
         "replaces": "recstudio_tpu/ops/transformer_layer.py:267",
         "launches": launches("fused_transformer_layer"), **row(k1_b)},
        {"name": "fused_mha", "route": "cuda", "source": "recstudio_torch/csrc/attention.cu",
         "replaces": "recstudio_tpu/ops/attention.py:71",
         "launches": launches("fused_mha"), **row(k3_c)},
        {"name": "fused_transformer_layer_bwd", "route": "cuda",
         "source": "recstudio_torch/csrc/transformer_layer_bwd.cu",
         "replaces": "recstudio_tpu/ops/transformer_layer.py:292",
         "launches": launches("fused_transformer_layer_bwd"), **row(k2_d)},
    ]
    for name, kid, line in (("catalog_logsumexp_fwd", "K7", 53),
                            ("catalog_logsumexp_dq", "K8", 115),
                            ("catalog_logsumexp_ditems", "K9", 135)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "recstudio_torch/csrc/softmax_z.cu",
                        "replaces": f"recstudio_tpu/ops/softmax_z.py:{line}",
                        "launches": launches(name), **row(clse_f[kid])})
    for name, kid, line, res in (("flash_mha_fwd", "K4", 133, k4_h),
                                 ("flash_mha_bwd_dq", "K5", 220, k5_h),
                                 ("flash_mha_bwd_dkv", "K6", 246, k6_h)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "recstudio_torch/csrc/flash_attention.cu",
                        "replaces": f"recstudio_tpu/ops/attention.py:{line}",
                        "launches": launches(name), **row(res)})
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"GPU {gpu_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
