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
  an epoch under ``sparse_adam`` (the packed row-sparse step); 8 requests of 8192
  rows through ``ScorePredictor`` held to ``predict``. No kernel;
- phase S: ``quickstart.run`` of DeepFM, FM and LR on ml-100k at the
  repo's config (fm family: ``fmeval``, ratings binarized at 3.0; early
  stopping on validation AUC, patience 10), test AUC held to each model's
  JAX band (``recstudio_torch/assets/{deepfm,fm,lr}_ml100k_train_
  reference.json``), one epoch profiled, every test row served through
  ``ScorePredictor(max_batch=256)``, whose probabilities must be
  ``evaluate``'s. No kernel;
- phase T: LightGCN at the JAX bench's ``graph_scale`` setup
  (``amazon-book-shape``: 52,643 users, 91,599 items, 2,984,108
  interactions, seed 7; ratio split [0.8, 0.1, 0.1]; d 64, 3 layers, batch
  8192, one uniform negative, Adam 1e-3, l2 1e-4) on the ELL route (the
  graph past the dense budget): generation, ETL and graph-build seconds,
  padded ELL slots against edges and the tables' bytes, 20 timed steps,
  peak memory, one step's loss and gradients held to the edge-list route
  and to a bitwise repeat, one layer's forward on the ELL and edge-list
  routes beside ``torch.sparse.mm`` of the same CSR matrix, one epoch and
  its busy share, every test user evaluated. No kernel;
- phase U: ``quickstart.run`` of LightGCN, NGCF and SimGCL (for the
  epochs of their references: 40, 40 and 20) on ml-100k at the repo's
  configs, held to the JAX seeds' bands (``recstudio_torch/assets/
  {lightgcn,ngcf,simgcl}_ml100k_train_reference.json``): LightGCN's and
  NGCF's test NDCG@10, whose bands clear the untrained models' by
  ``NDCG_MARGIN``; SimGCL, which does not learn to rank at its config in
  the JAX package either, its last epoch's training loss (its NDCG@10
  reported beside its band); every test user served, LightGCN's lists
  held to the model copied to the CPU. No kernel;
- phase V: DeepFM at the repo's config through the packed row-sparse
  step (``learner: sparse_adam``, ``sparse_rows: auto``) on
  ``generate_ctr("criteo-10m-hugevocab-shape")`` at 6,000,000 rows (the
  JAX bench's ``ctr_bigvocab_sparse_adam`` at 10,000,000, cut for the time
  limit; its data built by a process of this script's own while the
  earlier phases run), batch 8192: gen and ETL seconds, the table's rows,
  a one-epoch fit and its test AUC, 20 timed steps, the card's busy share
  over 200 profiled steps; one packed step held to one dense lazy-Adam
  step from the same state (parameters and moments), rows no lookup
  touched held unchanged bit for bit, and the step to a bitwise repeat;
  20 steps of the dense ``LazyAdam`` beside. No kernel;
- phase W: AutoInt at its repo config (embed 10, attention 64, 3 layers, 2
  heads, MLP [128, 64], dropout 0.5) on phase R's data, batch 8192: a
  one-epoch fit and its test AUC, the evaluation and ``ScorePredictor``
  through K3 (counted), training through the plain softmax (no launch);
  20 timed steps, one step held to the CPU copy with the same dropout
  seeds, the evaluation's probabilities held to the plain route's;
- phase X: ``quickstart.run`` of WideDeep, DCN, NFM and AutoInt on
  ml-100k at the repo's configs for at most the epochs of their
  references (10, 8, 8 and 12; early stopping may end them sooner), test
  AUC held to the JAX seeds' bands (``recstudio_torch/assets/{widedeep,dcn,nfm,
  autoint}_ml100k_train_reference.json``), whose AUC band must clear the
  untrained AUC by ``AUC_MARGIN``; the batch norms calibrated; every test
  row served through ``ScorePredictor`` against ``evaluate`` and
  ``predict``; AutoInt launches K3;
- phase Y: BPR (d 64) on phase T's amazon-book-shape splits with
  ``SampledSoftmaxLoss`` under the ``midx-pop`` proposal (32 clusters a
  half-space, 1,024 buckets, 100 negatives, batch 2048): the refresh's ms
  (catalog encode, two k-means runs, index and CDFs) and its bitwise
  repeat, the state built on the card against a CPU copy from the same
  k-means result, two epochs (step and sample ms, examples/s, peak
  memory), the busy share of 100 profiled steps, the test NDCG@10; then
  each other proposal (``uniform``, ``pop``, ``midx-uni``,
  ``cluster-uni``, ``cluster-pop``, ``lsh``) and mining method (``dns``,
  ``sir``, ``brute``, ``toprand``, ``top&rand``, ``negative_count [200,
  100]``) for ``SAMPLER_MODE_STEPS`` steps; every proposal's 2^20 draws
  for four queries held to its proposal (total variation), its
  ``log_neg_prob`` to ``compute_item_p`` of its draws. No kernel;
- phase Y2: SASRec at phase D's setup (L 200, d 128, batch 256) with
  ``SampledSoftmaxLoss`` under ``midx-uni`` over ``[B, L, D]`` queries (20
  negatives): ``Y2_STEPS`` steps through K1 and K2 with the loss falling,
  the sampler gates, two requests served through K1;
- phase Z: ``quickstart.run`` of PMF, CML, NCF, LogisticMF and BPR under
  ``midx-pop`` on ml-100k, held to the JAX seeds' bands
  (``recstudio_torch/assets/{pmf,cml,ncf,logisticmf,bpr_midx_pop}_
  ml100k_train_reference.json``), every test user served through
  ``Predictor``, whose lists give ``evaluate``'s metrics. No kernel;
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
ML100K_TRAIN_REFERENCE = os.path.join(REPO, "recstudio_torch", "assets",
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
# a gradient that is zero in exact arithmetic, as a share of the largest
TOL_ZERO_GRAD = 1e-6
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
# phase U: a JAX NDCG@10 band must clear the untrained model's by this much
NDCG_MARGIN = 0.05
# phase T: one propagation layer against torch.sparse.mm, relative to the
# product's largest magnitude (float32 sums of up to a hub's degree terms)
TOL_LAYER = 1e-5
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


def grad_errors(got, want, zero=()):
    """(max abs error, ok) of gradient tensors by name, each held to
    TOL_GRAD relative to its own largest magnitude. The tensors named in
    ``zero`` have a zero gradient in exact arithmetic (an attention's key
    bias moves every score of a row alike, which the softmax removes):
    both sides' float32 noise there is held under ``TOL_ZERO_GRAD`` of the
    largest gradient of all, not to each other."""
    max_abs, ok = 0.0, True
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        diff = (got[name] - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        if name in zero:
            ok &= max(float(got[name].abs().max()), float(w.abs().max())) \
                < TOL_ZERO_GRAD * largest
            continue
        ok &= bool((diff <= TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs()).all())
    return max_abs, ok


def training_model(device, model_name, batch_size, L=200, train=None, parts=None,
                   **model_conf):
    """``model_name`` on the synthetic ml-1m shape at ``max_seq_len`` L,
    seed 7, ready for optimizer steps on device-resident batches: (model,
    conf, dataset, test split, dataset name, ETL seconds). ``train``
    overrides ``train`` keys; ``parts`` go to the constructor (``loss=``)."""
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = L
    cls, conf = get_model(model_name)
    conf["model"].update(model_conf)
    conf["train"].update(batch_size=batch_size, seed=7, **(train or {}))
    ds = cls._get_dataset_class()(name, config=config)
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device=device, **(parts or {}))
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
              quickstart=False, cpu_lists=False, overrides=None):
    """fit + evaluate on ml-100k at the repo's config for the reference's
    epochs (through ``quickstart.run`` with ``quickstart``; ``overrides``,
    config groups layered over the repo's config as the reference's runs
    were), test NDCG@10
    held to the JAX seeds' band, then every test user served from the
    trained weights in requests of the eval batch (8 of 128 at ml-100k).
    ``model_keys`` names the ``model`` config keys checked against
    ``expected`` besides the width, L (a sequence model's), batch and
    epochs. With no ``kernels`` named, the phase must launch none. A
    reference with a ``learning_gate`` is held to it: ``ndcg``, the band
    clears the untrained NDCG@10 by ``NDCG_MARGIN``; ``train_loss`` (a JAX
    model that does not learn to rank at its config, whose test NDCG@10 is
    the random-init level and is reported, not gated), the last epoch's
    training loss lies inside the JAX band of it. With
    ``cpu_lists`` every served list is held to the model copied to the CPU
    (ids up to ties, scores within ``TOL_SCORES``)."""
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
            conf = {"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}}
            for group, values in (overrides or {}).items():
                conf.setdefault(group, {}).update(values)
            model, (trn, _, tst), result = run(model_name, "ml-100k", verbose=False,
                                               device=device, model_config=conf)
        else:
            cls, conf = get_model(model_name)
            conf["train"]["epochs"] = ref["epochs"]
            conf["eval"]["save_path"] = SAVE_DIR
            trn, val, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
            model = cls(conf, device=device)
            model.fit(trn, val)
            result = model.evaluate(tst, verbose=False)
        run_s = time.perf_counter() - t0
        return (model, trn, tst, result, run_s) + serve(model, trn, tst)

    (model, trn, tst, result, run_s, pred, (scores, ids, targets)), counts = counted(drive)
    users = len(tst.data_index)
    cpu_bad = cpu_rows = None
    if cpu_lists:
        from recstudio_torch.utils.parity import topk_mismatches
        cpu = cpu_copy(model, trn)
        _, (s_c, i_c, _) = serve(cpu, trn, tst)
        cpu_rows, cpu_max_diff = len(i_c), float(np.abs(scores - s_c).max())
        cpu_bad = topk_mismatches(ids, scores, i_c, s_c, TOL_SCORES)
    mc, tc = model.config["model"], model.config["train"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[v] for k, v in model_keys.items()},
                 batch=tc["batch_size"], epochs=tc["epochs"])
    if hasattr(model, "max_seq_len"):
        shape["L"] = model.max_seq_len
    shape.update({k: tc[k] for k in ("mask_ratio", "weight_decay", "learner", "sampler",
                                     "negative_count") if k in expected})
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
    if "learning_gate" in ref:
        out.update(learning_gate=ref["learning_gate"],
                   ndcg_in_jax_band=lo <= result["ndcg@10"] <= hi,
                   train_loss_last=model.epoch_log[-1]["train_loss"],
                   jax_band_train_loss_last=ref["train_loss_last_band"])
    if cpu_lists:
        out.update(cpu_rows=cpu_rows, cpu_rows_disagreeing=cpu_bad,
                   cpu_max_score_diff=cpu_max_diff, cpu_tol=TOL_SCORES)
    if quickstart:              # the card's busy share of one more epoch, profiled
        train_s = sorted(e["train_s"] for e in model.epoch_log)
        epoch_s = train_s[len(train_s) // 2]
        model._epoch_refresh(0)         # what the epoch reads (a sampler's index)
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
    if ref.get("learning_gate") != "train_loss":
        check(lo <= result["ndcg@10"] <= hi,
              f"phase {tag} test NDCG@10 {result['ndcg@10']} outside the JAX band [{lo}, {hi}]")
    if ref.get("learning_gate") == "ndcg":
        check(lo - ref["untrained_ndcg@10"] >= NDCG_MARGIN,
              f"phase {tag} {model_name}: the JAX band does not clear the untrained NDCG@10")
    elif ref.get("learning_gate") == "train_loss":
        # the JAX model does not learn to rank at this config: its test
        # NDCG@10 is the random-init level (reported beside the band above);
        # the training loss shows that the port trains as the JAX model does
        l_lo, l_hi = ref["train_loss_last_band"]
        check(l_lo <= out["train_loss_last"] <= l_hi,
              f"phase {tag} {model_name}: last training loss {out['train_loss_last']} outside "
              f"the JAX band [{l_lo}, {l_hi}]")
    if cpu_lists:
        check(cpu_rows == users and cpu_bad == 0,
              f"phase {tag}: {cpu_bad} of {cpu_rows} lists differ from the CPU copy's")
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


_CRITEO = {}


def criteo_setup():
    """Phase R's data and DeepFM config (the JAX bench's ``ctr_scale``):
    ``(reference, dataset, (train, val, test), DeepFM class, config, gen s,
    ETL s)``; built once a process (phase W trains AutoInt on it), a fresh
    copy of the config each call."""
    if "setup" not in _CRITEO:
        _CRITEO["setup"] = _criteo_setup()
    ref, ds, splits, cls, conf, gen_s, etl_s = _CRITEO["setup"]
    return ref, ds, splits, cls, json.loads(json.dumps(conf)), gen_s, etl_s


def ctr_dataset(shape_name, rows):
    """``generate_ctr(shape_name)`` at ``rows`` (seed 11, the shape's
    vocabularies) built as the JAX bench builds it (``fmeval``, entry split
    [0.8, 0.1, 0.1] after ``np.random.seed(11)``): ``(dataset, splits, gen
    s, ETL s)``."""
    import numpy as np
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.data.synthetic import ctr_shape_vocabs, generate_ctr
    t0 = time.perf_counter()
    name, config = generate_ctr(shape_name, rows, seed=11, vocabs=ctr_shape_vocabs(shape_name))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.random.seed(11)
    ds = TripletDataset(name, config=config)
    splits = ds.build(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
    etl_s = time.perf_counter() - t0
    check(ds.num_inters == rows and len(ds.field2type) == 40 and ds.fuid is None,
          f"{shape_name} dataset {ds.num_inters} rows, {len(ds.field2type)} fields")
    return ds, splits, gen_s, etl_s


def _criteo_setup():
    from recstudio_torch.utils import get_model
    with open(CRITEO_TRAIN_REFERENCE) as f:
        ref = json.load(f)
    ds, splits, gen_s, etl_s = ctr_dataset("criteo-1m-shape", ref["rows"])
    B = ref["batch_size"]
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
    epoch's busy share, dropout masks, a sparse_adam epoch (the packed
    row-sparse step), and ``ScorePredictor`` at 8192 rows a request."""
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

    # sparse_adam (the packed row-sparse step): fit's epoch warms it; a timed
    # one, a profiled one
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
    lazy_packed = lazy._ctr_sparse_enabled()
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
           "sparse_adam": {"optimizer": lazy_opt, "packed_step": lazy_packed,
                           "first_epoch_loss": lazy_loss,
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
    check(lazy_opt == "LazyAdam" and lazy_packed,
          f"phase R sparse_adam ran {lazy_opt}, packed step {lazy_packed}")
    check(serve_diff <= TOL_PROB, f"phase R ScorePredictor differs from predict by {serve_diff}")
    check(pred.stats()["requests"] == len(starts) == min(8, -(-len(tst.data_index) // B)),
          "phase R served other than 8 requests")
    return out


def ranker_fit_phase(device, tag, model_name, expected, kernels=(), profile=True):
    """A ranker the way users start it, ``quickstart.run(model_name,
    "ml-100k")`` at the repo's config for at most its reference's epochs
    (early stopping may end it sooner), test AUC held to
    its JAX band (which must clear the untrained AUC by ``AUC_MARGIN``),
    one epoch profiled (``profile``), every test row served through
    ``ScorePredictor(max_batch=256)``, whose probabilities must be
    ``evaluate``'s and ``predict``'s. Its batch norms must be calibrated
    (count > 0). It launches ``kernels`` and no other."""
    import numpy as np
    from recstudio_torch import eval as ev
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import ScorePredictor
    import torch
    with open(ML100K_TRAIN_REFERENCE.format(model_name.lower())) as f:
        ref = json.load(f)

    def drive():
        t0 = time.perf_counter()
        model, (trn, _, tst), result = run(
            model_name, "ml-100k", verbose=False, device=device,
            model_config={"train": {"epochs": ref["epochs"]}, "eval": {"save_path": SAVE_DIR}})
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
    shape = dict(embed_dim=model.embed_dim, **{k: mc[k] for k in expected if k != "embed_dim"},
                 batch=tc["batch_size"], epochs=tc["epochs"],
                 patience=tc["early_stop_patience"], fmeval=trn.fmeval)
    check(shape == dict(expected, batch=512, epochs=ref["epochs"],
                        patience=ref["early_stop_patience"], fmeval=True),
          f"phase {tag} {model_name} config {shape}")
    want = eval_probs(model, tst)
    served_diff = float(np.abs(probs - want).max())
    tst.use_field = model.fields
    predicted = np.concatenate([model.predict(tst._get_pos_batch(np.arange(
        i, min(i + 4096, len(tst.data_index))))) for i in range(0, len(tst.data_index), 4096)])
    predict_diff = float(np.abs(probs - predicted).max())
    served_auc = float(ev.auc(torch.from_numpy(probs),
                              torch.from_numpy(tst.inter_feat.get_col("rating")[
                                  tst.data_index])))
    bn_counts = [float(m.count) for m in model.net.modules() if isinstance(m, SimpleBatchNorm)]
    train_s = sorted(e["train_s"] for e in model.epoch_log)
    epoch_s = train_s[len(train_s) // 2]
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0)) if profile else (None, None)
    steps = -(-model._epoch_rows // tc["batch_size"])
    lo, hi = ref["auc_band"]
    out = {"phase": tag, "model": model_name, "dataset": "ml-100k",
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
           "jax_runs": ref["runs"], "bn_counts": bn_counts, "served_rows": len(probs),
           "served_auc": served_auc, "served_max_abs_diff_vs_evaluate": served_diff,
           "served_max_abs_diff_vs_predict": predict_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    others = {k: v for k, v in counts.items() if k not in kernels and v}
    check(not others, f"phase {tag} {model_name} launched {others}")
    check(all(counts[k] > 0 for k in kernels), f"phase {tag} {model_name}: {counts}")
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log),
          f"phase {tag} {model_name} loss")
    check(lo > ref["untrained_auc"] + AUC_MARGIN,
          f"phase {tag} {model_name}: the JAX band [{lo}, {hi}] does not clear the untrained "
          f"AUC {ref['untrained_auc']} by {AUC_MARGIN}")
    check(lo <= result["auc"] <= hi, f"phase {tag} {model_name} test AUC {result['auc']} "
                                     f"outside the JAX band [{lo}, {hi}]")
    check(all(c > 0 for c in bn_counts), f"phase {tag} {model_name} BN counts {bn_counts}")
    check(len(probs) == len(tst.data_index) and max(served_diff, predict_diff) <= TOL_PROB,
          f"phase {tag} {model_name}: served probabilities differ from evaluate's by "
          f"{served_diff}, from predict's by {predict_diff}")
    return out


def phase_s(device):
    """DeepFM, FM and LR the way users start them (``ranker_fit_phase``).
    No kernel."""
    return [ranker_fit_phase(device, "S", name, expected) for name, expected in (
        ("DeepFM", dict(embed_dim=10, mlp_layer=[256, 256, 256], dropout=0.3)),
        ("FM", dict(embed_dim=10)), ("LR", dict(embed_dim=1)))]


# ---------------------------------------------------------------------------
# phase T's amazon-book-shape dataset and splits, which phase Y trains on
_AMAZON = {}


def phase_t(device):
    """LightGCN at amazon-book-shape on the ELL route (the JAX bench's
    ``graph_scale``): graph build, 20 timed steps, one step held to the
    edge-list route and to a bitwise repeat, one layer's forward against
    ``torch.sparse.mm`` of the same CSR matrix, an epoch and its busy
    share, every test user evaluated."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.utils import get_model, seed_everything
    t0 = time.perf_counter()
    name, config = generate("amazon-book-shape", *SHAPES["amazon-book-shape"], seed=7)
    gen_s = time.perf_counter() - t0
    cls, conf = get_model("LightGCN")
    seed_everything(2022)
    t0 = time.perf_counter()
    ds = cls._get_dataset_class()(name, config=config)
    trn, _, tst = ds.build(**conf["data"])
    etl_s = time.perf_counter() - t0
    _AMAZON.update(name=name, ds=ds, splits=(trn, tst), etl_s=etl_s)   # phase Y's too
    # 6 of the shape's 91,599 item ids are never drawn (seed 7)
    check((ds.num_users - 1, ds.num_items - 1, ds.num_inters) == (52643, 91593, 2_984_108),
          f"phase T dataset {ds.num_users - 1} x {ds.num_items - 1} x {ds.num_inters}")
    conf["train"].update(batch_size=8192)
    conf["eval"].update(batch_size=512, cutoff=[20], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    mc, tc = conf["model"], conf["train"]
    shape = dict(embed_dim=conf["model"]["embed_dim"], n_layers=mc["n_layers"],
                 l2=mc["l2_reg_weight"], batch=tc["batch_size"], lr=tc["learning_rate"],
                 learner=tc["learner"], negatives=tc["negative_count"],
                 split=conf["data"]["split_ratio"])
    check(shape == dict(embed_dim=64, n_layers=3, l2=1e-4, batch=8192, lr=1e-3,
                        learner="adam", negatives=1, split=[0.8, 0.1, 0.1]),
          f"phase T config {shape}")
    model = cls(conf, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._init_model(trn)
    model._init_parameter(trn)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    check(model._prop_m is None and model._adj is None and model._ell is not None
          and model._sym_spmm is not None, "phase T: the graph did not take the ELL route")
    ell = model.ell_stats()
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    n_rows = model._epoch_rows
    steps_per_epoch = -(-n_rows // tc["batch_size"])

    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model))
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one step on the ELL route, again, and on the edge-list route, from the
    # same parameters and generator states (so the same negatives)
    sym = model._sym_spmm

    def set_path(edges):
        model._sym_spmm = None if edges else sym

    batch = steps[-1]
    states = (model.generator.get_state(), model.device_generator.get_state())
    torch.cuda.reset_peak_memory_stats()
    loss_e, grads_e = path_loss_and_grads(model, batch, states, set_path, False)
    ell_step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_r, grads_r = path_loss_and_grads(model, batch, states, set_path, False)
    loss_l, grads_l = path_loss_and_grads(model, batch, states, set_path, True)
    set_path(False)
    model.net.eval()
    bitwise = loss_e == loss_r and all(torch.equal(grads_e[k], grads_r[k]) for k in grads_e)
    grad_err, grads_ok = grad_errors(grads_e, grads_l)
    del grads_e, grads_r, grads_l

    # one propagation layer's forward: ELL, the edge list, torch.sparse.mm
    # of the same matrix in CSR (the yardstick; not used on the path)
    gen = torch.Generator(device=device)
    gen.manual_seed(2035)
    emb = torch.randn(model._num_nodes, 64, generator=gen, device=device)
    src = model._edges[0]
    crow = torch.cat([model._deg_in.new_zeros(1), torch.cumsum(model._deg_in, 0)])
    csr = torch.sparse_csr_tensor(crow, src.long(), model._edge_w,
                                  (model._num_nodes, model._num_nodes))
    with torch.no_grad():
        ref = torch.sparse.mm(csr, emb)
        layer_scale = float(ref.abs().max())
        layer_err = float((model._ell_apply(emb) - ref).abs().max())
        edge_err = float((model._edge_apply(emb) - ref).abs().max())
        del ref
        ell_ms = time_ms(lambda: model._ell_apply(emb))
        edge_ms = time_ms(lambda: model._edge_apply(emb))
        sparse_ms = time_ms(lambda: torch.sparse.mm(csr, emb))
    del emb, csr, crow

    torch.cuda.synchronize()
    t = time.perf_counter()
    epoch_loss = model.training_epoch(0)
    epoch_s = time.perf_counter() - t
    host_ms, busy_ms = busy_share(lambda: model.training_epoch(0))
    model._eval_epoch(tst, ["ndcg", "recall"], [20])          # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [20])
    eval_s = time.perf_counter() - t
    p50 = times[len(times) // 2]
    out = {"phase": "T", "model": "LightGCN", "dataset": name, "users": ds.num_users - 1,
           "items": ds.num_items - 1, "inters": int(ds.num_inters), "train_rows": n_rows,
           "config": shape, "gen_s": gen_s, "etl_s": etl_s, "graph_build_s": graph_s,
           "nodes": model._num_nodes, "route": "ell", "ell": ell,
           "ell_slots_per_edge": ell["slots"] / ell["edges"], "launches": counts,
           "steps": len(times), "step_ms_p50": p50, "step_ms_max": times[-1],
           "examples_per_s": tc["batch_size"] / (p50 / 1e3), "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]), "peak_mem_gb": step_peak,
           "ell_step_peak_mem_gb": ell_step_peak, "ell_loss": loss_e, "edge_list_loss": loss_l,
           "grad_max_abs_err": grad_err, "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS,
           "step_bitwise_repeat": bitwise, "layer_fwd_ms": {"ell": ell_ms, "edge_list": edge_ms,
                                                            "torch_sparse_mm_csr": sparse_ms},
           "layer_max_abs_err_vs_sparse_mm": {"ell": layer_err, "edge_list": edge_err},
           "layer_max_abs": layer_scale, "layer_tol": TOL_LAYER,
           "steps_per_epoch": steps_per_epoch, "epoch_s": epoch_s, "epoch_loss": epoch_loss,
           "profiled_epoch_host_ms": host_ms, "profiled_epoch_busy_ms": busy_ms,
           "busy_share_of_epoch": None if busy_ms is None else busy_ms / host_ms,
           "eval_users": len(tst.data_index), "eval_s": eval_s,
           "eval_queries_per_s": len(tst.data_index) / eval_s, **ev}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase T launched a kernel: {counts}")
    check(all(np.isfinite(float(x)) for x in losses) and np.isfinite(epoch_loss), "phase T loss")
    check(abs(loss_e - loss_l) <= TOL_LOSS * abs(loss_l),
          f"phase T: ELL loss {loss_e} vs edge-list {loss_l}")
    check(grads_ok, f"phase T: ELL gradients disagree with the edge list's: {grad_err}")
    check(bitwise, "phase T: the ELL step does not repeat bit for bit")
    check(max(layer_err, edge_err) <= TOL_LAYER * layer_scale,
          f"phase T: a layer disagrees with torch.sparse.mm: {layer_err}, {edge_err}")
    check(np.isfinite(ev["ndcg@20"]) and np.isfinite(ev["recall@20"]), "phase T eval")
    return out


def phase_u(device):
    """LightGCN, NGCF and SimGCL the way users start them, ``quickstart.run``
    on ml-100k at the repo's configs for the epochs of their references,
    held to their JAX bands;
    LightGCN's served lists held to the CPU copy's."""
    graph = {"LightGCN": (dict(n_layers="n_layers", l2="l2_reg_weight",
                               prop_dtype="prop_dtype"),
                          dict(embed_dim=64, n_layers=3, l2=1e-4, prop_dtype="fp32", batch=512)),
             "NGCF": (dict(layer_size="layer_size", mess_dropout="mess_dropout",
                           l2="l2_reg_weight"),
                      dict(embed_dim=64, layer_size=[64] * 4, mess_dropout=[0.1] * 3, l2=1e-5,
                           batch=2048)),
             "SimGCL": (dict(n_layers="n_layers", eps="eps", cl_weight="cl_weight",
                             temperature="temperature", cl_neg_type="cl_neg_type",
                             l2="l2_reg_weight"),
                        dict(embed_dim=64, n_layers=3, eps=0.1, cl_weight=0.5, temperature=0.2,
                             cl_neg_type="all", l2=1e-4, batch=2048))}
    return [fit_phase(device, "U", name, ML100K_TRAIN_REFERENCE.format(name.lower()), keys,
                      expected, (), quickstart=True, cpu_lists=name == "LightGCN")
            for name, (keys, expected) in graph.items()]


# phase V: the JAX bench's ctr_bigvocab_sparse_adam (bench.py:307-327), its
# rows cut from 10,000,000 to 6,000,000 for the script's time limit, the
# vocabularies kept; the table (the ids the Zipf draws reach, 21.8 M rows at
# 10,000,000) must keep more than V_MIN_TABLE_ROWS rows
V_SHAPE = "criteo-10m-hugevocab-shape"
V_ROWS = 6_000_000
V_MIN_TABLE_ROWS = 13_000_000
# the epoch's steps run under the profiler for the card's busy share
V_PROFILE_STEPS = 200
# one packed step against one dense lazy-Adam step (tests/test_sparse_rows.py)
TOL_PACKED = (2e-4, 1e-6)  # (rtol, atol)


def start_ctr_data(shape_name, rows):
    """Build ``ctr_dataset(shape_name, rows)`` in a process of its own (its
    generation and ETL are host work, minutes at 10,000,000 rows), while
    the card's earlier phases run: ``(process, pickle path)``."""
    path = os.path.join(REPO, "build", "recstudio_torch", f"{shape_name}-{rows}.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ctr-data",
                             shape_name, str(rows), path], cwd=REPO)
    return proc, path


def write_ctr_data(shape_name, rows, path):
    """``--ctr-data``: pickle ``ctr_dataset(shape_name, rows)`` to ``path``,
    at a low priority beside the phases that run meanwhile."""
    import pickle
    os.nice(10)
    sys.path.insert(0, REPO)
    data = ctr_dataset(shape_name, rows)
    with open(path + ".part", "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".part", path)


def load_ctr_data(prepared):
    """Wait for ``start_ctr_data``'s process and load its dataset:
    ``(dataset, splits, gen s, ETL s, s waited)``."""
    import pickle
    proc, path = prepared
    t0 = time.perf_counter()
    rc = proc.wait()
    wait_s = time.perf_counter() - t0
    check(rc == 0 and os.path.isfile(path), f"the CTR data process failed ({rc})")
    with open(path, "rb") as f:
        ds, splits, gen_s, etl_s = pickle.load(f)
    os.remove(path)
    return ds, splits, gen_s, etl_s, wait_s


def net_state(model):
    """Copies of a model's parameters, buffers and optimizer state."""
    import copy
    return ({k: v.detach().clone() for k, v in model.net.state_dict().items()},
            copy.deepcopy(model.optimizer.state_dict()))


def set_net_state(model, state):
    """Load ``net_state``'s copies (the optimizer takes its state tensors as
    they are, so it is given copies of them, and ``state`` stays as saved)."""
    import copy
    sd, opt = state
    model.net.load_state_dict(sd)
    model.optimizer.load_state_dict(copy.deepcopy(opt))


def dense_copy(model, trn, state):
    """The port's DeepFM with ``sparse_rows: false`` (dense ``LazyAdam``)
    holding the packed model's ``state``: the tables' first D columns, their
    moments from the packed columns, the dense leaves' moments and the
    step count from its optimizer."""
    import torch
    conf = json.loads(json.dumps(model.config))
    conf["train"]["sparse_rows"] = "false"
    dense = type(model)(conf, device=model.device)
    dense._init_model(trn)
    dense._init_parameter(trn)
    sd, opt = state
    tables = {k: m.embed_dim for k, m in packed_table_names(model).items()}
    dense.net.load_state_dict({k: v[:, :tables[k]] if k in tables else v
                               for k, v in sd.items()})
    dense.optimizer = dense._get_optimizer()
    names = [n for n, _ in model.net.named_parameters()]
    moments = {names[i]: st for i, st in opt["state"].items()}
    with torch.no_grad():
        for name, p in dense.net.named_parameters():
            mu, nu = dense.optimizer.moments(p)
            if name in tables:
                d = tables[name]
                mu.copy_(sd[name][:, d:2 * d])
                nu.copy_(sd[name][:, 2 * d:])
            elif name in moments:
                mu.copy_(moments[name]["mu"])
                nu.copy_(moments[name]["nu"])
    dense.optimizer.param_groups[0]["count"] = opt["param_groups"][0]["count"]
    return dense


def packed_table_names(model):
    """``{state_dict name of a packed table: its Embeddings module}``."""
    return {f"{prefix}.token_embedding.weight": m for prefix, m in model.net.named_modules()
            if m in model._packed_embeddings()}


def packed_versus_dense(model, dense, state, after, tables):
    """Largest errors of the packed step's ``after`` state against the dense
    step's: parameters, and each table's mu and nu columns against the
    dense moments; and whether all lie within ``TOL_PACKED``."""
    import torch
    rtol, atol = TOL_PACKED
    errs, ok = {}, True
    params = dict(dense.net.named_parameters())
    for name, want in dense.net.state_dict().items():
        got = after[name]
        pairs = [("params", got, want)]
        if name in tables:
            d = tables[name].embed_dim
            mu, nu = dense.optimizer.moments(params[name])
            pairs = [("params", got[:, :d], want), ("mu", got[:, d:2 * d], mu),
                     ("nu", got[:, 2 * d:], nu)]
        for tag, g, w in pairs:
            diff = (g - w).abs()
            errs[f"{name}:{tag}"] = float(diff.max())
            ok &= bool((diff <= atol + rtol * w.abs()).all())
    return errs, ok


def phase_v(device, rows=V_ROWS, prepared=None):
    """DeepFM at criteo-10m-hugevocab-shape through the packed row-sparse
    step (the JAX bench's ``ctr_bigvocab_sparse_adam``): gen and ETL
    seconds (in ``start_ctr_data``'s process when ``prepared``), the
    table's rows, one epoch by ``fit`` and its test AUC, 20 timed steps,
    the card's busy share over ``V_PROFILE_STEPS`` profiled steps; one packed step held to one
    dense lazy-Adam step from the same state, to a bitwise repeat, and
    rows no lookup touched to be unchanged bit for bit; 20 steps of the
    dense ``LazyAdam`` on the same batches for comparison."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import ctr_shape_vocabs
    from recstudio_torch.utils import get_model
    if prepared is None:
        ds, (trn, val, tst), gen_s, etl_s = ctr_dataset(V_SHAPE, rows)
        wait_s = None
    else:
        ds, (trn, val, tst), gen_s, etl_s, wait_s = load_ctr_data(prepared)
    check(ds.num_inters == rows, f"phase V dataset {ds.num_inters} rows, not {rows}")
    vocab_rows = sum(ds.num_values(f) for f, t in ds.field2type.items() if t == "token")
    B = 8192
    cls, conf = get_model("DeepFM")
    conf["train"].update(epochs=1, batch_size=B, learner="sparse_adam", sparse_rows="auto",
                         learning_rate=1e-3, seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        return model, fit_s, model.evaluate(tst, verbose=False)

    (model, fit_s, result), counts = counted(drive)
    if model.ckpt_path and os.path.isfile(model.ckpt_path):
        os.remove(model.ckpt_path)          # a few GB of packed table
    engaged = model._ctr_sparse_enabled()
    tables = packed_table_names(model)
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, mlp=mc["mlp_layer"], activation=mc["activation"],
                 dropout=mc["dropout"], fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, mlp=[256, 256, 256], activation="tanh", dropout=0.3,
                        fields=39, batch=8192), f"phase V config {shape}")
    check(rows < V_ROWS or vocab_rows > V_MIN_TABLE_ROWS,
          f"phase V table {vocab_rows} rows, not past {V_MIN_TABLE_ROWS}")
    check(engaged and sorted(tables) == ["embedding.token_embedding.weight",
                                         "linear.embedding.token_embedding.weight"],
          f"phase V: the packed step did not engage ({sorted(tables)})")
    table = model.net.embedding.token_embedding.weight
    n = len(trn.data_index)

    # 20 timed steps on device-resident batches, peak memory
    batches = list(itertools.islice(epoch_stream(model), 23))

    def timed(m):
        torch.cuda.reset_peak_memory_stats(device)
        m.net.train()
        ms = []
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m._grad_step(batch)
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t) * 1e3)
        m.net.eval()
        return sorted(ms)[len(ms) // 2], min(ms), torch.cuda.max_memory_allocated(device) / 1e9

    step_p50, step_min, peak_gb = timed(model)

    # fit's epoch, and the first V_PROFILE_STEPS steps of the next profiled
    # for the card's busy time (a whole epoch under the profiler took 42 s
    # at 10,000,000 rows)
    epoch_s = model.epoch_log[0]["train_s"]
    steps = -(-n // B)

    def profiled_steps():
        model.net.train()
        for batch in itertools.islice(model._epoch_batches(), V_PROFILE_STEPS):
            model._grad_step(batch)
        model.net.eval()

    host_ms, busy_ms = busy_share(profiled_steps)
    busy_share_of_steps = None if busy_ms is None else \
        busy_ms / (V_PROFILE_STEPS * epoch_s / steps * 1e3)

    # one packed step from a saved state, twice: a bitwise repeat, and rows
    # no lookup of the batch touched unchanged bit for bit
    batch = batches[0]
    gen = model.generator.get_state()
    state = net_state(model)
    model.generator.set_state(gen)
    model.net.train()
    loss_a = float(model._grad_step(batch))
    after = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    set_net_state(model, state)
    model.generator.set_state(gen)
    loss_b = float(model._grad_step(batch))
    model.net.eval()
    bitwise = loss_a == loss_b and all(torch.equal(after[k], v)
                                       for k, v in model.net.state_dict().items())
    untouched_ok, touched_rows = True, {}
    for name, m in tables.items():
        touched = torch.zeros(after[name].shape[0], dtype=torch.bool, device=device)
        ids = torch.stack([batch[f] for _, f in m.token], -1).long() + m.offsets
        touched[ids.reshape(-1)] = True
        touched_rows[name] = int(touched.sum())
        untouched_ok &= torch.equal(after[name][~touched], state[0][name][~touched])

    # the same step on the dense LazyAdam from the same state
    dense = dense_copy(model, trn, state)
    check(not dense._ctr_sparse_enabled() and table.shape[1] == 3 * model.embed_dim,
          "phase V: the dense copy is packed")
    dense.generator.set_state(gen)
    dense.net.train()
    loss_d = float(dense._grad_step(batch))
    dense.net.eval()
    errs, same = packed_versus_dense(model, dense, state, after, tables)
    del state, after
    dense_p50, dense_min, dense_peak = timed(dense)
    del dense
    torch.cuda.empty_cache()

    out = {"phase": "V", "model": "DeepFM", "dataset": ds.name, "rows": rows,
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "learner": "sparse_adam", "sparse_rows": "auto", "packed_step": engaged,
           "vocab_slots": sum(ctr_shape_vocabs(V_SHAPE)), "table_rows": vocab_rows, "table_shape": list(table.shape),
           "table_gb": table.numel() * 4 / 1e9, "launches": counts, "gen_s": gen_s,
           "etl_s": etl_s, "data_wait_s": wait_s, "fit_s": fit_s,
           "steps_per_epoch": steps, "step_ms_p50": step_p50, "step_ms_min": step_min,
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "epoch_s": epoch_s, "epoch_examples_per_s": n / epoch_s,
           "profiled_steps": V_PROFILE_STEPS, "profiled_steps_host_ms": host_ms,
           "profiled_steps_busy_ms": busy_ms, "busy_share_of_epoch": busy_share_of_steps,
           "test_auc": result["auc"], "test_logloss": result["logloss"],
           "packed_vs_dense": {"loss_packed": loss_a, "loss_dense": loss_d,
                               "max_abs_err": max(errs.values()), "tol": TOL_PACKED,
                               "ok": same, "errors": errs},
           "untouched_rows_bitwise": untouched_ok, "touched_rows": touched_rows,
           "step_bitwise_repeat": bitwise,
           "dense_lazy_adam": {"step_ms_p50": dense_p50, "step_ms_min": dense_min,
                               "examples_per_s": B / dense_p50 * 1e3,
                               "peak_mem_gb": dense_peak}}
    emit("PHASE", out)
    check(not any(counts.values()), f"phase V launched a kernel: {counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and 0 < result["auc"] < 1,
          f"phase V loss {model.epoch_log[0]['train_loss']}, AUC {result['auc']}")
    check(same, f"phase V: the packed step differs from dense lazy Adam's: {errs}")
    check(untouched_ok, "phase V: the packed step moved rows no lookup touched")
    check(bitwise, "phase V: the packed step does not repeat bit for bit")
    return out


def phase_w(device):
    """AutoInt at its repo config on phase R's data (criteo-1m-shape), batch
    8192: a one-epoch fit and its test AUC (the evaluation through K3), 20
    timed steps (dropout 0.5 in training: the plain softmax, no kernel),
    one step held to the CPU copy with the same dropout seeds, the
    evaluation's probabilities held to the plain-attention route on the
    same weights, eval rows/s, and ``ScorePredictor`` at 8192 rows a
    request held to ``predict``."""
    import numpy as np
    import torch
    from recstudio_torch.models.module.layers import MultiHeadAttention
    from recstudio_torch.serving import ScorePredictor
    from recstudio_torch.utils import get_model
    ref, ds, (trn, val, tst), _, _, gen_s, etl_s = criteo_setup()
    B = ref["batch_size"]
    cls, conf = get_model("AutoInt")
    conf["train"].update(epochs=1, batch_size=B, learner="adam", learning_rate=1e-3,
                         seed=2022)
    conf["eval"].update(batch_size=B, val_metrics=["auc"], test_metrics=["auc", "logloss"],
                        save_path=SAVE_DIR)

    def drive():
        model = cls(conf, device=device)
        t = time.perf_counter()
        model.fit(trn, None)
        fit_s = time.perf_counter() - t
        return model, fit_s, model.evaluate(tst, verbose=False)

    (model, fit_s, result), counts = counted(drive)
    mc = model.config["model"]
    shape = dict(embed_dim=model.embed_dim, **{k: mc[k] for k in (
        "attention_dim", "num_attention_layers", "n_head", "mlp_layer", "activation",
        "dropout", "wide", "deep", "residual_project", "layer_norm")},
        fields=len(model.net.embedding.field_specs), batch=B)
    check(shape == dict(embed_dim=10, attention_dim=64, num_attention_layers=3, n_head=2,
                        mlp_layer=[128, 64], activation="relu", dropout=0.5, wide=True,
                        deep=True, residual_project=True, layer_norm=False, fields=39,
                        batch=8192), f"phase W config {shape}")
    n = len(trn.data_index)
    batches = list(itertools.islice(epoch_stream(model), 23))
    torch.cuda.reset_peak_memory_stats(device)
    model.net.train()
    step_ms = []
    _, train_counts = counted(lambda: model._grad_step(batches[0]))
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

    # one step on the card held to the CPU copy (same batch and dropout seeds)
    batch = batches[0]
    gen = model.generator.get_state()
    loss_k, grads_k = ranker_step(model, batch, gen)
    cpu = cpu_copy(model, trn)
    loss_c, grads_c = ranker_step(cpu, {k: v.cpu() for k, v in batch.items()}, gen)
    key_biases = [k for k in grads_c if k.endswith(".attn.k_proj.bias")]
    grads_k = {k: v.cpu() for k, v in grads_k.items()}
    max_abs, ok = grad_errors(grads_k, grads_c, key_biases)
    # each tensor's largest error over its tolerance (1 at the tolerance)
    grad_err_over_tol = {k: float(((grads_k[k] - w).abs() / (
        TOL_GRAD[0] * float(w.abs().max()) + TOL_GRAD[1] * w.abs() + 1e-30)).max())
        for k, w in grads_c.items()}
    del cpu

    # the evaluation's probabilities through K3, and through the plain softmax
    attn = [m for m in model.net.modules() if isinstance(m, MultiHeadAttention)]
    probs_k, eval_counts = counted(lambda: eval_probs(model, tst))
    for m in attn:
        m.plain = True
    probs_p = eval_probs(model, tst)
    for m in attn:
        m.plain = False
    k3_diff = float(np.abs(probs_k - probs_p).max())
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._eval_epoch(tst, ["auc", "logloss"], [None])
    eval_s = time.perf_counter() - t

    # ScorePredictor at 8192 rows a request, held to predict()
    pred = ScorePredictor(model, max_batch=B, train_data=trn)
    fields = [f for f in tst.inter_feat.fields if f != model.frating]
    starts = range(0, min(8 * B, len(tst.data_index)), B)
    requests = [{f: tst.inter_feat.get_col(f)[tst.data_index[i:i + B]] for f in fields}
                for i in starts]
    pred.warm(requests[0])
    served, serve_counts = counted(lambda: [pred(r) for r in requests])
    want = [model.predict(tst._get_pos_batch(np.arange(i, i + len(r)))) for i, r in zip(
        starts, served)]
    serve_diff = max(float(np.abs(a - b).max()) for a, b in zip(served, want))
    L = len(model.net.embedding.field_specs)
    tile = 32
    out = {"phase": "W", "model": "AutoInt", "dataset": ds.name, "rows": ref["rows"],
           "train_rows": n, "test_rows": len(tst.data_index), "config": shape,
           "launches": counts, "training_step_launches": train_counts,
           "eval_launches": eval_counts, "serve_launches": serve_counts,
           "fit_s": fit_s, "fit_epoch_s": model.epoch_log[0]["train_s"],
           "steps_per_epoch": -(-n // B), "step_ms_p50": step_p50, "step_ms_min": min(step_ms),
           "examples_per_s": B / step_p50 * 1e3, "peak_mem_gb": peak_gb,
           "test_auc": result["auc"], "test_logloss": result["logloss"],
           "eval_s": eval_s, "eval_rows_per_s": len(tst.data_index) / eval_s,
           "cpu_loss": loss_c, "card_loss": loss_k, "grad_max_abs_err": max_abs,
           "grad_tol": TOL_GRAD, "loss_tol": TOL_LOSS, "zero_gradients": key_biases,
           "grad_err_over_tol": grad_err_over_tol,
           "zero_gradient_tol": TOL_ZERO_GRAD,
           "k3_vs_plain_route_max_abs_diff": k3_diff, "prob_tol": TOL_PROB,
           "k3_real_pair_share_of_tiles": L * L / (-(-L // tile) * tile) ** 2,
           "serve_max_abs_diff_vs_predict": serve_diff,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    others = {k: v for k, v in counts.items() if k != "fused_mha" and v}
    check(not others, f"phase W launched {others}")
    check(counts["fused_mha"] > 0 and eval_counts["fused_mha"] > 0
          and serve_counts["fused_mha"] > 0 and not any(train_counts.values()),
          f"phase W: K3 launches fit/evaluate {counts}, eval {eval_counts}, serving "
          f"{serve_counts}, a training step {train_counts}")
    check(np.isfinite(model.epoch_log[0]["train_loss"]) and 0 < result["auc"] < 1,
          f"phase W loss {model.epoch_log[0]['train_loss']}, AUC {result['auc']}")
    check(abs(loss_k - loss_c) <= TOL_LOSS * abs(loss_c), f"phase W loss {loss_k} vs {loss_c}")
    check(ok, f"phase W gradients disagree with the CPU copy's: {max_abs}")
    check(k3_diff <= TOL_PROB, f"phase W: K3's probabilities differ from the plain route's "
                               f"by {k3_diff}")
    check(serve_diff <= TOL_PROB, f"phase W ScorePredictor differs from predict by {serve_diff}")
    return out


def phase_x(device):
    """WideDeep, DCN, NFM and AutoInt the way users start them
    (``ranker_fit_phase``): batch norms calibrated, AutoInt's validation,
    evaluation and serving through K3."""
    return [ranker_fit_phase(device, "X", name, expected,
                             ("fused_mha",) if name == "AutoInt" else (), profile=False)
            for name, expected in (
                ("WideDeep", dict(embed_dim=10, mlp_layer=[256, 256, 256], activation="relu",
                                  dropout=0.3, batch_norm=True)),
                ("DCN", dict(embed_dim=10, mlp_layer=[256, 256, 256], num_layers=6,
                             activation="relu", dropout=0.5, batch_norm=True)),
                ("NFM", dict(embed_dim=10, mlp_layer=[128, 128, 128], activation="sigmoid",
                             dropout=0.3, batch_norm=True)),
                ("AutoInt", dict(embed_dim=10, attention_dim=64, num_attention_layers=3,
                                 n_head=2, mlp_layer=[128, 64], dropout=0.5)))]


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases Y, Y2, Z: the sampler layer
# ---------------------------------------------------------------------------
# the proposals and mining methods of train.sampler and train.sampling_method
# that phase Y runs for SAMPLER_MODE_STEPS steps each beside its midx-pop fit
PROPOSALS = ("uniform", "pop", "midx-uni", "cluster-uni", "cluster-pop", "lsh")
MINING = ("dns", "sir", "brute", "toprand", "top&rand")
SAMPLER_MODE_STEPS = 50
# phase Y2's timed SASRec steps (the loss must fall from the first 50 to the last 50)
Y2_STEPS = 300
# draws a sampler makes for one fixed batch of queries in its distribution gate
SAMPLER_DRAWS = 2 ** 20
# the gate: total variation of the draws' frequencies from the proposal (over
# buckets, or items grouped by id where the support is large) at most twice
# its expected value under the proposal itself plus this slack
TV_SLACK = 0.005
# id groups of the item-level gates on a large support
ID_GROUPS = 1024
# log_neg_prob against compute_item_p of the draws: the same float32 dot
# products of O(1) vectors, taken by a product and by an einsum
TOL_ITEM_P = 1e-4
# a sampler state built on the card against its CPU copy from the same
# k-means result: floats (rtol, atol), the bucket weights being sums of up
# to ~3,300 float32 weights (a cluster's items) that the two devices add in
# other orders, n eps at most 2e-4; the in-bucket CDF cp, running sums of
# up to a bucket's weights over their total
TOL_STATE = (2e-4, 1e-6)
TOL_CP = 2e-3


def tv_and_noise(counts, probs):
    """Total variation of ``counts``' frequencies from ``probs`` and its
    expected value when the draws follow ``probs`` (numpy float64)."""
    import numpy as np
    n = counts.sum()
    tv = 0.5 * float(np.abs(counts / n - probs).sum())
    noise = 0.5 * float(np.sum(np.sqrt(2.0 * probs * (1.0 - probs) / (np.pi * n))))
    return tv, noise


def proposal_groups(sampler, state, queries, num_items):
    """The sampler's proposal for each of ``queries`` [Q, D], from its
    definition in float64 (not the sampler's code): ``(group of each item
    id [num_items], the mean over the queries of the proposal over the
    groups, name of the level)``. MIDX: its K^2 buckets; cluster: its K
    clusters; popularity, uniform and LSH: items grouped by id range."""
    import torch
    from recstudio_torch.ann import sampler as S
    q = queries.double()
    ids = torch.arange(num_items, device=q.device)
    by_id = torch.clamp_max(ids * ID_GROUPS // num_items, ID_GROUPS - 1)

    def grouped(p_items):                      # [Q, num_items] -> [ID_GROUPS]
        out = torch.zeros(ID_GROUPS, dtype=torch.float64, device=q.device)
        return out.index_add(0, by_id, p_items.mean(0))

    if isinstance(sampler, S.MIDXSamplerUniform) and not isinstance(
            sampler, S.ClusterSamplerUniform):
        K = sampler.K
        half = q.shape[-1] // 2
        r0s = torch.softmax(q[:, :half] @ state["c0"].double().t(), -1)
        r1s = torch.softmax(q[:, half:] @ state["c1"].double().t(), -1)
        wkk = state["wkk"].double()
        s0 = (r1s @ wkk.t()) * r0s + 1e-12
        s1 = wkk[None] * r1s[:, None, :] + 1e-12
        p = (s0 / s0.sum(-1, keepdim=True))[:, :, None] * s1 / s1.sum(-1, keepdim=True)
        group = (state["cd0"] - 1) * K + state["cd1"] - 1
        return group, p.reshape(len(q), -1).mean(0), "bucket"
    if isinstance(sampler, S.ClusterSamplerUniform):
        p = torch.softmax(q @ state["c"].double().t(), -1)
        return state["cd"] - 1, p.mean(0), "cluster"
    if isinstance(sampler, S.PopularSamplerModel):
        return by_id, grouped(state["pop_prob"].double()[None]), "item_id_group"
    if isinstance(sampler, S.LSHSampler):
        code_q = sampler._hash(queries)                                   # [Q, L]
        code_i = sampler._hash(state["item_embs"])                        # [N - 1, L]
        share = (code_i[None] == code_q[:, None]).sum(-1).double()        # [Q, N - 1]
        share = torch.cat([share.new_zeros(len(q), 1), share], 1)
        return by_id, grouped(share / share.sum(-1, keepdim=True)), "item_id_group"
    p = torch.full((1, num_items), 1.0 / (num_items - 1), dtype=torch.float64, device=q.device)
    p[:, 0] = 0.0
    return by_id, grouped(p), "item_id_group"


def sampler_gates(model, queries, tag):
    """The sampler's gates for one fixed batch of ``queries`` [Q, D]:
    ``SAMPLER_DRAWS`` draws against its proposal (and, for MIDX, the items
    of its likeliest bucket against the in-bucket law), and its
    ``log_neg_prob`` against ``compute_item_p`` of the draws. Returns the
    report; fails the run on a gate."""
    import torch
    from recstudio_torch.ann import sampler as S
    sampler, state = model.sampler, model.states.get("sampler")
    n = model.num_items
    per_query = SAMPLER_DRAWS // len(queries)
    gen = torch.Generator(device=queries.device)
    gen.manual_seed(2040)
    with torch.no_grad():
        _, neg, lnp = sampler(queries, per_query, gen, state=state)
        group, probs, level = proposal_groups(sampler, state, queries, n)
        drawn = group[neg.reshape(-1)]
        counts = torch.bincount(drawn, minlength=len(probs)).double()
        tv, noise = tv_and_noise(counts.cpu().numpy(), probs.cpu().numpy())
        out = {"sampler": type(sampler).__name__, "draws": int(neg.numel()), "level": level,
               "cells": len(probs), "tv": tv, "tv_expected_noise": noise,
               "tv_bound": 2 * noise + TV_SLACK}
        check(tv <= 2 * noise + TV_SLACK,
              f"phase {tag} {out['sampler']}: draws off the proposal, TV {tv} (noise {noise})")
        if isinstance(sampler, S.MIDXSamplerUniform) and level == "bucket":
            top = int(torch.argmax(probs))
            members = state["indices"][state["indptr"][top]:state["indptr"][top + 1]] + 1
            w = state["p"][members].double() if "p" in state else \
                torch.ones(len(members), dtype=torch.float64, device=members.device)
            inside = neg.reshape(-1)[drawn == top]
            c = (inside[:, None] == members[None, :]).sum(0).double()
            itv, inoise = tv_and_noise(c.cpu().numpy(), (w / w.sum()).cpu().numpy())
            out.update(in_bucket_items=len(members), in_bucket_draws=int(inside.numel()),
                       in_bucket_tv=itv, in_bucket_tv_bound=2 * inoise + TV_SLACK)
            check(itv <= 2 * inoise + TV_SLACK,
                  f"phase {tag} {out['sampler']}: in-bucket draws off, TV {itv} ({inoise})")
        if not isinstance(sampler, (S.LSHSampler, S.UniformSampler)):
            q = sampler._queries(queries) if hasattr(sampler, "_queries") else queries
            want = sampler.compute_item_p(q, neg, state)
            diff = (lnp - want).abs()
            bad = int((diff > TOL_ITEM_P * torch.clamp_min(want.abs(), 1.0)).sum())
            out.update(log_prob_max_abs_diff=float(diff.max()), log_prob_mismatches=bad,
                       log_prob_tol=TOL_ITEM_P)
            check(bad == 0, f"phase {tag} {out['sampler']}: {bad} log_neg_prob differ from "
                            "compute_item_p of the draws")
    return out


def state_cpu_copy(model, tag):
    """The card's sampler state against a CPU copy built from the same
    k-means result: integer arrays bit for bit, floats to ``TOL_STATE``
    (``cp`` to ``TOL_CP``)."""
    import torch
    from recstudio_torch.ann import sampler as S
    sampler, state = model.sampler, model.states["sampler"]
    x = model.states["item_vector"].cpu()
    cpu = {k: v.cpu() for k, v in state.items()}
    if isinstance(sampler, S.ClusterSamplerUniform):
        copy = sampler.build_state(x, cpu["c"], cpu["cd"][1:] - 1)
    else:
        copy = sampler.build_state(x, cpu["c0"], cpu["cd0"][1:] - 1, cpu["c1"], cpu["cd1"][1:] - 1)
    worst, ok = {}, sorted(copy) == sorted(cpu)
    for key, want in copy.items():
        got = cpu[key]
        if not torch.is_floating_point(want):
            same = torch.equal(got, want)
            worst[key] = 0.0 if same else float((got - want).abs().max())
            ok &= same
            continue
        worst[key] = float((got - want).abs().max())
        if key == "cp":
            ok &= worst[key] <= TOL_CP
        else:
            ok &= bool(torch.allclose(got, want, rtol=TOL_STATE[0], atol=TOL_STATE[1]))
    check(ok, f"phase {tag}: the card's sampler state differs from the CPU copy's: {worst}")
    return {"max_abs_diff": worst, "tol": TOL_STATE, "cp_tol": TOL_CP}


def refresh_repeats(model):
    """``_epoch_refresh(0)`` twice from the same generator state: whether
    every state tensor repeats bit for bit, and the second's ms."""
    import torch
    gen = model.device_generator.get_state()
    model._epoch_refresh(0)
    first = {k: v.clone() for k, v in model.states["sampler"].items()}
    first["item_vector"] = model.states["item_vector"].clone()
    model.device_generator.set_state(gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model._epoch_refresh(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    again = dict(model.states["sampler"], item_vector=model.states["item_vector"])
    return all(torch.equal(first[k], again[k]) for k in first) and sorted(first) == \
        sorted(again), ms


def sample_ms(model, batch):
    """Card time of one batch's ``sampling`` (the train config's method),
    its query encoded in eval mode."""
    import torch
    tc = model.config["train"]
    was = model.net.training
    model.net.eval()
    with torch.no_grad():
        q = model.net.encode_query(model._get_query_feat(batch))
    model.net.train(was)
    return time_ms(lambda: model.sampling(batch, model.neg_count, q,
                                          method=tc.get("sampling_method", "none"),
                                          excluding_hist=tc.get("excluding_hist", False)),
                   iters=10)


def phase_y(device):
    """BPR at amazon-book-shape with ``SampledSoftmaxLoss`` under the
    ``midx-pop`` proposal (32 clusters a half-space, 100 negatives, batch
    2048): two epochs, each after the sampler's refresh, and the test
    NDCG@10; then each other proposal and mining method for
    ``SAMPLER_MODE_STEPS`` steps; the sampler gates."""
    import numpy as np
    import torch
    from recstudio_torch.data.synthetic import SHAPES, generate
    from recstudio_torch.models.loss_func import SampledSoftmaxLoss
    from recstudio_torch.ops.kmeans import kmeans
    from recstudio_torch.utils import get_model, seed_everything
    cls, conf = get_model("BPR")
    t0 = time.perf_counter()
    name, config = generate("amazon-book-shape", *SHAPES["amazon-book-shape"], seed=7)
    if _AMAZON.get("name") == name:                   # phase T's splits (same data config)
        ds, (trn, tst) = _AMAZON["ds"], _AMAZON["splits"]
    else:
        seed_everything(2022)
        ds = cls._get_dataset_class()(name, config=config)
        trn, _, tst = ds.build(**conf["data"])
    etl_s = time.perf_counter() - t0
    conf["train"].update(batch_size=2048, sampler="midx-pop", sampler_num_clusters=32,
                         negative_count=100, epochs=2)
    conf["eval"].update(batch_size=512, cutoff=[10], test_metrics=["ndcg", "recall"],
                        topk=100, save_path=SAVE_DIR)
    tc = conf["train"]
    model = cls(conf, device=device, loss=SampledSoftmaxLoss())
    model._init_model(trn)
    model._init_parameter(trn)
    model.optimizer = model._get_optimizer()
    model._setup_scan_epoch(trn)
    shape = dict(embed_dim=model.embed_dim, batch=tc["batch_size"], lr=tc["learning_rate"],
                 learner=tc["learner"], sampler=tc["sampler"],
                 clusters=tc["sampler_num_clusters"], negatives=tc["negative_count"],
                 loss=type(model.loss_fn).__name__, users=ds.num_users - 1,
                 items=ds.num_items - 1, inters=int(ds.num_inters))
    check(shape == dict(embed_dim=64, batch=2048, lr=1e-3, learner="adam", sampler="midx-pop",
                        clusters=32, negatives=100, loss="SampledSoftmaxLoss", users=52643,
                        items=91593, inters=2_984_108), f"phase Y config {shape}")
    steps_per_epoch = -(-model._epoch_rows // tc["batch_size"])

    # the refresh: the catalog encode, two k-means runs, the index and CDFs
    model._epoch_refresh(0)                               # warm
    bitwise, refresh_ms = refresh_repeats(model)
    half = model.states["item_vector"][:, :32].contiguous()
    kmeans_ms = time_ms(lambda: kmeans(half, 32, 30, model.device_generator), iters=3, warmup=1)
    state_y = state_cpu_copy(model, "Y")

    def fit_two_epochs():
        epochs = []
        for ep in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model._epoch_refresh(ep)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = model.training_epoch(ep)
            torch.cuda.synchronize()
            epochs.append({"epoch": ep, "refresh_ms": (t1 - t) * 1e3,
                           "train_s": time.perf_counter() - t1, "train_loss": loss})
        return epochs

    torch.cuda.reset_peak_memory_stats()
    epochs, fit_counts = counted(fit_two_epochs)
    fit_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev = model._eval_epoch(tst, ["ndcg", "recall"], [10])
    eval_s = time.perf_counter() - t
    model._epoch_refresh(2)
    batches = [b for b, _ in zip(epoch_stream(model), range(100))]
    host_ms, busy_ms = busy_share(lambda: [model._grad_step(b) for b in batches])
    base_sample_ms = sample_ms(model, batches[0])
    gates = [sampler_gates(model, model.net.encode_query(batches[0][model.fuid][:4]).detach(),
                           "Y")]

    # each other proposal and mining method, SAMPLER_MODE_STEPS steps each
    modes = []
    for mode in PROPOSALS + MINING:
        if mode in PROPOSALS:
            tc.update(sampler=mode, sampling_method="none", negative_count=100)
        else:
            tc.update(sampler="midx-pop", sampling_method=mode, negative_count=[200, 100])
        model.neg_count = tc["negative_count"]
        model.sampler = model._get_sampler(trn)
        model.states.pop("sampler", None)
        model._epoch_refresh(3)
        torch.cuda.reset_peak_memory_stats()
        _, times, losses, counts = timed_steps(model, epoch_stream(model),
                                               n=SAMPLER_MODE_STEPS)
        row = {"mode": mode, "sampler": type(model.sampler).__name__,
               "sampling_method": tc["sampling_method"], "negatives": tc["negative_count"],
               "sample_ms": sample_ms(model, batches[0]), "step_ms_p50": times[len(times) // 2],
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "losses_finite": bool(torch.isfinite(losses).all()),
               "launches": sum(counts.values()),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if mode in PROPOSALS:
            row["gate"] = sampler_gates(
                model, model.net.encode_query(batches[0][model.fuid][:4]).detach(), "Y")
        if mode in ("cluster-pop",):
            row["state_vs_cpu"] = state_cpu_copy(model, "Y")
        modes.append(row)
        emit("SAMPLER_MODE", {"phase": "Y", **row})
    model.states.clear()
    train_s = [e["train_s"] for e in epochs]
    step_ms = sum(train_s) / (2 * steps_per_epoch) * 1e3
    out = {"phase": "Y", "model": "BPR", "dataset": name, "config": shape, "etl_s": etl_s,
           "train_rows": model._epoch_rows, "steps_per_epoch": steps_per_epoch,
           "refresh_ms": refresh_ms, "kmeans_ms_one_run": kmeans_ms,
           "refresh_bitwise_repeat": bitwise, "state_vs_cpu": state_y, "epochs": epochs,
           "launches": fit_counts, "step_ms_mean": step_ms, "sample_ms": base_sample_ms,
           "examples_per_s": tc["batch_size"] / (step_ms / 1e3), "peak_mem_gb": fit_peak,
           "profiled_steps": len(batches), "profiled_host_ms": host_ms,
           "profiled_busy_ms": busy_ms,
           "busy_share": None if busy_ms is None else busy_ms / host_ms,
           "eval_users": len(tst.data_index), "eval_s": eval_s, **ev,
           "gates": gates, "modes": modes}
    emit("PHASE", out)
    check(bitwise, "phase Y: the sampler refresh does not repeat bit for bit")
    check(not any(fit_counts.values()), f"phase Y launched a kernel: {fit_counts}")
    check(all(np.isfinite(e["train_loss"]) for e in epochs), "phase Y loss")
    check(all(m["losses_finite"] for m in modes),
          f"phase Y: a mode's loss is not finite: {[m['mode'] for m in modes]}")
    check(not any(m["launches"] for m in modes), "phase Y: a mode launched a kernel")
    check(np.isfinite(ev["ndcg@10"]) and ev["ndcg@10"] > 0, f"phase Y test NDCG@10 {ev}")
    return out


def phase_y2(device):
    """SASRec at phase D's ml-1m-shape setup (hidden 128, 2 layers, 2 heads,
    dropout 0.5, L 200) with ``SampledSoftmaxLoss`` under the ``midx-uni``
    proposal over ``[B, L, D]`` queries (32 clusters, 20 negatives, batch
    256): ``Y2_STEPS`` steps through K1 and K2, the loss falling; the
    sampler gates; requests served through K1."""
    import torch
    from recstudio_torch.models.loss_func import SampledSoftmaxLoss
    from recstudio_torch.serving import Predictor
    model, conf, ds, tst, name, etl_s = training_model(
        device, "SASRec", 256, embed_dim=128,
        train=dict(sampler="midx-uni", sampler_num_clusters=32, negative_count=20),
        parts=dict(loss=SampledSoftmaxLoss()))
    mc, tc = conf["model"], conf["train"]
    shape = dict(B=tc["batch_size"], L=ds.max_seq_len, D=model.embed_dim, F=mc["hidden_size"],
                 H=mc["head_num"], layers=mc["layer_num"], dropout=mc["dropout_rate"],
                 sampler=tc["sampler"], clusters=tc["sampler_num_clusters"],
                 negatives=tc["negative_count"], loss=type(model.loss_fn).__name__)
    check(shape == dict(B=256, L=200, D=128, F=128, H=2, layers=2, dropout=0.5,
                        sampler="midx-uni", clusters=32, negatives=20,
                        loss="SampledSoftmaxLoss"), f"phase Y2 config {shape}")
    model._epoch_refresh(0)
    bitwise, refresh_ms = refresh_repeats(model)
    state_y2 = state_cpu_copy(model, "Y2")
    torch.cuda.reset_peak_memory_stats()
    steps, times, losses, counts = timed_steps(model, epoch_stream(model), n=Y2_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    batch = steps[-1]
    model.net.eval()
    s_ms = sample_ms(model, batch)
    # four position queries [L, D] of the last batch's first sequence, as
    # training encodes them (the per-position queries the sampler draws for)
    model.net.train()
    with torch.no_grad():
        q = model.net.encode_query(model._get_query_feat(batch), model.generator)
    model.net.eval()
    gates = [sampler_gates(model, q[0][batch[model.fiid][0] > 0][:4].contiguous(), "Y2")]
    model.states.pop("item_vector", None)

    def serve():
        pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
        reqs = list(itertools.islice(tst.eval_loader(256), 2))
        for b in reqs:
            pred({f: b[f][:int(b["_size"])] for f in sorted(model.query_fields)})
        return pred

    pred, serve_counts = counted(serve)
    out = {"phase": "Y2", "model": "SASRec", "dataset": name, "config": shape, "etl_s": etl_s,
           "refresh_ms": refresh_ms, "refresh_bitwise_repeat": bitwise,
           "state_vs_cpu": state_y2, "steps": len(times), "launches": counts,
           "step_ms_p50": times[len(times) // 2], "step_ms_max": times[-1],
           "sample_ms": s_ms, "examples_per_s": 256 / (times[len(times) // 2] / 1e3),
           "loss_first_50_mean": first, "loss_last_50_mean": last, "peak_mem_gb": peak,
           "gates": gates, "serve_launches": serve_counts,
           **{"serve_" + k: v for k, v in pred.stats().items()}}
    emit("PHASE", out)
    check(bitwise, "phase Y2: the sampler refresh does not repeat bit for bit")
    check(counts["fused_transformer_layer"] > 0 and counts["fused_transformer_layer_bwd"] > 0,
          f"phase Y2 launched no K1 or no K2 in training: {counts}")
    check(serve_counts["fused_transformer_layer"] > 0, f"phase Y2 served without K1: "
                                                       f"{serve_counts}")
    check(bool(torch.isfinite(losses).all()), "phase Y2 loss not finite")
    check(last < first, f"phase Y2: the loss did not fall ({first} -> {last})")
    return out


def phase_z(device):
    """PMF, CML, NCF (fusion), LogisticMF and BPR under ``midx-pop`` the way
    users start them (``quickstart.run`` on ml-100k at the repo's configs,
    for the epochs of their JAX references), each held to its JAX seeds'
    band (``recstudio_torch/assets/{pmf,cml,ncf,logisticmf,bpr_midx_pop}_
    ml100k_train_reference.json``, written by ``scripts/torch_mf_seeds.py``)
    and every test user served through ``Predictor``, whose lists give
    ``evaluate``'s metrics."""
    runs = (
        ("PMF", "pmf", {}, dict(embed_dim=64, batch=512, learner="adam")),
        ("CML", "cml", dict(margin="margin"), dict(embed_dim=64, margin=1, batch=512,
                                                   negative_count=5)),
        ("NCF", "ncf", dict(score_mode="score_mode", mlp="mlp_hidden_size"),
         dict(embed_dim=64, score_mode="fusion", mlp=[128, 64], batch=512, negative_count=1)),
        ("LogisticMF", "logisticmf", {}, dict(embed_dim=64, batch=512, learner="adagrad",
                                              negative_count=10)),
        ("BPR", "bpr_midx_pop", {}, dict(embed_dim=64, batch=512, sampler="midx-pop",
                                         negative_count=1)))
    out = []
    for model_name, ref_name, keys, expected in runs:
        with open(ML100K_TRAIN_REFERENCE.format(ref_name)) as f:
            overrides = json.load(f).get("overrides") or None
        out.append(fit_phase(device, "Z", model_name, ML100K_TRAIN_REFERENCE.format(ref_name),
                             keys, expected, (), quickstart=True, overrides=overrides))
    return out


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


def k3_unmasked_versus_plain(device, B, H, L, Dh):
    """K3 through ``fused_mha`` with no mask at all (AutoInt's attention over
    the fields) against mha_plain, with a bitwise repeat, beside SDPA; the
    share of the ``MHA_TILE`` tiles' score pairs that are real (L pads to
    whole tiles)."""
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import MHA_TILE, fused_mha, mha_plain
    rng = np.random.default_rng(B + L + 2)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
               for _ in range(3))
    kern = lambda: fused_mha(q, k, v)
    plain = lambda: mha_plain(q, k, v)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K3)
        bitwise = torch.equal(got, kern())
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(lib)
    flops = 4 * B * H * L * L * Dh
    nbytes = 4 * 4 * B * H * L * Dh
    b_ms, by = bound(flops, nbytes)
    padded = (-(-L // MHA_TILE[0]) * MHA_TILE[0]) * (-(-L // MHA_TILE[1]) * MHA_TILE[1])
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh, causal=False, key_padding=False),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "tol": TOL_K3,
            "ok": ok and bitwise, "bitwise_repeatable": bitwise, "tile": list(MHA_TILE),
            "real_pair_share_of_tiles": L * L / padded, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


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

    v_data = start_ctr_data(V_SHAPE, V_ROWS)
    try:
        return _main(device, v_data)
    finally:
        if v_data[0].poll() is None:
            v_data[0].kill()
            v_data[0].wait()
        for path in (v_data[1], v_data[1] + ".part"):
            if os.path.isfile(path):
                os.remove(path)


def _main(device, v_data) -> int:
    import torch
    from recstudio_torch.ops import _native
    gpu = gpu_line()
    lib = _native.load()
    ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("BUILD", {"seconds": lib.build_seconds, "library": os.path.relpath(lib.path, REPO)})
    for ln in ptxas:
        print(f"PTXAS {ln}", flush=True)

    phases = []
    for fn in (phase_a, phase_b, phase_c, phase_d, phase_e, phase_f, phase_g, phase_h,
               phase_i, phase_j, phase_k, phase_l, phase_m, phase_n, phase_o, phase_p,
               phase_q, phase_r, phase_s, phase_t, phase_u, phase_w, phase_x, phase_y,
               phase_y2, phase_z, lambda d: phase_v(d, prepared=v_data)):
        t = time.perf_counter()
        out = fn(device)
        phases += out if isinstance(out, list) else [out]
        print(f"LAP {phases[-1]['phase']} {time.perf_counter() - t:.1f} s", flush=True)

    k1_a = k1_versus_plain(device, 128, 20, 64, 128, 2)
    k1_b = k1_versus_plain(device, 256, 200, 128, 128, 2)
    k3_b = k3_versus_plain(device, 256, 2, 200, 64)
    k3_c = k3_versus_plain(device, 64, 2, 384, 64)
    # BERT4Rec's attention through K1 at F: no attention mask, right padding
    k3_f = k3_versus_plain(device, 256, 2, 200, 32, causal=False)
    # AutoInt's attention over criteo's 39 fields at W's batch: no mask, Dh 32
    k3_autoint = k3_unmasked_versus_plain(device, 8192, 2, 39, 32)
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
            ("K3@F", k3_f), ("K3@autoint", k3_autoint),
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
         "launches": launches("fused_mha"),
         "launches_by_phase": {p["phase"] + ("" if "model" not in p else f":{p['model']}"):
                               p["launches"]["fused_mha"] for p in phases
                               if p["launches"].get("fused_mha")}, **row(k3_c)},
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
    if sys.argv[1:2] == ["--ctr-data"]:     # start_ctr_data's process
        write_ctr_data(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
