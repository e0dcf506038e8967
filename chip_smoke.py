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
# logZ (K7): logsumexp of up to 500,000 float32 terms, each thread summing
# its share in order; values near 10
TOL_LOGZ = (1e-4, 1e-5)


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
    import torch
    from recstudio_torch import eval as ev
    ids_t = torch.as_tensor(ids)
    tgt = torch.as_tensor(targets)[:, None]
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
    """Run ``fn`` with every launch count zeroed first; return (result, counts)."""
    import torch
    from recstudio_torch import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


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
    steps, times, losses, counts = timed_steps(model, model._epoch_batches())
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


def fit_phase(device, tag, model_name, reference, dropout_key, expected, kernels):
    """fit + evaluate on ml-100k at the repo's config for the reference's
    epochs, test NDCG@10 held to the JAX seeds' band, then 8 requests served
    from the trained weights."""
    import numpy as np
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model
    with open(reference) as f:
        ref = json.load(f)
    cls, conf = get_model(model_name)
    conf["train"]["epochs"] = ref["epochs"]
    conf["eval"]["save_path"] = SAVE_DIR
    ds = cls._get_dataset_class()("ml-100k")
    trn, val, tst = ds.build(**conf["data"])
    model = cls(conf, device=device)
    mc, tc = conf["model"], conf["train"]
    shape = dict(embed_dim=model.embed_dim, hidden=mc["hidden_size"], heads=mc["head_num"],
                 layers=mc["layer_num"], dropout=mc[dropout_key],
                 L=ds.max_seq_len, batch=tc["batch_size"], epochs=tc["epochs"])
    shape.update({k: tc[k] for k in ("mask_ratio", "weight_decay") if k in expected})
    check(shape == dict(expected, epochs=ref["epochs"]), f"phase {tag} config {shape}")

    def drive():
        t0 = time.perf_counter()
        model.fit(trn, val)
        fit_s = time.perf_counter() - t0
        result = model.evaluate(tst, verbose=False)
        pred = Predictor(model, max_batch=128, k=20, train_data=tst).warm()
        served = serve_split(pred, model, tst, 128)
        return fit_s, result, pred, served

    (fit_s, result, pred, (scores, ids, targets)), counts = counted(drive)
    served = rank_metrics(ids, targets)
    lo, hi = ref["ndcg@10_band"]
    out = {"phase": tag, "model": model_name, "dataset": "ml-100k", "config": shape,
           "launches": counts, "fit_s": fit_s,
           "epochs": [{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in e.items()} for e in model.epoch_log],
           "test_ndcg@10": result["ndcg@10"], "test_recall@10": result["recall@10"],
           "jax_band_ndcg@10": [lo, hi], "jax_runs": ref["runs"],
           "requests": pred.stats()["requests"], "served_ndcg@10": served["ndcg@10"],
           "served_recall@10": served["recall@10"], **{"serve_" + k: v for k, v in
                                                       pred.stats().items()}}
    if "untrained_ndcg@10" in ref:
        out["jax_untrained_ndcg@10"] = ref["untrained_ndcg@10"]
    emit("PHASE", out)
    for name in kernels:
        check(counts[name] > 0, f"phase {tag} launched no {name}")
    check(all(np.isfinite(e["train_loss"]) for e in model.epoch_log), f"phase {tag} loss")
    check(lo <= result["ndcg@10"] <= hi,
          f"phase {tag} test NDCG@10 {result['ndcg@10']} outside the JAX band [{lo}, {hi}]")
    check(pred.stats()["requests"] == 8, f"phase {tag} served other than 8 requests")
    check(abs(served["ndcg@10"] - result["ndcg@10"]) <= TOL_METRIC and
          abs(served["recall@10"] - result["recall@10"]) <= TOL_METRIC,
          f"phase {tag}: served lists do not come from the evaluated (trained) weights")
    return out


def phase_e(device):
    """SASRec: fit + evaluate on ml-100k at the repo's config, then serve."""
    return fit_phase(device, "E", "SASRec", TRAIN_REFERENCE, "dropout_rate",
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
    return fit_phase(device, "G", "BERT4Rec", BERT4REC_TRAIN_REFERENCE, "dropout",
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


def clse_inputs(device, M, N, D, seed):
    """Query rows and a catalog at the scale of a trained model's, and the
    cotangent of a BERT4Rec batch: nonzero (1 / count) on a fifth of the
    rows, zero on the rest."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(M, D)).astype(np.float32)
    items = rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)
    keep = rng.random(M) < 0.2
    g = np.where(keep, 1.0 / max(int(keep.sum()), 1), 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (q, items, g))


def clse_versus_plain(device, M, N, D, seed=2028):
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
    q, items, g = clse_inputs(device, M, N, D, seed)
    shape = dict(M=M, N=N, D=D)
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
              phase_e(device), phase_f(device), phase_g(device), phase_h(device)]

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
    rows = [("K1@A", k1_a), ("K1@B", k1_b), ("K3@B", k3_b), ("K3@C", k3_c),
            ("K3@F", k3_f),
            ("K1train@D", k1_d), ("K2@D", k2_d), ("K1@F", k1_f), ("K1train@F", k1t_f),
            ("K2@F", k2_f)]
    rows += [(f"{k}@F", clse_f[k]) for k in ("K7", "K8", "K9")]
    rows += [(f"{k}@cat500k", clse_cat[k]) for k in ("K7", "K8", "K9")]
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
