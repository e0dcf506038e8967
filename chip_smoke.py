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
- each kernel against its plain PyTorch version on the phases' shapes,
  with its time, the plain version's, PyTorch's own call where one exists,
  and the card's bound for the same work.

Launch counts are zeroed before each phase and read after it; a kernel of
a phase that was not launched in it fails the run. Every failure exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(REPO, "recstudio_torch", "assets", "sasrec_ml100k_reference.json")

# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth. Both kernels compute in float32 on the SIMT cores.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL_K1 = (1e-4, 1e-4)      # (atol, rtol): float32 sums of <= 1024 terms, then LayerNorm
TOL_K3 = (2e-5, 1e-4)      # float32 sums of <= 512 terms; outputs are averages of v
TOL_SCORES = 1e-4          # served scores: dot products of O(1) vectors, d <= 128


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


def attended_pairs(pad, attn) -> int:
    """(example, query, key) triples that attention must weigh on these
    masks: the allowed keys of each query row, or all Lk keys of a row whose
    keys are all masked (it averages them). Masked-out pairs need no work."""
    allowed = ~(attn[None] | pad[:, None, :])            # [B, Lq, Lk]
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
    from recstudio_torch.utils.parity import topk_mismatches
    t0 = time.perf_counter()
    name, config = generate("ml-1m-shape", *SHAPES["ml-1m-shape"], seed=7)
    config["max_seq_len"] = 200
    model, conf, ds, tst, _ = build_model(name, config, 128, 7, device)
    etl_s = time.perf_counter() - t0
    pred = Predictor(model, max_batch=256, k=20, train_data=tst).warm()
    (scores, ids, targets), counts = counted(lambda: serve_split(pred, model, tst, 256))
    stats = pred.stats()
    # the same weights through the plain path, on the first two requests
    layers = model.query_encoder.transformer.layers
    batches = iter(tst.eval_loader(256))
    bad = n_cmp = 0
    max_diff = 0.0
    for _ in range(2):
        batch = next(batches)
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


# ---------------------------------------------------------------------------
def k1_versus_plain(device, B, L, D, F, H):
    import numpy as np
    import torch
    from recstudio_torch.ops.transformer_layer import (fused_transformer_layer,
                                                       transformer_layer_plain)
    from recstudio_torch.utils.convert import random_sasrec_params
    rng = np.random.default_rng(B + L)
    tree = random_sasrec_params(B + L, 2, D, 1, F, 1)
    params = layer_params(tree["query_encoder"]["transformer"]["layer_0"], device)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(device)
    pad = torch.from_numpy(right_padding(rng, B, L)).to(device)
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1)
    kern = lambda: fused_transformer_layer(x, params, pad, causal, H, 0.0, "gelu", 1e-12, False)
    plain = lambda: transformer_layer_plain(x, params, pad, causal, H, "gelu", 1e-12)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K1)
        ms, plain_ms = time_ms(kern), time_ms(plain)
    flops = 2 * B * L * D * (3 * D + D + 2 * F) + 4 * attended_pairs(pad, causal) * D
    nbytes = 4 * (2 * B * L * D + 4 * D * D + 2 * D * F + 9 * D + F + B * L + L * L)
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, L=L, D=D, F=F, H=H), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K1, "ok": ok, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


def k3_versus_plain(device, B, H, L, Dh):
    import numpy as np
    import torch
    from recstudio_torch.ops.attention import additive_masks, fused_mha, mha_plain
    rng = np.random.default_rng(B + L + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(device)
               for _ in range(3))
    pad_np = right_padding(rng, B, L)
    pad_np[0] = True                   # one example whose keys are all masked
    pad = torch.from_numpy(pad_np).to(device)
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=device), 1)
    pad_add, attn_add = additive_masks(pad, causal)
    sdpa_mask = (attn_add[None, None] + pad_add[:, None, None, :]).clamp_min(
        torch.finfo(torch.float32).min)
    kern = lambda: fused_mha(q, k, v, pad, causal)
    plain = lambda: mha_plain(q, k, v, pad_add, attn_add)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    with torch.no_grad():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        max_abs, max_rel, ok = errors(got, want, TOL_K3)
        masked_row_ok = bool(torch.allclose(got[0], v[0].mean(dim=1, keepdim=True).expand_as(
            got[0]), atol=TOL_K3[0], rtol=TOL_K3[1]))
        ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(lib)
    flops = 4 * H * attended_pairs(pad, causal) * Dh
    nbytes = 4 * (4 * B * H * L * Dh + B * L + L * L)
    b_ms, by = bound(flops, nbytes)
    return {"shape": dict(B=B, H=H, L=L, Dh=Dh), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "tol": TOL_K3, "ok": ok and masked_row_ok,
            "all_masked_row_uniform": masked_row_ok, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by, "gflop": flops / 1e9}


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

    phases = [phase_a(device), phase_b(device), phase_c(device)]

    k1_a = k1_versus_plain(device, 128, 20, 64, 128, 2)
    k1_b = k1_versus_plain(device, 256, 200, 128, 128, 2)
    k3_b = k3_versus_plain(device, 256, 2, 200, 64)
    k3_c = k3_versus_plain(device, 64, 2, 384, 64)
    for name, res in (("K1@A", k1_a), ("K1@B", k1_b), ("K3@B", k3_b), ("K3@C", k3_c)):
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
    ]
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
