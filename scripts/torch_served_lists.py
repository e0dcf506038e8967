#!/usr/bin/env python3
"""Served lists against ``evaluate``'s, user by user, after a fit on ml-100k.

    python3 scripts/torch_served_lists.py [--model BERT4Rec] [--epochs 10] [--out FILE]

Fits ``--model`` on ml-100k at the repo's config for ``--epochs`` epochs
(``fit(train, val)``, the best validation epoch restored by ``evaluate``),
as ``chip_smoke.py`` phase G does, then ranks every test user twice from
the same weights: through ``evaluate``'s route (the eval batches of the
test split, ``model.topk`` at ``eval.topk``, the rows padded with row 0)
and through ``serving.Predictor`` at k 20 (requests of the eval batch,
padded with zero rows). For each user whose target sits at another rank
in the two top-10 lists, it writes both lists, the target's score, the
catalog scores at the ranks where the lists part, and whether the two
sides' scores there are equal (a tie that ``torch.topk`` broke two ways)
or not (a fault). Prints one JSON line; ``--out`` also writes it to a
file. Runs on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def target_rank(ids: np.ndarray, target: int, k: int = 10) -> int:
    """The 1-based rank of ``target`` among the first ``k`` of ``ids``, or 0."""
    hit = np.flatnonzero(ids[:k] == target)
    return int(hit[0]) + 1 if hit.size else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="BERT4Rec")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from recstudio_torch.models.basemodel.recommender import batch_to_device
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils import get_model

    cls, conf = get_model(args.model)
    conf["train"]["epochs"] = args.epochs
    trn, val, tst = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    with tempfile.TemporaryDirectory() as tmp:
        conf["eval"]["save_path"] = tmp
        model = cls(conf, device=args.device)
        t0 = time.perf_counter()
        model.fit(trn, val)
        result = model.evaluate(tst, verbose=False)
        fit_s = time.perf_counter() - t0
    size, topk = int(conf["eval"]["batch_size"]), int(conf["eval"]["topk"])
    pred = Predictor(model, max_batch=size, k=20, train_data=tst).warm()
    rows, differing = 0, []
    for host in tst.eval_loader(size):
        n = int(host["_size"])
        batch = batch_to_device(host, model.device)
        with torch.no_grad():
            e_scores, e_ids = model.topk(batch, topk, batch.get("user_hist"))
            query = model.net.encode_query(model._get_query_feat(batch))
            full = model._mask_hist_scores(
                model.score_func.catalog(query, model.states["item_vector"]),
                batch.get("user_hist"))
        s_scores, s_ids = pred({f: host[f][:n] for f in sorted(model.query_fields)})
        e_ids, e_scores = e_ids[:n].cpu().numpy(), e_scores[:n].cpu().numpy()
        full = full[:n].cpu().numpy()
        for r in range(n):
            target = int(host[model.fiid][r])
            re_, rs_ = target_rank(e_ids[r], target), target_rank(s_ids[r], target)
            if re_ == rs_:
                continue
            part = [int(i) for i in np.flatnonzero(e_ids[r, :20] != s_ids[r, :20])]
            differing.append({
                "user": int(host[model.fuid][r]), "target": target,
                "evaluate_rank": re_, "served_rank": rs_,
                "target_score": float(full[r, target - 1]),
                "evaluate_top20": e_ids[r, :20].tolist(), "served_top20": s_ids[r, :20].tolist(),
                "ranks_apart": [p + 1 for p in part],
                "evaluate_scores_there": [float(e_scores[r, p]) for p in part],
                "served_scores_there": [float(s_scores[r, p]) for p in part],
                "catalog_scores_of_served_there": [float(full[r, s_ids[r, p] - 1]) for p in part],
                "tie": bool(all(e_scores[r, p] == s_scores[r, p] for p in part)),
                "items_with_target_score": int((full[r] == full[r, target - 1]).sum())})
        rows += n
    out = {"model": args.model, "epochs": args.epochs, "device": str(model.device),
           "gpu": torch.cuda.get_device_name(0) if model.device.type == "cuda" else None,
           "fit_s": fit_s, "best_epoch": model.callback.best_epoch,
           "test_ndcg@10": result["ndcg@10"], "test_recall@10": result["recall@10"],
           "users": rows, "users_differing": len(differing), "differing": differing}
    line = json.dumps(out)
    print("SERVED_LISTS " + line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
