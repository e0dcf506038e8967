#!/usr/bin/env python3
"""The port's DeepFM at phase R's setup, seed by seed: test AUC and
logloss before training and after each epoch.

The data and config are ``chip_smoke.criteo_setup``'s (the JAX bench's
``ctr_scale``: ``generate_ctr("criteo-1m-shape")``, 1,000,000 rows, batch
8192, Adam 1e-3, DeepFM at the repo's config). For each seed the script
evaluates the untrained model on the test split, fits one epoch
(``fit(train, None)``), then trains epoch after epoch, evaluating the
test split after each. It shows how far apart seeds lie after a given
number of epochs, which is what phase R's band is read at.

Run from the root of a checkout, on a machine with the card::

    python3 scripts/torch_ctr_seeds.py [--epochs 6] [--seeds 2022 2023 ...]

One JSON line a seed, then one line with each epoch's AUCs over the
seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seed_run(seed: int, epochs: int, device, data) -> dict:
    trn, tst, cls, conf = data
    conf = json.loads(json.dumps(conf))
    conf["train"].update(seed=seed, epochs=1)
    metrics = ["auc", "logloss"]
    untrained = cls(conf, device=device)
    untrained._init_model(trn)
    untrained._init_parameter(trn)
    log = [{"epochs": 0, **untrained._eval_epoch(tst, metrics, [None])}]
    del untrained
    model = cls(conf, device=device)
    t = time.perf_counter()
    model.fit(trn, None)
    log.append({"epochs": 1, "train_s": time.perf_counter() - t,
                **model._eval_epoch(tst, metrics, [None])})
    for n in range(1, epochs):
        t = time.perf_counter()
        loss = model.training_epoch(n)
        log.append({"epochs": n + 1, "train_s": time.perf_counter() - t, "train_loss": loss,
                    **model._eval_epoch(tst, metrics, [None])})
    return {"seed": seed, "log": log}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2022, 2023, 2024, 2025, 2026, 2027])
    args = ap.parse_args()
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as c
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"GPU {c.gpu_line()}", flush=True)
    _, _, (trn, _, tst), cls, conf, gen_s, etl_s = c.criteo_setup()
    print(json.dumps({"gen_s": gen_s, "etl_s": etl_s}), flush=True)
    runs = []
    for seed in args.seeds:
        runs.append(seed_run(seed, args.epochs, device, (trn, tst, cls, conf)))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"auc_by_epochs": {str(e): [r["log"][e]["auc"] for r in runs]
                                        for e in range(args.epochs + 1)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
