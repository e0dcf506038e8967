#!/usr/bin/env python3
"""Rankers seed by seed: the port's DeepFM at phase R's setup, and the
JAX bands of phases X, AF and AJ (WideDeep, DCN, NFM and AutoInt;
InterHAt, DIFM and xDeepFM; FinalMLP, FiGNN and FGCNN, on ml-100k).

    python3 scripts/torch_ctr_seeds.py [--epochs 6] [--seeds 2022 2023 ...]
    JAX_PLATFORMS=cpu python scripts/torch_ctr_seeds.py --jax-ml100k [WideDeep DCN ... FGCNN]
    JAX_PLATFORMS=cpu python scripts/torch_ctr_seeds.py --one MODEL SEED
    python3 scripts/torch_ctr_seeds.py --port MODEL [SEED ...]

With no mode (on the card), the port's DeepFM at phase R's setup
(``chip_smoke.criteo_setup``: the JAX bench's ``ctr_scale``,
``generate_ctr("criteo-1m-shape")``, 1,000,000 rows, batch 8192, Adam
1e-3, DeepFM at the repo's config): for each seed the test AUC and
logloss of the untrained model, then after ``fit(train, None)`` for one
epoch and after each further epoch. It shows how far apart seeds lie
after a given number of epochs, which is what phase R's band is read at.
One JSON line a seed, then one line with each epoch's AUCs over the seeds.

``--jax-ml100k`` runs ``SEEDS`` of the JAX package's
``quickstart.run(<model>, "ml-100k")`` at the repo's config for at most
``ML100K_EPOCHS`` epochs on the CPU, ``PARALLEL`` processes at a time
(each a ``--one`` run: the fit, stopped early on validation AUC with the
config's patience, then the test AUC and logloss of the best epoch, and
the test AUC of the same seed's untrained model), and writes
``recstudio_torch/assets/<model>_ml100k_train_reference.json``: the runs,
the AUC band (the seeds' range widened by their spread) and the largest
untrained AUC. ``--port`` runs the port's ``quickstart.run`` on the card
the same way, one line a seed (2022 by default): test AUC, best epoch and
the BN layers' calibration counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
ML100K_MODELS = ("WideDeep", "DCN", "NFM", "AutoInt", "InterHAt", "DIFM", "xDeepFM", "FinalMLP",
                 "FiGNN", "FGCNN")
# the epoch cap of each ml-100k run, phase X's depth: the JAX fits' best
# validation epochs at the config's own cap (1000, patience 10) were 3–10
# (WideDeep), 2–7 (DCN), 3–8 (NFM) and 7–25 (AutoInt), and the ten epochs
# of patience after them took most of phase X's time; cut again to 4 each
# when phases AA–AD joined the script, to 2 each when phases AG and AH
# joined it, and to 1 each but DCN when phases AI and AJ did, for its time
# limit (at 1 epoch one of DCN's six seeds stays at the untrained AUC, and
# its band could not fail); InterHAt, DIFM and xDeepFM (phase AF) ran at
# most 2 each and run 1 since phases AI and AJ; FinalMLP, FiGNN and FGCNN
# (phase AJ) one each: the depth at which all six seeds of each clear the
# untrained AUC by AUC_MARGIN, and no more
ML100K_EPOCHS = dict({name: 1 for name in ML100K_MODELS}, DCN=2)
SEEDS = (2022, 2023, 2024, 2025, 2026, 2027)
PARALLEL = 6
ABOUT = {
    "WideDeep": "embed_dim 10, MLP [256, 256, 256] with batch norm, relu, dropout 0.3",
    "DCN": "embed_dim 10, 6 cross layers, MLP [256, 256, 256] with batch norm, relu, "
           "dropout 0.5",
    "NFM": "embed_dim 10, bi-interaction with batch norm, MLP [128, 128, 128] with batch "
           "norm, sigmoid, dropout 0.3",
    "AutoInt": "embed_dim 10, attention_dim 64, 3 attention layers, 2 heads, residual "
               "projection, MLP [128, 64], relu, dropout 0.5",
    "InterHAt": "embed_dim 16, one transformer layer (2 heads, feedforward 64, relu), order "
                "3, aggregation_dim 32, MLP [128, 64], relu, dropout 0.3",
    "DIFM": "embed_dim 10, self-attention FEN (2 heads), MLP FEN [256, 256], relu, "
            "dropout 0.3",
    "xDeepFM": "embed_dim 10, CIN [100, 100, 100] (direct False), MLP [128, 128, 128], "
               "relu, dropout 0.2",
    "FinalMLP": "embed_dim 10, two streams MLP [256, 256], relu, dropout 0.3, feature "
                "selection over the user and the item features (fs MLP [128]), bilinear "
                "fusion with 2 heads",
    "FiGNN": "embed_dim 10, 2 graph layers with a shared GRU cell, attentional readout",
    "FGCNN": "embed_dim 10, convolutions with channels [6, 8], heights [7, 7], pooling [2, "
             "2], recombination [3, 3], inner products, MLP [128, 64], relu, dropout 0.3",
}


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


def criteo_seeds(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2022, 2023, 2024, 2025, 2026, 2027])
    args = ap.parse_args(argv)
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


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def jax_run(name: str, seed: int) -> dict:
    """One JAX ``quickstart.run(name, "ml-100k")`` at the repo's config for
    at most ``ML100K_EPOCHS[name]`` epochs, and the test AUC of the same
    seed's untrained model."""
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model, (trn, _, tst), out = run(
            name, "ml-100k", verbose=False,
            model_config={"train": {"seed": seed, "epochs": ML100K_EPOCHS[name]},
                          "eval": {"save_path": tmp}})
        fit_s = time.time() - t0
        cls, conf = get_model(name)
        conf["train"].update(seed=seed)
        conf["eval"]["save_path"] = tmp
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        untrained._train_data = trn          # what fit sets: BN calibrates on its batches
        before = untrained.evaluate(tst, verbose=False)
    return {"seed": seed, "fit_s": fit_s, "auc": float(out["auc"]),
            "logloss": float(out["logloss"]), "best_epoch": int(model.callback.best_epoch),
            "untrained_auc": float(before["auc"])}


def write(name: str, runs) -> None:
    from recstudio_tpu.utils import get_model
    tc = dict(get_model(name)[1]["train"], epochs=ML100K_EPOCHS[name])
    untrained = max(r["untrained_auc"] for r in runs)
    ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config ({ABOUT[name]}; "
                    "fm family: fmeval, ratings binarized at 3.0, low_rating_thres 0.0, ratio "
                    "split [0.8, 0.1, 0.1] per user, batch 512, adam 1e-3, BCE), "
                    f"quickstart.run: fit(train, val) for at most {tc['epochs']} epochs, early "
                    "stopping on validation AUC with patience "
                    f"{tc['early_stop_patience']} and the best epoch's weights and batch-norm "
                    "statistics restored, then evaluate(test), JAX on the CPU; metric = test "
                    "AUC; band = seeds' range widened by their spread; untrained = the largest "
                    "test AUC of the seeds' models before fit; written by "
                    "scripts/torch_ctr_seeds.py",
           "epochs": tc["epochs"], "early_stop_patience": tc["early_stop_patience"],
           "metric": "auc", "runs": runs, "auc_band": band([r["auc"] for r in runs]),
           "untrained_auc": untrained}
    path = os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: band {ref['auc_band']}, untrained {untrained}", flush=True)


def jax_bands(names) -> int:
    jobs = [(n, s) for n in names for s in SEEDS]
    runs, running = {}, {}
    while jobs or running:
        while jobs and len(running) < PARALLEL:
            n, s = jobs.pop(0)
            running[(n, s)] = subprocess.Popen(
                [sys.executable, __file__, "--one", n, str(s)], stdout=subprocess.PIPE,
                text=True, cwd=REPO)
        key = next(iter(running))
        out = running.pop(key).communicate()[0]
        runs[key] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"model": key[0], **runs[key]}), flush=True)
    for n in names:
        write(n, [runs[(n, s)] for s in SEEDS])
    return 0


def port_runs(name: str, seeds) -> int:
    """The port's ``quickstart.run(name, "ml-100k")`` on the card, seed by
    seed, at the repo's config and the JAX runs' epoch cap."""
    import torch
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    from recstudio_torch.quickstart import run
    torch.backends.cuda.matmul.allow_tf32 = False
    print("GPU", torch.cuda.get_device_name(0), flush=True)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            model, _, out = run(name, "ml-100k", verbose=False, device="cuda",
                                model_config={"train": {"seed": seed,
                                                        "epochs": ML100K_EPOCHS[name]},
                                              "eval": {"save_path": tmp}})
        counts = [float(m.count) for m in model.net.modules() if isinstance(m, SimpleBatchNorm)]
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch,
                          "epochs_run": len(model.epoch_log), "auc": out["auc"],
                          "logloss": out["logloss"], "bn_counts": counts}), flush=True)
    return 0


def main(argv) -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if argv[:1] == ["--one"]:             # one JAX model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(jax_run(argv[1], int(argv[2]))))
        return 0
    if argv[:1] == ["--jax-ml100k"]:
        return jax_bands(argv[1:] or list(ML100K_MODELS))
    if argv[:1] == ["--port"]:
        return port_runs(argv[1], [int(a) for a in argv[2:]] or [2022])
    return criteo_seeds(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
