#!/usr/bin/env python3
"""The JAX bands of phase AD: DIN and DIEN on ml-100k, and HardShare, MMoE,
PLE and AITM on the small planted-signal multitask file.

    JAX_PLATFORMS=cpu python scripts/torch_seq_mt_seeds.py --jax [DIN DIEN HardShare ...]
    JAX_PLATFORMS=cpu python scripts/torch_seq_mt_seeds.py --one MODEL SEED [--epochs N]
    python3 scripts/torch_seq_mt_seeds.py --port MODEL [SEED ...] [--epochs N]

``--jax`` runs ``SEEDS`` of the JAX package's ``quickstart.run(<model>,
<dataset>)`` at the repo's config for at most ``EPOCHS[model]`` epochs on
the CPU, ``PARALLEL`` processes at a time (each a ``--one`` run: the fit,
stopped early on validation AUC with the config's patience and the best
epoch restored, then the test metrics, and the test AUC of the same seed's
untrained model), and writes
``recstudio_torch/assets/<model>_<dataset>_train_reference.json``: the
runs, the AUC band of each rating (the seeds' range widened by their
spread) and the largest untrained AUC of each. DIN and DIEN train on
ml-100k as a ``SeqDataset`` (L 20, ratings binarized at 3.0); the
multitask models on ``kuairand-pure-small`` (``scripts/multitask_data.py``,
seed 7, written under ``build/``), every ``is_*`` label a rating.
``--port`` runs the port's ``quickstart.run`` on the card the same way,
one line a seed (2022 by default). ``--epochs N`` sets the epoch cap of
``--one`` and ``--port`` runs in place of ``EPOCHS`` (``--jax`` writes the
bands at ``EPOCHS`` only).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
DATA_DIR = os.path.join(REPO, "build", "recstudio_torch", "synthetic")
MODELS = ("DIN", "DIEN", "HardShare", "MMoE", "PLE", "AITM")
MULTITASK = ("HardShare", "MMoE", "PLE", "AITM")
MT_DATASET, MT_SEED = "kuairand-pure-small", 7
# the epoch cap of each run, phase AD's depth (for the script's time limit:
# an ml-100k epoch takes 7 s on the card for DIN, 11 for DIEN; at a cap of 2
# their best epochs were 0 or 1, and the port's DIEN landed 0.003 under a
# band of six seeds 0.005 apart, so DIEN keeps 3; the multitask models' best validation
# epochs at a cap of 4 were 1-3, and one epoch of the four took 80 s of a
# slow host's run)
# DIN cut to 1 when phases AG and AH joined the script
EPOCHS = {"DIN": 1, "DIEN": 3, "HardShare": 1, "MMoE": 1, "PLE": 1, "AITM": 1}
SEEDS = (2022, 2023, 2024, 2025, 2026, 2027)
PARALLEL = 4
ABOUT = {
    "DIN": "embed_dim 128, attention MLP [128, 64] with Dice, batch norm, fc MLP [128, 64, 64] "
           "with Dice and batch norm, dropout 0.3, batch 256, eval batch 32",
    "DIEN": "embed_dim 128, GRU extractor and AUGRU hidden 128, fc MLP [128, 64, 64] sigmoid, "
            "dropout 0.3, batch 256, eval batch 32",
    "HardShare": "embed_dim 64, bottom MLP [128, 128], top MLP [128, 128], relu, dropout 0.5",
    "MMoE": "embed_dim 64, 2 experts [128, 128], gates [128], towers [128], relu, dropout 0.5",
    "PLE": "embed_dim 64, 1 level, 2 specific and 2 shared experts [128, 128], gates [128], "
           "towers [128], relu, dropout 0.5",
    "AITM": "embed_dim 64, towers [128, 64], relu, dropout 0.5, one-head attention transfer, "
            "calibrator",
}


def dataset_of(name: str):
    """``(dataset name, data config or None)`` of a model's runs."""
    if name not in MULTITASK:
        return "ml-100k", None
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from multitask_data import write_kuairand
    return write_kuairand(MT_DATASET, DATA_DIR, seed=MT_SEED)


def ratings_of(name: str):
    if name not in MULTITASK:
        return ["rating"]
    from multitask_data import RATINGS
    return list(RATINGS)


def auc_key(name: str, rating: str) -> str:
    return f"{rating}_auc" if name in MULTITASK else "auc"


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def jax_run(name: str, seed: int, epochs: int) -> dict:
    """One JAX ``quickstart.run`` at the repo's config for at most
    ``epochs``, and the test AUCs of the same seed's untrained model."""
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model
    dataset, data_config = dataset_of(name)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model, (trn, _, tst), out = run(
            name, dataset, data_config=data_config, verbose=False,
            model_config={"train": {"seed": seed, "epochs": epochs},
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
    keys = [auc_key(name, r) for r in ratings_of(name)]
    return {"seed": seed, "fit_s": fit_s, "best_epoch": int(model.callback.best_epoch),
            "metrics": {k: float(v) for k, v in out.items()},
            "untrained": {k: float(before[k]) for k in keys}}


def write(name: str, runs) -> None:
    from recstudio_tpu.utils import get_model
    tc = dict(get_model(name)[1]["train"], epochs=EPOCHS[name])
    dataset, _ = dataset_of(name)
    keys = [auc_key(name, r) for r in ratings_of(name)]
    data = ("ml-100k as a SeqDataset (L 20, low_rating_thres 0.0, ratings binarized at 3.0, "
            "leave-one-out split)" if name not in MULTITASK else
            f"{MT_DATASET} (scripts/multitask_data.py, seed {MT_SEED}: 2,000 users, 800 "
            "videos, 60,000 rows before duplicate pairs are dropped, the fields of "
            "kuairand-pure.yaml, the six is_* labels as ratings, fmeval, no binarization, "
            "ratio split [0.8, 0.1, 0.1] per user, batch 512, adam 1e-3)")
    ref = {"about": f"recstudio_tpu {name} on {data} at the repo's config ({ABOUT[name]}), "
                    f"quickstart.run: fit(train, val) for at most {tc['epochs']} epochs, early "
                    "stopping on validation AUC with patience "
                    f"{tc['early_stop_patience']} and the best epoch's weights and batch-norm "
                    "statistics restored, then evaluate(test), JAX on the CPU; metric = test "
                    "AUC of each rating; band = seeds' range widened by their spread; untrained "
                    "= the largest test AUC of the seeds' models before fit; written by "
                    "scripts/torch_seq_mt_seeds.py",
           "dataset": dataset, "epochs": tc["epochs"],
           "early_stop_patience": tc["early_stop_patience"], "metric": "auc", "runs": runs,
           "auc_band": {k: band([r["metrics"][k] for r in runs]) for k in keys},
           "untrained_auc": {k: max(r["untrained"][k] for r in runs) for k in keys}}
    path = os.path.join(ASSETS, f"{name.lower()}_{dataset}_train_reference.json")
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: bands {ref['auc_band']}, untrained {ref['untrained_auc']}",
          flush=True)


def jax_bands(names) -> int:
    jobs = [(n, s) for n in names for s in SEEDS]
    for n in names:
        dataset_of(n)                        # write the data once, before the runs
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


def port_runs(name: str, seeds, epochs: int) -> int:
    """The port's ``quickstart.run`` on the card, seed by seed, at the
    repo's config for at most ``epochs``."""
    import torch
    from recstudio_torch.quickstart import run
    torch.backends.cuda.matmul.allow_tf32 = False
    print("GPU", torch.cuda.get_device_name(0), flush=True)
    dataset, data_config = dataset_of(name)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            model, _, out = run(name, dataset, data_config=data_config, verbose=False,
                                device="cuda",
                                model_config={"train": {"seed": seed, "epochs": epochs},
                                              "eval": {"save_path": tmp}})
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch,
                          "epochs_run": len(model.epoch_log), **out}), flush=True)
    return 0


def main(argv) -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    epochs = None
    if "--epochs" in argv:
        at = argv.index("--epochs")
        epochs = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    if argv[:1] == ["--one"]:             # one JAX model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(jax_run(argv[1], int(argv[2]), epochs or EPOCHS[argv[1]])))
        return 0
    if argv[:1] == ["--jax"] and epochs is None:
        return jax_bands(argv[1:] or list(MODELS))
    if argv[:1] == ["--port"]:
        return port_runs(argv[1], [int(a) for a in argv[2:]] or [2022],
                         epochs or EPOCHS[argv[1]])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
