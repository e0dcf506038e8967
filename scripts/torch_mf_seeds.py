"""Write the JAX bands that phase Z of ``chip_smoke.py`` holds the port's
PMF, CML, NCF, LogisticMF and BPR under the ``midx-pop`` sampler to.

    JAX_PLATFORMS=cpu python scripts/torch_mf_seeds.py [PMF CML NCF LogisticMF BPR-midx-pop]
    JAX_PLATFORMS=cpu python scripts/torch_mf_seeds.py --one RUN SEED
    python3 scripts/torch_mf_seeds.py --port RUN [SEED ...]

A run is a model at the repo's config with the overrides of ``RUNS``
(``BPR-midx-pop``: BPR with ``train.sampler: midx-pop``, 32 clusters a
half-space). For each, six seeds of the JAX package's
``quickstart.run(<model>, "ml-100k")`` run on the CPU, six at a time
(about five minutes on 8 cores for all thirty), each followed by the test
NDCG@10 of the same seed's untrained model. PMF and BPR run to their early stop
under the config's epoch cap; CML, NCF and LogisticMF run ``EPOCHS``
epochs (their patience of 10 still stops them earlier when validation
stalls) and are evaluated at their best validation epoch. Each run's
asset, ``recstudio_torch/assets/<run>_ml100k_train_reference.json``, holds
the runs, the NDCG@10 band (the seeds' range widened by their spread),
the band of the last epoch's training loss (the same rule), the largest
untrained NDCG@10, and ``learning_gate``: ``ndcg`` when the NDCG band
clears the untrained metric by ``MARGIN``, else ``train_loss`` (the model
does not learn to rank at its config in these epochs, and phase Z holds
its last training loss to the JAX band as the sign that it trains).

``--one`` prints one JAX run as JSON. ``--port`` runs the port's
``quickstart.run`` on the card at the same config and epochs, one line a
seed (2022 by default): test NDCG@10, best epoch, last training loss.
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
# run name -> (model, config overrides)
RUNS = {"PMF": ("PMF", {}), "CML": ("CML", {}), "NCF": ("NCF", {}),
        "LogisticMF": ("LogisticMF", {}),
        "BPR-midx-pop": ("BPR", {"train": {"sampler": "midx-pop", "sampler_num_clusters": 32}})}
MODELS = tuple(RUNS)
SIX = (2022, 2023, 2024, 2025, 2026, 2027)
SEEDS = {name: SIX for name in RUNS}
# None: the config's own cap (1000), with early stopping at its patience
EPOCHS = {"PMF": None, "CML": 30, "NCF": 20, "LogisticMF": 20, "BPR-midx-pop": None}
MARGIN = 0.05
PARALLEL = 6
ABOUT = {
    "PMF": "d 64, inner product, squared error to the rating, no sampler, batch 512, adam 1e-3, "
           "eval batch 20, early stopping on val NDCG@5 with patience 10",
    "CML": "d 64, euclidean scores, CMLoss margin 1 with no rank weight, ALSDataset (one row "
           "a user), 5 uniform negatives, batch 512, adam 1e-2, patience 10",
    "NCF": "d 64, fusion scorer (MLP [128, 64], relu), binary cross-entropy, one uniform "
           "negative, batch 512, adam 1e-3, patience 10",
    "LogisticMF": "d 64, inner product, LogitLoss alpha 0.5, 10 uniform negatives, batch 512, "
                  "adagrad 1e-2 (optax), patience 10",
    "BPR-midx-pop": "d 64, inner product, BPR, one negative from the midx-pop sampler (32 "
                    "clusters a half-space, refreshed each epoch), batch 512, adam 1e-3, eval "
                    "batch 20, early stopping on val NDCG@5 with patience 10",
}


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def one_run(name: str, seed: int):
    """One JAX ``quickstart.run`` of the run ``name`` and the same seed's
    untrained test NDCG@10; the epochs' training losses are read from the
    JAX log (``Recommender.log_dict``, wrapped in this process)."""
    from recstudio_tpu.models.basemodel.recommender import Recommender
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model
    losses = {}
    log_dict = Recommender.log_dict

    def logging(self, nepoch, metrics, *args, **kwargs):
        if "train_loss" in metrics:
            losses[int(nepoch)] = float(metrics["train_loss"])
        return log_dict(self, nepoch, metrics, *args, **kwargs)

    Recommender.log_dict = logging
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model_name, override = RUNS[name]
        model, (trn, _, tst), out = run(model_name, "ml-100k", verbose=False,
                                        model_config=run_config(name, seed, tmp))
        fit_s = time.time() - t0
        cls, conf = get_model(model_name)
        for group, values in override.items():
            conf[group].update(values)
        conf["train"].update(seed=seed)
        conf["eval"]["save_path"] = tmp
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        before = untrained.evaluate(tst, verbose=False)
    epochs = [losses[e] for e in sorted(losses)]
    return {"seed": seed, "fit_s": fit_s, "best_epoch": int(model.callback.best_epoch),
            "epochs_run": len(epochs), "ndcg@10": float(out["ndcg@10"]),
            "recall@10": float(out["recall@10"]), "ndcg@20": float(out["ndcg@20"]),
            "untrained_ndcg@10": float(before["ndcg@10"]),
            "train_loss_first": epochs[0], "train_loss_last": epochs[-1]}


def run_config(name: str, seed: int, save_path: str):
    """The overrides of the run ``name`` at ``seed`` (both packages')."""
    train = {"seed": seed}
    if EPOCHS[name] is not None:
        train["epochs"] = EPOCHS[name]
    conf = {"train": train, "eval": {"save_path": save_path}}
    for group, values in RUNS[name][1].items():
        conf.setdefault(group, {}).update(values)
    return conf


def port_runs(name: str, seeds):
    """The port's ``quickstart.run(name, "ml-100k")`` on the card, seed by
    seed, at the epochs of the JAX runs."""
    import torch
    from recstudio_torch.quickstart import run
    torch.backends.cuda.matmul.allow_tf32 = False
    print("GPU", torch.cuda.get_device_name(0), flush=True)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            model, _, out = run(RUNS[name][0], "ml-100k", verbose=False, device="cuda",
                                model_config=run_config(name, seed, tmp))
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch,
                          "epochs_run": len(model.epoch_log), "ndcg@10": out["ndcg@10"],
                          "train_loss_last": model.epoch_log[-1]["train_loss"]}), flush=True)


def reference_name(name: str) -> str:
    """The asset file of the run ``name``."""
    return name.lower().replace("-", "_") + "_ml100k_train_reference.json"


def write(name: str, runs):
    from recstudio_tpu.utils import get_model
    conf = get_model(RUNS[name][0])[1]
    ndcg = band([r["ndcg@10"] for r in runs])
    untrained = max(r["untrained_ndcg@10"] for r in runs)
    epochs = EPOCHS[name] or conf["train"]["epochs"]
    ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config ({ABOUT[name]}), "
                    f"{epochs} epochs" + (" at most" if EPOCHS[name] is None else "")
                    + ", quickstart.run: fit(train, val) then evaluate(test) at the best "
                    "validation epoch, JAX on the CPU; bands = seeds' range widened by their "
                    f"spread; untrained = the largest test NDCG@10 of the seeds' untrained "
                    f"models ({untrained:.4f}); written by scripts/torch_mf_seeds.py",
           "model": RUNS[name][0], "overrides": RUNS[name][1],
           "epochs": epochs, "early_stop_patience": conf["train"]["early_stop_patience"],
           "runs": runs, "ndcg@10_band": ndcg, "untrained_ndcg@10": untrained,
           "train_loss_last_band": band([r["train_loss_last"] for r in runs]),
           "learning_gate": "ndcg" if ndcg[0] - untrained >= MARGIN else "train_loss"}
    path = os.path.join(ASSETS, reference_name(name))
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: band {ndcg}, untrained {untrained}, gate {ref['learning_gate']}")


def main(argv):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if argv[:1] == ["--one"]:             # one model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(one_run(argv[1], int(argv[2]))))
        return 0
    if argv[:1] == ["--port"]:
        port_runs(argv[1], [int(a) for a in argv[2:]] or [2022])
        return 0
    names = argv or list(MODELS)
    todo = [(n, s) for n in names for s in SEEDS[n]]
    runs, running = {}, {}
    while todo or running:                # at most PARALLEL JAX processes at a time
        while todo and len(running) < PARALLEL:
            key = todo.pop(0)
            running[key] = subprocess.Popen([sys.executable, __file__, "--one", key[0],
                                             str(key[1])], stdout=subprocess.PIPE, text=True,
                                            cwd=REPO)
        key = next(iter(running))
        runs[key] = json.loads(running.pop(key).communicate()[0].strip().splitlines()[-1])
    for n in names:
        write(n, [runs[(n, s)] for s in SEEDS[n]])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
