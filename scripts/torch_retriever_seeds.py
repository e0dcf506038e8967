"""Write the JAX bands that phase AL of ``chip_smoke.py`` holds the port's
EASE, ItemKNN, SLIM, WRMF, IRGAN, DSSM, IPSBPR, PDA, SGL and NCL to.

    JAX_PLATFORMS=cpu python scripts/torch_retriever_seeds.py [MODEL ...]
    JAX_PLATFORMS=cpu python scripts/torch_retriever_seeds.py --one MODEL SEED
    python3 scripts/torch_retriever_seeds.py --port MODEL [SEED ...]

Each model runs the JAX package's ``quickstart.run(<model>, "ml-100k")``
on the CPU at the repo's config with the overrides of ``RUNS`` for
``EPOCHS`` epochs (its early stopping may end it sooner) and is evaluated
at its best validation epoch, ``PARALLEL`` processes at a time, each
followed by the test NDCG@10 of the same seed's untrained model. EASE,
ItemKNN and SLIM solve in closed form: given the split (numpy's stream
from ``train.seed``) their result is fixed, so they run the one seed AL
runs (2022), and their band is that value within ``CLOSED_FORM_TOL``
(float32 solves on the card reorder sums and may swap near-tied items in
a list). The others run six seeds; their band is the seeds' range of test
NDCG@10 widened by their spread. Every band must clear the untrained
model's largest test NDCG@10 (``check``: the script fails otherwise).
Each model's asset, ``recstudio_torch/assets/<model>_ml100k_train_
reference.json``, holds the runs, the band, the untrained value and the
band of the last epoch's training loss. ``--one`` prints one JAX run as
JSON; ``--port`` runs the port's ``quickstart.run`` on the card at the
same config, one line a seed (2022 by default).
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
# model -> config overrides (both packages'): NCL's warm-up cut from 20 so
# its prototype term is on inside AL's epochs, and its patience raised from
# 10 to 100 (NCL's as SGL's config has it): at its config its BPR loss sits
# at log 2 for its first 30-40 epochs (the structure term at temperature
# 0.05 holds it; without the two contrastive terms it falls from the first
# epoch), so its validation NDCG does not rise before then
RUNS = {"EASE": {}, "ItemKNN": {}, "SLIM": {}, "WRMF": {}, "IRGAN": {}, "DSSM": {},
        "IPSBPR": {}, "PDA": {}, "SGL": {},
        "NCL": {"train": {"warm_up_epoch": 5, "early_stop_patience": 100}}}
MODELS = tuple(RUNS)
CLOSED_FORM = ("EASE", "ItemKNN", "SLIM")
SIX = (2022, 2023, 2024, 2025, 2026, 2027)
SEEDS = {name: (2022,) if name in CLOSED_FORM else SIX for name in RUNS}
# AL's depth: the closed-form models' one epoch (their config's); WRMF five
# user and five item half-sweeps; IRGAN four cycles of five discriminator
# and two generator epochs (its generator, which evaluation reads, ranks
# at the untrained level before its second cycle); DSSM one epoch (cut from
# 3 for the script's time: at 3 its best epochs were 1 and 2, the band
# [0.0842, 0.1396]); IPSBPR, PDA and SGL at the graph models' depth of
# phase U; NCL past its plateau (its loss fell at epoch 38-41 of a 60-epoch
# trial of the port's): 50 epochs, cut from 60 for the script's time (at 60
# the band was [0.2322, 0.2912], best epochs 56-59)
EPOCHS = {"EASE": 1, "ItemKNN": 1, "SLIM": 1, "WRMF": 10, "IRGAN": 28, "DSSM": 1,
          "IPSBPR": 10, "PDA": 10, "SGL": 10, "NCL": 50}
CLOSED_FORM_TOL = 0.003
PARALLEL = 6
ABOUT = {
    "EASE": "lambda 250, closed form on the split's interaction matrix, eval batch 128",
    "ItemKNN": "cosine similarity, 100 neighbours a column, closed form",
    "SLIM": "alpha 1, l1_ratio 0.1, positive only, 200 ISTA steps, closed form",
    "WRMF": "d 64, alpha 1, lambda 0.5, ALS half-sweeps (users on even epochs), no optimizer",
    "IRGAN": "d 64, ALSDataset rows at batch 16, 5 discriminator then 2 generator epochs a "
             "cycle, adam(w) 1e-3 with weight decay 1e-4 each, T_dis 0.2, T_gen 1, "
             "sample_lambda 0.2, one negative a positive, evaluation by the generator",
    "DSSM": "d 64, towers [128, 128, 128] tanh with dropout 0.3 over the user's five fields "
            "and the item id, BCE on one uniform negative, batch 512, adam 1e-3, "
            "cutoffs [10, 20, 50]",
    "IPSBPR": "d 64, BPR weighted by clipped inverse propensity (gamma 0.5, clip 100), one "
              "uniform negative, batch 512, adam 1e-3",
    "PDA": "d 64, BPR on (elu(s) + 1) pop^0.1, one uniform negative, batch 512, adam 1e-3",
    "SGL": "d 64, 3 layers, ED edge dropout 0.1, ssl_reg 0.1, temperature 0.2, l2 1e-4, "
           "batch 2048, one uniform negative, adam 1e-3, patience 100",
    "NCL": "d 64, 3 layers, hyper_layers 1, 10 clusters, warm-up 5 epochs (cut from 20), "
           "patience 100 (raised from 10), ssl_reg 0.005, proto_reg 2e-4, temperature 0.05, "
           "alpha 0.5, batch 2048, adam 2e-3",
}


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def run_config(name: str, seed: int, save_path: str):
    """The overrides of ``name`` at ``seed`` (both packages')."""
    conf = {"train": {"seed": seed, "epochs": EPOCHS[name]}, "eval": {"save_path": save_path}}
    for group, values in RUNS[name].items():
        conf.setdefault(group, {}).update(values)
    return conf


def one_run(name: str, seed: int):
    """One JAX ``quickstart.run`` of ``name`` and the same seed's untrained
    test NDCG@10 (none for a closed-form model, which has no weights
    before its solve); the training losses are read from the JAX log."""
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
        conf_over = run_config(name, seed, tmp)
        model, (trn, _, tst), out = run(name, "ml-100k", verbose=False, model_config=conf_over)
        fit_s = time.time() - t0
        untrained = None
        if name not in CLOSED_FORM:
            cls, conf = get_model(name)
            for group, values in conf_over.items():
                conf[group].update(values)
            model0 = cls(conf)
            model0._init_model(trn)
            model0._init_parameter(trn)
            model0.val_check = False
            untrained = float(model0.evaluate(tst, verbose=False)["ndcg@10"])
    epochs = [losses[e] for e in sorted(losses)]
    return {"seed": seed, "fit_s": fit_s, "best_epoch": int(model.callback.best_epoch),
            "epochs_run": len(epochs), "ndcg@10": float(out["ndcg@10"]),
            "recall@10": float(out["recall@10"]), "ndcg@20": float(out["ndcg@20"]),
            "untrained_ndcg@10": untrained,
            "train_loss_first": epochs[0], "train_loss_last": epochs[-1]}


def port_runs(name: str, seeds):
    """The port's ``quickstart.run(name, "ml-100k")`` on the card, seed by
    seed, at the JAX runs' config."""
    import torch
    from recstudio_torch.quickstart import run
    torch.backends.cuda.matmul.allow_tf32 = False
    print("GPU", torch.cuda.get_device_name(0), flush=True)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            model, _, out = run(name, "ml-100k", verbose=False, device="cuda",
                                model_config=run_config(name, seed, tmp))
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch,
                          "epochs_run": len(model.epoch_log), "ndcg@10": out["ndcg@10"],
                          "train_loss_last": model.epoch_log[-1]["train_loss"]}), flush=True)


def reference_name(name: str) -> str:
    return name.lower() + "_ml100k_train_reference.json"


def reference(name: str, runs):
    """The asset of ``name`` from its runs."""
    ndcg = [r["ndcg@10"] for r in runs]
    if name in CLOSED_FORM:
        ndcg_band = [ndcg[0] - CLOSED_FORM_TOL, ndcg[0] + CLOSED_FORM_TOL]
        rule = (f"band = the JAX value within {CLOSED_FORM_TOL} (deterministic given the "
                "split)")
        untrained = None
    else:
        ndcg_band = band(ndcg)
        rule = "band = the seeds' range widened by their spread"
        untrained = max(r["untrained_ndcg@10"] for r in runs)
    return {"about": f"recstudio_tpu {name} on ml-100k at the repo's config ({ABOUT[name]}), "
                     f"{EPOCHS[name]} epochs at most, quickstart.run: fit(train, val) then "
                     f"evaluate(test) at the best validation epoch, JAX on the CPU; {rule}; "
                     "written by scripts/torch_retriever_seeds.py",
            "model": name, "overrides": RUNS[name], "epochs": EPOCHS[name],
            "closed_form": name in CLOSED_FORM, "runs": runs, "ndcg@10_band": ndcg_band,
            "untrained_ndcg@10": untrained,
            "train_loss_last_band": band([r["train_loss_last"] for r in runs])}


def check(ref) -> None:
    """A band must clear the untrained model's value."""
    if ref["untrained_ndcg@10"] is not None and \
            ref["ndcg@10_band"][0] <= ref["untrained_ndcg@10"]:
        raise SystemExit(f"{ref['model']}: band {ref['ndcg@10_band']} does not clear the "
                         f"untrained NDCG@10 {ref['untrained_ndcg@10']}")


def main(argv):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if argv[:1] == ["--one"]:
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
    while todo or running:
        while todo and len(running) < PARALLEL:
            key = todo.pop(0)
            running[key] = subprocess.Popen([sys.executable, __file__, "--one", key[0],
                                             str(key[1])], stdout=subprocess.PIPE, text=True,
                                            cwd=REPO)
        key = next(iter(running))
        runs[key] = json.loads(running.pop(key).communicate()[0].strip().splitlines()[-1])
    for n in names:
        ref = reference(n, [runs[(n, s)] for s in SEEDS[n]])
        path = os.path.join(ASSETS, reference_name(n))
        with open(path, "w") as f:
            json.dump(ref, f, indent=1)
            f.write("\n")
        print(f"wrote {path}: band {ref['ndcg@10_band']}, untrained {ref['untrained_ndcg@10']}")
        check(ref)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
