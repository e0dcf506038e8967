"""Write the JAX bands that phase U of ``chip_smoke.py`` holds the port's
LightGCN, NGCF and SimGCL to.

    JAX_PLATFORMS=cpu python scripts/torch_graph_seeds.py [LightGCN NGCF SimGCL]
    JAX_PLATFORMS=cpu python scripts/torch_graph_seeds.py --one MODEL SEED [CONFIG_JSON]
    python3 scripts/torch_graph_seeds.py --port MODEL [SEED ...]

For each model, ``SEEDS`` of the JAX package's ``quickstart.run(<model>,
"ml-100k")`` at the repo's config run in parallel on the CPU (about
fifteen minutes on 8 cores for all eighteen), each followed by the test
NDCG@10 of the same seed's untrained model. Each runs ``EPOCHS`` epochs
(LightGCN's early stopping, patience 10, may end it sooner; NGCF's and
SimGCL's patience of 100 does not), is evaluated at its best validation
epoch among those, and takes six seeds: LightGCN and NGCF at 40 epochs
are still climbing (their best epoch is near the last), and SimGCL does
not learn to rank at its config (its best validation epoch is 0 or 1 and
its test NDCG@10 lies at the untrained level), so three seeds understate
the spread. Each model's asset,
``recstudio_torch/assets/<model>_ml100k_train_reference.json``, holds the
runs, the NDCG@10 band (the seeds' range widened by their spread), the
band of the last epoch's training loss (the same rule), the largest
untrained NDCG@10, and ``learning_gate``: ``ndcg`` when the NDCG band
clears the untrained metric by ``MARGIN``, else ``train_loss`` (the model
does not learn to rank at this config in these epochs, and phase U holds
its last training loss to the JAX band as the sign that it trains).

``--one`` prints one JAX run as JSON, with ``CONFIG_JSON`` layered over
the config (``'{"model": {"cl_weight": 0}}'`` trains SimGCL without its
contrastive term). ``--port`` runs the port's ``quickstart.run`` on the
card at the same epochs, one line a seed (2022 by default): test NDCG@10,
best epoch, last training loss.
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
MODELS = ("LightGCN", "NGCF", "SimGCL")
SIX = (2022, 2023, 2024, 2025, 2026, 2027)
SEEDS = {"LightGCN": SIX, "NGCF": SIX, "SimGCL": SIX}
# None: the config's own cap (1000), with early stopping at its patience.
# LightGCN's cap is phase U's depth: its fits stopped early after 93–126
# epochs (best 82–115), whose time the script's limit no longer allows (40,
# then 20 when phases AA–AD joined the script); NGCF's 40 were cut to 30
# when phases AG and AH joined it (at 20 its band cleared the untrained
# NDCG@10 by 0.048, under MARGIN, and its loss falls less than a train_loss
# gate asks); LightGCN and SimGCL cut from 20 to 10 when phases AI and AJ
# joined it
EPOCHS = {"LightGCN": 10, "NGCF": 30, "SimGCL": 10}
MARGIN = 0.05
ABOUT = {
    "LightGCN": "d 64, 3 layers (collapsed operator M, fp32), l2 1e-4, batch 512, one uniform "
                "negative, BPR, adam 1e-3, early stopping on val NDCG@5 with patience 10",
    "NGCF": "d 64, layers [64, 64, 64, 64], message dropout 0.1, l2 1e-5, batch 2048, one "
            "uniform negative, BPR, adam 1e-4 (patience 100 > the epochs run)",
    "SimGCL": "d 64, 3 layers, eps 0.1, cl_weight 0.5, temperature 0.2, cl_neg_type all, "
              "l2 1e-4, batch 2048, one uniform negative, BPR + InfoNCE, adam 1e-3 "
              "(patience 100 > the epochs run)",
}


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def one_run(name: str, seed: int, override=None):
    """One JAX ``quickstart.run(name, "ml-100k")`` (``override`` layered
    over its config) and the same seed's untrained test NDCG@10; the
    epochs' training losses are read from the JAX log
    (``Recommender.log_dict``, wrapped in this process)."""
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
        model, (trn, _, tst), out = run(name, "ml-100k", verbose=False,
                                        model_config=run_config(name, seed, tmp, override))
        fit_s = time.time() - t0
        cls, conf = get_model(name)
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


def run_config(name: str, seed: int, save_path: str, override=None):
    train = {"seed": seed}
    if EPOCHS[name] is not None:
        train["epochs"] = EPOCHS[name]
    conf = {"train": train, "eval": {"save_path": save_path}}
    for group, values in (override or {}).items():
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
            model, _, out = run(name, "ml-100k", verbose=False, device="cuda",
                                model_config=run_config(name, seed, tmp))
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch,
                          "epochs_run": len(model.epoch_log), "ndcg@10": out["ndcg@10"],
                          "train_loss_last": model.epoch_log[-1]["train_loss"]}), flush=True)


def write(name: str, runs):
    from recstudio_tpu.utils import get_model
    conf = get_model(name)[1]
    ndcg = band([r["ndcg@10"] for r in runs])
    untrained = max(r["untrained_ndcg@10"] for r in runs)
    epochs = EPOCHS[name] or conf["train"]["epochs"]
    ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config ({ABOUT[name]}), "
                    f"{epochs} epochs" + (" at most" if EPOCHS[name] is None else "")
                    + ", quickstart.run: fit(train, val) then evaluate(test) at the best "
                    "validation epoch, JAX on the CPU; bands = seeds' range widened by their "
                    f"spread; untrained = the largest test NDCG@10 of the seeds' untrained "
                    f"models ({untrained:.4f}); written by scripts/torch_graph_seeds.py",
           "epochs": epochs, "early_stop_patience": conf["train"]["early_stop_patience"],
           "runs": runs, "ndcg@10_band": ndcg, "untrained_ndcg@10": untrained,
           "train_loss_last_band": band([r["train_loss_last"] for r in runs]),
           "learning_gate": "ndcg" if ndcg[0] - untrained >= MARGIN else "train_loss"}
    path = os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: band {ndcg}, untrained {untrained}, gate {ref['learning_gate']}")


def main(argv):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if argv[:1] == ["--one"]:             # one model and seed: print its run as JSON
        from test_torch_jax_csv import jax_native_csv
        override = json.loads(argv[3]) if len(argv) > 3 else None
        with jax_native_csv(tempfile.mkdtemp()):
            print(json.dumps(one_run(argv[1], int(argv[2]), override)))
        return 0
    if argv[:1] == ["--port"]:
        port_runs(argv[1], [int(a) for a in argv[2:]] or [2022])
        return 0
    names = argv or list(MODELS)
    procs = {(n, s): subprocess.Popen([sys.executable, __file__, "--one", n, str(s)],
                                      stdout=subprocess.PIPE, text=True, cwd=REPO)
             for n in names for s in SEEDS[n]}
    runs = {k: json.loads(p.communicate()[0].strip().splitlines()[-1])
            for k, p in procs.items()}
    for n in names:
        write(n, [runs[(n, s)] for s in SEEDS[n]])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
