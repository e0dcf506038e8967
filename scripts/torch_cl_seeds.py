"""Write the JAX bands that phase AH of ``chip_smoke.py`` holds the port's
CL4SRec, ICLRec and CoSeRec to.

    JAX_PLATFORMS=cpu python scripts/torch_cl_seeds.py [CL4SRec ICLRec CoSeRec]
    JAX_PLATFORMS=cpu python scripts/torch_cl_seeds.py --one MODEL SEED
    python3 scripts/torch_cl_seeds.py --port MODEL [SEED ...]

For each model, ``SEEDS`` of the JAX package's ``quickstart.run(<model>,
"ml-100k")`` at the repo's config (d 64, F 64, one layer, batch 256, BCE on
one uniform negative a position, the contrastive terms) run in parallel on
the CPU for ``EPOCHS`` epochs (their patience, 40, does not end them
sooner; an ml-100k epoch is four steps), each evaluated at its best
validation epoch and followed by the test NDCG@10 of the same seed's
untrained model (a few minutes on 8 cores for all eighteen). ``EPOCHS`` is
the depth that takes the three clear of chance and no further: at 20
epochs their validation NDCG@20 had climbed from about 0.006 to 0.030
(ICLRec, flat from there), 0.042 (CL4SRec) and 0.082 (CoSeRec, past its
five warm-up epochs of co-occurrence neighbours). Each asset,
``recstudio_torch/assets/<model>_ml100k_train_reference.json``, holds the
runs, the NDCG@10 band (the seeds' range widened by their spread) and the
largest untrained NDCG@10, which the band must clear (``chance_gate``).
``--one`` prints one JAX run as JSON; ``--port`` runs the port's
``quickstart.run`` on the card at the same epochs, one line a seed (2022 by
default).
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
MODELS = ("CL4SRec", "ICLRec", "CoSeRec")
SEEDS = (2022, 2023, 2024, 2025, 2026, 2027)
EPOCHS = 20
ABOUT = {
    "CL4SRec": "item_crop views (tau 0.2), cl_weight 0.1",
    "ICLRec": "item_random views, 256 intents from k-means before each epoch, cl_weight 0.1, "
              "intent_cl_weight 0.1, layer_norm_eps 1e-5",
    "CoSeRec": "five views by length (threshold 12), insert 0.5, substitute 0.05, "
               "co-occurrence neighbours for 5 warm-up epochs then embedding neighbours, "
               "cl_weight 0.1",
}


def band(values):
    spread = max(values) - min(values)
    return [min(values) - spread, max(values) + spread]


def run_config(seed: int, save_path: str):
    return {"train": {"seed": seed, "epochs": EPOCHS}, "eval": {"save_path": save_path}}


def one_run(name: str, seed: int):
    """One JAX ``quickstart.run(name, "ml-100k")`` and the same seed's
    untrained test NDCG@10."""
    from recstudio_tpu.quickstart import run
    from recstudio_tpu.utils import get_model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        model, (trn, _, tst), out = run(name, "ml-100k", verbose=False,
                                        model_config=run_config(seed, tmp))
        fit_s = time.time() - t0
        cls, conf = get_model(name)
        conf["train"].update(seed=seed)
        conf["eval"]["save_path"] = tmp
        untrained = cls(conf)
        untrained._init_model(trn)
        untrained._init_parameter(trn)
        untrained.val_check = False
        untrained._train_data = trn        # ICLRec's refresh encodes the training split
        before = untrained.evaluate(tst, verbose=False)
    return {"seed": seed, "fit_s": fit_s, "best_epoch": int(model.callback.best_epoch),
            "ndcg@10": float(out["ndcg@10"]), "recall@10": float(out["recall@10"]),
            "untrained_ndcg@10": float(before["ndcg@10"])}


def port_runs(name: str, seeds):
    """The port's ``quickstart.run(name, "ml-100k")`` on the card, seed by
    seed, at ``EPOCHS``."""
    import torch
    from recstudio_torch.quickstart import run
    torch.backends.cuda.matmul.allow_tf32 = False
    print("GPU", torch.cuda.get_device_name(0), flush=True)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            model, _, out = run(name, "ml-100k", verbose=False, device="cuda",
                                model_config=run_config(seed, tmp))
        print(json.dumps({"model": name, "seed": seed, "run_s": time.perf_counter() - t0,
                          "best_epoch": model.callback.best_epoch, "ndcg@10": out["ndcg@10"],
                          "train_loss_last": model.epoch_log[-1]["train_loss"]}), flush=True)


def write(name: str, runs):
    from recstudio_tpu.utils import get_model
    conf = get_model(name)[1]
    ndcg = band([r["ndcg@10"] for r in runs])
    untrained = max(r["untrained_ndcg@10"] for r in runs)
    ref = {"about": f"recstudio_tpu {name} on ml-100k at the repo's config (d 64, F 64, 2 "
                    f"heads, 1 layer, L 20, dropout 0.5, batch 256, BCE on one uniform "
                    f"negative a position, {ABOUT[name]}), {EPOCHS} epochs, quickstart.run: "
                    "fit(train, val) then evaluate(test) at the best validation epoch, JAX "
                    "on the CPU; band = seeds' range widened by their spread; untrained = "
                    f"the largest test NDCG@10 of the seeds' untrained models "
                    f"({untrained:.4f}), which the band clears (chance_gate); written by "
                    "scripts/torch_cl_seeds.py",
           "epochs": EPOCHS, "early_stop_patience": conf["train"]["early_stop_patience"],
           "runs": runs, "ndcg@10_band": ndcg, "untrained_ndcg@10": untrained,
           "chance_gate": ndcg[0] > untrained}
    path = os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")
    with open(path, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {path}: band {ndcg}, untrained {untrained}")


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
    procs = {(n, s): subprocess.Popen([sys.executable, __file__, "--one", n, str(s)],
                                      stdout=subprocess.PIPE, text=True, cwd=REPO)
             for n in names for s in SEEDS}
    runs = {k: json.loads(p.communicate()[0].strip().splitlines()[-1])
            for k, p in procs.items()}
    for n in names:
        write(n, [runs[(n, s)] for s in SEEDS])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
