"""FinalMLP, FiGNN and FGCNN the way users start them, on the CPU, and the
JAX bands phase AJ of ``chip_smoke.py`` holds them to.

A one-epoch ``quickstart.run`` of each on ml-100k (dropout off) learns
past its band's untrained AUC.
``{finalmlp,fignn,fgcnn}_ml100k_train_reference.json`` hold the JAX
package's test AUC after ``quickstart.run(name, "ml-100k")`` at the repo's
config for ``ML100K_EPOCHS`` (1) epoch, for six seeds
(``scripts/torch_ctr_seeds.py --jax-ml100k FinalMLP FiGNN FGCNN``).
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_ctr_zoo_fit import AUC_MARGIN, ASSETS, REPO, SEEDS

BAND_MODELS = ("FinalMLP", "FiGNN", "FGCNN")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference(name):
    with open(os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", BAND_MODELS)
def test_quickstart_one_epoch_learns_on_cpu(name, tmp_path):
    from recstudio_torch.quickstart import run
    from recstudio_torch.utils import get_model
    no_dropout = {k: 0.0 for k in get_model(name)[1]["model"] if "dropout" in k}
    model, (trn, val, tst), out = run(
        name, "ml-100k", device="cpu", verbose=False,
        model_config={"train": {"epochs": 1, "batch_size": 2048}, "model": no_dropout,
                      "eval": {"save_path": str(tmp_path)}})
    assert len(model.epoch_log) == 1 and "auc" in model.epoch_log[0]
    assert np.isfinite(out["logloss"]) and _reference(name)["untrained_auc"] < out["auc"] < 1


@pytest.mark.parametrize("name", BAND_MODELS)
def test_training_reference_file(name):
    """Phase AJ's bands can fail: each clears the untrained AUC by
    ``AUC_MARGIN``, from six JAX seeds at the repo's config, for the one
    epoch ``scripts/torch_ctr_seeds.py`` runs them."""
    import importlib.util
    from recstudio_torch.utils import get_model
    spec = importlib.util.spec_from_file_location(
        "torch_ctr_seeds", os.path.join(REPO, "scripts", "torch_ctr_seeds.py"))
    seeds_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeds_script)
    ref = _reference(name)
    tc = get_model(name)[1]["train"]
    assert (ref["epochs"], ref["early_stop_patience"]) == (seeds_script.ML100K_EPOCHS[name],
                                                          tc["early_stop_patience"]) == (1, 10)
    assert ref["metric"] == "auc" and [r["seed"] for r in ref["runs"]] == list(SEEDS)
    aucs = [r["auc"] for r in ref["runs"]]
    spread = max(aucs) - min(aucs)
    assert ref["auc_band"] == [min(aucs) - spread, max(aucs) + spread]
    assert ref["untrained_auc"] == max(r["untrained_auc"] for r in ref["runs"])
    assert ref["untrained_auc"] + AUC_MARGIN < ref["auc_band"][0] < ref["auc_band"][1] < 1
    assert all(r["best_epoch"] == 0 for r in ref["runs"])
