"""EASE, ItemKNN, SLIM, WRMF, IRGAN, DSSM, IPSBPR, PDA, SGL and NCL the way
users start them: a short CPU ``quickstart.run`` of each, and the JAX
bands of ``chip_smoke.py``'s phase AL (their registry entries and configs:
``test_torch_config.py``).

- ``quickstart.run(name, "ml-100k", device="cpu")`` at small settings
  (d 16 where the model has tables; SLIM's 10 ISTA steps; DSSM without
  dropout; IRGAN one discriminator and one generator epoch; NCL's
  prototype term on in its second epoch): finite losses and test metrics,
  the training path the model asks for (no optimizer for the closed-form
  and ALS models, two for IRGAN, each of which stepped);
- each ``recstudio_torch/assets/<model>_ml100k_train_reference.json``
  (written by ``scripts/torch_retriever_seeds.py``): its band follows its
  runs, and clears the untrained model's NDCG@10.
"""
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
NEW = ("EASE", "ItemKNN", "SLIM", "WRMF", "IRGAN", "DSSM", "IPSBPR", "PDA", "SGL", "NCL")
CLOSED_FORM_TOL = 0.003
# the small settings of the CPU runs
QUICK = {"EASE": {}, "ItemKNN": {}, "SLIM": {"train": {"max_iter": 10}},
         "WRMF": {"model": {"embed_dim": 16}, "train": {"epochs": 2}},
         "IRGAN": {"model": {"embed_dim": 16},
                   "train": {"epochs": 2, "every_n_epoch_dis": 1, "every_n_epoch_gen": 1}},
         "DSSM": {"model": {"embed_dim": 16, "dropout": 0.0, "mlp_layer": [32, 32]}},
         "IPSBPR": {"model": {"embed_dim": 16}}, "PDA": {"model": {"embed_dim": 16}},
         "SGL": {"model": {"embed_dim": 16}, "train": {"batch_size": 4096}},
         "NCL": {"model": {"embed_dim": 16}, "train": {"epochs": 2, "warm_up_epoch": 1,
                                                        "batch_size": 4096}}}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", NEW)
def test_quickstart_runs_on_the_cpu(name, tmp_path):
    from recstudio_torch.quickstart import run
    conf = {"train": {"epochs": 1}, "eval": {"save_path": str(tmp_path)}}
    for group, values in QUICK[name].items():
        conf.setdefault(group, {}).update(values)
    model, _, result = run(name, "ml-100k", verbose=False, device="cpu", model_config=conf)
    assert model.device == torch.device("cpu") and type(model).__name__ == name
    assert len(model.epoch_log) == conf["train"]["epochs"]
    assert all(np.isfinite(e["train_loss"]) for e in model.epoch_log)
    assert result and all(np.isfinite(v) for v in result.values())
    assert 0.0 < result["ndcg@10"] <= 1.0
    if name in ("EASE", "ItemKNN", "SLIM", "WRMF"):
        assert model.optimizers == [] and model.optimizer is None
    else:
        assert len(model.optimizers) == (2 if name == "IRGAN" else 1)
        assert all(opt.state for opt in model.optimizers)      # each one stepped
    if name == "NCL":
        assert float(model.states.get("proto_on", 0.0)) == 0.0   # evaluation's refresh
        assert model.states["user_centroids"].shape == (10, 16)


def _reference(name):
    with open(os.path.join(ASSETS, f"{name.lower()}_ml100k_train_reference.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", NEW)
def test_training_reference_file(name):
    ref = _reference(name)
    assert ref["model"] == name and ref["epochs"] > 0 and ref["about"]
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    if ref["closed_form"]:
        assert name in ("EASE", "ItemKNN", "SLIM") and len(ndcg) == 1
        assert ref["ndcg@10_band"] == [ndcg[0] - CLOSED_FORM_TOL, ndcg[0] + CLOSED_FORM_TOL]
        assert ref["untrained_ndcg@10"] is None
        return
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert [r["seed"] for r in ref["runs"]] == list(range(2022, 2028))
    assert ref["untrained_ndcg@10"] == max(r["untrained_ndcg@10"] for r in ref["runs"])
    assert ref["ndcg@10_band"][0] > ref["untrained_ndcg@10"]
    loss = [r["train_loss_last"] for r in ref["runs"]]
    spread = max(loss) - min(loss)
    assert ref["train_loss_last_band"] == [min(loss) - spread, max(loss) + spread]
