"""The port's ``quickstart.run`` and its command line.

- ``quickstart.run("BPR", "ml-100k", device="cpu")`` fits two epochs and
  evaluates, as the JAX package's does; JSON config files and the ETL keys
  of the model's ``data`` group are layered as there.
- The command line (``python -m recstudio_torch.quickstart``) turns an argv
  into the same nested overrides as the JAX package's parser.
"""
import json

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in each test: these shapes gain nothing from
    more, and torch's spinning worker threads slow a fit of tiny steps, and
    every other test process that shares the cores, many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARGVS = [
    ["-m", "BPR", "-d", "ml-100k", "--epochs", "3"],
    ["-m", "BPR", "--learner", "sparse_adam", "--learning_rate", "0.01", "--cutoff",
     "[5,10]", "--seed", "none", "--shuffle", "false", "--sampling_method", "dns"],
    ["-m", "SASRec", "--dropout_rate", "0.2", "--split_ratio", "2", "--mode", "detail"],
    ["--model", "BERT4Rec", "--dataset", "ml-100k", "--batch_size", "64",
     "--test_metrics", "[ndcg,recall]"],
    ["-m", "NARM", "--hidden_size", "64", "--dropout_rate", "[0.1,0.2]"],
    ["-m", "STAMP", "-d", "ml-100k", "--epochs", "2", "--embed_dim", "32"],
    ["-m", "GRU4Rec", "--negative_count", "2", "--layer_num", "2"],
]


def _parse(argv, get_model, get_default_parser, add_model_arguments, parser2nested_dict):
    parser = get_default_parser()
    args, _ = parser.parse_known_args(argv)
    _, conf = get_model(args.model)
    args = add_model_arguments(parser, conf).parse_args(argv)
    return vars(args)["model"], parser2nested_dict(args)


@pytest.mark.parametrize("argv", ARGVS, ids=["bpr", "bpr-flags", "sasrec", "bert4rec", "narm",
                                         "stamp", "gru4rec"])
def test_cli_overrides_match_jax(argv):
    from recstudio_tpu.utils import add_model_arguments as j_add
    from recstudio_tpu.utils import get_default_parser as j_parser
    from recstudio_tpu.utils import get_model as j_get_model
    from recstudio_tpu.utils import parser2nested_dict as j_nested
    from recstudio_torch.utils import (add_model_arguments, get_default_parser, get_model,
                                       parser2nested_dict)
    got = _parse(argv, get_model, get_default_parser, add_model_arguments, parser2nested_dict)
    want = _parse(argv, j_get_model, j_parser, j_add, j_nested)
    assert got == want and got[1]


def test_cli_refuses_a_bad_choice():
    from recstudio_torch.utils import add_model_arguments, get_default_parser, get_model
    parser = add_model_arguments(get_default_parser(), get_model("BPR")[1])
    with pytest.raises(SystemExit):
        parser.parse_args(["--sampling_method", "nope"])


def test_run_fits_and_evaluates_on_the_cpu(tmp_path):
    from recstudio_torch.models.mf import BPR
    from recstudio_torch.quickstart import run
    model, datasets, result = run("BPR", "ml-100k", verbose=False, device="cpu",
                                  model_config={"train": {"epochs": 2},
                                                "eval": {"save_path": str(tmp_path)}})
    assert isinstance(model, BPR) and model.device.type == "cpu" and len(datasets) == 3
    assert [e["epoch"] for e in model.epoch_log] == [0, 1]
    losses = [e["train_loss"] for e in model.epoch_log]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert len(result) == 18 and all(np.isfinite(list(result.values())))
    assert result["ndcg@5"] > 0.05                 # far above a random ranking
    assert model.ckpt_path.startswith(str(tmp_path))


def test_run_layers_json_configs_and_etl_keys(tmp_path):
    """A JSON model config, keyword overrides and an ETL key of the model's
    data group (``low_rating_thres``), which reaches the dataset config."""
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.quickstart import run
    path = tmp_path / "bpr.json"
    path.write_text(json.dumps({"data": {"low_rating_thres": 4.0},
                                "eval": {"save_path": str(tmp_path)}}))
    model, (trn, _, _), result = run("BPR", "ml-100k", model_config=str(path), verbose=False,
                                     device="cpu", train={"epochs": 0},
                                     eval={"test_metrics": ["ndcg"], "cutoff": [5]})
    assert model.config["data"]["low_rating_thres"] == 4.0
    assert model.config["train"]["epochs"] == 0 and sorted(result) == ["ndcg@5"]
    assert trn.config["low_rating_thres"] == 4.0
    assert trn.num_inters == JaxTripletDataset("ml-100k", config={"low_rating_thres": 4.0}).num_inters


def test_run_refuses_tune_mode():
    from recstudio_torch.quickstart import run
    with pytest.raises(NotImplementedError, match="nni"):
        run("BPR", "ml-100k", run_mode="tune", device="cpu")


def test_module_entry_point_runs(tmp_path, capsys):
    from recstudio_torch.quickstart.__main__ import main
    main(["-m", "BPR", "-d", "ml-100k", "--device", "cpu", "--epochs", "1",
          "--learner", "sparse_adam", "--save_path", str(tmp_path), "--test_metrics", "[ndcg]",
          "--cutoff", "[10]"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["ndcg@10"] and 0 < out["ndcg@10"] < 1
