"""The port's configs (JSON copies) merge to the JAX package's YAML configs."""
import pytest

from recstudio_tpu.utils import get_dataset_default_config as jax_dataset_config
from recstudio_tpu.utils import get_model as jax_get_model

from recstudio_torch.utils import get_dataset_default_config, get_model, list_models


def test_sasrec_config_equals_jax():
    _, want = jax_get_model("SASRec")
    cls, got = get_model("SASRec")
    assert got == want
    assert cls.__name__ == "SASRec"
    assert get_model("sasrec")[1] == want


def test_bert4rec_config_equals_jax():
    _, want = jax_get_model("BERT4Rec")
    cls, got = get_model("BERT4Rec")
    assert got == want
    assert cls.__name__ == "BERT4Rec"
    assert got["model"]["dropout"] == 0.2 and "dropout_rate" not in got["model"]


@pytest.mark.parametrize("name", ["GRU4Rec", "NARM", "STAMP"])
def test_rnn_and_attention_model_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert get_model(name.lower())[1] == want


@pytest.mark.parametrize("name", ["MultiDAE", "MultiVAE"])
def test_autoencoder_model_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert got["eval"]["batch_size"] == 200 and got["train"]["weight_decay"] == 1e-5


@pytest.mark.parametrize("name", ["DeepFM", "FM", "LR", "WideDeep", "DCN", "NFM", "AutoInt",
                                  "InterHAt", "DIFM", "xDeepFM", "DCNv2", "PNN", "DLRM", "FwFM",
                                  "AFM", "FFM", "FmFM", "FiBiNET", "MaskNet", "ONN", "HFM", "AFN",
                                  "DeepCrossing", "FLEN", "IFM", "EDCN", "FinalMLP", "PPNet",
                                  "DeepIM", "LorentzFM", "AOANet", "SAM", "DESTINE", "FiGNN",
                                  "CCPM", "FGCNN"])
def test_ranker_model_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert got["data"]["fmeval"] is True and got["data"]["binarized_rating_thres"] == 3.0
    assert got["eval"]["cutoff"] is None


@pytest.mark.parametrize("name", ["LightGCN", "NGCF", "SimGCL", "SGL", "NCL"])
def test_graph_model_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert got["train"]["negative_count"] == 1 and got["data"]["neg_count"] == 0
    assert got["data"]["sampler"] is None


@pytest.mark.parametrize("name", ["DIN", "DIEN"])
def test_seq_ranker_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert got["data"]["binarized_rating_thres"] == 3.0 and got["eval"]["batch_size"] == 32


@pytest.mark.parametrize("name", ["HardShare", "MMoE", "PLE", "AITM"])
def test_multitask_model_configs_equal_jax(name):
    """The multitask family's defaults (``multitask/config/all.yaml``):
    ``fmeval``, no rating threshold or binarization, equal task weights."""
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert got["data"]["fmeval"] is True and got["data"]["binarized_rating_thres"] is None
    assert got["train"]["weights"] is None and got["eval"]["val_metrics"] == ["auc", "logloss"]


def test_ml100k_config_equals_jax():
    assert get_dataset_default_config("ml-100k") == jax_dataset_config("ml-100k")


def test_unknown_dataset_falls_back_to_defaults():
    assert get_dataset_default_config("no-such-set") == jax_dataset_config("no-such-set")


@pytest.mark.parametrize("name", ["BPR", "PMF", "CML", "NCF", "LogisticMF", "EASE", "ItemKNN",
                                  "SLIM", "WRMF", "IRGAN", "DSSM", "IPSBPR", "PDA"])
def test_mf_model_configs_equal_jax(name):
    _, want = jax_get_model(name)
    cls, got = get_model(name)
    assert got == want and cls.__name__ == name
    assert get_model(name.lower())[1] == want


def test_registry_lists_what_is_ported():
    assert list_models() == {"sasrec": "seq", "bert4rec": "seq", "gru4rec": "seq",
                             "narm": "seq", "stamp": "seq", "bpr": "mf", "pmf": "mf",
                             "cml": "mf", "ncf": "mf", "logisticmf": "mf",
                             "multidae": "ae", "multivae": "ae",
                             "deepfm": "fm", "fm": "fm", "lr": "fm", "widedeep": "fm",
                             "dcn": "fm", "nfm": "fm", "autoint": "fm",
                             "lightgcn": "graph", "ngcf": "graph", "simgcl": "graph",
                             "din": "seq", "dien": "seq", "hardshare": "multitask",
                             "mmoe": "multitask", "ple": "multitask", "aitm": "multitask",
                             "interhat": "fm", "difm": "fm", "xdeepfm": "fm", "dcnv2": "fm",
                             "pnn": "fm", "dlrm": "fm", "fwfm": "fm", "afm": "fm", "ffm": "fm",
                             "fmfm": "fm", "fibinet": "fm", "masknet": "fm", "onn": "fm",
                             "hfm": "fm", "afn": "fm", "cl4srec": "seq", "coserec": "seq",
                             "iclrec": "seq", "caser": "seq", "fpmc": "seq", "transrec": "seq",
                             "hgn": "seq", "npe": "seq", "deepcrossing": "fm", "flen": "fm",
                             "ifm": "fm", "edcn": "fm", "finalmlp": "fm", "ppnet": "fm",
                             "deepim": "fm", "lorentzfm": "fm", "aoanet": "fm", "sam": "fm",
                             "destine": "fm", "fignn": "fm", "ccpm": "fm", "fgcnn": "fm",
                             "ease": "mf", "itemknn": "mf", "slim": "mf", "wrmf": "mf",
                             "irgan": "mf", "dssm": "mf", "ipsbpr": "debias", "pda": "debias",
                             "sgl": "graph", "ncl": "graph"}


@pytest.mark.parametrize("key,value", [
    ("precision", "bf16"), ("precision", "bfloat16"), ("precision", "int8-someday"),
    ("ckpt_backend", "orbax"), ("tensorboard_path", "./tb")])
def test_train_keys_the_port_does_not_honour_raise(key, value):
    """A train key the port would silently ignore is refused when the model
    is built, as an unported learner is when its optimizer is made."""
    cls, conf = get_model("SASRec")
    conf["train"][key] = value
    with pytest.raises(NotImplementedError, match=key):
        cls(conf, device="cpu")


@pytest.mark.parametrize("precision", ["default", "fp32", "bf16_3x", "FP32"])
def test_float32_precisions_are_accepted(precision):
    cls, conf = get_model("SASRec")
    conf["train"]["precision"] = precision
    conf["train"]["ckpt_backend"] = "pickle"
    assert cls(conf, device="cpu").config["train"]["precision"] == precision
