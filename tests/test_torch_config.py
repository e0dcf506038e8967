"""The port's configs (JSON copies) merge to the JAX package's YAML configs."""
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


def test_ml100k_config_equals_jax():
    assert get_dataset_default_config("ml-100k") == jax_dataset_config("ml-100k")


def test_unknown_dataset_falls_back_to_defaults():
    assert get_dataset_default_config("no-such-set") == jax_dataset_config("no-such-set")


def test_registry_lists_what_is_ported():
    assert list_models() == {"sasrec": "seq", "bert4rec": "seq"}
