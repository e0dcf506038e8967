"""Model registry: name -> (model class, layered default config).

The subset of ``recstudio_tpu/utils/registry.py`` this port implements:
SASRec, BERT4Rec, GRU4Rec, NARM and STAMP (``seq``), BPR, PMF, CML, NCF
and LogisticMF (``mf``),
MultiDAE and MultiVAE (``ae``), DeepFM, FM, LR, WideDeep, DCN, NFM and
AutoInt (``fm``), LightGCN, NGCF and SimGCL (``graph``), and the dataset
configs they run on.
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Dict, Tuple, Type

from .config import CONFIG_DIR, deep_update, get_base_model_config, load_json

# model name (lower case) -> (family, class name, config files layered over basemodel)
_MODELS = {"sasrec": ("seq", "SASRec", ("seq_all", "sasrec")),
           "bert4rec": ("seq", "BERT4Rec", ("seq_all", "bert4rec")),
           "gru4rec": ("seq", "GRU4Rec", ("seq_all", "gru4rec")),
           "narm": ("seq", "NARM", ("seq_all", "narm")),
           "stamp": ("seq", "STAMP", ("seq_all", "stamp")),
           "bpr": ("mf", "BPR", ("mf_all", "bpr")),
           "pmf": ("mf", "PMF", ("mf_all", "pmf")),
           "cml": ("mf", "CML", ("mf_all", "cml")),
           "ncf": ("mf", "NCF", ("mf_all", "ncf")),
           "logisticmf": ("mf", "LogisticMF", ("mf_all", "logisticmf")),
           "multidae": ("ae", "MultiDAE", ("multidae",)),
           "multivae": ("ae", "MultiVAE", ("multivae",)),
           "deepfm": ("fm", "DeepFM", ("fm_all", "deepfm")),
           "fm": ("fm", "FM", ("fm_all", "fm")),
           "lr": ("fm", "LR", ("fm_all", "lr")),
           "widedeep": ("fm", "WideDeep", ("fm_all", "widedeep")),
           "dcn": ("fm", "DCN", ("fm_all", "dcn")),
           "nfm": ("fm", "NFM", ("fm_all", "nfm")),
           "autoint": ("fm", "AutoInt", ("fm_all", "autoint")),
           "lightgcn": ("graph", "LightGCN", ("lightgcn",)),
           "ngcf": ("graph", "NGCF", ("ngcf",)),
           "simgcl": ("graph", "SimGCL", ("simgcl",))}


def list_models() -> Dict[str, str]:
    """Return {model_name_lower: family}."""
    return {name: family for name, (family, _, _) in _MODELS.items()}


def get_model(model_name: str) -> Tuple[Type, Dict[str, Any]]:
    """Look up a model class by name and assemble its layered default config."""
    lname = model_name.lower()
    if lname not in _MODELS:
        raise ValueError(f"Model '{model_name}' not found. Available: {sorted(_MODELS)}")
    family, class_name, layers = _MODELS[lname]
    module = importlib.import_module(f"recstudio_torch.models.{family}.{lname}")
    conf = get_base_model_config()
    for name in layers:
        conf = deep_update(conf, load_json(name))
    return getattr(module, class_name), conf


def get_dataset_default_config(dataset_name: str) -> Dict[str, Any]:
    """``data_all`` overlaid by ``<dataset>`` when the port ships one."""
    conf = load_json("data_all")
    if os.path.isfile(os.path.join(CONFIG_DIR, f"{dataset_name}.json")):
        conf = deep_update(conf, load_json(dataset_name))
    return conf
