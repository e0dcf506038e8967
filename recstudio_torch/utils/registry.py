"""Model registry: name -> (model class, layered default config).

The subset of ``recstudio_tpu/utils/registry.py`` this port implements:
SASRec, and the dataset configs it is served on.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple, Type

from .config import CONFIG_DIR, deep_update, get_base_model_config, load_json

# model name (lower case) -> (family, config files layered over basemodel)
_MODELS = {"sasrec": ("seq", ("seq_all", "sasrec"))}


def list_models() -> Dict[str, str]:
    """Return {model_name_lower: family}."""
    return {name: family for name, (family, _) in _MODELS.items()}


def get_model(model_name: str) -> Tuple[Type, Dict[str, Any]]:
    """Look up a model class by name and assemble its layered default config."""
    lname = model_name.lower()
    if lname not in _MODELS:
        raise ValueError(f"Model '{model_name}' not found. Available: {sorted(_MODELS)}")
    _, layers = _MODELS[lname]
    from ..models.seq.sasrec import SASRec
    conf = get_base_model_config()
    for name in layers:
        conf = deep_update(conf, load_json(name))
    return SASRec, conf


def get_dataset_default_config(dataset_name: str) -> Dict[str, Any]:
    """``data_all`` overlaid by ``<dataset>`` when the port ships one."""
    conf = load_json("data_all")
    if os.path.isfile(os.path.join(CONFIG_DIR, f"{dataset_name}.json")):
        conf = deep_update(conf, load_json(dataset_name))
    return conf
