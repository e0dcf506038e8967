"""quickstart.run: one call that trains and evaluates a model.

Counterpart of ``recstudio_tpu/quickstart/run.py:16-78``: the model's
layered default config, overlaid by a JSON file (``model_config_path``, or
``model_config`` as a path) and by the overrides given as a dict or as
``data``/``model``/``train``/``eval`` keyword arguments; the ETL keys of
the model's ``data`` group passed into the dataset config; then build,
``fit(train, val)`` and ``evaluate(test)``. It runs on the card unless
``device="cpu"`` is asked for. Configs are JSON files (the port reads no
YAML), and no log file is written.
"""
from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional, Union

import torch

from ..utils import deep_update, get_model, seed_everything

# ETL keys of the model's data group that override the dataset config
# (run.py:52-57)
_ETL_KEYS = ("low_rating_thres", "min_user_inter", "min_item_inter", "max_seq_len",
             "drop_dup", "field_max_len", "float_field_preprocess", "save_cache")


def _load_json(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _layer(conf: Dict[str, Any], override: Optional[Union[Dict, str]]) -> Dict[str, Any]:
    if isinstance(override, dict):
        return deep_update(conf, override)
    if isinstance(override, str):
        return deep_update(conf, _load_json(override))
    return conf


def run(model: str, dataset: str, model_config: Optional[Union[Dict, str]] = None,
        data_config: Optional[Union[Dict, str]] = None,
        model_config_path: Optional[str] = None,
        data_config_path: Optional[str] = None,
        verbose: bool = True, run_mode: str = "light",
        device: Union[str, torch.device] = "cuda", **kwargs):
    """Build ``dataset``, fit ``model`` on its train split with validation,
    evaluate on its test split; returns ``(model, datasets, test_result)``.
    ``run_mode="tune"`` needs ``nni`` and is not ported."""
    if run_mode == "tune":
        raise NotImplementedError("run_mode 'tune' needs nni, which the port does not use")
    model_class, model_conf = get_model(model)
    if model_config_path is not None:
        model_conf = deep_update(model_conf, _load_json(model_config_path))
    model_conf = _layer(model_conf, model_config)
    grouped = {k: v for k, v in kwargs.items()
               if isinstance(v, dict) and k in ("data", "model", "train", "eval")}
    model_conf = deep_update(model_conf, grouped)

    logger = logging.getLogger("recstudio_torch")
    if verbose and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(levelname)s %(message)s",
                                               "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    seed_everything(model_conf["train"].get("seed") or 2022)
    rec = model_class(model_conf, device=device)

    data_conf: Dict[str, Any] = {}
    if data_config_path is not None:
        data_conf = _load_json(data_config_path)
    data_conf = _layer(data_conf, data_config)
    etl = {k: v for k, v in model_conf.get("data", {}).items() if k in _ETL_KEYS}
    data_conf = deep_update(etl, data_conf)

    ds = model_class._get_dataset_class()(name=dataset, config=data_conf or None)
    datasets = ds.build(**model_conf["data"])
    logger.info("dataset %s: %d users, %d items, %d interactions", dataset,
                ds.num_users - 1, ds.num_items - 1, ds.num_inters)
    val = datasets[1] if len(datasets) > 1 else None
    rec.fit(datasets[0], val)
    test_result = rec.evaluate(datasets[-1], verbose=verbose) if len(datasets) > 2 else None
    return rec, datasets, test_result
