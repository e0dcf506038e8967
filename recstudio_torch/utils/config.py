"""Layered configuration: basemodel -> family -> model -> overrides.

Same merge order as ``recstudio_tpu/utils/config.py`` and
``utils/registry.py``. The YAML files of the JAX package are kept here as
JSON copies under ``configs/`` so the port needs no YAML parser.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(PKG_ROOT, "configs")


def load_json(name: str) -> Dict[str, Any]:
    """Load ``configs/<name>.json``."""
    with open(os.path.join(CONFIG_DIR, f"{name}.json"), "r", encoding="utf-8") as f:
        return json.load(f)


def deep_update(base: Dict[str, Any], update: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursively merge ``update`` into a copy of ``base``.

    Nested dicts are merged key-wise; any other value type is replaced.
    """
    out = copy.deepcopy(base)
    if not update:
        return out
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def get_base_model_config() -> Dict[str, Any]:
    return load_json("basemodel")
