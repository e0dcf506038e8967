"""Command-line flags from a nested config dict.

The port's copy of ``recstudio_tpu/utils/arguments.py:20-86``: every leaf
of the merged model config becomes a ``--key`` flag whose destination is
``group/key`` (the first group wins a key that two groups hold), and
``parser2nested_dict`` folds the parsed flags back into the nested
``{data, model, train, eval}`` overrides. Values are parsed by
``_str2value`` (``none``/``null``/``~``, booleans, ints, floats, ``[a,b]``
lists, else the string).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

_CHOICES = {
    "train/accelerator": ["cpu", "tpu", "gpu", "dp", "ddp"],
    "train/init_method": ["xavier_normal", "normal", "xavier_uniform"],
    "train/sampling_method": ["none", "sir", "dns", "toprand", "top&rand", "brute"],
}


def get_default_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--model", "-m", type=str, default="BPR", help="model name")
    parser.add_argument("--dataset", "-d", type=str, default="ml-100k", help="dataset name")
    parser.add_argument("--data_dir", type=str, default=None, help="directory of dataset files")
    parser.add_argument("--mode", type=str, default="light",
                        choices=["light", "detail", "tune"], help="running mode")
    return parser


def _str2value(s: str) -> Any:
    if s.lower() in ("none", "null", "~"):
        return None
    if s.lower() == "true":
        return True
    if s.lower() == "false":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_str2value(x.strip()) for x in inner.split(",")] if inner else []
    return s


def add_model_arguments(parser: argparse.ArgumentParser,
                        config: Dict[str, Any]) -> argparse.ArgumentParser:
    seen = set()
    for group, sub in config.items():
        if not isinstance(sub, dict):
            continue
        for key in sub:
            if key in seen:
                continue
            seen.add(key)
            dest = f"{group}/{key}"
            kwargs: Dict[str, Any] = {"dest": dest, "default": argparse.SUPPRESS,
                                      "type": _str2value}
            if dest in _CHOICES:
                kwargs["choices"] = _CHOICES[dest]
            parser.add_argument(f"--{key}", **kwargs)
    return parser


def parser2nested_dict(args: argparse.Namespace,
                       ignore=("model", "dataset", "mode", "data_dir")) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for dest, value in vars(args).items():
        if dest in ignore:
            continue
        if "/" in dest:
            group, key = dest.split("/", 1)
            out.setdefault(group, {})[key] = value
        else:
            out[dest] = value
    return out
