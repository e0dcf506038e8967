"""Deterministic seeding across python, numpy and torch.

Counterpart of ``recstudio_tpu/utils/seed.py``. Parameter initialisation
does not read the global torch generator: it takes an explicit
``torch.Generator`` (``models/init.py``).
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 2022) -> int:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def make_generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed`` (draws are moved to the device)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g
