"""Training callbacks: early stopping and the last-epoch checkpoint.

Counterpart of ``recstudio_tpu/utils/callbacks.py``: the best parameters
are kept as an in-memory copy (``model.snapshot()``) and written, with the
optimizer and generator states, to
``<save_path>/<Model>/<dataset>/<timestamp>.ckpt`` when the fit ends.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional


class EarlyStopping:
    def __init__(self, model, monitor: str, dataset_name: str = "", save_dir: Optional[str] = None,
                 filename: Optional[str] = None, patience: int = 10, mode: str = "max"):
        self.model = model
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.counter = 0
        self.best_value = float("-inf") if mode == "max" else float("inf")
        self.best_epoch = -1
        self.best_params = None
        self.save_dir = os.path.join(save_dir or "./saved/", type(model).__name__, dataset_name)
        self.filename = filename or time.strftime("%Y-%m-%d-%H-%M-%S.ckpt")

    def _improved(self, new: float, best: float) -> bool:
        return new > best if self.mode == "max" else new < best

    def __call__(self, epoch: int, metrics: Dict[str, Any]) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        if self._improved(value, self.best_value):
            self.best_value = value
            self.best_epoch = epoch
            self.best_params = self.model.snapshot()
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience

    def save_checkpoint(self, epoch: int) -> str:
        if self.best_params is not None:
            self.model.restore(self.best_params)
        path = os.path.join(self.save_dir, self.filename)
        self.model.save_checkpoint(path, epoch=self.best_epoch,
                                   metric={self.monitor: self.best_value})
        return path


class SaveLastCallback:
    def __init__(self, model, dataset_name: str = "", save_dir: Optional[str] = None,
                 filename: Optional[str] = None):
        self.model = model
        self.save_dir = os.path.join(save_dir or "./saved/", type(model).__name__, dataset_name)
        self.filename = filename or time.strftime("%Y-%m-%d-%H-%M-%S.ckpt")
        self.best_params = None

    def __call__(self, epoch: int, metrics: Dict[str, Any]) -> bool:
        return False

    def save_checkpoint(self, epoch: int) -> str:
        path = os.path.join(self.save_dir, self.filename)
        self.model.save_checkpoint(path, epoch=epoch, metric={})
        return path
