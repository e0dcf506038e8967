"""Recommender: configuration, model assembly and parameters.

The serving subset of ``recstudio_tpu/models/basemodel/recommender.py``:
config, ``_init_model``, ``_init_parameter`` and ``batch_to_device``. The
model is an ``nn.Module`` (``self.net``) on ``self.device``; parameters are
drawn from an explicit ``torch.Generator`` seeded with ``train.seed``.
Training (``fit``, optimizers, losses, evaluation loops) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ...utils import get_base_model_config, make_generator, resolve_device, seed_everything
from ..init import init_parameters


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


class Recommender:
    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config if config is not None else get_base_model_config()
        self.device = resolve_device(device)
        seed = self.config["train"].get("seed")
        if seed is not None:
            seed_everything(seed)
        self.generator = make_generator(seed or 0)
        self.embed_dim = self.config["model"]["embed_dim"]
        self.net: Optional[torch.nn.Module] = None
        self.states: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _get_dataset_class():
        raise NotImplementedError

    def _init_model(self, train_data):
        self.fields = set(train_data.use_field)
        self.frating = train_data.frating
        self.fuid = train_data.fuid
        self.fiid = train_data.fiid
        self.item_feat = train_data.item_feat
        if self.item_feat is not None:
            self.item_fields = set(self.item_feat.fields).intersection(self.fields)
        else:
            self.item_fields = {self.fiid}

    def _init_parameter(self, train_data=None):
        """Initialise ``self.net``'s parameters by role (``train.init_method``,
        ``train.init_range``), then place it on the device in eval mode."""
        method = self.config["train"].get("init_method") or "xavier_normal"
        init_range = self.config["train"].get("init_range", 0.02)
        init_parameters(self.net, self.generator, method, init_range)
        self.net.to(self.device).eval()

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load parameters (e.g. from ``utils.convert.params_from_jax``)."""
        self.net.load_state_dict(state_dict)
        self.net.to(self.device).eval()
        self.states.clear()  # cached item vectors belong to the old weights
