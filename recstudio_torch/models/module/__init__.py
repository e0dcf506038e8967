from typing import Optional

import torch
from torch import nn

from .layers import (AttentionLayer, GRULayer, MLPModule, SeqPoolingLayer, TransformerEncoder,
                     TransformerLayer, get_act)


class Embedding(nn.Embedding):
    """Embedding table with [PAD]=0 row semantics, counterpart of
    ``recstudio_tpu/models/module/__init__.py:Embedding``: row 0 is zeroed
    at init (``models/init.py``) and its gradient is zeroed by the engine
    (``zero_pad_rows_in_grads``), so it stays 0 in training. As a tower of
    a two-tower net it takes the ids alone; ``rng`` (the dropout stream the
    other towers take) is accepted and unused, as the JAX module's
    ``training`` flag is."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: int = 0):
        super().__init__(num_embeddings, features, padding_idx=padding_idx)

    def forward(self, ids: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(ids)


__all__ = ["AttentionLayer", "Embedding", "GRULayer", "MLPModule", "SeqPoolingLayer",
           "TransformerEncoder", "TransformerLayer", "get_act"]
