from torch import nn

from .layers import SeqPoolingLayer, TransformerEncoder, TransformerLayer


class Embedding(nn.Embedding):
    """Embedding table with [PAD]=0 row semantics (``padding_idx`` 0),
    counterpart of ``recstudio_tpu/models/module/__init__.py:Embedding``."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: int = 0):
        super().__init__(num_embeddings, features, padding_idx=padding_idx)


__all__ = ["Embedding", "SeqPoolingLayer", "TransformerEncoder", "TransformerLayer"]
