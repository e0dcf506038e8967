"""MultiDAE: a denoising autoencoder over each user's interactions.

Counterpart of ``recstudio_tpu/models/ae/multidae.py``: the user's
training items (the history window of a ``UserDataset`` row) embedded by
the query tower's own table and summed, divided by the square root of
their count (``history_bag``); dropout; an MLP encoder-decoder with the
activation after every layer; ``out_proj`` back to ``embed_dim``. The
item tower is a plain ``Embedding``, scored by inner product and trained
with the full-catalog ``SoftmaxLoss``, one softmax a user shared by its
target items: through ``_fused_softmax_step`` (K7, K8, K9 on the card,
D = ``embed_dim``) unless ``train.fused_softmax`` is ``false``.

The bag is a sum the JAX package leaves to XLA (no Pallas kernel); here
it is ``F.embedding_bag``, which never materializes the ``[B, W, D]``
rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...data.dataset import UserDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SoftmaxLoss
from ..module import Embedding, MLPModule
from ..module.layers import seeded_dropout


def history_bag(table: nn.Embedding, hist: torch.Tensor) -> torch.Tensor:
    """``sum_w table[hist[:, w]] / sqrt(max(nnz, 1))`` over each row's
    nonzero ids (row 0 of the table, the ``[PAD]`` row, is zero): ``[B, D]``."""
    bag = F.embedding_bag(hist.long(), table.weight, mode="sum", padding_idx=0)
    nnz = (hist != 0).sum(-1, keepdim=True).clamp_min(1).to(bag.dtype)
    return bag / torch.sqrt(nnz)


class MultiDAEQueryEncoder(nn.Module):
    def __init__(self, fiid: str, num_items: int, embed_dim: int, dropout_rate: float,
                 encoder_dims: Sequence[int], decoder_dims: Sequence[int],
                 activation: str = "relu"):
        super().__init__()
        if encoder_dims[-1] != decoder_dims[0] or encoder_dims[0] != decoder_dims[-1]:
            raise ValueError(f"encoder {encoder_dims} and decoder {decoder_dims} do not mirror")
        self.fiid = fiid
        self.dropout_rate = dropout_rate
        self.item_embedding = Embedding(num_items, embed_dim)
        self.encoder_decoder = MLPModule([embed_dim, *encoder_dims, *decoder_dims[1:]],
                                         activation_func=activation)
        self.out_proj = nn.Linear(decoder_dims[-1], embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        h = history_bag(self.item_embedding, batch["in_" + self.fiid])
        h = seeded_dropout(h, self.dropout_rate, self.training, rng)
        return self.out_proj(self.encoder_decoder(h))


class MultiDAE(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return UserDataset

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return MultiDAEQueryEncoder(self.fiid, train_data.num_items, self.embed_dim,
                                    mc["dropout"], mc["encoder_dims"], mc["decoder_dims"],
                                    mc["activation"])

    def _get_sampler(self, train_data):
        return None

    def _get_loss_func(self):
        return SoftmaxLoss()
