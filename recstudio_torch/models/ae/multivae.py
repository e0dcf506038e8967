"""MultiVAE: a variational autoencoder over each user's interactions, with
KL annealing.

Counterpart of ``recstudio_tpu/models/ae/multivae.py``: MultiDAE's
history bag and dropout, an MLP encoder, ``enc_out`` to the mean and log
variance of a Gaussian; in training the decoder takes ``z = mu + eps o
exp(logvar / 2)`` and the step adds ``anneal * kl`` to the softmax loss,
in eval mode it takes ``mu``. The anneal coefficient advances once an
epoch (``_epoch_refresh``: epoch x steps per epoch / ``anneal_total_step``,
at most ``anneal_max``), the JAX package's per-epoch rule.

``training_step`` materializes the ``[B, N]`` catalog scores, as the JAX
package does (``multivae.py:96-110``): at ``embed_dim`` 600 they are a
plain product, above the catalog kernels' D <= 256, so MultiVAE launches
none of the port's kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...data.dataset import UserDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SoftmaxLoss
from ..module import Embedding, MLPModule
from ..module.layers import seeded_dropout
from .multidae import history_bag


class MultiVAEQueryEncoder(nn.Module):
    def __init__(self, fiid: str, num_items: int, embed_dim: int, dropout_rate: float,
                 encoder_dims: Sequence[int], decoder_dims: Sequence[int],
                 activation: str = "relu"):
        super().__init__()
        if encoder_dims[-1] != decoder_dims[0] or encoder_dims[0] != decoder_dims[-1]:
            raise ValueError(f"encoder {encoder_dims} and decoder {decoder_dims} do not mirror")
        self.fiid = fiid
        self.dropout_rate = dropout_rate
        self.latent_dim = encoder_dims[-1]
        enc_in = [embed_dim, *encoder_dims[:-1]]
        self.item_embedding = Embedding(num_items, embed_dim)
        self.encoder = MLPModule(enc_in, activation_func=activation)
        self.enc_out = nn.Linear(enc_in[-1], 2 * self.latent_dim)
        self.decoder = MLPModule(list(decoder_dims), activation_func=activation)
        self.out_proj = nn.Linear(decoder_dims[-1], embed_dim)

    def forward(self, batch: Dict[str, torch.Tensor], rng: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """Eval mode: the query ``[B, embed_dim]`` from ``mu``. Training
        mode: ``(query, kl)`` from ``z = mu + eps o exp(logvar / 2)``, with
        the caller's ``eps [B, latent]``; ``rng`` seeds the dropout."""
        h = history_bag(self.item_embedding, batch["in_" + self.fiid])
        h = self.encoder(seeded_dropout(h, self.dropout_rate, self.training, rng))
        mu, logvar = self.enc_out(h).chunk(2, dim=-1)
        if not self.training:
            return self.out_proj(self.decoder(mu))
        z = mu + eps * torch.exp(0.5 * logvar)
        kl = -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1))
        return self.out_proj(self.decoder(z)), kl


class MultiVAE(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return UserDataset

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return MultiVAEQueryEncoder(self.fiid, train_data.num_items, self.embed_dim,
                                    mc["dropout_rate"], mc["encoder_dims"], mc["decoder_dims"],
                                    mc["activation"])

    def _get_sampler(self, train_data):
        return None

    def _get_loss_func(self):
        return SoftmaxLoss()

    def _epoch_refresh(self, nepoch: int):
        super()._epoch_refresh(nepoch)
        tc = self.config["train"]
        steps = getattr(self, "_steps_per_epoch", 1)
        self.states["anneal"] = min(float(tc["anneal_max"]),
                                    max(nepoch, 0) * steps / float(tc["anneal_total_step"]))

    def training_step(self, batch: Dict[str, torch.Tensor],
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``SoftmaxLoss`` over the materialized catalog scores, one softmax
        a user shared by its targets, plus ``anneal * kl``. ``eps`` is drawn
        from the device generator unless the caller gives it."""
        query_feat = self._get_query_feat(batch)
        if eps is None:
            rows = batch["in_" + self.fiid].shape[0]
            eps = torch.randn((rows, self.query_encoder.latent_dim),
                              generator=self.device_generator, device=self.device)
        query, kl = self.query_encoder(query_feat, self.generator, eps)
        pos_score = self.score_func(query, self.net.encode_item(batch[self.fiid]))
        pos_score = torch.where(batch[self.fiid] == 0, float("-inf"), pos_score)
        all_score = self.score_func.catalog(query, self._item_vectors())
        loss = self.loss_fn(label=batch[self.frating], pos_score=pos_score, all_score=all_score)
        return loss + self.states.get("anneal", 0.0) * kl
