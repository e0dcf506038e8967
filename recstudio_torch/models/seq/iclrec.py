"""ICLRec: intent contrastive learning for sequential recommendation.

Counterpart of ``recstudio_tpu/models/seq/iclrec.py``: CL4SRec with
``item_random`` views (``augment_type``), a symmetric instance InfoNCE,
and an intent InfoNCE that pulls each view towards its sequence's intent,
the nearest of ``num_intent_clusters`` centres. Before each training
epoch (``_epoch_refresh``) every training window is encoded with dropout
off, pooled at its last position as the JAX package's evaluation encode
is, and clustered by ``ops/kmeans.py`` on the device into
``states["intent_centroids"]``; an evaluation refresh leaves them (no
inference path reads them). In a step the sequences are encoded the same
way, in evaluation mode under ``no_grad`` (K1's evaluation route, no
dropout), and the net goes back to training mode for the rest of the
step.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...ops.kmeans import kmeans
from ..module.data_augmentation import (View, info_nce, item_crop, item_mask, item_random,
                                        item_reorder)
from .cl4srec import CL4SRec


class ICLRec(CL4SRec):

    def _augment(self, seq: torch.Tensor, seqlen: torch.Tensor) -> View:
        """One view of ``model.augment_type`` (``iclrec.py:28-38``)."""
        kind, gen = self.config["model"].get("augment_type", "item_random"), self.device_generator
        if kind == "item_random":
            return item_random(seq, seqlen, mask_id=self.mask_id, generator=gen)
        if kind == "item_crop":
            return item_crop(seq, seqlen, generator=gen)
        if kind == "item_mask":
            return item_mask(seq, seqlen, mask_id=self.mask_id, generator=gen)
        if kind == "item_reorder":
            return item_reorder(seq, seqlen, generator=gen)
        raise ValueError(f"unknown augment_type {kind}")

    @torch.no_grad()
    def _encode_eval(self, seq: torch.Tensor, seqlen: torch.Tensor) -> torch.Tensor:
        """Sequences encoded with dropout off and pooled at the last true
        position (``iclrec.py:40-47``, ``training=False``); the net's mode is
        put back."""
        was_training = self.net.training
        self.net.eval()
        try:
            return self.net.encode_query({"in_" + self.fiid: seq, "seqlen": seqlen})
        finally:
            self.net.train(was_training)

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int):
        """Before a training epoch, the intent centres from every training
        window's encoding (``iclrec.py:49-68``), the k-means draws from the
        device generator."""
        super()._epoch_refresh(nepoch)
        if nepoch < 0:
            return
        rows = torch.arange(self._epoch_rows, device=self.device)
        windows = self._batch_fn(self._epoch_arrays, rows)
        reps = self._encode_eval(windows["in_" + self.fiid], windows["seqlen"])
        centroids, _ = kmeans(reps, int(self.config["model"]["num_intent_clusters"]),
                              generator=self.device_generator)
        self.states["intent_centroids"] = centroids

    def intent_loss(self, zi: torch.Tensor, zj: torch.Tensor,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The views against their sequences' nearest intent centre, rows of
        one intent not each other's negatives (``iclrec.py:83-95``)."""
        t = self.config["model"]["temperature"]
        centroids = self.states["intent_centroids"]
        seq_rep = self._encode_eval(batch["in_" + self.fiid], batch["seqlen"])
        d = (seq_rep ** 2).sum(-1, keepdim=True) - 2 * seq_rep @ centroids.t() \
            + (centroids ** 2).sum(-1)
        intent_ids = torch.argmin(d, dim=-1)
        seq2intent = centroids[intent_ids]
        return 0.5 * (info_nce(zi, seq2intent, t, "inner_product", "batch_both",
                               instance_labels=intent_ids)
                      + info_nce(zj, seq2intent, t, "inner_product", "batch_both",
                                 instance_labels=intent_ids))

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """SASRec's loss, ``cl_weight`` times the symmetric instance InfoNCE
        and ``intent_cl_weight`` times the intent InfoNCE (``iclrec.py:70-97``)."""
        base = super(CL4SRec, self).training_step(batch)
        mc = self.config["model"]
        t = mc["temperature"]
        zi, zj = self._view_reps(batch)
        instance = 0.5 * (info_nce(zi, zj, t, "inner_product", "batch_both")
                          + info_nce(zj, zi, t, "inner_product", "batch_both"))
        return base + mc["cl_weight"] * instance \
            + mc["intent_cl_weight"] * self.intent_loss(zi, zj, batch)
