"""CL4SRec: contrastive learning for sequential recommendation.

Counterpart of ``recstudio_tpu/models/seq/cl4srec.py``: SASRec on
``SeqToSeqDataset`` windows (BCE on one uniform negative a position, every
position a target: training pooling ``origin``), plus ``cl_weight`` times
the batch-negative InfoNCE of two augmented views of each sequence, each
encoded with dropout and mean-pooled over its true positions. The item
table has ``num_items + 1`` rows: id ``num_items`` is the ``[MASK]`` token
of ``item_mask``; the catalog scored in serving and evaluation is items
``1 .. num_items - 1`` (``BaseRetriever._item_vectors``), as BERT4Rec's.
A training step runs the encoder three times: three K1 launches a layer
forward and three K2 launches backward on the card. The views' draws
come from the device generator (``_views``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ...data.dataset import SeqToSeqDataset
from ..module import Embedding, SeqPoolingLayer
from ..module.data_augmentation import View, info_nce, item_crop, item_mask, item_reorder
from .sasrec import SASRec


class CL4SRec(SASRec):
    _training_pooling = "origin"

    @staticmethod
    def _get_dataset_class():
        return SeqToSeqDataset

    def _init_model(self, train_data):
        super()._init_model(train_data)
        self.mask_id = train_data.num_items          # the extra row is the mask token
        self._mean = SeqPoolingLayer("mean")

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items + 1, self.embed_dim)

    def _augment(self, seq: torch.Tensor, seqlen: torch.Tensor) -> View:
        """One view of ``model.augment_type`` (``cl4srec.py:44-52``); the
        crop keeps ``tau`` of the sequence."""
        mc, gen = self.config["model"], self.device_generator
        kind = mc.get("augment_type", "item_crop")
        if kind == "item_crop":
            return item_crop(seq, seqlen, mc.get("tau", 0.2), generator=gen)
        if kind == "item_mask":
            return item_mask(seq, seqlen, mask_id=self.mask_id, generator=gen)
        if kind == "item_reorder":
            return item_reorder(seq, seqlen, generator=gen)
        raise ValueError(f"unknown augment_type {kind}")

    def _views(self, batch: Dict[str, torch.Tensor]) -> Tuple[View, View]:
        """The two augmented views of the batch's sequences."""
        seq, seqlen = batch["in_" + self.fiid], batch["seqlen"]
        return self._augment(seq, seqlen), self._augment(seq, seqlen)

    def _encode_mean(self, seq: torch.Tensor, seqlen: torch.Tensor) -> torch.Tensor:
        """A view encoded in training mode (dropout on, every position) and
        mean-pooled over its true positions."""
        out = self.net.encode_query({"in_" + self.fiid: seq, "seqlen": seqlen}, self.generator)
        return self._mean(out, seqlen)

    def _view_reps(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        (seq_i, len_i), (seq_j, len_j) = self._views(batch)
        return self._encode_mean(seq_i, len_i), self._encode_mean(seq_j, len_j)

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """SASRec's loss plus ``cl_weight`` times the views' InfoNCE
        (``cl4srec.py:54-74``)."""
        base = super().training_step(batch)
        mc = self.config["model"]
        zi, zj = self._view_reps(batch)
        cl = info_nce(zi, zj, mc["temperature"], "inner_product", "batch_both")
        return base + mc["cl_weight"] * cl
