"""BERT4Rec: bidirectional transformer with masked-item prediction.

Counterpart of ``recstudio_tpu/models/seq/bert4rec.py``. The item table has
``num_items + 1`` rows: id ``num_items`` is the ``[MASK]`` token. Training
masks a share ``train.mask_ratio`` of each history's true positions
(``_reconstruct_train_data``); the encoder (``SASRecQueryEncoder`` with no
attention mask) returns every position, the target of a masked position is
its original item and every other position gets target 0, whose score
becomes -inf and drops out of ``SoftmaxLoss``. The catalog that the loss and
serving score against is items ``1..num_items-1``
(``BaseRetriever._item_vectors``), without ``[PAD]`` and ``[MASK]``.
Serving pools the last true position.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...data.dataset import SeqDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SoftmaxLoss
from ..module import Embedding
from .sasrec import SASRecQueryEncoder


class BERT4Rec(BaseRetriever):

    def _init_model(self, train_data):
        super()._init_model(train_data)
        self.mask_token = train_data.num_items

    @staticmethod
    def _get_dataset_class():
        return SeqDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items + 1, self.embed_dim)   # + [MASK]

    def _get_query_encoder(self, train_data):
        mc = self.config["model"]
        return SASRecQueryEncoder(
            fiid=self.fiid, embed_dim=self.embed_dim,
            max_seq_len=train_data.config["max_seq_len"], n_head=mc["head_num"],
            hidden_size=mc["hidden_size"], dropout=mc["dropout"],
            activation=mc["activation"], layer_norm_eps=float(mc["layer_norm_eps"]),
            n_layer=mc["layer_num"], item_encoder=self.item_encoder,
            bidirectional=True, training_pooling_type="mask")

    def _get_loss_func(self):
        return SoftmaxLoss()

    def _get_sampler(self, train_data):
        return None

    def _reconstruct_train_data(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Mask each true history position with probability
        ``train.mask_ratio`` (``bert4rec.py:58-67``); the uniforms come from
        ``self.device_generator``."""
        key = "in_" + self.fiid
        seq = batch[key]
        rand = torch.rand(seq.shape, generator=self.device_generator, device=seq.device)
        rand = torch.where(seq == 0, 1.0, rand)
        masked = rand < float(self.config["train"]["mask_ratio"])
        batch = dict(batch)
        batch[key] = torch.where(masked, torch.full_like(seq, self.mask_token), seq)
        batch[self.fiid] = torch.where(masked, seq, torch.zeros_like(seq))
        return batch

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return super().training_step(self._reconstruct_train_data(batch))
