"""WRMF: weighted matrix factorization by alternating least squares.

Counterpart of ``recstudio_tpu/models/mf/wrmf.py``: BPR's two tables and
inner-product scores, trained with no optimizer. Each epoch is one whole
half-sweep, the users on even epochs and the items on odd ones: every row
of the ``ALSDataset`` view (a user's items, or an item's users, padded
with 0) solves ``(α EᵀE + GᵀG + λI) x = (α + 1) Eᵀr`` for its vector,
``E`` the other table's rows of its list, ``r = rating > 0`` (pads count
0) and ``GᵀG`` taken over the whole other table, its pad row included,
as one batched ``torch.linalg.solve``. Each half-sweep packs its whole
view, staged on the device once a fit; the config's ``batch_size`` is
read by no code, as in the JAX package. The ``[rows, L, D]`` gather at
the longest list sets the sweep's peak memory.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...data.advance_dataset import ALSDataset
from ..basemodel.baseretriever import BaseRetriever
from ..module import Embedding
from ..scorer import InnerProductScorer


class WRMF(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return ALSDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return Embedding(train_data.num_users, self.embed_dim)

    def _get_score_func(self):
        return InnerProductScorer()

    def _get_loss_func(self):
        return None

    def _get_sampler(self, train_data):
        return None

    def _get_optimizers(self):
        return None

    def _get_train_loaders(self, train_data):
        """The user view and the item view of the split, each whole, as
        tensors on the device (``wrmf.py:46-55``)."""
        def pack(view, key_field, val_field):
            batch = view._get_pos_batch(np.arange(len(view.data_index)))
            return {name: torch.from_numpy(np.ascontiguousarray(batch[f])).to(self.device)
                    for name, f in (("keys", key_field), ("vals", val_field),
                                    ("ratings", self.frating))}
        fuid, fiid = train_data.fuid, train_data.fiid
        return [pack(train_data, fuid, fiid), pack(train_data.transpose(), fiid, fuid)]

    @torch.no_grad()
    def als_sweep(self, data: Dict[str, torch.Tensor], update_query: bool) -> None:
        """One half-sweep over ``data`` (``wrmf.py:57-76``): the user table
        when ``update_query``, else the item table, its rows ``keys`` set."""
        alpha = float(self.config["train"]["alpha"])
        lam = float(self.config["train"]["lambda"])
        own = self.net.query_encoder if update_query else self.net.item_encoder
        other = (self.net.item_encoder if update_query else self.net.query_encoder).weight
        d = other.shape[-1]
        gram = other.t() @ other + lam * torch.eye(d, dtype=other.dtype, device=other.device)
        emb = other[data["vals"].long()]                                 # [B, L, D]
        r = (data["ratings"] > 0).to(other.dtype)                        # [B, L]
        A = alpha * torch.einsum("bld,ble->bde", emb, emb) + gram
        b = torch.einsum("bld,bl->bd", emb, r) * (alpha + 1.0)
        x = torch.linalg.solve(A, b[..., None]).squeeze(-1)              # [B, D]
        own.weight[data["keys"].long()] = x

    def training_epoch(self, nepoch: int) -> float:
        self.als_sweep(self.trainloaders[nepoch % 2], nepoch % 2 == 0)
        return 0.0
