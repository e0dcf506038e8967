"""SGL: LightGCN with a contrastive term between two edge-dropout views.

Counterpart of ``recstudio_tpu/models/graph/sgl.py``: LightGCN's loss
(its ``forward`` on its own route, the collapsed operator while the dense
adjacency fits) plus ``ssl_reg`` times InfoNCE (cosine, every user or item
of the second view a negative) between two views of the batch's users
and of its items. A view propagates over the edge list with each edge
kept with probability ``1 - ssl_ratio`` and the kept messages scaled by
``1 / (1 - ssl_ratio)``: ``aug_type: ED`` draws one keep mask for all
layers, ``RW`` one a layer, from the model's device generator. The
messages are summed by ``segment_sum_sorted`` over the dst-sorted edges,
so a step repeats bit for bit. Another ``aug_type`` raises (the JAX
package runs ``ED`` for any but ``RW``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..loss_func import l2_reg_loss_fn
from ..module.data_augmentation import info_nce
from .base import segment_sum_sorted
from .lightgcn import LightGCN

AUG_TYPES = ("ED", "RW")


class SGL(LightGCN):

    def _init_model(self, train_data):
        aug = self.config["model"].get("aug_type", "ED")
        if aug not in AUG_TYPES:
            raise NotImplementedError(f"SGL aug_type {aug!r} is not ported: {AUG_TYPES}")
        super()._init_model(train_data)
        self._src_norm = self._edge_norm[self._edges[0].long()]

    def keep_masks(self) -> Sequence[torch.Tensor]:
        """One view's keep masks over the edges, one a layer (``ED``: the same
        mask each layer), from the device generator (``sgl.py:41-44``)."""
        mc = self.config["model"]
        n_masks = mc["n_layers"] if mc.get("aug_type", "ED") == "RW" else 1
        masks = [torch.rand(self._edges[0].shape[0], generator=self.device_generator,
                            device=self.device) < 1.0 - mc["ssl_ratio"] for _ in range(n_masks)]
        return masks if n_masks > 1 else masks * mc["n_layers"]

    def _dropped_layer(self, emb: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """One propagation layer with the dropped edges' messages zeroed
        (``sgl.py:26-32``)."""
        src, _ = self._edges
        ratio = self.config["model"]["ssl_ratio"]
        msg = F.embedding(src, emb) * self._src_norm[:, None]
        msg = torch.where(keep[:, None], msg / (1.0 - ratio), torch.zeros_like(msg))
        return segment_sum_sorted(msg, self._deg_in) * self._edge_norm[:, None]

    def propagate_view(self, keep: Optional[Sequence[torch.Tensor]] = None):
        """One view's ``(users, items)``: the mean of layer 0 and the dropped
        layers (``sgl.py:34-48``)."""
        keep = self.keep_masks() if keep is None else keep
        x = self.net.node_embeddings()
        layers = [x]
        for mask in keep:
            x = self._dropped_layer(x, mask)
            layers.append(x)
        out = torch.stack(layers).mean(0)
        return out[: self.num_users], out[self.num_users:]

    def training_step(self, batch: Dict[str, torch.Tensor],
                      keep: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
        """``sgl.py:50-63``; ``keep`` gives the two views' masks."""
        output = self.forward(batch)
        loss = self.loss_fn(batch[self.frating], **output["score"])
        reg = l2_reg_loss_fn(*self._reg_rows(batch, output["neg_id"]))
        mc = self.config["model"]
        u1, i1 = self.propagate_view(None if keep is None else keep[0])
        u2, i2 = self.propagate_view(None if keep is None else keep[1])
        uid, iid = batch[self.fuid], batch[self.fiid]
        temp = mc["temperature"]
        cl = info_nce(F.embedding(uid, u1), F.embedding(uid, u2), temp, "cosine", "all",
                      all_reps=u2[1:]) \
            + info_nce(F.embedding(iid, i1), F.embedding(iid, i2), temp, "cosine", "all",
                       all_reps=i2[1:])
        return loss + mc["l2_reg_weight"] * reg + mc["ssl_reg"] * cl
