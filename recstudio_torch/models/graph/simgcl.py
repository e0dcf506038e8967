"""SimGCL: graph contrastive learning over noise-perturbed views.

Counterpart of ``recstudio_tpu/models/graph/simgcl.py``: LightGCN's loss
plus ``cl_weight`` times InfoNCE between two perturbed propagations of the
batch's users and of its items. A perturbed propagation adds
``sign(x) * normalize(u) * eps`` to each layer's output, ``u`` uniform on
[0, 1) from the model's device generator, and reads out the mean of the L
layer outputs without layer 0. With ``cl_neg_type: all`` every user (item)
of the second view is a negative; ``batch_both`` and ``batch_single`` take
the batch's rows. The raw batch ids are used, duplicates included, as in
the JAX package. The views propagate layer by layer, so the dense
adjacency stays held and the collapsed operator is not built.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..loss_func import l2_reg_loss_fn
from ..module.data_augmentation import _normalize, info_nce
from .lightgcn import LightGCN


class SimGCL(LightGCN):

    _needs_layer_graph = True

    def _propagate_perturbed(self, noise: Optional[Sequence[torch.Tensor]] = None):
        """One perturbed view; ``noise`` gives each layer's uniform draws
        (from the device generator when None)."""
        mc = self.config["model"]
        emb = self.net.node_embeddings()
        layers = []
        x = emb
        for i in range(mc["n_layers"]):
            x = self._gcn_layer(x)
            u = noise[i] if noise is not None else torch.rand(
                x.shape, generator=self.device_generator, device=x.device)
            x = x + torch.sign(x) * _normalize(u) * mc["eps"]
            layers.append(x)
        out = torch.stack(layers).mean(0)
        return out[: self.num_users], out[self.num_users:]

    def training_step(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[Sequence[Sequence[torch.Tensor]]] = None) -> torch.Tensor:
        """``simgcl.py:46-66``; ``noise`` gives the two views' draws."""
        output = self.forward(batch)
        loss = self.loss_fn(batch[self.frating], **output["score"])
        reg = l2_reg_loss_fn(*self._reg_rows(batch, output["neg_id"]))
        mc = self.config["model"]
        u1, i1 = self._propagate_perturbed(None if noise is None else noise[0])
        u2, i2 = self._propagate_perturbed(None if noise is None else noise[1])
        uid, iid = batch[self.fuid], batch[self.fiid]
        neg_type = mc.get("cl_neg_type", "all")
        temp = mc["temperature"]
        if neg_type == "all":
            cl = info_nce(F.embedding(uid, u1), F.embedding(uid, u2), temp, "cosine", "all",
                          all_reps=u2[1:]) \
                + info_nce(F.embedding(iid, i1), F.embedding(iid, i2), temp, "cosine", "all",
                           all_reps=i2[1:])
        else:
            cl = info_nce(F.embedding(uid, u1), F.embedding(uid, u2), temp, "cosine", neg_type) \
                + info_nce(F.embedding(iid, i1), F.embedding(iid, i2), temp, "cosine", neg_type)
        return loss + mc["l2_reg_weight"] * reg + mc["cl_weight"] * cl
