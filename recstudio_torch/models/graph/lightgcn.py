"""LightGCN: linear propagation over the whole graph, layer-mean readout.

Counterpart of ``recstudio_tpu/models/graph/lightgcn.py``: L normalized
propagation layers, the mean of the L + 1 layer outputs as the readout,
the BPR loss on uniform negatives plus ``l2_reg_weight`` times the L2
penalty on the batch's raw (layer-0) user, positive and negative rows.

The readout is linear in the embeddings, so while the dense adjacency fits
its budget it is folded into one operator ``M = (I + A + ... + A^L) /
(L + 1)`` (``_mean_walk_operator``, a plain product on the device, as the
JAX package computes it outside any kernel), and a step's propagation is
one ``M @ emb``; ``_adj`` is then freed, so one ``[n, n]`` matrix is held.
``model.prop_dtype: bf16`` stores M in bfloat16 and upcasts it to
float32 in the product, as JAX's type promotion does: only M's entries are
rounded. A subclass that overrides ``propagate`` or sets
``_needs_layer_graph`` keeps ``_adj`` and the per-layer loop instead.
Past the budget the loop runs on the ELL layout.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..loss_func import l2_reg_loss_fn
from .base import BaseGraphRetriever


def _mean_walk_operator(adj: torch.Tensor, n_layers: int, out_dtype: torch.dtype) -> torch.Tensor:
    """``M = (I + A + ... + A^L) / (L + 1)`` on ``adj``'s device
    (``lightgcn.py:17-24``); the first power is ``A`` itself, which is
    ``A @ I`` exactly."""
    acc = torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    power = None
    for _ in range(n_layers):
        power = adj.clone() if power is None else adj @ power
        acc += power
    acc /= n_layers + 1
    return acc.to(out_dtype)


class LightGCN(BaseGraphRetriever):

    # a subclass whose other paths read the per-layer graph sets this, and
    # keeps ``_adj`` instead of the collapsed operator
    _needs_layer_graph = False

    def _init_model(self, train_data):
        super()._init_model(train_data)
        self._prop_m = None
        collapse = (type(self).propagate is LightGCN.propagate
                    and not self._needs_layer_graph)
        if self._adj is not None and collapse:
            bf16 = str(self.config["model"].get("prop_dtype", "fp32")).lower() \
                in ("bf16", "bfloat16")
            self._prop_m = _mean_walk_operator(self._adj, self.config["model"]["n_layers"],
                                               torch.bfloat16 if bf16 else torch.float32)
            self._adj = None            # M subsumes the dense adjacency

    def propagate(self):
        emb = self.net.node_embeddings()
        if self._prop_m is not None:
            out = self._prop_m.to(emb.dtype) @ emb
        else:
            layers = [emb]
            x = emb
            for _ in range(self.config["model"]["n_layers"]):
                x = self._gcn_layer(x)
                layers.append(x)
            out = torch.stack(layers).mean(0)
        return out[: self.num_users], out[self.num_users:]

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        output = self.forward(batch)
        loss = self.loss_fn(batch[self.frating], **output["score"])
        reg = l2_reg_loss_fn(*self._reg_rows(batch, output["neg_id"]))
        return loss + self.config["model"]["l2_reg_weight"] * reg
