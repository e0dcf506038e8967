"""NCL: LightGCN with structure and prototype contrastive terms.

Counterpart of ``recstudio_tpu/models/graph/ncl.py``: propagation goes
layer by layer (``_gcn_layer``, so the dense adjacency stays held, not
the collapsed operator). Beside the BPR loss and the L2 penalty, the
structure term (``ssl_reg``) aligns each batch row's layer-``2
hyper_layers`` vector with its layer-0 vector against every layer-0 user
(item), and the prototype term (``proto_reg``, on from ``warm_up_epoch``)
aligns its layer-0 vector with its k-means centroid against every
centroid, items weighted by ``alpha``. The centroids (``num_clusters``
of the raw tables' rows 1.., ``ops/kmeans.py`` drawn from the device
generator) are refreshed in ``_epoch_refresh``: when there are none, at
every epoch from the warm-up on, and at each evaluation, as in the JAX
package. The config's ``num_m_epoch`` is read by no code.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ...ops.kmeans import kmeans
from ..loss_func import l2_reg_loss_fn
from ..module.data_augmentation import info_nce
from .lightgcn import LightGCN


class NCL(LightGCN):

    def _propagate_layers(self) -> List[torch.Tensor]:
        x = self.net.node_embeddings()
        layers = [x]
        for _ in range(self.config["model"]["n_layers"]):
            x = self._gcn_layer(x)
            layers.append(x)
        return layers

    def propagate(self):
        out = torch.stack(self._propagate_layers()).mean(0)
        return out[: self.num_users], out[self.num_users:]

    @torch.no_grad()
    def _epoch_refresh(self, nepoch: int):
        """``ncl.py:43-59``: ``proto_on``, and the centroids recomputed when
        there are none, from the warm-up on, and for inference."""
        super()._epoch_refresh(nepoch)
        warm = self.config["train"].get("warm_up_epoch", 0)
        self.states["proto_on"] = torch.tensor(1.0 if nepoch >= warm else 0.0,
                                               device=self.device)
        if nepoch < 0 or nepoch >= warm or "user_centroids" not in self.states:
            self.refresh_centroids()

    @torch.no_grad()
    def refresh_centroids(self) -> None:
        """k-means of the raw user and item rows (pad rows left out)."""
        k = self.config["model"]["num_clusters"]
        u_c, u_a = kmeans(self.net.user_embedding.weight[1:], k, generator=self.device_generator)
        i_c, i_a = kmeans(self.net.item_embedding.weight[1:], k, generator=self.device_generator)
        pad = torch.zeros(1, dtype=u_a.dtype, device=u_a.device)
        self.states.update({"user_centroids": u_c, "item_centroids": i_c,
                            "user_2cluster": torch.cat([pad, u_a]),
                            "item_2cluster": torch.cat([pad, i_a])})

    def training_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``ncl.py:61-95``."""
        mc = self.config["model"]
        st = self.states
        uid, iid = batch[self.fuid], batch[self.fiid]
        layers = self._propagate_layers()
        out = torch.stack(layers).mean(0)
        user_all, item_all = out[: self.num_users], out[self.num_users:]
        query = F.embedding(uid, user_all)
        pos_score = self.score_func(query, F.embedding(iid, item_all))
        log_pos_prob, neg_ids, log_neg_prob = self.sampling(batch, self.neg_count,
                                                            query.detach())
        neg_score = self.score_func(query, F.embedding(neg_ids, item_all))
        loss = self.loss_fn(batch[self.frating], pos_score, log_pos_prob, neg_score,
                            log_neg_prob)
        reg = l2_reg_loss_fn(*self._reg_rows(batch, neg_ids))
        temp, alpha = mc["temperature"], mc["alpha"]
        center = layers[0]
        context = layers[min(mc["hyper_layers"] * 2, len(layers) - 1)]
        u_cen, i_cen = center[: self.num_users], center[self.num_users:]
        u_ctx, i_ctx = context[: self.num_users], context[self.num_users:]
        structure = info_nce(F.embedding(uid, u_ctx), F.embedding(uid, u_cen), temp, "cosine",
                             "all", all_reps=u_cen[1:]) \
            + alpha * info_nce(F.embedding(iid, i_ctx), F.embedding(iid, i_cen), temp,
                               "cosine", "all", all_reps=i_cen[1:])
        u_c, i_c = st["user_centroids"], st["item_centroids"]
        proto = info_nce(F.embedding(uid, u_cen), u_c[st["user_2cluster"][uid.long()]], temp,
                         "cosine", "all", all_reps=u_c) \
            + alpha * info_nce(F.embedding(iid, i_cen), i_c[st["item_2cluster"][iid.long()]],
                               temp, "cosine", "all", all_reps=i_c)
        return loss + mc["l2_reg_weight"] * reg + mc["ssl_reg"] * structure \
            + st["proto_on"] * mc["proto_reg"] * proto
