"""BaseRetriever: the two-tower retrieval abstraction, serving subset.

Counterpart of ``recstudio_tpu/models/basemodel/baseretriever.py``: the
shared-item-tower net of sequence models, the catalog encoding cached in
``states["item_vector"]`` (``_epoch_refresh(-1)``), and full-catalog top-k
with the user's history masked inside the score matrix
(``baseretriever.py:493-543``), which is exactly the reference's
``topk(k + len(hist))``-then-filter. Sampling, losses, training steps,
approximate and sharded retrieval are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.topk import topk as topk_op
from ..module import Embedding
from ..scorer import InnerProductScorer
from .recommender import Recommender, batch_to_device


class SharedItemTowerNet(nn.Module):
    """Two-tower net where the query encoder OWNS the item embedding table
    (sequence models: the same table embeds history items and scores
    targets). ``encode_item`` routes through the query encoder's
    ``item_encoder`` so the parameters are shared."""

    def __init__(self, query_encoder: nn.Module, score_func):
        super().__init__()
        self.query_encoder = query_encoder
        self.score_func = score_func

    def encode_query(self, query_feat):
        return self.query_encoder(query_feat)

    def encode_item(self, item_feat):
        return self.query_encoder.item_encoder(item_feat)


class BaseRetriever(Recommender):
    def __init__(self, config: Dict = None, device="cuda"):
        super().__init__(config, device)
        self.query_fields = None
        for key in ("ann", "mesh"):
            if self.config["train"].get(key):
                raise NotImplementedError(f"train.{key} is not ported yet")

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        raise NotImplementedError

    def _get_score_func(self):
        return InnerProductScorer()

    def _init_model(self, train_data):
        super()._init_model(train_data)
        self.num_items = train_data.num_items
        self.num_users = train_data.num_users
        self.item_encoder = self._get_item_encoder(train_data)
        self.query_encoder = self._get_query_encoder(train_data)  # shares item_encoder
        self.score_func = self._get_score_func()
        self.net = SharedItemTowerNet(self.query_encoder, self.score_func)
        # query-side fields: user feats + in_-prefixed item fields (+ seqlen)
        from ...data.dataset import SeqDataset
        self.query_fields = set(train_data.user_feat.fields).intersection(self.fields)
        if isinstance(train_data, SeqDataset):
            self.query_fields |= {"in_" + f for f in self.item_fields}
            self.query_fields.add("seqlen")

    def _get_query_feat(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {f: v for f, v in batch.items() if f in self.query_fields}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _compute_item_vector(self) -> torch.Tensor:
        """Encode the full catalog, items 1..N-1 (the [PAD] row excluded)."""
        ids = torch.arange(1, self.num_items, device=self.device)
        return self.net.encode_item(ids)

    def _epoch_refresh(self, nepoch: int):
        """``nepoch = -1`` (inference): snapshot the catalog encoding from the
        current parameters into ``states["item_vector"]``."""
        if nepoch >= 0:
            raise NotImplementedError("training-time refresh is not ported yet")
        self.states["item_vector"] = self._compute_item_vector()

    # ------------------------------------------------------------------
    def _mask_hist_scores(self, scores: torch.Tensor,
                          user_hist: Optional[torch.Tensor]) -> torch.Tensor:
        """Set scores of history items to -inf. Column j of ``scores`` is item
        j + 1; pad entries (0) of ``user_hist`` are dropped."""
        if user_hist is None:
            return scores
        n_cols = scores.shape[-1]
        col = torch.where(user_hist > 0, user_hist.to(torch.long) - 1, n_cols)
        # one spare column takes the dropped pad entries
        ext = torch.cat([scores, scores.new_zeros(scores.shape[0], 1)], dim=-1)
        ext.scatter_(1, col, float("-inf"))
        return ext[:, :n_cols]

    def _topk_from_scores(self, scores: torch.Tensor, k: int,
                          user_hist: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        score_k, idx = topk_op(self._mask_hist_scores(scores, user_hist), k)
        return score_k, idx + 1

    @torch.no_grad()
    def topk(self, batch: Dict[str, torch.Tensor], k: int,
             user_hist: Optional[torch.Tensor] = None,
             return_query: bool = False):
        """Top-k catalog items per query: ``(scores [B, k], item ids [B, k])``,
        ids 1-based; ``user_hist`` [B, H] (0 = pad) items are excluded."""
        item_vector = self.states.get("item_vector")
        if item_vector is None:
            item_vector = self._compute_item_vector()
        query = self.net.encode_query(self._get_query_feat(batch))
        scores = self.score_func.catalog(query, item_vector)
        score_k, topk_items = self._topk_from_scores(scores, k, user_hist)
        if return_query:
            return score_k, topk_items, query
        return score_k, topk_items

    def predict(self, batch: Dict[str, np.ndarray], k: int) -> Tuple[np.ndarray, np.ndarray]:
        """numpy batch in, numpy ``(scores, item ids)`` out; ``batch`` may
        carry ``user_hist``."""
        dev = batch_to_device(batch, self.device)
        if "item_vector" not in self.states:
            self._epoch_refresh(-1)
        score, items = self.topk(dev, k, dev.get("user_hist"))
        return score.cpu().numpy(), items.cpu().numpy()
