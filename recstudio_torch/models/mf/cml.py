"""CML: collaborative metric learning.

Counterpart of ``recstudio_tpu/models/mf/cml.py``: user and item
embedding towers scored by the negated squared distance
(``EuclideanScorer``), a hinge of the nearest negative against each of
the user's items (``CMLoss``), trained on one row a user holding all of
that user's training items (``ALSDataset``) with uniform negatives.
"""
import torch

from ...data.advance_dataset import ALSDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import PairwiseLoss
from ..module import Embedding
from ..scorer import EuclideanScorer


class CMLoss(PairwiseLoss):
    """``cml.py:13-31``: ``relu(max neg - pos + margin)`` for every
    positive ``[B, W]`` against its row's negatives ``[B, n]``, padded
    positives (``-inf``) flipped to ``+inf`` so their hinge is 0; the mean
    over all ``B W`` places. With ``use_rank_weight`` not ``None`` (the
    JAX test, so ``False`` weights too), each place is weighted by
    ``log(1 + rank)``, the rank estimated from the share of negatives
    inside the margin times the catalog size."""

    def __init__(self, margin: float = 2.0, use_rank_weight=False, n_items: int = None):
        self.margin = margin
        self.use_rank_weight = use_rank_weight
        self.n_items = (n_items - 1) if n_items else None

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        pos = torch.where(torch.isinf(pos_score), float("inf"), pos_score)
        loss = neg_score.amax(-1)[..., None] - pos + self.margin
        loss = torch.maximum(loss, torch.zeros_like(loss))
        if self.use_rank_weight is not None:
            impostors = (neg_score[..., None, :] - pos_score[..., None] + self.margin) > 0
            rank = impostors.to(torch.float32).mean(-1) * self.n_items
            return (loss * torch.log(rank + 1.0)).mean()
        return loss.mean()


class CML(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return ALSDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return Embedding(train_data.num_users, self.embed_dim)

    def _get_score_func(self):
        return EuclideanScorer()

    def _get_loss_func(self, train_data):
        return CMLoss(self.config["model"]["margin"], self.config["model"]["use_rank_weight"],
                      train_data.num_items)
