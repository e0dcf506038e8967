"""LogisticMF: logistic matrix factorization.

Counterpart of ``recstudio_tpu/models/mf/logisticmf.py``: user and item
embedding towers, inner-product scores, the logistic likelihood with
confidence ``alpha`` (``LogitLoss``) on uniform negatives, trained with
``adagrad`` (optax's, ``models/optim.OptaxAdagrad``).
"""
from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import PairwiseLoss, softplus
from ..module import Embedding
from ..scorer import InnerProductScorer


class LogitLoss(PairwiseLoss):
    """``logisticmf.py:14-21``: ``-mean(alpha pos - (1 + alpha)
    softplus(pos) - mean_neg softplus(neg))``."""

    def __init__(self, alpha: float):
        self.alpha = alpha

    def __call__(self, label, pos_score, log_pos_prob, neg_score, log_neg_prob):
        l1 = self.alpha * pos_score - (1 + self.alpha) * softplus(pos_score)
        l2 = softplus(neg_score).mean(-1)
        return -(l1 - l2).mean()


class LogisticMF(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return Embedding(train_data.num_users, self.embed_dim)

    def _get_score_func(self):
        return InnerProductScorer()

    def _get_loss_func(self):
        return LogitLoss(self.config["train"]["alpha"])
