"""BPR: Bayesian personalized ranking by matrix factorization.

Counterpart of ``recstudio_tpu/models/mf/bpr.py``: a user embedding tower
and an item embedding tower (``TwoTowerNet``), inner-product scores, the
BPR loss on uniform negatives, trained on the flat interactions of a
``TripletDataset``.
"""
from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BPRLoss
from ..module import Embedding
from ..scorer import InnerProductScorer


class BPR(BaseRetriever):

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
        return BPRLoss()
