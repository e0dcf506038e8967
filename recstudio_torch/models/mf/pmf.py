"""PMF: probabilistic matrix factorization.

Counterpart of ``recstudio_tpu/models/mf/pmf.py``: user and item
embedding towers, inner-product scores, the squared error to the rating
(``SquareLoss``) with no sampler, on the flat interactions of a
``TripletDataset``.
"""
from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import SquareLoss
from ..module import Embedding
from ..scorer import InnerProductScorer


class PMF(BaseRetriever):

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
        return SquareLoss()

    def _get_sampler(self, train_data):
        return None
