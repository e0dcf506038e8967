"""NCF: neural collaborative filtering.

Counterpart of ``recstudio_tpu/models/mf/ncf.py``: user and item
embedding towers scored by an MLP (``score_mode: mlp``), a generalized
matrix factorization (``mf``) or their fusion (``fusion``), the scorer a
module of the net; binary cross-entropy on uniform negatives. The JAX
net applies the score function with no training flag, so its MLP's
dropout never acts; the port builds the MLP with none.
"""
from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BinaryCrossEntropyLoss
from ..module import Embedding, MLPModule
from ..scorer import FusionMFMLPScorer, GMFScorer, MLPScorer


class NCF(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_item_encoder(self, train_data):
        return Embedding(train_data.num_items, self.embed_dim)

    def _get_query_encoder(self, train_data):
        return Embedding(train_data.num_users, self.embed_dim)

    def _get_score_func(self):
        mc = self.config["model"]
        mode = mc["score_mode"]
        if mode not in ("mlp", "mf", "fusion"):
            raise ValueError("NCF score_mode must be one of ['mlp', 'mf', 'fusion']")
        if mode == "mlp":
            return MLPScorer(MLPModule([self.embed_dim * 2] + mc["mlp_hidden_size"] + [1],
                                       activation_func=mc["activation"], last_activation=False))
        if mode == "mf":
            return GMFScorer(self.embed_dim, activation=mc["activation"])
        mlp = MLPModule([self.embed_dim * 2] + mc["mlp_hidden_size"],
                        activation_func=mc["activation"])
        return FusionMFMLPScorer(emb_dim=self.embed_dim, hidden_size=mc["mlp_hidden_size"][-1],
                                 mlp=mlp, activation=mc["activation"])

    def _get_loss_func(self):
        return BinaryCrossEntropyLoss()
