"""PNN: product-based neural network, inner or outer products.

Counterpart of ``recstudio_tpu/models/fm/pnn.py``: the flattened field
embeddings beside the pairs' products (``InnerProductLayer``, or
``OuterProductLayer`` named ``outer``) go through an MLP.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, InnerProductLayer, OuterProductLayer, make_field_specs


class PNNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 batch_norm: bool, product_type: str = "inner"):
        super().__init__()
        F = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        if product_type == "inner":
            self.inner = InnerProductLayer(F)
        elif product_type == "outer":
            self.outer = OuterProductLayer(F, embed_dim)
        else:
            raise ValueError("product_type must be inner or outer")
        self.product_type = product_type
        self.mlp = MLPModule([F * embed_dim + F * (F - 1) // 2, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout, batch_norm=batch_norm,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        prod = getattr(self, self.product_type)(emb)
        x = torch.cat([emb.reshape(emb.shape[0], -1), prod], dim=-1)
        return self.mlp(x, rng).squeeze(-1)


class PNN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return PNNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                      tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                      mc.get("batch_norm", False), mc.get("product_type", "inner"))
