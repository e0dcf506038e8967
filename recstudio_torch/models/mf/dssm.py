"""DSSM: a two-tower model over the user's and the item's features.

Counterpart of ``recstudio_tpu/models/mf/dssm.py``: each tower
(``FeatureTower``) embeds its fields (``Embeddings`` over
``make_field_specs``, sorted by name), flattens them and runs the
``MLPModule`` of ``model.mlp_layer`` (``activation``, ``dropout``,
``batch_norm``); scores are inner products, the loss binary
cross-entropy on uniform negatives. Every field of the data is in use
(``_set_data_field``): the query tower reads the user's fields and the
item tower the item's; on ml-100k, whose config loads no item file, that
is the five user fields and the item id. A multi-field item tower needs
the catalog's feature table on the device, which is not ported, and
raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseretriever import BaseRetriever
from ..loss_func import BinaryCrossEntropyLoss
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import MLPModule
from ..scorer import InnerProductScorer


class FeatureTower(nn.Module):
    """``dssm.py:19-38``: ``Embeddings`` (``embedding``), flattened, then
    ``MLPModule`` (``mlp``). Training-mode dropout draws its seeds from
    ``rng``, or from ``generator`` (the model's) where the caller gives
    none, as the item tower's callers do."""

    generator: Optional[torch.Generator] = None

    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str,
                 dropout: float, batch_norm: bool):
        super().__init__()
        self.field_specs = tuple(field_specs)
        self.embedding = Embeddings(self.field_specs, embed_dim)
        self.mlp = MLPModule([len(self.field_specs) * embed_dim, *mlp_layer],
                             activation_func=activation, dropout=dropout, batch_norm=batch_norm)

    def forward(self, feat: Union[torch.Tensor, Dict[str, torch.Tensor]],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if not isinstance(feat, dict):                # a single id field
            feat = {self.field_specs[0][0]: feat}
        emb = self.embedding(feat)
        return self.mlp(emb.reshape(*emb.shape[:-2], -1), self.generator if rng is None else rng)


class DSSM(BaseRetriever):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _set_data_field(self, data) -> None:
        data.use_field = set(data.field2type.keys())

    def _tower(self, fields, train_data) -> FeatureTower:
        mc = self.config["model"]
        return FeatureTower(make_field_specs(fields, train_data), self.embed_dim,
                            tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                            mc.get("batch_norm", False))

    def _get_query_encoder(self, train_data):
        fields = set(train_data.user_feat.fields) & set(train_data.use_field) \
            if train_data.user_feat is not None else {self.fuid}
        return self._tower(fields, train_data)

    def _get_item_encoder(self, train_data):
        fields = set(train_data.item_feat.fields) & set(train_data.use_field) \
            if train_data.item_feat is not None else {self.fiid}
        if fields - {self.fiid}:
            raise NotImplementedError(
                f"a multi-field DSSM item tower ({sorted(fields)}) needs the catalog's feature "
                "table on the device, which is not ported")
        return self._tower(fields, train_data)

    def _get_score_func(self):
        return InnerProductScorer()

    def _get_loss_func(self):
        return BinaryCrossEntropyLoss()

    def _init_model(self, train_data):
        self._set_data_field(train_data)
        super()._init_model(train_data)
        for tower in (self.item_encoder, self.query_encoder):
            if isinstance(tower, FeatureTower):
                tower.generator = self.generator

    def _eval_epoch(self, data, metric_names, cutoffs):
        data.use_field = self.fields          # the query tower reads the user's fields
        return super()._eval_epoch(data, metric_names, cutoffs)
