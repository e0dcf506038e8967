"""FLEN: the field-leveraged embedding network.

Counterpart of ``recstudio_tpu/models/fm/flen.py``: the fields fall into
groups (``model.fields``, a list of field lists; by default the
interaction table's, the user table's and the item table's fields, each
group that has any). Across the groups' sums an MF term
(``InnerProductLayer(M, reduction=False)``, the pairs weighed by
``r_mf``), within each group an FM term (weighed by ``r_fm``); with the
first-order ``linear`` score they go through ``fwbi_fc`` (no bias, batch
norm); a deep MLP with batch norm beside; ``fc`` (no bias) scores the
two. With fewer than two groups there is no pair for ``r_mf``: the net
cannot be built, as in the JAX package (whose ``r_mf`` initializer
divides by its zero fan-in).
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import (Embeddings, FMLayer, InnerProductLayer, LinearLayer,
                          make_field_specs)


class FLENNet(nn.Module):
    def __init__(self, field_specs, group_specs, embed_dim: int, mlp_layer, activation: str,
                 dropout: float):
        super().__init__()
        M = len(group_specs)
        if M < 2:
            raise ValueError(f"FLEN needs at least two field groups for its MF term, got {M}")
        names = [n for n, _, _ in field_specs]
        self.groups = [[names.index(n) for n, _, _ in g] for g in group_specs]
        F = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.linear = LinearLayer(field_specs)
        self.mf = InnerProductLayer(M, reduction=False)
        self.r_mf = nn.Linear(M * (M - 1) // 2, 1, bias=False)
        self.fm = FMLayer()
        self.r_fm = nn.Linear(M, 1, bias=False)
        self.fwbi_fc = MLPModule([embed_dim + 1, embed_dim + 1], activation_func=activation,
                                 dropout=dropout, bias=False, batch_norm=True)
        self.mlp = MLPModule([F * embed_dim, *mlp_layer], activation_func=activation,
                             dropout=dropout, batch_norm=True)
        self.fc = nn.Linear(mlp_layer[-1] + embed_dim + 1, 1, bias=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        lr_out = self.linear(batch)
        group_embs = [emb[:, idx, :] for idx in self.groups]
        mf_in = torch.stack([g.sum(1) for g in group_embs], dim=1)          # [B, M, D]
        mf_out = self.r_mf(self.mf(mf_in).transpose(1, 2)).squeeze(-1)      # [B, D]
        fm = torch.stack([self.fm(g) for g in group_embs], dim=1)           # [B, M, D]
        fm_out = self.r_fm(fm.transpose(1, 2)).squeeze(-1)                  # [B, D]
        fwbi = self.fwbi_fc(torch.cat([lr_out[:, None], fm_out + mf_out], dim=-1), rng)
        deep = self.mlp(emb.reshape(emb.shape[0], -1), rng)
        return self.fc(torch.cat([deep, fwbi], dim=-1)).squeeze(-1)


class FLEN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        specs = make_field_specs(self.fields, train_data)
        groups_cfg = mc.get("fields")
        if groups_cfg is None:
            groups = []
            for feat in (train_data.inter_feat, train_data.user_feat, train_data.item_feat):
                if feat is not None:
                    g = make_field_specs(set(feat.fields) & set(self.fields), train_data)
                    if g:
                        groups.append(g)
        else:
            groups = [make_field_specs(set(g) & set(self.fields), train_data)
                      for g in groups_cfg]
        return FLENNet(specs, tuple(groups), self.embed_dim, tuple(mc["mlp_layer"]),
                       mc["activation"], mc["dropout"])
