"""AutoInt: feature interactions learned by self-attention.

Counterpart of ``recstudio_tpu/models/fm/autoint.py``: the field
embeddings are projected to ``attention_dim`` (``att_proj``), go through
``num_attention_layers`` ``SelfAttentionInteractingLayer``s (``attn_{i}``)
and are scored by ``attn_fc``; with ``wide`` the first-order
``LinearLayer`` and with ``deep`` an MLP over the flattened embeddings are
added. The attention's heads go through ``fused_mha`` (K3 on the card) in
evaluation and serving, and through the plain softmax in training when its
dropout acts, as the JAX gate routes them.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import (Embeddings, LinearLayer, SelfAttentionInteractingLayer,
                          make_field_specs)


class AutoIntNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, attention_dim: int,
                 num_attention_layers: int, n_head: int, mlp_layer, activation: str,
                 dropout: float, wide: bool = True, deep: bool = True, residual: bool = True,
                 residual_project: bool = True, layer_norm: bool = False):
        super().__init__()
        F = len(field_specs)
        self.num_attention_layers = num_attention_layers
        self.embedding = Embeddings(field_specs, embed_dim)
        self.att_proj = nn.Linear(embed_dim, attention_dim)
        for i in range(num_attention_layers):
            self.add_module(f"attn_{i}", SelfAttentionInteractingLayer(
                attention_dim, n_head, dropout, residual, residual_project, layer_norm))
        self.attn_fc = nn.Linear(F * attention_dim, 1)
        self.linear = LinearLayer(field_specs) if wide else None
        self.mlp = MLPModule([F * embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, last_activation=False, last_bn=False) \
            if deep else None

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = self.att_proj(emb)
        for i in range(self.num_attention_layers):
            x = getattr(self, f"attn_{i}")(x, rng)
        score = self.attn_fc(x.reshape(x.shape[0], -1)).squeeze(-1)
        if self.linear is not None:
            score = score + self.linear(batch)
        if self.mlp is not None:
            score = score + self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1)
        return score


class AutoInt(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return AutoIntNet(make_field_specs(self.fields, train_data), self.embed_dim,
                          mc["attention_dim"], mc["num_attention_layers"], mc["n_head"],
                          tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                          mc.get("wide", True), mc.get("deep", True), mc.get("residual", True),
                          mc.get("residual_project", True), mc.get("layer_norm", False))
