"""DIFM: dual input-aware factorization machine.

Counterpart of ``recstudio_tpu/models/fm/difm.py``: a vector-wise
factor-estimating network (``vector_fen``, a ``SelfAttentionInteractingLayer``
over the fields, then ``p_vec``) and a bit-wise one (``bit_fen``, an MLP
over the flattened embeddings, then ``p_bit``) give one weight a field;
the weights scale the first-order embeddings (``linear_emb``, plus
``bias``) and the FM's field embeddings. The attention's heads go through
``fused_mha`` (K3 on the card) in evaluation and serving, and through the
plain softmax in training when its dropout acts, as the JAX gate routes
them.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FMLayer, SelfAttentionInteractingLayer, make_field_specs


class DIFMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, mlp_layer, activation: str, dropout: float,
                 n_head: int = 1, batch_norm: bool = False):
        super().__init__()
        F = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.vector_fen = SelfAttentionInteractingLayer(embed_dim, n_head, dropout)
        self.p_vec = nn.Linear(F * embed_dim, F, bias=False)
        self.bit_fen = MLPModule([F * embed_dim, *mlp_layer], activation_func=activation,
                                 dropout=dropout, batch_norm=batch_norm)
        self.p_bit = nn.Linear(mlp_layer[-1], F, bias=False)
        self.linear_emb = Embeddings(field_specs, 1)
        self.bias = nn.Parameter(torch.zeros(1))
        self.fm = FMLayer(reduction="sum")

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        flat = emb.reshape(emb.shape[0], -1)
        att = self.vector_fen(emb, rng)
        m = self.p_vec(att.reshape(att.shape[0], -1)) + self.p_bit(self.bit_fen(flat, rng))
        lr = (self.linear_emb(batch).squeeze(-1) * m).sum(-1) + self.bias[0]
        return lr + self.fm(emb * m[..., None])


class DIFM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DIFMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                       tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                       mc.get("n_head", 1), mc.get("batch_norm", False))
