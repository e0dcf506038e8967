"""FiGNN: the field interaction graph neural network.

Counterpart of ``recstudio_tpu/models/fm/fignn.py``: a dense field graph
with learned edge weights (``edge_w`` over each pair's two embeddings, a
leaky relu, a softmax over the row, then the diagonal zeroed, not
renormalised); ``num_layers`` rounds of per-field ``W_out_{i}``,
aggregation over the graph, per-field ``W_in_{i}`` plus ``bias_{i}``, and
one ``GRUCell`` shared by the rounds (the state first) plus the
embeddings; an attentional readout (``mlp1`` a field, gated by
``mlp2``).
"""
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module.ctr import Embeddings, make_field_specs
from ..module.layers import GRUCell


class FiGNNNet(nn.Module):
    """The JAX module scores each ordered pair with ``edge_w`` over the
    concatenation ``[e_i, e_j]`` (a ``[B, F^2, 2D]`` input); that is
    ``e_i . a + e_j . b`` with ``a``, ``b`` the kernel's two halves, which
    is computed here from two ``[B, F]`` projections. ``W_out_{i}`` and
    ``W_in_{i}`` ``[F, D, D]`` keep flax's ``normal(0.02)``, which the JAX
    rule by name leaves."""

    def __init__(self, field_specs, embed_dim: int, num_layers: int):
        super().__init__()
        nf, d = len(field_specs), embed_dim
        self.num_layers = num_layers
        self.embedding = Embeddings(field_specs, embed_dim)
        self.edge_w = nn.Linear(2 * d, 1, bias=False)
        self.gru = GRUCell(d, d)
        self.raw_init = {}
        for i in range(num_layers):
            for name in (f"W_out_{i}", f"W_in_{i}"):
                self.register_parameter(name, nn.Parameter(torch.zeros(nf, d, d)))
                self.raw_init[name] = "normal_0.02"
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.zeros(d)))
        self.mlp1 = nn.Linear(d, 1, bias=False)
        self.mlp2 = nn.Linear(nf * d, nf, bias=False)
        self.register_buffer("off_diag", 1.0 - torch.eye(nf), persistent=False)

    def graph(self, emb: torch.Tensor) -> torch.Tensor:
        """The edge weights ``[B, F, F]`` of the embeddings ``[B, F, D]``."""
        d = emb.shape[-1]
        a, b = self.edge_w.weight[0, :d], self.edge_w.weight[0, d:]
        w = torch.matmul(emb, a)[:, :, None] + torch.matmul(emb, b)[:, None, :]
        return torch.softmax(F.leaky_relu(w), dim=-1) * self.off_diag

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        B, nf, d = emb.shape
        w = self.graph(emb)
        h = emb
        for i in range(self.num_layers):
            h_out = torch.einsum("fde,bfd->bfe", getattr(self, f"W_out_{i}"), h)
            agg = torch.matmul(w, h_out)
            x = torch.einsum("fde,bfd->bfe", getattr(self, f"W_in_{i}"), agg) \
                + getattr(self, f"bias_{i}")
            h = self.gru(h.reshape(B * nf, d), x.reshape(B * nf, d)).reshape(B, nf, d) + emb
        score_w = self.mlp1(h).squeeze(-1)                                   # [B, F]
        gate = self.mlp2(h.reshape(B, -1))                                   # [B, F]
        return (score_w * gate).sum(-1)


class FiGNN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return FiGNNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                        mc["num_layers"])
