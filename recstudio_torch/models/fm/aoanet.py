"""AOANet: the architecture and operation adaptive network.

Counterpart of ``recstudio_tpu/models/fm/aoanet.py``: an MLP over the
flattened embeddings beside ``num_interaction_layers``
``GeneralizedInteractionFusion`` layers (``gin_{i}``), each fusing the
embeddings with the layer before's ``num_subspaces`` outputs; ``fc``
scores the MLP's output and the last fusion's, flattened.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class GeneralizedInteractionFusion(nn.Module):
    """``aoanet.py:17-34``: ``out[b, o, i] = sum_j h[o, j] W[o, i, j] sum_f
    b0[b, f, i] sum_n alpha[f, n, o] bi[b, n, j]``. The JAX module forms
    the outer products ``[B, F, N, D, D]`` first; here ``alpha`` is
    contracted with ``bi`` first, a ``[B, F, O, D]`` intermediate, which
    is the same function. ``W [O, D, D]`` (declared as copies of the
    identity) is a kernel to the JAX rule by name (its lower-cased name
    ``w``), drawn by the model's ``init_method`` over flax's fans;
    ``alpha [F, N, O]`` and ``h [O, D, 1]`` start at 1."""

    def __init__(self, num_fields: int, embed_dim: int, in_subspaces: int, out_subspaces: int):
        super().__init__()
        self.W = nn.Parameter(torch.eye(embed_dim).repeat(out_subspaces, 1, 1))
        self.alpha = nn.Parameter(torch.ones(num_fields, in_subspaces, out_subspaces))
        self.h = nn.Parameter(torch.ones(out_subspaces, embed_dim, 1))

    def forward(self, b0: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
        t = torch.einsum("fno,bnj->bfoj", self.alpha, bi)                    # [B, F, O, D]
        fusion = torch.einsum("bfi,bfoj->boij", b0, t) * self.W              # [B, O, D, D]
        return torch.matmul(fusion, self.h).squeeze(-1)                      # [B, O, D]


class AOANetNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, num_interaction_layers: int,
                 num_subspaces: int, mlp_layer, activation: str, dropout: float):
        super().__init__()
        F = len(field_specs)
        self.n_layers = num_interaction_layers
        self.embedding = Embeddings(field_specs, embed_dim)
        self.mlp = MLPModule([F * embed_dim, *mlp_layer], activation_func=activation,
                             dropout=dropout, last_activation=False, last_bn=False)
        for i in range(num_interaction_layers):
            self.add_module(f"gin_{i}", GeneralizedInteractionFusion(
                F, embed_dim, F if i == 0 else num_subspaces, num_subspaces))
        gin_width = (num_subspaces if num_interaction_layers else F) * embed_dim
        self.fc = nn.Linear(mlp_layer[-1] + gin_width, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        mlp_out = self.mlp(emb.reshape(emb.shape[0], -1), rng)
        bi = emb
        for i in range(self.n_layers):
            bi = getattr(self, f"gin_{i}")(emb, bi)
        return self.fc(torch.cat([mlp_out, bi.reshape(bi.shape[0], -1)], dim=-1)).squeeze(-1)


class AOANet(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return AOANetNet(make_field_specs(self.fields, train_data), self.embed_dim,
                         mc["num_interaction_layers"], mc["num_subspaces"],
                         tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"])
