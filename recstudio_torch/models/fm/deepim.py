"""DeepIM: the deep interaction machine.

Counterpart of ``recstudio_tpu/models/fm/deepim.py``: the
``InteractionMachine`` turns the power sums ``p_k = sum_f e_f^k`` into
the elementary symmetric sums of orders 1 to ``order`` (at most 5) by
Newton's identities, term for term as the JAX module writes them, and
scores them with ``fc``; an MLP over the flattened embeddings adds its
score.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by the products ``jax.lax.integer_pow`` takes (binary
    exponentiation: ``x^3 = x (x x)``, ``x^4 = (x x)(x x)``), so each
    power rounds as the JAX package's does."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


class InteractionMachine(nn.Module):
    def __init__(self, embed_dim: int, order: int = 2):
        super().__init__()
        if order > 5:
            raise ValueError("InteractionMachine supports order <= 5")
        self.order = order
        self.fc = nn.Linear(order * embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = x
        p = [q.sum(1)]
        outs = [p[0]]
        for k in range(2, self.order + 1):
            q = q * x
            p.append(q.sum(1))
            if k == 2:
                outs.append((_ipow(p[0], 2) - p[1]) / 2)
            elif k == 3:
                outs.append((_ipow(p[0], 3) - 3 * p[0] * p[1] + 2 * p[2]) / 6)
            elif k == 4:
                outs.append((_ipow(p[0], 4) - 6 * _ipow(p[0], 2) * p[1] + 3 * _ipow(p[1], 2)
                             + 8 * p[0] * p[2] - 6 * p[3]) / 24)
            else:
                outs.append((_ipow(p[0], 5) - 10 * _ipow(p[0], 3) * p[1]
                             + 20 * _ipow(p[0], 2) * p[2] - 30 * p[0] * p[3]
                             - 20 * p[1] * p[2] + 15 * p[0] * _ipow(p[1], 2)
                             + 24 * p[4]) / 120)
        return self.fc(torch.cat(outs, dim=-1)).squeeze(-1)


class DeepIMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, order: int, mlp_layer, activation: str,
                 dropout: float, batch_norm: bool):
        super().__init__()
        self.embedding = Embeddings(field_specs, embed_dim)
        self.im = InteractionMachine(embed_dim, order)
        self.mlp = MLPModule([len(field_specs) * embed_dim, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout, batch_norm=batch_norm,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        return self.im(emb) + self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1)


class DeepIM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DeepIMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                         mc.get("order", 2), tuple(mc["mlp_layer"]), mc["activation"],
                         mc["dropout"], mc.get("batch_norm", False))
