"""CCPM: the convolutional click prediction model.

Counterpart of ``recstudio_tpu/models/fm/ccpm.py``: the embeddings as a
one-channel map ``[B, 1, F, D]`` go through field-axis convolutions
(``conv_{i}``, kernel ``(h, 1)``, SAME padding: ``module/ctr.FieldConv``),
each followed by ``tanh`` and k-max pooling over the fields: the k
largest values of each column in descending order, ties lower field
first (``ops/topk``, as ``jax.lax.top_k``), not in field order, with ``k
= max(3, (1 - ((i + 1) / L)^(L - i - 1)) F)`` before the last layer and 3
at it. An MLP reads the last map flattened in the JAX package's NHWC
order (field, column, channel), plus the first-order ``linear`` score.
"""
from typing import Dict, List, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ...ops.topk import topk
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FieldConv, LinearLayer, make_field_specs


def kmax_sizes(num_fields: int, num_layers: int) -> List[int]:
    """Each layer's k (``ccpm.py:43-46``), capped by the rows it gets."""
    sizes, height = [], num_fields
    for i in range(num_layers):
        k = max(3, int((1 - (float(i + 1) / num_layers) ** (num_layers - i - 1)) * num_fields)) \
            if i < num_layers - 1 else 3
        height = min(k, height)
        sizes.append(height)
    return sizes


def kmax_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest rows of each column of an NCHW map ``[B, C, F, D]``,
    in descending order, ties lower row first: ``[B, C, k, D]``."""
    return topk(x.transpose(2, 3), k)[0].transpose(2, 3)


class CCPMNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, channels, heights, mlp_layer,
                 activation: str, dropout: float):
        super().__init__()
        chans = [1] + list(channels)
        self.ks = kmax_sizes(len(field_specs), len(heights))
        self.linear = LinearLayer(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        for i, (h, c) in enumerate(zip(heights, channels)):
            self.add_module(f"conv_{i}", FieldConv(chans[i], c, h))
        width = self.ks[-1] * embed_dim * chans[len(self.ks)]
        self.mlp = MLPModule([width, *mlp_layer, 1], activation_func=activation, dropout=dropout,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        lr = self.linear(batch)
        x = self.embedding(batch)[:, None]                                   # [B, 1, F, D]
        for i, k in enumerate(self.ks):
            x = torch.tanh(getattr(self, f"conv_{i}")(x))
            x = kmax_pool(x, k)
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)                    # NHWC order
        return lr + self.mlp(h, rng).squeeze(-1)


class CCPM(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return CCPMNet(make_field_specs(self.fields, train_data), self.embed_dim,
                       tuple(mc["channels"]), tuple(mc["heights"]), tuple(mc["mlp_layer"]),
                       mc["activation"], mc["dropout"])
