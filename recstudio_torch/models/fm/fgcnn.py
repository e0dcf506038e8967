"""FGCNN: feature generation by convolution, then an inner-product net.

Counterpart of ``recstudio_tpu/models/fm/fgcnn.py``: a second table set
(``gen_embedding``) feeds ``FGCNNLayer``, which generates new field
embeddings; an ``InnerProductLayer`` over the raw and the generated
fields, beside them flattened, goes through an MLP.
"""
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, FieldConv, InnerProductLayer, make_field_specs


class FGCNNLayer(nn.Module):
    """``fgcnn.py:18-53``: for each layer, a field-axis convolution
    (``conv_{i}``, ``module/ctr.FieldConv``), ``tanh``, a max pool of
    ``p`` fields (VALID, so ``F // p`` rows), then ``recomb_{i}`` over
    the pooled map flattened in the JAX package's NHWC order (field,
    column, channel) to ``rc`` new fields a pooled row, ``tanh``. The
    pooled map feeds the next layer."""

    def __init__(self, num_raw_fields: int, embed_dim: int, channels, heights, pooling_sizes,
                 recombine_channels):
        super().__init__()
        chans = [1] + list(channels)
        self.pooling_sizes = tuple(pooling_sizes)
        self.embed_dim = embed_dim
        height, self.num_new = num_raw_fields, 0
        for i, (c, h, p, rc) in enumerate(zip(channels, heights, pooling_sizes,
                                               recombine_channels)):
            self.add_module(f"conv_{i}", FieldConv(chans[i], c, h))
            height //= p
            self.add_module(f"recomb_{i}", nn.Linear(c * height * embed_dim,
                                                     rc * height * embed_dim))
            self.num_new += rc * height

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        B = inputs.shape[0]
        x = inputs[:, None]                                                  # [B, 1, F, D]
        new_embs = []
        for i, p in enumerate(self.pooling_sizes):
            x = torch.tanh(getattr(self, f"conv_{i}")(x))
            x = F.max_pool2d(x, (p, 1), (p, 1))
            rec = getattr(self, f"recomb_{i}")(x.permute(0, 2, 3, 1).reshape(B, -1))
            new_embs.append(torch.tanh(rec).reshape(B, -1, self.embed_dim))
        return torch.cat(new_embs, dim=1)


class FGCNNNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, channels, heights, pooling_sizes,
                 recombine_channels, mlp_layer, activation: str, dropout: float):
        super().__init__()
        nf = len(field_specs)
        self.embedding = Embeddings(field_specs, embed_dim)
        self.gen_embedding = Embeddings(field_specs, embed_dim)
        self.fgcnn = FGCNNLayer(nf, embed_dim, channels, heights, pooling_sizes,
                                recombine_channels)
        total = nf + self.fgcnn.num_new
        self.inner = InnerProductLayer(total)
        self.mlp = MLPModule([total * embed_dim + total * (total - 1) // 2, *mlp_layer, 1],
                             activation_func=activation, dropout=dropout,
                             last_activation=False, last_bn=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        all_emb = torch.cat([emb, self.fgcnn(self.gen_embedding(batch))], dim=1)
        h = torch.cat([all_emb.reshape(all_emb.shape[0], -1), self.inner(all_emb)], dim=-1)
        return self.mlp(h, rng).squeeze(-1)


class FGCNN(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return FGCNNNet(make_field_specs(self.fields, train_data), self.embed_dim,
                        tuple(mc["channels"]), tuple(mc["heights"]), tuple(mc["pooling_sizes"]),
                        tuple(mc["recombine_channels"]), tuple(mc["mlp_layer"]),
                        mc["activation"], mc["dropout"])
