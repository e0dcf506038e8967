"""MaskNet: instance-guided mask blocks, serial or parallel.

Counterpart of ``recstudio_tpu/models/fm/masknet.py``: the flattened
embeddings guide ``num_blocks`` ``MaskBlock``s. In parallel each block
masks the LayerNorm-ed embeddings (``emb_ln``, over D, flax's epsilon
1e-6) and an MLP scores their outputs concatenated; in series each block
masks the one before's output and ``fc`` scores the last.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, MaskBlock, make_field_specs


class MaskNetNet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, parallel: bool, num_blocks: int,
                 block_dim: int, reduction_ratio: float, mlp_layer, activation: str,
                 dropout: float, hidden_layer_norm: bool = True):
        super().__init__()
        width = len(field_specs) * embed_dim
        self.parallel, self.num_blocks = parallel, num_blocks
        self.embedding = Embeddings(field_specs, embed_dim)
        self.emb_ln = nn.LayerNorm(embed_dim, eps=1e-6)
        dims = [width] * (num_blocks + 1) if parallel else [width] + [block_dim] * num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", MaskBlock(
                width, dims[i], block_dim, reduction_ratio, activation, dropout,
                hidden_layer_norm))
        if parallel:
            self.mlp = MLPModule([num_blocks * block_dim, *mlp_layer, 1],
                                 activation_func=activation, dropout=dropout,
                                 last_activation=False, last_bn=False)
        else:
            self.fc = nn.Linear(block_dim, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        flat = emb.reshape(emb.shape[0], -1)
        ln_flat = self.emb_ln(emb).reshape(emb.shape[0], -1)
        if self.parallel:
            h = torch.cat([getattr(self, f"block_{i}")(flat, ln_flat, rng)
                           for i in range(self.num_blocks)], dim=-1)
            return self.mlp(h, rng).squeeze(-1)
        h = ln_flat
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(flat, h, rng)
        return self.fc(h).squeeze(-1)


class MaskNet(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return MaskNetNet(make_field_specs(self.fields, train_data), self.embed_dim,
                          mc.get("parallel", False), mc["num_blocks"], mc["block_dim"],
                          mc.get("reduction_ratio", 1), tuple(mc["mlp_layer"]),
                          mc["activation"], mc["dropout"], mc.get("hidden_layer_norm", True))
