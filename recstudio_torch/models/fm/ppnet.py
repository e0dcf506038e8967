"""PPNet: the parameter personalized network.

Counterpart of ``recstudio_tpu/models/fm/ppnet.py``: before each MLP
stage ``pp_mlp_{i}``, a gate MLP ``gate_{i}`` reads the flattened
embeddings, detached (``stop_gradient`` there), beside the embeddings of
the gate fields (``gate_embedding``; by default the user and item ids)
and scales the stage's input by ``2 sigmoid``; ``fc`` scores the last
stage. With no gate field among the model's fields the net cannot be
built, as in the JAX package (whose empty ``Embeddings`` raises).
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class PPNetNet(nn.Module):
    def __init__(self, field_specs, gate_specs, embed_dim: int, mlp_layer, gate_hidden_dim: int,
                 activation: str, dropout: float, batch_norm: bool):
        super().__init__()
        if not gate_specs:
            raise ValueError("PPNet: no gate field among the model's fields")
        width = len(field_specs) * embed_dim
        self.embedding = Embeddings(field_specs, embed_dim)
        self.gate_embedding = Embeddings(gate_specs, embed_dim)
        dims = [width, *mlp_layer]
        self.n_stages = len(dims) - 1
        gate_in = width + len(gate_specs) * embed_dim
        for i in range(self.n_stages):
            self.add_module(f"gate_{i}", MLPModule(
                [gate_in, gate_hidden_dim, dims[i]], activation_func=activation, dropout=dropout,
                last_activation=False))
            self.add_module(f"pp_mlp_{i}", MLPModule(
                [dims[i], dims[i + 1]], activation_func=activation, dropout=dropout,
                batch_norm=batch_norm))
        self.fc = nn.Linear(dims[-1], 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        flat = emb.reshape(emb.shape[0], -1)
        gate_emb = self.gate_embedding(batch)
        gate_in = torch.cat([flat.detach(), gate_emb.reshape(gate_emb.shape[0], -1)], dim=-1)
        h = flat
        for i in range(self.n_stages):
            gate = 2.0 * torch.sigmoid(getattr(self, f"gate_{i}")(gate_in, rng))
            h = getattr(self, f"pp_mlp_{i}")(gate * h, rng)
        return self.fc(h).squeeze(-1)


class PPNet(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        gate_fields = set(mc.get("gate_fields") or [self.fuid, self.fiid])
        return PPNetNet(make_field_specs(self.fields, train_data),
                        make_field_specs(gate_fields & set(self.fields), train_data),
                        self.embed_dim, tuple(mc["mlp_layer"]), mc.get("gate_hidden_dim", 64),
                        mc["activation"], mc["dropout"], mc.get("batch_norm", False))
