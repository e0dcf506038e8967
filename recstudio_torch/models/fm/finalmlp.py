"""FinalMLP: two MLP streams with feature selection and bilinear fusion.

Counterpart of ``recstudio_tpu/models/fm/finalmlp.py``: with
``feature_selection``, each stream's input is the flattened embeddings
scaled by ``2 sigmoid`` of a gate MLP (``fs_gate1``, ``fs_gate2``) over
the stream's own fields, embedded by tables of their own (``fs_emb1``,
``fs_emb2``; by default the user features and the item features, or the
user and item ids where the dataset has no feature table). Two MLPs
(``mlp1``, ``mlp2``) and ``MultiHeadBilinearFusion`` score them. A
stream with no field among the model's fields cannot be built, as in the
JAX package (whose empty ``Embeddings`` raises).
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, make_field_specs


class MultiHeadBilinearFusion(nn.Module):
    """``finalmlp.py:18-35``: ``lr1(x1) + lr2(x2)`` (no biases) plus, over
    ``n_head`` heads, ``h1 W_h h2 + b_h`` with ``bilinear [H, d1, d2]``
    (flax ``normal(0.02)``, which the JAX rule by name leaves) and
    ``bilinear_bias [H]``."""

    def __init__(self, n_head: int, dim1: int, dim2: int):
        super().__init__()
        self.n_head = n_head
        self.d1, self.d2 = dim1 // n_head, dim2 // n_head
        self.lr1 = nn.Linear(dim1, 1, bias=False)
        self.lr2 = nn.Linear(dim2, 1, bias=False)
        self.bilinear = nn.Parameter(torch.zeros(n_head, self.d1, self.d2))
        self.bilinear_bias = nn.Parameter(torch.zeros(n_head))
        self.raw_init = {"bilinear": "normal_0.02"}

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        lr = self.lr1(x1) + self.lr2(x2)
        h1 = x1.reshape(-1, self.n_head, self.d1)
        h2 = x2.reshape(-1, self.n_head, self.d2)
        blr = torch.einsum("bhd,hde,bhe->bh", h1, self.bilinear, h2) + self.bilinear_bias
        return lr.squeeze(-1) + blr.sum(-1)


class FinalMLPNet(nn.Module):
    def __init__(self, field_specs, stream1_specs, stream2_specs, embed_dim: int, mlp_layer1,
                 mlp_layer2, activation1: str, activation2: str, dropout1: float,
                 dropout2: float, batch_norm1: bool, batch_norm2: bool, fs_mlp_layer,
                 n_head: int, feature_selection: bool = True):
        super().__init__()
        width = len(field_specs) * embed_dim
        self.feature_selection = feature_selection
        self.embedding = Embeddings(field_specs, embed_dim)
        if feature_selection:
            if not stream1_specs or not stream2_specs:
                raise ValueError("FinalMLP: a feature-selection stream has no field among the "
                                 "model's fields")
            self.fs_emb1 = Embeddings(stream1_specs, embed_dim)
            self.fs_emb2 = Embeddings(stream2_specs, embed_dim)
            self.fs_gate1 = MLPModule([len(stream1_specs) * embed_dim, *fs_mlp_layer, width],
                                      activation_func="relu", last_activation=False)
            self.fs_gate2 = MLPModule([len(stream2_specs) * embed_dim, *fs_mlp_layer, width],
                                      activation_func="relu", last_activation=False)
        self.mlp1 = MLPModule([width, *mlp_layer1], activation_func=activation1,
                              dropout=dropout1, batch_norm=batch_norm1)
        self.mlp2 = MLPModule([width, *mlp_layer2], activation_func=activation2,
                              dropout=dropout2, batch_norm=batch_norm2)
        self.fusion = MultiHeadBilinearFusion(n_head, mlp_layer1[-1], mlp_layer2[-1])

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        flat = emb.reshape(emb.shape[0], -1)
        if self.feature_selection:
            g1, g2 = self.fs_emb1(batch), self.fs_emb2(batch)
            gate1 = 2 * torch.sigmoid(self.fs_gate1(g1.reshape(g1.shape[0], -1), rng))
            gate2 = 2 * torch.sigmoid(self.fs_gate2(g2.reshape(g2.shape[0], -1), rng))
            e1, e2 = gate1 * flat, gate2 * flat
        else:
            e1 = e2 = flat
        return self.fusion(self.mlp1(e1, rng), self.mlp2(e2, rng))


class FinalMLP(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        specs = make_field_specs(self.fields, train_data)
        f1 = mc.get("fields1") or (train_data.user_feat.fields
                                   if train_data.user_feat is not None else [self.fuid])
        f2 = mc.get("fields2") or (train_data.item_feat.fields
                                   if train_data.item_feat is not None else [self.fiid])
        s1 = make_field_specs(set(f1) & set(self.fields), train_data)
        s2 = make_field_specs(set(f2) & set(self.fields), train_data)
        return FinalMLPNet(specs, s1, s2, self.embed_dim, tuple(mc["mlp_layer1"]),
                           tuple(mc["mlp_layer2"]), mc["activation1"], mc["activation2"],
                           mc["dropout1"], mc["dropout2"], mc.get("batch_norm1", False),
                           mc.get("batch_norm2", False), tuple(mc["fs_mlp_layer"]),
                           mc["n_head"], mc.get("feature_selection", True))
