"""DESTINE: the disentangled self-attentive network.

Counterpart of ``recstudio_tpu/models/fm/destine.py``: the embeddings,
projected to ``attention_dim`` (``proj``), go through
``num_attention_layers`` ``DisentangledSelfAttention`` layers; ``attn_fc``
scores them flattened, plus the first-order ``linear`` score (``wide``)
and an MLP over the flattened embeddings (``deep``). The config's
``res_mode`` is read by no JAX module and is not read here.
"""
from typing import Dict, Optional

import torch
from torch import nn

from ...data.dataset import TripletDataset
from ..basemodel.baseranker import BaseRanker
from ..module import MLPModule
from ..module.ctr import Embeddings, LinearLayer, make_field_specs
from ..module.layers import seeded_dropout


class DisentangledSelfAttention(nn.Module):
    """``destine.py:17-53``: a unary term, the softmax over the fields of
    ``unary(x)`` (one logit a head), and a pairwise term, the softmax over
    the keys of the whitened ``(q - mean_f q)(k - mean_f k)^T / sqrt(d_h)``;
    the unary weight ``[B H, F, 1]`` is added to every key of its query's
    row, as the JAX module's broadcast adds it. Dropout on the weights (the
    plain Philox mask), ``attn @ v``, and the residual ``res(x)`` (DESTINE
    sets the JAX module's ``residual`` and ``scale`` always). This is not
    ``fused_mha``'s function, so it reaches no kernel."""

    def __init__(self, embed_dim: int, attention_dim: int, n_head: int = 1, dropout: float = 0.0,
                 relu_before_att: bool = False):
        super().__init__()
        self.attention_dim, self.n_head, self.dropout = attention_dim, n_head, dropout
        self.relu_before_att = relu_before_att
        self.unary = nn.Linear(embed_dim, n_head)
        self.Wq = nn.Linear(embed_dim, attention_dim)
        self.Wk = nn.Linear(embed_dim, attention_dim)
        self.Wv = nn.Linear(embed_dim, attention_dim)
        self.res = nn.Linear(embed_dim, attention_dim)

    def forward(self, inputs: torch.Tensor, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B, F, _ = inputs.shape
        H = self.n_head
        dph = self.attention_dim // H
        unary = torch.softmax(self.unary(inputs), dim=1)                     # [B, F, H]
        unary = unary.transpose(1, 2).reshape(B * H, F, 1)
        q, k, v = self.Wq(inputs), self.Wk(inputs), self.Wv(inputs)
        if self.relu_before_att:
            q, k, v = torch.relu(q), torch.relu(k), torch.relu(v)

        def split(x):
            return x.reshape(B, F, H, dph).transpose(1, 2).reshape(B * H, F, dph)

        q, k, v = split(q), split(k), split(v)
        mu_q = q - q.mean(1, keepdim=True)
        mu_k = k - k.mean(1, keepdim=True)
        pair = torch.matmul(mu_q, mu_k.transpose(1, 2)) / (dph ** 0.5)
        attn = seeded_dropout(unary + torch.softmax(pair, dim=2), self.dropout, self.training,
                              rng)
        out = torch.matmul(attn, v).reshape(B, H, F, dph).transpose(1, 2).reshape(
            B, F, self.attention_dim)
        return out + self.res(inputs)


class DESTINENet(nn.Module):
    def __init__(self, field_specs, embed_dim: int, attention_dim: int,
                 num_attention_layers: int, n_head: int, mlp_layer, activation: str,
                 dropout: float, wide: bool = True, deep: bool = True,
                 relu_before_att: bool = False):
        super().__init__()
        F = len(field_specs)
        self.n_layers = num_attention_layers
        self.embedding = Embeddings(field_specs, embed_dim)
        self.proj = nn.Linear(embed_dim, attention_dim)
        for i in range(num_attention_layers):
            self.add_module(f"attn_{i}", DisentangledSelfAttention(
                attention_dim, attention_dim, n_head, dropout, relu_before_att))
        self.attn_fc = nn.Linear(F * attention_dim, 1)
        self.linear = LinearLayer(field_specs) if wide else None
        self.mlp = MLPModule([F * embed_dim, *mlp_layer, 1], activation_func=activation,
                             dropout=dropout, last_activation=False,
                             last_bn=False) if deep else None

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embedding(batch)
        x = self.proj(emb)
        for i in range(self.n_layers):
            x = getattr(self, f"attn_{i}")(x, rng)
        score = self.attn_fc(x.reshape(x.shape[0], -1)).squeeze(-1)
        if self.linear is not None:
            score = score + self.linear(batch)
        if self.mlp is not None:
            score = score + self.mlp(emb.reshape(emb.shape[0], -1), rng).squeeze(-1)
        return score


class DESTINE(BaseRanker):

    @staticmethod
    def _get_dataset_class():
        return TripletDataset

    def _get_score_net(self, train_data):
        mc = self.config["model"]
        return DESTINENet(make_field_specs(self.fields, train_data), self.embed_dim,
                          mc["attention_dim"], mc["num_attention_layers"], mc["n_head"],
                          tuple(mc["mlp_layer"]), mc["activation"], mc["dropout"],
                          mc.get("wide", True), mc.get("deep", True),
                          mc.get("relu_before_att", False))
