"""Parameter conversion between the JAX package and the port.

``params_from_jax`` turns a JAX SASRec parameter tree (the nested dict of
arrays that ``model.params`` holds) into the port's ``state_dict``;
``params_to_jax`` is the reverse. Flax kernels are ``[in, out]`` and the
port's weights ``[out, in]``, so kernels are transposed. The fused
``qkv_kernel [D, 3D]`` is q|k|v blocks with the heads contiguous inside
each block (``transformer_layer.py:244-246``), which is exactly the row
order of the port's ``in_proj_weight [3D, D]``.

``random_sasrec_params`` draws a JAX-layout tree from a numpy seed, so the
tests and ``chip_smoke.py`` can feed the same weights to both packages
without JAX on the card.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# JAX transformer-layer leaf -> (port name, transpose)
_LAYER_MAP = {
    "qkv_kernel": ("in_proj_weight", True), "qkv_bias": ("in_proj_bias", False),
    "out_kernel": ("out_proj_weight", True), "out_bias": ("out_proj_bias", False),
    "norm1_scale": ("norm1_weight", False), "norm1_bias": ("norm1_bias", False),
    "ffn1_kernel": ("linear1_weight", True), "ffn1_bias": ("linear1_bias", False),
    "ffn2_kernel": ("linear2_weight", True), "ffn2_bias": ("linear2_bias", False),
    "norm2_scale": ("norm2_weight", False), "norm2_bias": ("norm2_bias", False),
}
_LAYER_UNMAP = {v[0]: (k, v[1]) for k, v in _LAYER_MAP.items()}


def _tensor(a, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a).copy())


def layer_params_from_jax(layer: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One JAX ``TransformerLayer``'s params -> the port's layer parameters."""
    return {name: _tensor(value, tr)
            for leaf, value in layer.items() for name, tr in [_LAYER_MAP[leaf]]}


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SASRec params -> the port's ``state_dict`` (float32 CPU tensors)."""
    qe = tree["query_encoder"]
    sd = {"query_encoder.item_encoder.weight": _tensor(qe["item_encoder"]["embedding"]),
          "query_encoder.pos_emb_table": _tensor(qe["pos_emb_table"])}
    layers = qe["transformer"]
    for i in range(len(layers)):
        for name, value in layer_params_from_jax(layers[f"layer_{i}"]).items():
            sd[f"query_encoder.transformer.layers.{i}.{name}"] = value
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's SASRec ``state_dict`` -> a JAX-layout tree of numpy arrays."""
    a = lambda name: state_dict[name].detach().cpu().numpy().astype(np.float32)
    layers = {}
    prefix = "query_encoder.transformer.layers."
    for key in state_dict:
        if key.startswith(prefix):
            i, name = key[len(prefix):].split(".", 1)
            leaf, tr = _LAYER_UNMAP[name]
            layers.setdefault(f"layer_{i}", {})[leaf] = a(key).T.copy() if tr else a(key)
    return {"query_encoder": {
        "item_encoder": {"embedding": a("query_encoder.item_encoder.weight")},
        "pos_emb_table": a("query_encoder.pos_emb_table"),
        "transformer": {f"layer_{i}": layers[f"layer_{i}"] for i in range(len(layers))}}}


def random_sasrec_params(seed: int, num_items: int, embed_dim: int, max_seq_len: int,
                         hidden_size: int, n_layers: int) -> Dict[str, Any]:
    """Seeded numpy weights in the JAX layout. Kernels ~ N(0, 1/fan_in);
    biases and LayerNorm offsets nonzero, so a wrong mapping shows."""
    rng = np.random.default_rng(seed)
    D, F = embed_dim, hidden_size
    f32 = lambda x: np.asarray(x, np.float32)
    emb = f32(rng.normal(0.0, 0.1, (num_items, D)))
    emb[0] = 0.0
    layers = {}
    for i in range(n_layers):
        layers[f"layer_{i}"] = {
            "qkv_kernel": f32(rng.normal(0.0, D ** -0.5, (D, 3 * D))),
            "qkv_bias": f32(rng.normal(0.0, 0.05, 3 * D)),
            "out_kernel": f32(rng.normal(0.0, D ** -0.5, (D, D))),
            "out_bias": f32(rng.normal(0.0, 0.05, D)),
            "norm1_scale": f32(1.0 + rng.normal(0.0, 0.05, D)),
            "norm1_bias": f32(rng.normal(0.0, 0.05, D)),
            "ffn1_kernel": f32(rng.normal(0.0, D ** -0.5, (D, F))),
            "ffn1_bias": f32(rng.normal(0.0, 0.05, F)),
            "ffn2_kernel": f32(rng.normal(0.0, F ** -0.5, (F, D))),
            "ffn2_bias": f32(rng.normal(0.0, 0.05, D)),
            "norm2_scale": f32(1.0 + rng.normal(0.0, 0.05, D)),
            "norm2_bias": f32(rng.normal(0.0, 0.05, D)),
        }
    return {"query_encoder": {"item_encoder": {"embedding": emb},
                              "pos_emb_table": f32(rng.normal(0.0, 0.1, (max_seq_len, D))),
                              "transformer": layers}}
