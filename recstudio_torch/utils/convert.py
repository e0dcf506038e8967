"""Parameter conversion between the JAX package and the port.

``params_from_jax`` turns a JAX SASRec, BERT4Rec, GRU4Rec, NARM, STAMP,
BPR, MultiDAE or MultiVAE parameter tree (the nested dict of arrays that
``model.params`` holds; BERT4Rec's item table has one more row, the
``[MASK]`` token; BPR's tree is its two tables, ``query_encoder/embedding``
and ``item_encoder/embedding``; a sequence model's query encoder owns the
item table the catalog is scored against; MultiDAE's and MultiVAE's query
encoder has a table of its own, ``item_embedding``, beside the item
tower's) into the port's ``state_dict``; ``params_to_jax`` is the reverse.
``lazy_adam_state_from_jax`` loads the JAX lazy-Adam state (``count``,
``mu``, ``nu``) into the port's ``LazyAdam``. Flax kernels are ``[in, out]`` and the
port's weights ``[out, in]``, so kernels are transposed. The fused
``qkv_kernel [D, 3D]`` is q|k|v blocks with the heads contiguous inside
each block (``transformer_layer.py:244-246``), which is exactly the row
order of the port's ``in_proj_weight [3D, D]``. A GRU layer's ``ih`` and
``hh`` kernels ``[in, 3H]``, ``[H, 3H]`` are ``r | z | n`` blocks, as the
rows of an ``nn.GRU``'s ``weight_ih_l0 [3H, in]`` and ``weight_hh_l0``;
every other ``Dense`` kernel is a ``Linear``'s weight transposed.

Gradients share their parameters' layouts, so the same maps carry them:
``params_to_jax`` of a ``{name: grad}`` dict (or ``layer_params_to_jax``
for one layer) gives the JAX package's gradient tree, which is how the
parity tests compare the two packages' gradients.

``ranker_params_from_jax`` and ``ranker_params_to_jax`` do the same for a
ranker's tree (DeepFM, FM, LR, WideDeep, DCN, NFM, AutoInt): token tables
``{name}_embedding`` and ``token_embedding`` become ``nn.Embedding``
weights (a packed ``[N, 3D]`` table of the JAX row-sparse fit is kept
whole for a packed port model, or gives its first D columns and, through
``ranker_moments_from_jax``, the dense ``LazyAdam``'s moments), the float
kernel ``dense_embedding``, the biases, ``CrossNetwork``'s ``w_{i}`` and
``b_{i}`` and a batch norm's ``scale`` keep their names, and every
``Dense`` kernel (``{name}_dense/weight``, ``mlp/dense_{i}``, the
attention's ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj``, ``res``,
``att_proj``, ``attn_fc``, ``fc``) is a ``Linear`` weight, transposed.
The flax ``batch_stats`` collection is the batch norms' ``mean``, ``var``
and ``count`` buffers (``ranker_batch_stats_to_jax`` the reverse).

``graph_params_from_jax`` and ``graph_params_to_jax`` do the same for a
graph model's tree (LightGCN, NGCF, SimGCL): the tables ``user_embedding``
and ``item_embedding`` are ``GraphNet``'s ``nn.Embedding`` weights, and
NGCF's ``layer_{i}/W1`` and ``W2`` ``Dense`` kernels are ``Linear``
weights, transposed.

A retriever whose score function has parameters (NCF's ``MLPScorer``,
``GMFScorer``, ``FusionMFMLPScorer``) keeps them under ``score_func``
in both layouts: ``W`` and the MLP's ``dense_{i}`` kernels ``[in, out]``
are ``Linear`` weights ``[out, in]``. ``sampler_state_from_jax`` turns a
sampler state built by the JAX package (``update``'s dict) into the
port's (integer arrays as int64), and ``lsh_weight_vectors_from_jax``
gives a port ``LSHSampler`` the JAX sampler's hyperplanes (the port draws
its own from a ``torch.Generator``; ``jax.random.PRNGKey(seed)``'s stream
cannot be reproduced).

``random_sasrec_params`` draws a JAX-layout tree from a numpy seed, so the
tests and ``chip_smoke.py`` can feed the same weights to both packages
without JAX on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

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


def layer_params_to_jax(layer: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One layer's parameters (or gradients), port names -> JAX leaves."""
    out = {}
    for name, value in layer.items():
        leaf, tr = _LAYER_UNMAP[name]
        a = value.detach().cpu().numpy().astype(np.float32)
        out[leaf] = a.T.copy() if tr else a
    return out


# modules whose ``weight`` is an embedding table (the JAX ``embedding``
# leaf, not transposed); a tower that is a table itself has the bare name
_TABLES = ("item_encoder", "item_embedding")


def _port_name(path) -> Tuple[str, bool]:
    """A leaf of a JAX tower's tree -> (the port's parameter name under
    the tower's, transpose)."""
    if path[-1] == "embedding":                     # an embedding table
        return ".".join(path[:-1] + ("weight",)), False
    if path[0] == "transformer":                    # transformer/layer_{i}/<leaf>
        name, tr = _LAYER_MAP[path[2]]
        return f"transformer.layers.{path[1][len('layer_'):]}.{name}", tr
    if path[0] == "gru":                            # gru/gru_{i}/{ih,hh}/{kernel,bias}
        kind = "weight" if path[3] == "kernel" else "bias"
        return f"gru.layers.{path[1][len('gru_'):]}.{kind}_{path[2]}_l0", kind == "weight"
    if path[-1] == "kernel":                        # a Dense: kernel [in, out]
        return ".".join(path[:-1]) + ".weight", True
    return ".".join(path), False                    # biases, pos_emb_table


def _jax_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """``_port_name``'s inverse."""
    parts = tuple(name.split("."))
    if parts == ("weight",) or (parts[-1] == "weight" and parts[-2] in _TABLES):
        return parts[:-1] + ("embedding",), False
    if parts[0] == "transformer":                   # transformer.layers.{i}.<name>
        leaf, tr = _LAYER_UNMAP[parts[3]]
        return ("transformer", f"layer_{parts[2]}", leaf), tr
    if parts[0] == "gru":                           # gru.layers.{i}.{weight,bias}_{ih,hh}_l0
        kind, gate, _ = parts[3].split("_")
        return ("gru", f"gru_{parts[2]}", gate, "kernel" if kind == "weight" else "bias"), \
            kind == "weight"
    if parts[-1] == "weight":
        return parts[:-1] + ("kernel",), True
    return parts, False


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SASRec, BERT4Rec, GRU4Rec, NARM, STAMP, BPR, PMF, CML, NCF,
    LogisticMF, MultiDAE or MultiVAE params -> the port's ``state_dict``
    (float32 CPU tensors)."""
    sd = {}
    for tower in ("item_encoder", "query_encoder", "score_func"):
        for path, value in _leaves(tree.get(tower, {})):
            name, tr = _port_name(path)
            sd[f"{tower}.{name}"] = _tensor(value, tr)
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` of one of those models (or its gradients by
    the same names) -> a JAX-layout tree of numpy arrays."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        tower, _, name = key.partition(".")
        path, tr = _jax_path(name)
        node = out.setdefault(tower, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        a = value.detach().cpu().numpy().astype(np.float32)
        node[path[-1]] = a.T.copy() if tr else a
    return out


def _is_token_table(leaf: str) -> bool:
    return leaf.endswith("_embedding") and leaf != "dense_embedding"


# the batch-norm statistics (flax ``batch_stats`` leaves, the port's buffers)
_BN_STATS = ("mean", "var", "count")


def ranker_params_from_jax(tree: Dict[str, Any], embed_dim: int,
                           batch_stats: Dict[str, Any] = None,
                           packed: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX ranker's params -> the port's ``state_dict``. ``embed_dim`` is
    the model's D (the ``linear`` tree's tables are 1 wide). A packed ``[N,
    3D]`` table of the JAX row-sparse fit (params | mu | nu) is kept whole
    for a port model whose tables are packed (``packed``), else it gives
    its first D columns (its moments: ``ranker_moments_from_jax``).
    ``batch_stats``, the flax collection of the net's batch norms, gives
    their ``mean``, ``var`` and ``count`` buffers; a LayerNorm's ``ln/scale``
    is its ``ln.weight``."""
    sd = {}
    for path, value in _leaves(tree):
        if path[-1] == "kernel":
            sd[".".join(path[:-1]) + ".weight"] = _tensor(value, True)
        elif _is_token_table(path[-1]):
            d = 1 if path[0] == "linear" else embed_dim
            a = np.asarray(value, np.float32)
            if a.shape[-1] == 3 * d and not packed:
                a = a[:, :d]
            sd[".".join(path) + ".weight"] = _tensor(a)
        elif path[-2:-1] == ("ln",) and path[-1] == "scale":
            sd[".".join(path[:-1]) + ".weight"] = _tensor(value)
        else:
            sd[".".join(path)] = _tensor(value)
    for path, value in _leaves(batch_stats or {}):
        sd[".".join(path)] = _tensor(value)
    return sd


def ranker_moments_from_jax(tree: Dict[str, Any], embed_dim: int
                            ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The moments a JAX row-sparse fit keeps in its packed ``[N, 3D]``
    tables: ``{port name: (mu, nu)}``, columns D to 2D and 2D to 3D, the
    dense ``LazyAdam``'s moments of the unpacked table."""
    out = {}
    for path, value in _leaves(tree):
        d = 1 if path[0] == "linear" else embed_dim
        a = np.asarray(value, np.float32)
        if _is_token_table(path[-1]) and a.shape[-1] == 3 * d:
            out[".".join(path) + ".weight"] = (_tensor(a[:, d:2 * d]), _tensor(a[:, 2 * d:]))
    return out


def _is_bn_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in _BN_STATS


def ranker_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``ranker_params_from_jax``'s inverse, for parameters or gradients
    (a packed table stays ``[N, 3D]``); the batch-norm buffers are left
    out (``ranker_batch_stats_to_jax``)."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if _is_bn_stat(key):
            continue
        parts = tuple(key.split("."))
        tr = False
        if parts[-1] == "weight":
            if _is_token_table(parts[-2]):
                parts = parts[:-1]
            elif parts[-2] == "ln" and value.dim() == 1:
                parts = parts[:-1] + ("scale",)
            else:
                parts, tr = parts[:-1] + ("kernel",), True
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        a = value.detach().cpu().numpy().astype(np.float32)
        node[parts[-1]] = a.T.copy() if tr else a
    return out


def ranker_batch_stats_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The batch norms' ``mean``, ``var`` and ``count`` buffers of a
    ranker's ``state_dict`` -> the flax ``batch_stats`` tree."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        if not _is_bn_stat(key):
            continue
        parts = key.split(".")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy().astype(np.float32)
    return out


def graph_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX graph model's params -> the port's ``state_dict``."""
    sd = {}
    for path, value in _leaves(tree):
        if len(path) == 1:                          # user_embedding, item_embedding
            sd[f"{path[0]}.weight"] = _tensor(value)
        elif path[-1] == "kernel":                  # layer_{i}/W{1,2}/kernel [in, out]
            sd[".".join(path[:-1]) + ".weight"] = _tensor(value, True)
        else:
            sd[".".join(path)] = _tensor(value)
    return sd


def graph_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``graph_params_from_jax``'s inverse, for parameters or gradients."""
    out: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = tuple(key.split("."))
        a = value.detach().cpu().numpy().astype(np.float32)
        if len(parts) == 2 and parts[1] == "weight":
            out[parts[0]] = a
            continue
        if parts[-1] == "weight":
            parts, a = parts[:-1] + ("kernel",), a.T.copy()
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return out


def lazy_adam_state_from_jax(net: torch.nn.Module, optimizer, state) -> None:
    """Load a JAX lazy-Adam state into the port's ``LazyAdam`` over
    ``net``'s parameters: ``state`` is the optimizer state of a
    ``sparse_adam`` model (a one-element tuple, optax's chain) or its
    ``LazyAdamState``, with ``count``, and ``mu`` and ``nu`` trees in the
    parameters' layout."""
    if isinstance(state, (tuple, list)) and not hasattr(state, "mu"):
        (state,) = state
    params = dict(net.named_parameters())
    for tree, key in ((state.mu, "mu"), (state.nu, "nu")):
        for name, value in params_from_jax(_as_numpy(tree)).items():
            optimizer.moments(params[name])
            optimizer.state[params[name]][key] = value.to(params[name].device)
    for group in optimizer.param_groups:
        group["count"] = int(np.asarray(state.count))


def sampler_state_from_jax(state: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX sampler's ``update`` state -> the port's: floats as float32,
    integers as int64, on ``device``."""
    out = {}
    for key, value in state.items():
        a = np.asarray(value)
        a = a.astype(np.int64) if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def lsh_weight_vectors_from_jax(sampler, jax_sampler) -> None:
    """Give the port's ``LSHSampler`` the JAX sampler's hyperplanes."""
    sampler.weight_vectors = _tensor(jax_sampler.weight_vectors)


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def random_sasrec_params(seed: int, num_items: int, embed_dim: int, max_seq_len: int,
                         hidden_size: int, n_layers: int) -> Dict[str, Any]:
    """Seeded numpy weights in the JAX layout. Kernels ~ N(0, 1/fan_in);
    biases and LayerNorm offsets nonzero, so a wrong mapping shows. Every
    table row but row 0 is drawn: BERT4Rec passes ``num_items + 1`` and gets
    a nonzero ``[MASK]`` row."""
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

