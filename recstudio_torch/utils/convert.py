"""Parameter conversion between the JAX package and the port.

``params_from_jax`` turns a JAX SASRec, BERT4Rec, GRU4Rec, NARM, STAMP,
CL4SRec, CoSeRec, ICLRec, Caser, FPMC, TransRec, HGN, NPE, BPR, MultiDAE
or MultiVAE parameter tree (the nested dict of arrays that
``model.params`` holds; BERT4Rec's and the contrastive models' item table
has one more row, the ``[MASK]`` token; Caser's, FPMC's, TransRec's,
HGN's and NPE's ``user_embedding``, FPMC's ``last_item_embedding`` and
NPE's item tower's nested ``embedding_layer`` are tables; Caser's
``horizontal_kernel_{h} (h, D, n_h)`` is the conv1d weight ``[n_h, D,
h]``, its axes reversed, and its ``vertical_kernel (n_v, L)``, HGN's
``W_g_4``, ``b_g_4`` and ``b_g`` and TransRec's ``global_user_emb`` keep
their layout, HGN's ``W_g_{1,2}`` and ``w_g_3`` being ``Dense`` kernels;
BPR's tree is its two tables, ``query_encoder/embedding`` and
``item_encoder/embedding``; a sequence model's query encoder owns the
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

The rest of the ``mf``, ``debias`` and ``graph`` families: WRMF's,
IPSBPR's and PDA's trees are BPR's two tables (``params_from_jax``);
IRGAN's four flat tables (``dis_user_embedding``, ...) and SGL's and
NCL's two take ``graph_params_from_jax``; DSSM's towers (``Embeddings``
tables and the ``mlp``'s ``Dense`` kernels, transposed) take
``ranker_params_from_jax`` with the port's net; EASE, ItemKNN and SLIM
carry ``R`` and ``B`` in ``states`` instead of parameters
(``closed_form_states_from_jax``).

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
Both functions take the port's net: its tensors give each table's width,
and a ``kernel`` is a ``Dense``'s only where the net holds an
``nn.Linear`` there; the raw parameters of the interaction layers keep
their name and layout (PNN's ``outer/kernel [D, P,
D]``, CIN's ``conv_{i}``, FmFM's ``field_weight``, FiBiNET's bilinear
``weight``, DCN-Mix's ``U_{i}``, ``V_{i}``, ``C_{i}``, ``bias_{i}``), and a
``TransformerLayer``'s leaves inside a ranker (InterHAt's ``trm``) map
through ``_LAYER_MAP`` as a sequence model's do. The rest of the zoo
follows the same rules: FiGNN's ``GRUCell`` ``gru/{ih,hh}`` kernels
``[in, 3d]`` are ``Linear`` weights ``[3d, in]``, its ``W_out_{i}``,
``W_in_{i}`` and ``bias_{i}``, FinalMLP's ``bilinear [H, d1, d2]``,
AOANet's ``W``, ``alpha`` and ``h``, SAM's ``W``, EDCN's ``cross_w_{i}``,
``cross_b_{i}`` and gates and IFM's ``bias`` are raw and keep their
layout; CCPM's and FGCNN's ``conv_{i}`` ``(h, 1, C_in, C_out)`` kernels
are ``FieldConv`` weights ``[C_out, C_in, h, 1]``, their axes permuted,
where the net holds a ``Conv2d``. The flax ``batch_stats``
collection is the batch norms' ``mean``, ``var``
and ``count`` buffers (``ranker_batch_stats_to_jax`` the reverse). The
same two functions carry DIN, DIEN and the multitask nets: an
``Embedding`` module's ``embedding`` leaf (DIN's and DIEN's
``item_embedding`` and ``item_bias``) is its ``weight``; a ``GRULayer``'s
``<name>/gru_{i}/{ih,hh}`` kernels and biases are its ``nn.GRU`` layer's
(DIEN's extractor, ``AIGRU``); a gated GRU's ``w_ih`` is a ``Linear`` and
its raw ``w_hh [H, 3H]`` keeps its layout; MMoE's ``nn.vmap``-ed bank
``experts/dense_{i}/{kernel,bias}`` is ``ExpertBank``'s ``kernel_{i} [E,
in, out]`` and ``bias_{i}``, untransposed. ``cascade_params_from_jax``
splits a JAX cascade into the ranker's ``state_dict`` and the retriever's,
which the JAX package nests in ``states["retriever"]["params"]``.

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


# a convolution's flax kernel (h, w, in, out) -> the port's Conv2d weight [out, in, h, w]
_HWIO_TO_OIHW = (3, 2, 0, 1)


def _tensor(a, transpose=False) -> torch.Tensor:
    """``a`` as a float32 tensor: transposed where ``transpose`` is True,
    its axes permuted where it is a permutation."""
    a = np.asarray(a, np.float32)
    if transpose is True:
        a = a.T
    elif transpose:
        a = a.transpose(transpose)
    return torch.from_numpy(np.array(a, order="C"))


def _jax_layout(a: np.ndarray, transpose) -> np.ndarray:
    """``_tensor``'s layout change undone."""
    if transpose is True:
        return a.T.copy()
    return a.transpose(np.argsort(transpose)).copy() if transpose else a


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
_TABLES = ("item_encoder", "item_embedding", "user_embedding", "last_item_embedding",
           "embedding_layer")
# raw 3-D kernels stored reversed: Caser's ``horizontal_kernel_{h}``, JAX
# ``(h, D, n_h)``, the port's conv1d weight ``[n_h, D, h]``
_REVERSED = "horizontal_kernel_"


def _port_name(path) -> Tuple[str, bool]:
    """A leaf of a JAX tower's tree -> (the port's parameter name under
    the tower's, transpose)."""
    if path[-1] == "embedding":                     # an embedding table
        return ".".join(path[:-1] + ("weight",)), False
    if path[-1].startswith(_REVERSED):
        return ".".join(path), True
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
    if parts[-1].startswith(_REVERSED):
        return parts, True
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
    """JAX SASRec, BERT4Rec, GRU4Rec, NARM, STAMP, the eight sequence
    retrievers of ``models/seq`` (CL4SRec to NPE), BPR, PMF, CML, NCF,
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


def _owner(net: torch.nn.Module, parts: Tuple[str, ...]):
    """The submodule of ``net`` at ``parts``, or None."""
    try:
        return net.get_submodule(".".join(parts))
    except AttributeError:
        return None


def _ranker_port_name(path: Tuple[str, ...], net: torch.nn.Module):
    """A leaf of a JAX ranker's tree that is not a CTR token table -> (the
    port's name, transpose or an axis permutation). A ``kernel`` is a
    ``Dense``'s, transposed, only where ``net`` holds an ``nn.Linear``; a
    raw ``kernel`` (PNN's ``outer/kernel [D, P, D]``) keeps its layout; a
    leaf where ``net`` holds an ``nn.Conv2d`` is its HWIO kernel."""
    for j, part in enumerate(path[:-2]):
        if part.startswith("gru_") and path[j + 1] in ("ih", "hh"):
            # a GRULayer's <name>/gru_{i}/{ih,hh}/{kernel,bias}
            kind = "weight" if path[-1] == "kernel" else "bias"
            return (".".join(path[:j] + ("layers", part[len("gru_"):]))
                    + f".{kind}_{path[j + 1]}_l0"), kind == "weight"
    if path[0] == "experts" and path[-2].startswith("dense_"):
        # MMoE's bank: experts/dense_{i}/{kernel [E, in, out], bias [E, out]}
        return f"experts.{path[-1]}_{path[-2][len('dense_'):]}", False
    if path[-1] in _LAYER_MAP:                      # a TransformerLayer's leaf
        name, tr = _LAYER_MAP[path[-1]]
        return ".".join(path[:-1] + (name,)), tr
    if path[-1] == "embedding":                     # an Embedding module's table
        return ".".join(path[:-1]) + ".weight", False
    if isinstance(_owner(net, path), torch.nn.Conv2d):
        # a raw convolution kernel (h, w, in, out) that the port holds in a
        # Conv2d (CCPM's and FGCNN's conv_{i}): its weight, axes permuted
        return ".".join(path) + ".weight", _HWIO_TO_OIHW
    owner = _owner(net, path[:-1])
    if path[-1] == "kernel" and isinstance(owner, torch.nn.Linear):
        return ".".join(path[:-1]) + ".weight", True
    if path[-1] == "scale" and isinstance(owner, torch.nn.LayerNorm):
        return ".".join(path[:-1]) + ".weight", False
    return ".".join(path), False


def _ranker_jax_path(parts: Tuple[str, ...], net: torch.nn.Module):
    """``_ranker_port_name``'s inverse: a ``weight`` is a CTR token table,
    an ``Embedding``'s table, a ``Linear``'s kernel, a ``Conv2d``'s HWIO
    kernel, a ``LayerNorm``'s scale, or else a
    raw parameter in the JAX layout (FiBiNET's bilinear ``weight``), as the
    module of ``net`` that holds it says."""
    leaf = parts[-1]
    if parts[-3:-2] == ("layers",) and leaf.endswith("_l0") and leaf.count("_") == 2:
        kind, gate, _ = leaf.split("_")             # {weight,bias}_{ih,hh}_l0
        return parts[:-3] + (f"gru_{parts[-2]}", gate,
                             "kernel" if kind == "weight" else "bias"), kind == "weight"
    if parts[0] == "experts" and leaf.startswith(("kernel_", "bias_")):
        kind, i = leaf.split("_")
        return ("experts", f"dense_{i}", kind), False
    if leaf in _LAYER_UNMAP:
        name, tr = _LAYER_UNMAP[leaf]
        return parts[:-1] + (name,), tr
    if leaf == "weight":
        from ..models.module.ctr import Embeddings
        owner = _owner(net, parts[:-1])
        if isinstance(owner, torch.nn.Embedding):
            if isinstance(_owner(net, parts[:-2]), Embeddings):     # a CTR token table
                return parts[:-1], False
            return parts[:-1] + ("embedding",), False
        if isinstance(owner, torch.nn.Linear):
            return parts[:-1] + ("kernel",), True
        if isinstance(owner, torch.nn.Conv2d):
            return parts[:-1], _HWIO_TO_OIHW
        if isinstance(owner, torch.nn.LayerNorm):
            return parts[:-1] + ("scale",), False
    return parts, False


def _target(sd: Dict[str, torch.Tensor], name: str, shape) -> torch.Tensor:
    """The port net's tensor ``name`` (``sd`` its ``state_dict``); a
    ``KeyError`` or ``ValueError`` where it has none, or one of another
    rank."""
    if name not in sd:
        raise KeyError(f"the port's net has no {name!r}")
    if sd[name].dim() != len(shape):
        raise ValueError(f"{name}: the port's is {tuple(sd[name].shape)}, the JAX leaf's "
                         f"{tuple(shape)}")
    return sd[name]


def _table_width(sd: Dict[str, torch.Tensor], path: Tuple[str, ...], width: int) -> int:
    """The width of the port's token table at ``path`` (``width`` columns in
    the JAX tree): a JAX table is as wide as the port's, or three times as
    wide (params | mu | nu of the row-sparse fit) for an unpacked port
    table; any other width raises."""
    d = _target(sd, ".".join(path) + ".weight", (0, width)).shape[-1]
    if width not in (d, 3 * d):
        raise ValueError(f"{'/'.join(path)}: a JAX table {width} wide for a port table "
                         f"{d} wide")
    return d


def ranker_params_from_jax(tree: Dict[str, Any], net: torch.nn.Module,
                           batch_stats: Dict[str, Any] = None) -> Dict[str, torch.Tensor]:
    """A JAX ranker's params -> the ``state_dict`` of the port's ``net``,
    whose tensors give each table's width and whose modules tell a
    ``Dense`` kernel from a raw parameter. A packed ``[N, 3D]`` table of
    the JAX row-sparse fit (params | mu | nu) is kept whole where ``net``'s
    table is packed, else it gives its first D columns (its moments:
    ``ranker_moments_from_jax``). ``batch_stats``, the flax collection of
    the net's batch norms, gives their ``mean``, ``var`` and ``count``
    buffers. A leaf ``net`` has no tensor for raises."""
    sd, target = {}, net.state_dict()
    for path, value in _leaves(tree):
        a = np.asarray(value, np.float32)
        if _is_token_table(path[-1]):
            d = _table_width(target, path, a.shape[-1])
            sd[".".join(path) + ".weight"] = _tensor(a[:, :d])
        else:
            name, tr = _ranker_port_name(path, net)
            sd[name] = _tensor(a, tr)
            _target(target, name, a.shape)
    for path, value in _leaves(batch_stats or {}):
        sd[".".join(path)] = _tensor(value)
    return sd


def ranker_moments_from_jax(tree: Dict[str, Any], net: torch.nn.Module
                            ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The moments a JAX row-sparse fit keeps in its packed ``[N, 3D]``
    tables: ``{port name: (mu, nu)}``, columns D to 2D and 2D to 3D, the
    dense ``LazyAdam``'s moments of ``net``'s unpacked table."""
    out, target = {}, net.state_dict()
    for path, value in _leaves(tree):
        a = np.asarray(value, np.float32)
        if _is_token_table(path[-1]):
            d = _table_width(target, path, a.shape[-1])
            if a.shape[-1] == 3 * d:
                out[".".join(path) + ".weight"] = (_tensor(a[:, d:2 * d]),
                                                   _tensor(a[:, 2 * d:]))
    return out


def _is_bn_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in _BN_STATS


def ranker_params_to_jax(values: Dict[str, torch.Tensor], net: torch.nn.Module
                         ) -> Dict[str, Any]:
    """``ranker_params_from_jax``'s inverse, for ``net``'s parameters or
    their gradients by the same names (a packed table stays ``[N, 3D]``);
    the batch-norm buffers are left out (``ranker_batch_stats_to_jax``)."""
    out: Dict[str, Any] = {}
    for key, value in values.items():
        if _is_bn_stat(key):
            continue
        parts, tr = _ranker_jax_path(tuple(key.split(".")), net)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _jax_layout(value.detach().cpu().numpy().astype(np.float32), tr)
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


def cascade_params_from_jax(params: Dict[str, Any], states: Dict[str, Any],
                            net: torch.nn.Module, batch_stats: Dict[str, Any] = None
                            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A JAX cascade's ranker params and ``states`` -> ``(the ranker's
    state_dict, the retriever's state_dict)``: the retriever's parameters
    are nested in ``states["retriever"]["params"]`` there
    (``baseranker.py:63-70``), and load into the port's retriever before
    the ranker freezes it."""
    return (ranker_params_from_jax(params, net, batch_stats),
            params_from_jax(_as_numpy(states["retriever"]["params"])))


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


def closed_form_states_from_jax(states: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX EASE's, ItemKNN's or SLIM's ``states`` -> the port's weights of
    the model: ``R`` and ``B`` as float32 tensors, which
    ``model.load_state_dict`` takes for a model with no net."""
    return {k: _tensor(states[k]) for k in ("R", "B")}


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

