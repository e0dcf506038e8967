"""Parameter (re)initialisation by parameter role.

Counterpart of ``recstudio_tpu/models/init.py``: embedding tables and
projection weights get N(0, init_range), xavier normal or xavier uniform;
biases 0; LayerNorm weights 1. Row 0 of every embedding table (the
``[PAD]`` row) is zeroed, and ``zero_pad_rows_in_grads`` keeps it so in
training. Draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
from torch import nn


def _draw(shape, method: str, init_range: float, generator: torch.Generator,
          fans=None) -> torch.Tensor:
    fan_out, fan_in = fans or (shape[0], shape[1])
    if method == "normal":
        return init_range * torch.randn(shape, generator=generator)
    if method == "xavier_uniform":
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * limit
    if method == "xavier_normal":
        return ((2.0 / (fan_in + fan_out)) ** 0.5) * torch.randn(shape, generator=generator)
    raise ValueError(f"unknown init method {method}")


def _flax_fans(shape):
    """flax's fans (``variance_scaling``, in axis -2, out axis -1): each
    scaled by the product of the other axes."""
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return shape[-1] * receptive, shape[-2] * receptive


# initializers a module declares for a raw parameter of its own
# (``raw_init``), the flax initializer the JAX module declares there
RAW_INITS = {
    "normal": lambda shape, g: torch.randn(shape, generator=g),
    "normal_0.02": lambda shape, g: 0.02 * torch.randn(shape, generator=g),
    "xavier_uniform": lambda shape, g: _draw(shape, "xavier_uniform", 0.0, g, _flax_fans(shape)),
    "xavier_normal": lambda shape, g: _draw(shape, "xavier_normal", 0.0, g, _flax_fans(shape)),
    # a conv1d weight [out, in, width], whose flax kernel is (width, in, out)
    "xavier_normal_conv1d": lambda shape, g: _draw(shape, "xavier_normal", 0.0, g,
                                                   _flax_fans(shape[::-1])),
    # a conv2d weight [out, in, h, w], whose flax kernel is (h, w, in, out)
    "xavier_uniform_hwio": lambda shape, g: _draw(
        shape, "xavier_uniform", 0.0, g, _flax_fans((shape[2], shape[3], shape[1], shape[0]))),
}


def _lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in`` (fan_in ``shape[0]``)."""
    x = torch.randn(shape, generator=generator)
    bad = x.abs() > 2.0
    while bad.any():
        x[bad] = torch.randn(int(bad.sum()), generator=generator)
        bad = x.abs() > 2.0
    return x * (shape[0] ** -0.5 / 0.87962566103423978)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator,
                    method: str = "xavier_normal", init_range: float = 0.02) -> None:
    """Re-initialise ``module``'s parameters in place, by role:

    - a raw parameter that its module names in ``raw_init`` (``{name:
      initializer}``, a key of ``RAW_INITS``): that initializer, which the
      JAX module declares and the JAX rule by name leaves (CIN's ``conv_{i}``,
      FmFM's ``field_weight``, the bilinear ``weight``, DCN-Mix's ``U_{i}``,
      ``V_{i}``, ``C_{i}``, ``bias_{i}``, HGN's ``W_g_4``, Caser's
      ``horizontal_kernel_{h}``, EDCN's ``cross_w_{i}``, FinalMLP's
      ``bilinear``, FiGNN's ``W_out_{i}`` and ``W_in_{i}``, CCPM's and
      FGCNN's convolution weights);
    - ``*norm*_weight``: 1; ``*bias`` and ``bias_*`` (a GRU's): 0;
    - 2-D ``*weight``, ``weight_*`` and ``*kernel`` (embedding tables,
      projections, a GRU's ``weight_ih_l0 [3H, in]`` and ``weight_hh_l0
      [3H, H]``, whose fans are the JAX ``[in, 3H]`` kernel's, Caser's
      ``vertical_kernel``): ``method``, with row 0 of embedding tables set
      to 0;
    - a 2-D parameter named ``*embedding*`` (the CTR ``dense_embedding``
      kernel ``[Fd, D]``): ``method``, with row 0 set to 0, as the JAX rule
      by name does to every ``embedding`` leaf;
    - a gated GRU's raw ``w_hh [H, 3H]``: LeCun normal (truncated at two
      standard deviations, variance 1 / H), the initializer the JAX module
      declares (its rule by name leaves it); an expert bank's
      ``[E, in, out]`` kernels, and a 3-D ``W`` (SAM's, AOANet's: the JAX
      rule lower-cases it to ``w``, a kernel): ``method`` with the fans
      ``E in`` and ``E out``, as the JAX rule reads the stacked leaf's
      (``init.py:18-25``);
    - any other 2-D parameter (learned position tables): N(0, 0.02), the
      initializer the JAX modules declare for them;
    - a 1-D parameter ``w_{i}`` (DCN's cross weights): N(0, 1), the
      initializer the JAX module declares (its rule by name leaves them);
      every other 1-D parameter keeps the value its module gave it (a
      batch norm's ``scale`` 1, ``Dice``'s ``alpha`` 0).
    """
    embeddings = {id(m.weight) for m in module.modules() if isinstance(m, nn.Embedding)}
    raw = {id(getattr(m, n)): RAW_INITS[kind] for m in module.modules()
           for n, kind in getattr(m, "raw_init", {}).items()}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in raw:
            p.copy_(raw[id(p)](tuple(p.shape), generator))
        elif "norm" in leaf and leaf.endswith("weight"):
            p.fill_(1.0)
        elif leaf.endswith("bias") or leaf.startswith("bias_"):
            p.zero_()
        elif (leaf.endswith(("weight", "kernel")) or leaf.startswith("weight_")) \
                and p.dim() == 2:
            p.copy_(_draw(tuple(p.shape), method, init_range, generator))
            if id(p) in embeddings:
                p[0].zero_()
        elif leaf == "w_hh" and p.dim() == 2:
            p.copy_(_lecun_normal(tuple(p.shape), generator))
        elif (leaf in ("kernel", "W") or leaf.startswith("kernel_")) and p.dim() == 3:
            E, n_in, n_out = p.shape
            p.copy_(_draw(tuple(p.shape), method, init_range, generator,
                          fans=(E * n_out, E * n_in)))
        elif "embedding" in leaf and p.dim() == 2:
            p.copy_(_draw(tuple(p.shape), method, init_range, generator))
            p[0].zero_()
        elif p.dim() == 2:
            p.copy_(0.02 * torch.randn(tuple(p.shape), generator=generator))
        elif p.dim() == 1 and leaf.startswith("w_"):
            p.copy_(torch.randn(tuple(p.shape), generator=generator))


@torch.no_grad()
def zero_pad_rows_in_grads(module: nn.Module) -> None:
    """Zero the gradient of the ``[PAD]`` row (row 0) of every embedding
    table (``init.py:67-79``). Learned position tables are not embedding
    tables and keep theirs."""
    for m in module.modules():
        if isinstance(m, nn.Embedding) and m.weight.grad is not None:
            m.weight.grad[0].zero_()
