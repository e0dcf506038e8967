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


def _draw(shape, method: str, init_range: float, generator: torch.Generator) -> torch.Tensor:
    fan_out, fan_in = shape[0], shape[1]
    if method == "normal":
        return init_range * torch.randn(shape, generator=generator)
    if method == "xavier_uniform":
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * limit
    if method == "xavier_normal":
        return ((2.0 / (fan_in + fan_out)) ** 0.5) * torch.randn(shape, generator=generator)
    raise ValueError(f"unknown init method {method}")


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator,
                    method: str = "xavier_normal", init_range: float = 0.02) -> None:
    """Re-initialise ``module``'s parameters in place, by role:

    - ``*norm*_weight``: 1; ``*bias`` and ``bias_*`` (a GRU's): 0;
    - 2-D ``*weight`` and ``weight_*`` (embedding tables, projections, a
      GRU's ``weight_ih_l0 [3H, in]`` and ``weight_hh_l0 [3H, H]``, whose
      fans are the JAX ``[in, 3H]`` kernel's): ``method``, with row 0 of
      embedding tables set to 0;
    - a 2-D parameter named ``*embedding*`` (the CTR ``dense_embedding``
      kernel ``[Fd, D]``): ``method``, with row 0 set to 0, as the JAX rule
      by name does to every ``embedding`` leaf;
    - any other 2-D parameter (learned position tables): N(0, 0.02), the
      initializer the JAX modules declare for them.
    """
    embeddings = {id(m.weight) for m in module.modules() if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if "norm" in leaf and leaf.endswith("weight"):
            p.fill_(1.0)
        elif leaf.endswith("bias") or leaf.startswith("bias_"):
            p.zero_()
        elif (leaf.endswith("weight") or leaf.startswith("weight_")) and p.dim() == 2:
            p.copy_(_draw(tuple(p.shape), method, init_range, generator))
            if id(p) in embeddings:
                p[0].zero_()
        elif "embedding" in leaf and p.dim() == 2:
            p.copy_(_draw(tuple(p.shape), method, init_range, generator))
            p[0].zero_()
        elif p.dim() == 2:
            p.copy_(0.02 * torch.randn(tuple(p.shape), generator=generator))


@torch.no_grad()
def zero_pad_rows_in_grads(module: nn.Module) -> None:
    """Zero the gradient of the ``[PAD]`` row (row 0) of every embedding
    table (``init.py:67-79``). Learned position tables are not embedding
    tables and keep theirs."""
    for m in module.modules():
        if isinstance(m, nn.Embedding) and m.weight.grad is not None:
            m.weight.grad[0].zero_()
