"""Attention-gated GRUs of the DIEN family.

Counterpart of ``recstudio_tpu/models/module/gru.py``. Each takes ``x [B,
L, D]`` and per-step attention scores ``att [B, L]`` and returns every
step's state ``[B, L, H]`` and the last state ``[B, H]`` (``AIGRU`` the
states alone, as the JAX module):

- ``AGRU``: the score replaces the update gate, ``h_t = (1 - a_t) h_{t-1}
  + a_t n_t``;
- ``AUGRU``: the score scales it, ``u'_t = a_t u_t``, ``h_t = (1 - u'_t)
  h_{t-1} + u'_t n_t``;
- ``AIGRU``: a plain ``GRULayer`` over ``att * x``.

``AGRU`` and ``AUGRU`` share ``_GatedGRU`` (``gru.py:22-55``): ``w_ih``, a
``Linear(D, 3H)``, is applied once over ``[B, L, D]`` before the time
loop, and ``w_hh`` is a raw ``[H, 3H]`` parameter (``h @ w_hh``); the
gates are ``r | u | n`` blocks and ``n = tanh(i_n + r h_n)``, as the JAX
scan's. The JAX package runs a ``lax.scan`` here, not a Pallas kernel, and
cuDNN has no attention-gated cell, so on every device the loop is PyTorch's
own, one step a position, and autograd takes its backward.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import GRULayer


class _GatedGRU(nn.Module):
    """The time loop of ``AGRU`` (``mode="replace"``) and ``AUGRU``
    (``mode="scale"``)."""

    def __init__(self, input_size: int, hidden_size: int, mode: str):
        super().__init__()
        if mode not in ("replace", "scale"):
            raise ValueError(f"unknown gated GRU mode {mode!r}")
        self.hidden_size, self.mode = hidden_size, mode
        self.w_ih = nn.Linear(input_size, 3 * hidden_size)
        self.w_hh = nn.Parameter(torch.zeros(hidden_size, 3 * hidden_size))

    def forward(self, x: torch.Tensor, att: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, H = x.shape[0], x.shape[1], self.hidden_size
        gi_all = self.w_ih(x)                                    # [B, L, 3H], hoisted
        h = gi_all.new_zeros(B, H)
        hs = []
        for t in range(L):
            gi, gh = gi_all[:, t], torch.matmul(h, self.w_hh)
            r = torch.sigmoid(gi[:, :H] + gh[:, :H])
            u = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
            a = att[:, t, None]
            gate = a * u if self.mode == "scale" else a
            h = (1.0 - gate) * h + gate * n
            hs.append(h)
        return torch.stack(hs, dim=1), h


class AGRU(nn.Module):
    """GRU whose update gate is the attention score (``gru.py:58-65``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.cell = _GatedGRU(input_size, hidden_size, "replace")

    def forward(self, x: torch.Tensor, att: torch.Tensor):
        return self.cell(x, att)


class AUGRU(nn.Module):
    """GRU whose update gate is scaled by the attention score
    (``gru.py:68-74``)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.cell = _GatedGRU(input_size, hidden_size, "scale")

    def forward(self, x: torch.Tensor, att: torch.Tensor):
        return self.cell(x, att)


class AIGRU(nn.Module):
    """A plain GRU over the attention-scaled inputs (``gru.py:77-86``):
    every step's state ``[B, L, H]``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.gru = GRULayer(input_size, hidden_size)

    def forward(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        return self.gru(x * att[:, :, None])
