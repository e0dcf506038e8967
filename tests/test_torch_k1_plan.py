"""The tile plan of the fused layer's forward (K1) and the order of its
fused epilogues, in plain torch on the CPU.

K1's four products run on ``csrc/sgemm_tile.cuh`` (``block_product_nt``)
with their epilogues fused: bias and activation, the dropout factor at the
element's index in the tensor its site drops from, the residual, and
LayerNorm over the D real columns of a tile that may be wider than D (its
weight rows past D are staged as zeros). ``ops.transformer_layer`` mirrors
the widest tile; these tests pin the mirror to the sources and check, in
float64, that the epilogues' order on a zero-padded tile gives
``layer_tail``'s result. Tolerances: float64 on both sides, rtol 1e-9 /
atol 1e-10.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from recstudio_torch.ops.dropout import SITE_FFN_HIDDEN, SITE_FFN_OUT, SITE_OUT, keep_scale
from recstudio_torch.ops.transformer_layer import (K1_GEMM_TILE, K2_GEMM_TILE, gelu_tanh,
                                                   layer_tail, param_shapes)

CSRC = Path(__file__).resolve().parents[1] / "recstudio_torch" / "csrc"


def test_k1_tile_constants_are_the_kernel_plan():
    """``K1_GEMM_TILE`` is the widest product tile K1 launches (rows and
    columns a block, k-slice): ``GemmTile<8, 8>`` of ``sgemm_tile.cuh``,
    through ``block_product_nt`` in both of K1's product kernels, whose
    earlier SIMT kernels are gone."""
    tile = (CSRC / "sgemm_tile.cuh").read_text()
    plan = re.search(r"template <int TM_, int TN_, int BK_ = (\d+), int STAGES_ = \d+>", tile)
    assert plan is not None and int(plan.group(1)) == K1_GEMM_TILE[2]
    assert "static constexpr int BM = 16 * TM, BN = 16 * TN;" in tile
    assert "__device__ __forceinline__ void block_product_nt(" in tile
    fwd = (CSRC / "transformer_layer.cu").read_text()
    assert '#include "sgemm_tile.cuh"' in fwd
    assert "if (t.tm == 8 && t.tn == 8) return f(GemmTile<8, 8>());" in fwd
    assert "if (t.tn == 16) return f(GemmTile<4, 16>());" in fwd
    assert fwd.count("block_product_nt<T>(acc, smem, A, W, M,") == 2
    for gone in ("gemm_bias_act_kernel", "gemm_residual_ln_kernel", "kLnRows"):
        assert gone not in fwd
    assert K1_GEMM_TILE[:2] == (16 * 8, 16 * 8) and K1_GEMM_TILE == K2_GEMM_TILE


def _ln_tile_width(D):
    """The columns of K1's LayerNorm tile: one tile across D."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _residual_ln_tile(A, W, bias, res, gamma, beta, eps, p, seed, site, real_only=True):
    """Steps 3 and 5 as the kernel orders them, on a tile of
    ``_ln_tile_width(D)`` columns whose weight rows past D are zeros: y =
    (A W^T + bias) * keep(site, m D + c) + res, zero past D; the mean and
    the variance over the D real columns (over the whole tile when not
    ``real_only``)."""
    M, D = res.shape
    width = _ln_tile_width(D)
    Wp = torch.zeros((width, W.shape[1]), dtype=W.dtype)
    Wp[:D] = W
    pad = lambda t: torch.cat([t, torch.zeros(t.shape[:-1] + (width - D,), dtype=t.dtype)], -1)
    keep = keep_scale((M, D), p, seed, site, "cpu").double()
    real = torch.arange(width) < D
    y = (A @ Wp.t() + pad(bias)) * pad(keep) + pad(res)
    y = torch.where(real, y, 0.0)
    n = D if real_only else width
    mu = y.sum(-1, keepdim=True) / n
    dv = torch.where(real, y - mu, 0.0) if real_only else y - mu
    inv = torch.rsqrt((dv * dv).sum(-1, keepdim=True) / n + eps)
    xhat = (y - mu) * inv
    return (xhat * pad(gamma) + pad(beta))[:, :D], xhat[:, :D], inv[:, 0]


def _fused_tail(x, attn, params, activation, eps, p, seed, real_only=True):
    """K1's steps 3-5 in the kernels' order: ``(out, hpre, h)``."""
    B, L, D = x.shape
    M = B * L
    a = attn.transpose(1, 2).reshape(M, D)
    x1, _, _ = _residual_ln_tile(a, params["out_proj_weight"], params["out_proj_bias"],
                                 x.reshape(M, D), params["norm1_weight"], params["norm1_bias"],
                                 eps, p, seed, SITE_OUT, real_only)
    hpre = x1 @ params["linear1_weight"].t() + params["linear1_bias"]
    F = hpre.shape[1]
    act = gelu_tanh(hpre) if activation == "gelu" else torch.relu(hpre)
    h = act * keep_scale((M, F), p, seed, SITE_FFN_HIDDEN, "cpu").double()
    out, _, _ = _residual_ln_tile(h, params["linear2_weight"], params["linear2_bias"], x1,
                                  params["norm2_weight"], params["norm2_bias"], eps, p, seed,
                                  SITE_FFN_OUT, real_only)
    return out.reshape(B, L, D), hpre, h


@pytest.mark.parametrize("D,H,F,activation", [
    (96, 3, 160, "gelu"), (96, 3, 160, "relu"), (64, 2, 128, "gelu"), (64, 2, 128, "relu")],
    ids=["d96-gelu", "d96-relu", "d64-gelu", "d64-relu"])
def test_fused_epilogue_order_gives_layer_tail(D, H, F, activation):
    """Bias, activation or keep factor, residual, then LayerNorm over the D
    real columns of a zero-padded tile (d 96 pads to 128; d 64 fills 64),
    at dropout 0.5: ``layer_tail``'s output. Over the whole padded tile the
    statistics would differ, so the test sees the padding."""
    rng = np.random.default_rng(D + F + len(activation))
    B, L, eps, p, seed = 3, 7, 1e-5, 0.5, 41
    x = torch.from_numpy(rng.normal(size=(B, L, D)))
    attn = torch.from_numpy(rng.normal(size=(B, H, L, D // H)))
    params = {name: torch.from_numpy(rng.normal(size=shape) * (0.2 if len(shape) == 2 else 1.0))
              for name, shape in param_shapes(D, F).items() if name[:2] != "in"}
    want = layer_tail(x, attn, params, activation, eps, p, seed)
    got, hpre, h = _fused_tail(x, attn, params, activation, eps, p, seed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-10)
    dropped = float((h == 0).double().mean())
    assert 0.4 < dropped < 0.6 or activation == "relu"
    assert hpre.shape == (B * L, F)
    if _ln_tile_width(D) > D:
        wide, _, _ = _fused_tail(x, attn, params, activation, eps, p, seed, real_only=False)
        assert float((wide - want).abs().max()) > 1e-3
