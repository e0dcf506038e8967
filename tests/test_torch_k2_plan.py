"""The tile plans of the fused layer's backward (K2) and the function its
attention steps compute, in plain torch on the CPU.

K2's products run on ``csrc/sgemm_tile.cuh`` and its attention steps on the
flash backward kernels (``csrc/flash_attention.cu``) at a tile plan of its
own; ``ops.transformer_layer`` mirrors both plans, and these tests pin the
mirrors to the sources and check that skipping the tile pairs the masks
cover fully, with the dropout of P, keeps the gradients. Tolerances: float64
on both sides, rtol 1e-9 / atol 1e-10.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from recstudio_torch.ops.attention import NEG, _raw_logits, additive_masks, mha_plain, mha_tiles
from recstudio_torch.ops.dropout import SITE_ATTN, keep_scale
from recstudio_torch.ops.transformer_layer import K2_ATTN_TILE, K2_GEMM_TILE

CSRC = Path(__file__).resolve().parents[1] / "recstudio_torch" / "csrc"


def test_k2_tile_constants_are_the_kernel_plan():
    """``K2_GEMM_TILE`` is the widest product tile K2 launches (rows and
    columns a block, k-slice) and ``K2_ATTN_TILE`` the (query rows, keys) of
    its attention steps at Dh <= 128."""
    tile = (CSRC / "sgemm_tile.cuh").read_text()
    plan = re.search(r"template <int TM_, int TN_, int BK_ = (\d+), int STAGES_ = \d+>", tile)
    assert plan is not None and int(plan.group(1)) == K2_GEMM_TILE[2]
    assert "static constexpr int BM = 16 * TM, BN = 16 * TN;" in tile
    bwd = (CSRC / "transformer_layer_bwd.cu").read_text()
    assert "inline int tile_side(int n) { return n <= 64 ? 4 : 8; }" in bwd
    assert "if (tm == 8 && tn == 8) return f(GemmTile<8, 8>());" in bwd
    assert K2_GEMM_TILE[:2] == (16 * 8, 16 * 8)
    flash = (CSRC / "flash_attention.cu").read_text()
    attn = re.search(r"constexpr int kLayerRows = (\d+), kLayerKeys = (\d+);", flash)
    assert attn is not None and tuple(map(int, attn.groups())) == K2_ATTN_TILE
    body = flash[flash.index("cudaError_t rs_launch_mha_bwd_train("):]
    assert "constexpr int RI = kLayerRows / 16, CJ = kLayerKeys / 16;" in body
    assert re.search(r"if \(p\.Dh <= 128\) return launch_bwd<RI, CJ, 8, true>", body)


def _tile_skipped_layer_attention_bwd(q, k, v, pad, attn, keep, g):
    """K2's attention steps as the kernels compute them: P from the row
    statistics K3 stores, the dropout factors read only where P is not 0,
    dP = (g v^T) o keep, delta = rowsum(g o A), and only the pairs of
    ``K2_ATTN_TILE`` tiles that hold an allowed pair (``mha_tiles``) or
    whose query tile holds a row with no allowed key. Returns ``(dq, dk,
    dv)`` and the bool ``[B, Lq, Lk]`` pairs computed."""
    tq, tk = K2_ATTN_TILE
    L = q.shape[2]
    tiles, empty = mha_tiles(pad, attn, L, L, tq, tk)
    computed = (tiles | empty[:, :, None]).repeat_interleave(tq, 1) \
        .repeat_interleave(tk, 2)[:, :L, :L]
    raw = _raw_logits(q, k, *additive_masks(pad, attn))
    s = torch.clamp_min(raw, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) / torch.exp(s - m).sum(dim=-1, keepdim=True)
    kp = torch.where(p != 0, keep, 0.0)
    out = (p * kp) @ v
    delta = (g * out).sum(dim=-1, keepdim=True)
    ds = torch.where(raw >= NEG, p * ((g @ v.transpose(-1, -2)) * kp - delta), 0.0)
    on = computed[:, None]
    ds, pk = torch.where(on, ds, 0.0), torch.where(on, p * kp, 0.0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (ds @ k * scale, ds.transpose(-1, -2) @ q * scale, pk.transpose(-1, -2) @ g), computed


@pytest.mark.parametrize("L,lens,causal", [
    (200, (0, 63, 64, 65), True), (37, (0, 5, 37, 20), True), (200, (0, 63, 64, 200), False)],
    ids=["causal-tile-borders-padded", "l37-causal-padded", "no-attn-mask-padded"])
def test_skipping_masked_tiles_keeps_the_layer_attention_backward(L, lens, causal):
    """Skipping the tile pairs at ``K2_ATTN_TILE`` that the masks cover
    fully, with dropout of P (rate 0.5) whose bits are read only where P is
    not 0, gives autograd's dq, dk, dv of the dropped attention
    (``mha_plain`` with the keep factors), with right padding at tile
    borders and example 0 fully padded: its P = 1 / L weighs every key, so
    all its pairs are computed."""
    rng = np.random.default_rng(L + len(lens) + causal)
    B, H, Dh = len(lens), 2, 8
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, L, Dh))) for _ in range(4))
    pad = torch.from_numpy(np.arange(L)[None, :] >= np.asarray(lens)[:, None])
    attn = torch.triu(torch.ones((L, L), dtype=torch.bool), 1) if causal else None
    keep = keep_scale((B, H, L, L), 0.5, 11, SITE_ATTN, "cpu").double()
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(mha_plain(qs, ks, vs, *additive_masks(pad, attn), keep),
                               (qs, ks, vs), g)
    got, computed = _tile_skipped_layer_attention_bwd(q, k, v, pad, attn, keep, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-10, err_msg=name)
    if L > max(K2_ATTN_TILE):          # more than one tile: some pair is skipped
        assert not bool(computed.all())
    assert bool(computed[0].all()) and float(want[0][0].abs().max()) > 1e-3
    if causal:   # no key tile past a query tile's last row
        tq, tk = K2_ATTN_TILE
        for i in range(-(-L // tq)):
            first = -(-((i + 1) * tq) // tk) * tk
            assert not bool(computed[1:, i * tq:(i + 1) * tq, first:].any())
