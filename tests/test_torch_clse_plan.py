"""The grid plans of the catalog log-partition kernels (K7, K8, K9) and
K7's merge of per-range (max, sum), in plain torch on the CPU.

``csrc/softmax_z.cu`` cuts the long axis of each kernel (items for K7 and
K8, query rows for K9) into S ranges of whole 64-row tiles, sized to the
blocks the card holds at once (``range_plan``). ``plan`` below is that rule
in Python; the tests pin its constants and cost terms to the source, and
the card's tests hold ``splits()`` to it at the card's resident blocks. K7
keeps a running (max, sum) for each (row, thread) of a range, merges the
16 threads of a row in the butterfly order of its shuffles, and merges the
ranges in order; a part that saw no item is (-inf, 0) and is rescaled by 0.
The tests replay that arithmetic in float64 on the ranges the plan cuts
and hold it to ``torch.logsumexp`` (rtol 1e-12: the same sums in another
order, float64 on both sides).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from recstudio_torch.ops.softmax_z import DITEMS_PLAN, DQ_PLAN, FWD_PLAN

CSRC = Path(__file__).resolve().parents[1] / "recstudio_torch" / "csrc"
TILE = 64
PEAK_OPS, PEAK_BYTES, TILE_SHARE, MAX_SPLITS = 67e12, 3.35e12, 0.5, 1024


def _cdiv(a, b):
    return -(-a // b)


def plan(kind, M, N, D, resident):
    """``(splits, per)``: what ``rs_catalog_lse_splits`` returns on a card
    that holds ``resident`` blocks of the kind's kernel at once."""
    rows, items = _cdiv(M, TILE), _cdiv(N, TILE)
    R, T = (items, rows) if kind == DITEMS_PLAN else (rows, items)
    if kind == FWD_PLAN:
        ops, (a, b, c), unit = TILE * TILE * 2 * D, (D + 4.0, 1.0, D + 1.0), M
    else:
        ops, (a, b, c) = TILE * TILE * 4 * D, (3.0, 1.0, 2.0)
        unit = (N if kind == DITEMS_PLAN else M) * D
    resident = max(resident, 1)
    tile_s = resident * ops / (PEAK_OPS * TILE_SHARE)
    unit_s = unit * 4 / PEAK_BYTES
    best, best_s = (1, T), math.inf
    for s in range(1, min(T, MAX_SPLITS) + 1):
        per = _cdiv(T, s)
        if _cdiv(T, per) != s:
            continue
        t = _cdiv(R * s, resident) * per * tile_s + (a * s + b if s > 1 else c) * unit_s
        if t < best_s:
            best, best_s = (s, per), t
    return best


def test_plan_constants_are_the_kernels():
    """``plan``'s tile, rates, share, cap, kinds and cost terms are those
    of ``softmax_z.cu``; K7 and K9 run on the register tile (``score_dots``,
    K9's product ``pv_product``), and the first version's helpers and fixed
    plan are gone."""
    src = (CSRC / "softmax_z.cu").read_text()
    assert f"constexpr int kT = {TILE};" in src
    assert ("constexpr double kPeakOps = 67e12, kPeakBytes = 3.35e12, kTileShare = 0.5;"
            in src)
    assert f"constexpr int kMaxSplits = {MAX_SPLITS};" in src
    assert (f"constexpr int kFwd = {FWD_PLAN}, kDitems = {DITEMS_PLAN}, kDq = {DQ_PLAN};"
            in src)
    cost = r"return range_plan\((.+?)\);"
    fwd, ditems, dq = (re.search(r"Plan " + name + r"\(int M, int N, int D, int resident\) "
                                 r"\{\s*" + cost, src, re.S).group(1).split()
                       for name in ("fwd_plan", "ditems_plan", "dq_plan"))
    assert " ".join(fwd) == ("cdiv(M, kT), cdiv(N, kT), (double)kT * kT * 2 * D, D + 4.0, "
                             "1.0, D + 1.0, (double)M, resident")
    assert " ".join(ditems) == ("cdiv(N, kT), cdiv(M, kT), (double)kT * kT * 4 * D, 3.0, "
                                "1.0, 2.0, (double)N * D, resident")
    assert " ".join(dq) == ("cdiv(M, kT), cdiv(N, kT), (double)kT * kT * 4 * D, 3.0, 1.0, "
                            "2.0, (double)M * D, resident")
    assert "const double t = waves * per * tile_s + (s > 1 ? a * s + b : c) * unit_s;" in src
    assert "if (cdiv(T, per) != s) continue;" in src
    for gone in ("tile_scores", "load_rows", "kLdp", "tiles_smem", "make_plan", "rows_plan",
                 "items_plan", "kTargetBlocks"):
        assert re.search(r"\b" + gone + r"\b", src) is None, gone
    assert src.count("score_dots<RI, CJ, LD>(sc, qs, its") == 2          # K7, K8
    assert src.count("score_dots<RI, CJ, LD>(sc, its, qs, D, ty, tx);") == 1   # K9
    assert "pv_product<RI, DK, kT, LD, LDP>(acc, ps, qs, ty, tx);" in src     # K9
    assert "pv_product<RI, DK, kT, LD, LDP>(acc, ps, its, ty, tx);" in src    # K8


@pytest.mark.parametrize("kind", [FWD_PLAN, DITEMS_PLAN, DQ_PLAN], ids=["K7", "K9", "K8"])
@pytest.mark.parametrize("M,N,D", [(51200, 3706, 64), (512, 500_000, 64), (10240, 1574, 64),
                                   (40, 20000, 8), (20000, 100, 33), (7, 3, 256)])
def test_plan_cuts_whole_tiles_without_an_empty_range(kind, M, N, D):
    """At residencies of one to four blocks an SM on 132 SMs, the plan's S
    ranges of ``per`` tiles cover the long axis once, none empty."""
    T = _cdiv(M if kind == DITEMS_PLAN else N, TILE)
    for resident in (132, 264, 396, 528):
        S, per = plan(kind, M, N, D, resident)
        assert 1 <= S <= min(T, MAX_SPLITS) and per == _cdiv(T, S)
        assert (S - 1) * per < T <= S * per


def _kernel_logz(scores, per, splits):
    """K7's arithmetic on ``scores [M, N]`` (float64): for each range of
    ``per`` tiles, a running (max, sum) for each (row, thread tx) over the
    columns tx + 16 j of each tile, past the range -inf; the 16 threads
    merged in the shuffles' order; the ranges merged in order
    (``lse_merge_kernel``). Returns logZ and the ranges' partials."""
    M, N = scores.shape
    inf = math.inf
    rescale = lambda mk, mn: torch.where(mk == -inf, 0.0, torch.exp(mk - mn))
    cols = torch.arange(16)[:, None] + 16 * torch.arange(TILE // 16)[None, :]   # [tx, j]
    parts = []
    for s in range(splits):
        n_begin = s * per * TILE
        n_end = min(N, n_begin + per * TILE)
        m = torch.full((M, 16), -inf, dtype=torch.float64)
        l = torch.zeros((M, 16), dtype=torch.float64)
        for n0 in range(n_begin, n_end, TILE):
            at = n0 + cols
            sc = torch.where(at < n_end, scores[:, at.clamp(max=N - 1)], -inf)
            mnew = torch.maximum(m, sc.amax(-1))
            alpha = torch.where(torch.isinf(m) & torch.isinf(mnew), 0.0, torch.exp(m - mnew))
            total = torch.where(torch.isinf(mnew), 0.0,
                                torch.exp(sc - mnew[..., None]).sum(-1))
            l, m = l * alpha + total, mnew
        for o in (8, 4, 2, 1):
            other = torch.arange(16) ^ o
            mo, lo = m[:, other], l[:, other]
            mn = torch.maximum(m, mo)
            l, m = l * rescale(m, mn) + lo * rescale(mo, mn), mn
        parts.append((m[:, 0], l[:, 0]))
    if splits == 1:
        m, l = parts[0]
        return m + torch.log(l), parts
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros(M, dtype=torch.float64)
    for mk, lk in parts:
        l = l + lk * rescale(mk, m)
    return m + torch.log(l), parts


@pytest.mark.parametrize("M,N,D,resident,ranges", [
    (3, 5, 8, 396, 1), (5, 64 * 9 + 7, 16, 4, 4), (4, 3706, 64, 132, 58),
    (70, 1574, 64, 396, 25), (2, 64 * 40 + 1, 33, 3, 3)],
    ids=["N5", "ragged", "F-items", "G-items", "last-tile-one-item"])
def test_in_order_merge_of_the_plans_ranges_is_logsumexp(M, N, D, resident, ranges):
    """K7's partials over the ranges its plan cuts, merged in order, give
    ``torch.logsumexp`` in float64: threads that see no item of a tile or of
    their whole range (N 5: threads 5-15; ragged last tiles) hold (-inf, 0)
    and drop out of the merge."""
    rng = np.random.default_rng(M + N + D)
    q = torch.from_numpy(rng.normal(size=(M, D)))
    items = torch.from_numpy(rng.normal(0.0, 0.3, size=(N, D)))
    scores = q @ items.t()
    S, per = plan(FWD_PLAN, M, N, D, resident)
    assert S == ranges
    got, parts = _kernel_logz(scores, per, S)
    want = torch.logsumexp(scores, -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0)
    assert len(parts) == S and all(bool((lk >= 1).all()) for _, lk in parts)


def test_an_empty_range_contributes_minus_inf_and_zero():
    """A range with no item (past N) stays (-inf, 0) through the threads'
    merge, and merging it with the others changes no bit of logZ."""
    rng = np.random.default_rng(11)
    scores = torch.from_numpy(rng.normal(size=(6, 200)))
    full, _ = _kernel_logz(scores, 1, 4)            # 4 ranges of one tile: items 0-199
    padded, parts = _kernel_logz(scores, 1, 5)      # a fifth range, all past N
    m, l = parts[-1]
    assert bool((m == -math.inf).all()) and bool((l == 0).all())
    assert torch.equal(full, padded)
    assert not bool(torch.isnan(padded).any())
