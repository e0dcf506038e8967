"""CUDA kernels of recstudio_torch against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip. Run on the
card with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``
(``--noconftest``: the shared conftest imports JAX, which the card lacks).
Tolerances: float32 throughout (TF32 off); sums are taken in another order
than PyTorch's, so results agree to float32 rounding, not bit for bit.
"""
import numpy as np
import pytest
import torch

from recstudio_torch.models.module import TransformerLayer
from recstudio_torch.ops.attention import (additive_masks, flash_mha_bwd_dkv,
                                           flash_mha_bwd_dkv_plain, flash_mha_bwd_dq,
                                           flash_mha_bwd_dq_plain, flash_mha_fwd,
                                           flash_mha_plain, fused_mha, mha_fwd, mha_plain)
from recstudio_torch.ops.softmax_z import (catalog_logsumexp, catalog_logsumexp_ditems,
                                           catalog_logsumexp_ditems_plain, catalog_logsumexp_dq,
                                           catalog_logsumexp_dq_plain, catalog_logsumexp_fwd,
                                           catalog_logsumexp_plain)
from recstudio_torch.ops.transformer_layer import (PARAM_NAMES, fused_transformer_layer,
                                                   fused_transformer_layer_bwd,
                                                   training_residuals,
                                                   transformer_layer_bwd_plain,
                                                   transformer_layer_plain)
from recstudio_torch.utils.convert import layer_params_from_jax, random_sasrec_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _masks(rng, B, L, dev, all_masked_row=False):
    lens = rng.integers(1, L + 1, size=B)
    pad = np.arange(L)[None, :] >= lens[:, None]
    if all_masked_row:
        pad[0] = True
    causal = torch.triu(torch.ones((L, L), dtype=torch.bool, device=dev), 1)
    return torch.from_numpy(pad).to(dev), causal


def _mha_inputs(dev, B, H, Lq, Lk, Dh, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    return rng, q, k, v


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal,padding", [
    (3, 2, 20, 20, 32, True, "random"), (2, 2, 200, 200, 64, True, "random"),
    (2, 1, 384, 384, 128, True, "random"), (2, 4, 7, 45, 16, False, "random"),
    (1, 1, 33, 512, 256, False, "random"),
    (4, 2, 200, 200, 64, True, "right"), (3, 2, 384, 384, 64, True, "right"),
    (4, 2, 200, 200, 32, False, "right"), (3, 2, 150, 300, 128, True, "right"),
    (2, 1, 200, 200, 256, True, "right"), (3, 2, 100, 100, 30, True, "right"),
    (2, 2, 77, 130, 37, False, "random")],
    ids=["L20-dh32", "L200-dh64", "L384-dh128", "lq7-lk45-dh16", "lk512-dh256",
         "B-right", "C-right", "F-right-dh32", "lq150-lk300-dh128", "L200-dh256",
         "dh30", "lq77-lk130-dh37"])
def test_fused_mha_matches_plain(dev, B, H, Lq, Lk, Dh, causal, padding):
    """K3 against mha_plain (TOL_K3: rtol 1e-4, atol 2e-5; outputs are
    averages of v): ragged tiles, Lq != Lk, every head width of the plan,
    and widths that are not a multiple of 4 (4-byte copies)."""
    rng, q, k, v = _mha_inputs(dev, B, H, Lq, Lk, Dh, Lq + Lk + Dh)
    if padding == "right":
        lens = rng.integers(1, Lk + 1, size=B)
        pad = torch.from_numpy(np.arange(Lk)[None, :] >= lens[:, None]).to(dev)
    else:
        pad = torch.from_numpy(rng.random((B, Lk)) < 0.3).to(dev)
        pad[:, 0] = False
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool, device=dev), 1) if causal else None
    before = fused_mha.launches
    got = fused_mha(q, k, v, pad, attn)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    want = mha_plain(q, k, v, *additive_masks(pad, attn))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
    assert torch.equal(mha_fwd(q, k, v, *additive_masks(pad, attn)), got)   # the same launch
    assert fused_mha.launches == before + 2


@pytest.mark.parametrize("Dh", [64, 32])
def test_fused_mha_rows_whose_key_tiles_are_all_skipped(dev, Dh):
    """Rows with no allowed key: a fully padded example (every key tile of
    its blocks skipped), and the first query tile's rows masked by the
    attention mask while the other rows keep keys. Each comes out as the
    average of its Lk values; the other rows as mha_plain's."""
    B, H, L = 3, 2, 200
    rng, q, k, v = _mha_inputs(dev, B, H, L, L, Dh, Dh)
    pad, causal = _masks(rng, B, L, dev, all_masked_row=True)
    attn = causal.clone()
    attn[:70] = True
    for mask, empty_rows in ((causal, None), (attn, slice(0, 70))):
        got = fused_mha(q, k, v, pad, mask)
        torch.cuda.synchronize()
        mean = v.mean(dim=2, keepdim=True)
        torch.testing.assert_close(got[0], mean[0].expand_as(got[0]), rtol=1e-4, atol=2e-5)
        if empty_rows is not None:
            torch.testing.assert_close(got[:, :, empty_rows],
                                       mean.expand_as(got)[:, :, empty_rows],
                                       rtol=1e-4, atol=2e-5)
        torch.testing.assert_close(got, mha_plain(q, k, v, *additive_masks(pad, mask)),
                                   rtol=1e-4, atol=2e-5)


def test_fused_mha_repeats_bitwise(dev):
    """Every block owns its rows and sums in a fixed order: the same inputs
    give bitwise the same output."""
    rng, q, k, v = _mha_inputs(dev, 8, 2, 200, 200, 64, 4)
    pad, causal = _masks(rng, 8, 200, dev, all_masked_row=True)
    assert torch.equal(fused_mha(q, k, v, pad, causal), fused_mha(q, k, v, pad, causal))


def test_fused_mha_all_masked_row_is_uniform(dev):
    rng = np.random.default_rng(0)
    B, H, L, Dh = 2, 2, 40, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    pad, causal = _masks(rng, B, L, dev, all_masked_row=True)
    got = fused_mha(q, k, v, pad, causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], v[0].mean(dim=1, keepdim=True).expand_as(got[0]),
                               rtol=1e-4, atol=2e-5)


def test_fused_mha_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 1, 8, 16), device=dev)
    with pytest.raises(ValueError):
        fused_mha(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        fused_mha(q, q.transpose(2, 3), q)
    big = torch.zeros((1, 1, 600, 16), device=dev)
    before = flash_mha_fwd.launches, fused_mha.launches
    assert fused_mha(big, big, big).shape == big.shape   # Lk > 512: the flash kernel K4
    assert (flash_mha_fwd.launches, fused_mha.launches) == (before[0] + 1, before[1])
    wide = torch.zeros((1, 1, 600, 257), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_mha(wide, wide, wide)
    wide = torch.zeros((1, 1, 64, 257), device=dev)   # Lk <= 512: K3 takes Dh <= 256 too
    before = fused_mha.launches
    with pytest.raises(ValueError, match="head dim"):
        fused_mha(wide, wide, wide)
    assert fused_mha.launches == before


def _flash_inputs(dev, B, H, Lq, Lk, Dh, causal, all_masked, seed, lens=None):
    """q, g [B, H, Lq, Dh], k, v [B, H, Lk, Dh], right padding (random
    lengths unless given; example 0 fully masked if asked) and the causal
    mask, as additive masks."""
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    lens = rng.integers(1, Lk + 1, size=B) if lens is None else np.asarray(lens)
    pad = np.arange(Lk)[None, :] >= lens[:, None]
    if all_masked:
        pad[0] = True
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool, device=dev), 1) if causal else None
    return q, k, v, g, additive_masks(torch.from_numpy(pad).to(dev), attn)


def _assert_grad_close(got, want, name):
    """Gradients: atol 1e-4 times the tensor's largest magnitude, rtol 1e-3
    (float32 sums of up to Lk terms in another order than cuBLAS's)."""
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4 * float(want.abs().max()),
                               msg=name)


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal,all_masked,lens", [
    (2, 2, 1024, 1024, 64, True, False, None), (2, 2, 2048, 2048, 64, False, False, None),
    (3, 1, 600, 600, 32, True, True, None), (2, 1, 520, 700, 128, False, True, None),
    (2, 2, 1024, 1024, 128, True, True, None), (1, 2, 640, 640, 256, True, False, None),
    (4, 2, 1024, 1024, 64, True, True, (0, 63, 64, 65)),
    (3, 1, 600, 800, 256, True, False, (63, 64, 65)),
    (1, 1, 4200, 4200, 64, True, False, (4150,))],
    ids=["causal-1024", "bidir-2048", "odd-600-masked", "lq-ne-lk-masked",
         "dh128-masked", "dh256", "tile-borders-masked", "tile-borders-dh256",
         "lk-4200"])
def test_flash_kernels_match_plain(dev, B, H, Lq, Lk, Dh, causal, all_masked, lens):
    """K4 against its plain version (out to rtol 1e-4 / atol 2e-5: averages
    of v over up to 4200 keys; the row statistics to 1e-4), K5 and K6
    against theirs on K4's out and statistics and against autograd of
    mha_plain. A fully masked example averages its Lk values, and its
    gradient is autograd's (P = 1 / Lk). Lengths at the borders of K5's and
    K6's tiles (32 and 64 keys), and 66 key tiles of 64 (lk-4200): more
    than one 64-bit word of tile marks would hold."""
    q, k, v, g, (pad_add, attn_add) = _flash_inputs(dev, B, H, Lq, Lk, Dh, causal, all_masked,
                                                    Lq + Lk + Dh, lens)
    counts = [f.launches for f in (flash_mha_fwd, flash_mha_bwd_dq, flash_mha_bwd_dkv)]
    out, stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
    dq, delta = flash_mha_bwd_dq(q, k, v, pad_add, attn_add, out, stats, g)
    dk, dv = flash_mha_bwd_dkv(q, k, v, pad_add, attn_add, stats, g, delta)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_mha_fwd, flash_mha_bwd_dq, flash_mha_bwd_dkv)] == \
        [c + 1 for c in counts]
    want_out, want_stats = flash_mha_plain(q, k, v, pad_add, attn_add)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-4)
    if all_masked:
        torch.testing.assert_close(out[0], v[0].mean(dim=1, keepdim=True).expand_as(out[0]),
                                   rtol=1e-4, atol=2e-5)
    wdq, wdelta = flash_mha_bwd_dq_plain(q, k, v, pad_add, attn_add, out, stats, g)
    wdk, wdv = flash_mha_bwd_dkv_plain(q, k, v, pad_add, attn_add, stats, g, wdelta)
    torch.testing.assert_close(delta, wdelta, rtol=1e-4, atol=1e-4)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(mha_plain(qs, ks, vs, pad_add, attn_add), (qs, ks, vs), g)
    for name, got, plain, autograd in (("dq", dq, wdq, auto[0]), ("dk", dk, wdk, auto[1]),
                                       ("dv", dv, wdv, auto[2])):
        _assert_grad_close(got, plain, name)
        _assert_grad_close(got, autograd, name)


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal,padding,lens", [
    (3, 2, 600, 600, 32, True, True, (0, 300, 600)), (2, 2, 1024, 1024, 64, True, True, None),
    (3, 1, 1024, 1024, 128, True, True, (0, 500, 1000)),
    (1, 2, 600, 600, 256, True, True, (555,)), (1, 1, 4200, 4200, 64, True, True, (4150,)),
    (4, 2, 1024, 1024, 64, True, True, (1, 64, 65, 1024)),
    (2, 2, 700, 700, 64, True, False, None), (3, 2, 1024, 1024, 64, False, True, (0, 70, 1024)),
    (2, 2, 600, 600, 40, False, False, None), (2, 1, 520, 700, 36, True, True, (0, 699))],
    ids=["dh32-masked", "dh64", "dh128-masked", "dh256", "lk-4200", "first-tile-only",
         "no-padding", "no-attn-mask-masked", "no-masks-dh40", "lq-ne-lk-dh36"])
def test_flash_forward_matches_plain(dev, B, H, Lq, Lk, Dh, causal, padding, lens):
    """K4 against flash_mha_plain: out to rtol 1e-4 / atol 2e-5 (averages of
    v over up to 4200 keys), the row statistics to 1e-4. A fully padded
    example (length 0) comes out as the mean of its Lk values with
    statistics exactly (finfo.min, Lk); rows whose keys lie in the first key
    tile alone (lengths 1, 64) skip every other tile; either mask null, and
    head widths that are not a multiple of 4 (4-byte copies). Repeats are
    bitwise."""
    q, k, v, _, (pad_add, attn_add) = _flash_inputs(dev, B, H, Lq, Lk, Dh, causal, False,
                                                    Lq + Lk + Dh + 1, lens)
    if not padding:
        pad_add = None
    before = flash_mha_fwd.launches
    out, stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
    torch.cuda.synchronize()
    assert flash_mha_fwd.launches == before + 1
    want, want_stats = flash_mha_plain(q, k, v, pad_add, attn_add)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-4)
    for b, n in enumerate(lens or ()):
        if n == 0:
            torch.testing.assert_close(out[b], v[b].mean(dim=1, keepdim=True).expand_as(out[b]),
                                       rtol=1e-4, atol=2e-5)
            assert bool((stats[b, ..., 0] == torch.finfo(torch.float32).min).all())
            assert bool((stats[b, ..., 1] == Lk).all())
    again, again_stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
    assert torch.equal(out, again) and torch.equal(stats, again_stats)


@pytest.mark.parametrize("all_masked", [False, True], ids=["no-empty-row", "example-0-masked"])
def test_flash_backward_of_keys_past_every_length(dev, all_masked):
    """K6's key tiles past an example's length hold no allowed pair: with a
    key in every row, their dk and dv are exactly 0 (P = 0 there). When
    example 0 is fully padded, its rows weigh every key (P = 1 / Lk), and
    its dk and dv are autograd's of mha_plain."""
    lens = (0 if all_masked else 100, 300, 700)
    q, k, v, g, masks = _flash_inputs(dev, 3, 2, 1024, 1024, 64, True, False, 11, lens)
    out, stats = flash_mha_fwd(q, k, v, *masks)
    _, delta = flash_mha_bwd_dq(q, k, v, *masks, out, stats, g)
    dk, dv = flash_mha_bwd_dkv(q, k, v, *masks, stats, g, delta)
    torch.cuda.synchronize()
    for b, n in enumerate(lens):
        if n:
            assert not bool(dk[b, :, n:].any()) and not bool(dv[b, :, n:].any())
            assert bool(dv[b, :, :n].abs().amax(dim=-1).gt(0).all())
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(mha_plain(qs, ks, vs, *masks), (qs, ks, vs), g)
    _assert_grad_close(dk, auto[1], "dk")
    _assert_grad_close(dv, auto[2], "dv")
    if all_masked:
        assert float(dv[0].abs().min()) > 0.0


def test_flash_backward_repeats_bitwise(dev):
    """Every block of K5 and K6 owns its outputs: no atomics, so the same
    inputs give bitwise the same gradients."""
    q, k, v, g, (pad_add, attn_add) = _flash_inputs(dev, 4, 2, 1024, 1024, 64, True, False, 3)
    out, stats = flash_mha_fwd(q, k, v, pad_add, attn_add)
    first = flash_mha_bwd_dq(q, k, v, pad_add, attn_add, out, stats, g)
    first += flash_mha_bwd_dkv(q, k, v, pad_add, attn_add, stats, g, first[1])
    second = flash_mha_bwd_dq(q, k, v, pad_add, attn_add, out, stats, g)
    second += flash_mha_bwd_dkv(q, k, v, pad_add, attn_add, stats, g, second[1])
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(out, flash_mha_fwd(q, k, v, pad_add, attn_add)[0])


def test_long_sequence_layer_trains_through_the_flash_kernels(dev):
    """A TransformerLayer at L 600 in training mode with dropout 0 takes the
    projections + fused_mha branch: K4 forward, K5 and K6 backward; its
    gradients agree with the plain layer's (dense mha_plain)."""
    B, L, D, F, H = 3, 600, 64, 128, 2
    rng = np.random.default_rng(8)
    tree = random_sasrec_params(9, 2, D, 1, F, 1)
    layer = TransformerLayer(D, H, F, 0.0, "gelu", 1e-12).to(dev).train()
    with torch.no_grad():
        for name, value in layer_params_from_jax(
                tree["query_encoder"]["transformer"]["layer_0"]).items():
            getattr(layer, name).copy_(value)
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev)
    inputs = [x.clone().requires_grad_(), *layer.parameters()]

    def grads(plain):
        layer.plain = plain
        return torch.autograd.grad(layer(inputs[0], pad, causal), inputs, g)

    counts = [f.launches for f in (flash_mha_fwd, flash_mha_bwd_dq, flash_mha_bwd_dkv,
                                   fused_mha, fused_transformer_layer)]
    got = grads(False)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_mha_fwd, flash_mha_bwd_dq, flash_mha_bwd_dkv,
                                 fused_mha, fused_transformer_layer)] == \
        [counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3], counts[4]]
    want = grads(True)
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_grad_close(a, b, f"input {i}")


@pytest.mark.parametrize("B,L,D,F,H,act,eps", [
    (5, 20, 64, 128, 2, "gelu", 1e-12), (3, 200, 128, 128, 2, "gelu", 1e-12),
    (4, 37, 96, 160, 3, "relu", 1e-6), (2, 256, 256, 1024, 4, "gelu", 1e-5),
    (3, 37, 128, 128, 2, "gelu", 1e-12), (3, 37, 36, 72, 3, "gelu", 1e-12),
    (2, 21, 30, 70, 3, "relu", 1e-6), (3, 41, 192, 256, 4, "gelu", 1e-12),
    (64, 40, 64, 128, 2, "gelu", 1e-12)])
def test_fused_transformer_layer_matches_plain(dev, B, L, D, F, H, act, eps):
    """K1 against the plain layer (TOL_K1: rtol 1e-4, atol 1e-4) at the
    edges of its tile plan: B L not a multiple of 128 (111 rows), d 96 and
    d 192 on zero-padded LayerNorm tiles (128 and 256 wide), row lengths
    that are not a multiple of 4 (d 30, F 70: 4-byte stores), F 1024 with d
    256 (the 64 x 256 LayerNorm tile), and 2,560 rows (64-row tiles where
    128-row tiles would not fill the card)."""
    rng = np.random.default_rng(B * L)
    tree = random_sasrec_params(L, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev)
    before = fused_transformer_layer.launches
    got = fused_transformer_layer(x, params, pad, causal, H, 0.0, act, eps, False)
    torch.cuda.synchronize()
    assert fused_transformer_layer.launches == before + 1
    want = transformer_layer_plain(x, params, pad, causal, H, act, eps)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,L,D,F,H,act,p,all_masked", [
    (5, 20, 64, 128, 2, "gelu", 0.5, False), (3, 200, 128, 128, 2, "gelu", 0.5, False),
    (4, 37, 96, 160, 3, "relu", 0.2, False), (2, 24, 64, 128, 2, "gelu", 0.0, False),
    (3, 200, 128, 128, 2, "gelu", 0.5, True), (3, 37, 128, 128, 2, "gelu", 0.5, False),
    (3, 37, 36, 72, 3, "gelu", 0.5, False), (2, 21, 30, 70, 3, "relu", 0.5, False),
    (2, 64, 256, 1024, 4, "gelu", 0.5, False)])
def test_fused_layer_training_matches_plain(dev, B, L, D, F, H, act, p, all_masked):
    """K1 (training) and K2 against the plain forward and autograd through
    it, with dropout on: the kernels regenerate the plain version's masks
    from the same seed. With a fully padded example, K2 recomputes P from
    the statistics K3 writes for rows whose key tiles it skipped
    (finfo.min, Lk). Tolerance: K1 as eval; gradients atol 1e-4 times
    their largest magnitude (float32 sums of up to B L terms)."""
    rng = np.random.default_rng(B * L + 1)
    tree = random_sasrec_params(L + 1, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev, all_masked_row=all_masked)
    seed = 12345
    k1, k2 = fused_transformer_layer.launches, fused_transformer_layer_bwd.launches
    out, res = training_residuals(x, params, pad, causal, H, p, act, 1e-12, seed)
    dx, grads = fused_transformer_layer_bwd(g, x, params, pad, causal, H, p, act, 1e-12, seed,
                                            res)
    torch.cuda.synchronize()
    assert (fused_transformer_layer.launches, fused_transformer_layer_bwd.launches) == \
        (k1 + 1, k2 + 1)
    want = transformer_layer_plain(x, params, pad, causal, H, act, 1e-12, p, seed, True)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    wdx, wgrads = transformer_layer_bwd_plain(g, x, params, pad, causal, H, p, act, 1e-12, seed)
    torch.testing.assert_close(dx, wdx, rtol=1e-4, atol=1e-4 * float(wdx.abs().max()))
    for name in PARAM_NAMES:
        torch.testing.assert_close(grads[name], wgrads[name], rtol=1e-4,
                                   atol=1e-4 * max(float(wgrads[name].abs().max()), 1e-3),
                                   msg=name)
    dx2, grads2 = fused_transformer_layer_bwd(g, x, params, pad, causal, H, p, act, 1e-12,
                                              seed, res)
    assert torch.equal(dx, dx2)                   # no atomics: bitwise repeatable
    assert all(torch.equal(grads[n], grads2[n]) for n in PARAM_NAMES)


@pytest.mark.parametrize("B,L,D,F,H,p", [(3, 200, 128, 128, 2, 0.5), (3, 37, 96, 160, 3, 0.2)])
def test_fused_layer_training_forward_repeats_bitwise(dev, B, L, D, F, H, p):
    """Every output of K1 in training mode belongs to one block and no
    atomics are used: two calls give bitwise the same output and
    residuals (hpre, xhat1/2, rstd1/2 and the rest)."""
    rng = np.random.default_rng(B + L + D)
    tree = random_sasrec_params(D, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, causal = _masks(rng, B, L, dev)
    out, res = training_residuals(x, params, pad, causal, H, p, "gelu", 1e-12, 77)
    out2, res2 = training_residuals(x, params, pad, causal, H, p, "gelu", 1e-12, 77)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    for name in res:
        assert torch.equal(res[name], res2[name]), name


def test_fused_layer_autograd_and_eval_path(dev):
    """In training mode the entry point is differentiable through K2; in
    eval mode it still launches the eval kernel, ignoring the seed."""
    tree = random_sasrec_params(0, 2, 32, 1, 64, 1)
    params = {n: t.to(dev).requires_grad_() for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.randn((2, 4, 32), device=dev, requires_grad=True)
    before = fused_transformer_layer_bwd.launches
    fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, True, 5).sum().backward()
    torch.cuda.synchronize()
    assert fused_transformer_layer_bwd.launches == before + 1
    assert torch.isfinite(x.grad).all() and all(torch.isfinite(p.grad).all()
                                                for p in params.values())
    with torch.no_grad():
        a = fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, False, 5)
        b = fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, False, 6)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused_transformer_layer(x.double(), params, None, None, 2, 0.1, "gelu", 1e-12, True, 5)


def test_fused_layer_without_attention_mask(dev):
    """The bidirectional layer of BERT4Rec: K1 (eval and training) and K2
    with no attention mask, only key padding."""
    B, L, D, F, H, p, seed = 4, 50, 64, 128, 2, 0.2, 99
    rng = np.random.default_rng(5)
    tree = random_sasrec_params(7, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, _ = _masks(rng, B, L, dev)
    got = fused_transformer_layer(x, params, pad, None, H, 0.0, "gelu", 1e-12, False)
    torch.testing.assert_close(got, transformer_layer_plain(x, params, pad, None, H, "gelu",
                                                            1e-12), rtol=1e-4, atol=1e-4)
    out, res = training_residuals(x, params, pad, None, H, p, "gelu", 1e-12, seed)
    torch.testing.assert_close(out, transformer_layer_plain(x, params, pad, None, H, "gelu",
                                                            1e-12, p, seed, True),
                               rtol=1e-4, atol=1e-4)
    dx, grads = fused_transformer_layer_bwd(g, x, params, pad, None, H, p, "gelu", 1e-12, seed,
                                            res)
    wdx, wgrads = transformer_layer_bwd_plain(g, x, params, pad, None, H, p, "gelu", 1e-12, seed)
    torch.testing.assert_close(dx, wdx, rtol=1e-4, atol=1e-4 * float(wdx.abs().max()))
    for name in PARAM_NAMES:
        torch.testing.assert_close(grads[name], wgrads[name], rtol=1e-4,
                                   atol=1e-4 * max(float(wgrads[name].abs().max()), 1e-3),
                                   msg=name)


@pytest.mark.parametrize("B,L,D,F,H,p,causal,all_masked", [
    (4, 37, 64, 256, 2, 0.5, True, True), (3, 37, 128, 256, 2, 0.0, True, True),
    (2, 40, 256, 256, 2, 0.5, True, False), (5, 37, 64, 128, 2, 0.0, False, True),
    (3, 37, 128, 256, 2, 0.5, False, True), (2, 37, 256, 128, 2, 0.0, False, False),
    (3, 200, 64, 128, 2, 0.5, True, True), (2, 256, 256, 1024, 2, 0.5, True, True)],
    ids=["d64-f256-causal-p0.5", "d128-f256-causal-p0", "d256-causal-p0.5",
         "d64-nomask-p0", "d128-f256-nomask-p0.5", "d256-nomask-p0", "d64-l200-causal-p0.5",
         "d256-f1024-l256-p0.5"])
def test_fused_layer_backward_across_widths(dev, B, L, D, F, H, p, causal, all_masked):
    """K2 against autograd through the plain forward at head widths 32, 64
    and 128 (d 64, 128, 256 with 2 heads), F unequal to d, B L a multiple of
    no product tile (L 37), example 0 fully padded, with and without the
    causal mask, dropout 0 and 0.5. Tolerance TOL_GRAD of chip_smoke.py:
    atol 1e-4 times each gradient's largest magnitude, rtol 1e-3 (float32
    sums of up to B L terms in another order). Repeats bit for bit."""
    rng = np.random.default_rng(B * L + D + F)
    tree = random_sasrec_params(L + D, 2, D, 1, F, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    pad, attn = _masks(rng, B, L, dev, all_masked_row=all_masked)
    attn = attn if causal else None
    seed = 777
    _, res = training_residuals(x, params, pad, attn, H, p, "gelu", 1e-12, seed)
    before = fused_transformer_layer_bwd.launches
    dx, grads = fused_transformer_layer_bwd(g, x, params, pad, attn, H, p, "gelu", 1e-12, seed,
                                            res)
    torch.cuda.synchronize()
    assert fused_transformer_layer_bwd.launches == before + 1
    wdx, wgrads = transformer_layer_bwd_plain(g, x, params, pad, attn, H, p, "gelu", 1e-12, seed)
    for name, got, want in (("x", dx, wdx), *((n, grads[n], wgrads[n]) for n in PARAM_NAMES)):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-4 * max(float(want.abs().max()), 1e-3), msg=name)
    dx2, grads2 = fused_transformer_layer_bwd(g, x, params, pad, attn, H, p, "gelu", 1e-12,
                                              seed, res)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(grads[n], grads2[n]) for n in PARAM_NAMES)


@pytest.mark.parametrize("B,L,D,F", [(1024, 200, 128, 128), (256, 200, 64, 128),
                                     (4, 37, 64, 256), (2, 256, 256, 1024), (1, 3, 8, 8)])
def test_weight_gradient_row_ranges_cover_the_rows_once(dev, B, L, D, F):
    """K2's plan for each weight gradient (sized to this card): S ranges of
    a multiple of the k-slice rows that cover [0, B L) exactly once, none
    empty."""
    from recstudio_torch.ops.transformer_layer import (K2_GEMM_TILE, WEIGHT_GRADS,
                                                       weight_grad_splits)
    M = B * L
    plan = weight_grad_splits(B, L, D, F)
    assert tuple(plan) == WEIGHT_GRADS
    for name, (S, rows) in plan.items():
        assert S >= 1 and rows > 0 and rows % K2_GEMM_TILE[2] == 0, name
        starts = [s * rows for s in range(S)]
        ends = [min(M, st + rows) for st in starts]
        covered = np.zeros(M, dtype=int)
        for st, en in zip(starts, ends):
            assert st < en, name                      # no empty range
            covered[st:en] += 1
        assert bool((covered == 1).all()), name


def _clse_inputs(M, N, D, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(dev)
    items = torch.from_numpy(rng.normal(0.0, 0.3, size=(N, D)).astype(np.float32)).to(dev)
    g = rng.normal(size=M).astype(np.float32)
    g[rng.random(M) < 0.8] = 0.0
    return q, items, torch.from_numpy(g).to(dev)


@pytest.mark.parametrize("M,N,D", [(300, 1000, 64), (37, 5000, 200), (1000, 129, 16),
                                   (512, 40000, 64), (5, 3, 256), (6000, 3706, 64),
                                   (256, 3706, 200)])
def test_catalog_logsumexp_kernels_match_plain(dev, M, N, D):
    """K7, K8, K9 against their plain versions, ragged tiles and every
    split plan (one range, items split, rows split), and MultiDAE's
    training shape (256 users, the ml-1m catalog, D 200). Tolerance: logZ atol
    1e-4 (sums of up to 40,000 terms); gradients atol 1e-4 times their
    largest magnitude, rtol 1e-3. K8 and K9 repeat bit for bit."""
    q, items, g = _clse_inputs(M, N, D, dev, M + N)
    counts = [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                   catalog_logsumexp_ditems)]
    logz = catalog_logsumexp_fwd(q, items)
    dq = catalog_logsumexp_dq(q, items, logz, g)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                 catalog_logsumexp_ditems)] == [c + 1 for c in counts]
    torch.testing.assert_close(logz, catalog_logsumexp_plain(q, items), rtol=1e-5, atol=1e-4)
    for got, want in ((dq, catalog_logsumexp_dq_plain(q, items, logz, g)),
                      (ditems, catalog_logsumexp_ditems_plain(q, items, logz, g))):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-4 * max(float(want.abs().max()), 1e-6))
    assert torch.equal(dq, catalog_logsumexp_dq(q, items, logz, g))
    assert torch.equal(ditems, catalog_logsumexp_ditems(q, items, logz, g))
    assert bool((dq[g == 0] == 0).all())


@pytest.mark.parametrize("M,N,D", [(40, 1000, 8), (300, 777, 33), (63, 3706, 64),
                                   (129, 500, 128), (70, 130, 256), (512, 20000, 64)])
def test_catalog_query_gradient_matches_plain(dev, M, N, D):
    """K8 against its plain version (atol 1e-4 times the gradient's largest
    magnitude, rtol 1e-3): widths 8 to 256, one not a multiple of 4 (4-byte
    copies), fewer rows than a tile, item counts that are a multiple of no
    tile, and a shape whose plan cuts the items into more than one range.
    K8 repeats bit for bit, and K7's and K9's plans are those of their rule
    (``plan`` of ``test_torch_clse_plan``) at the card's resident blocks,
    whatever K8's plan is."""
    from recstudio_torch.ops.softmax_z import DITEMS_PLAN, DQ_PLAN, FWD_PLAN, resident, splits
    from test_torch_clse_plan import plan
    q, items, g = _clse_inputs(M, N, D, dev, M + N + D)
    logz = catalog_logsumexp_fwd(q, items)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    dq = catalog_logsumexp_dq(q, items, logz, g)
    torch.cuda.synchronize()
    want = catalog_logsumexp_dq_plain(q, items, logz, g)
    torch.testing.assert_close(dq, want, rtol=1e-3, atol=1e-4 * max(float(want.abs().max()),
                                                                      1e-6))
    assert torch.equal(dq, catalog_logsumexp_dq(q, items, logz, g))
    assert bool((dq[g == 0] == 0).all())
    assert torch.equal(logz, catalog_logsumexp_fwd(q, items))
    assert torch.equal(ditems, catalog_logsumexp_ditems(q, items, logz, g))
    for kind in (FWD_PLAN, DITEMS_PLAN):
        assert splits(M, N, D, kind) == plan(kind, M, N, D, resident(D, kind))[0]
    if (M, N) == (512, 20000):
        assert splits(M, N, D, DQ_PLAN) > 1


# ranges: (K7's, K9's) plan, 1 or "S>1" where the shape fixes it on any card
@pytest.mark.parametrize("M,N,D,misaligned,ranges", [
    (40, 20000, 8, False, ("S>1", 1)), (20000, 100, 33, False, (None, "S>1")),
    (300, 50, 64, True, (1, "S>1")), (50, 777, 128, False, ("S>1", 1)),
    (129, 3706, 256, False, ("S>1", None)), (6000, 3706, 64, False, (None, None)),
    (1000, 129, 16, True, (None, None))],
    ids=["M40-d8", "N100-d33", "N50-misaligned", "M50-d128", "d256", "F-items",
         "d16-misaligned"])
def test_catalog_logsumexp_k7_k9_match_plain(dev, M, N, D, misaligned, ranges):
    """K7 and K9 on the register tile against their plain versions: widths
    8 to 256, fewer rows than a tile, rows and items that are a multiple of
    no tile, 16-byte copies and 4-byte ones (a width not a multiple of 4, or
    operands that start 4 bytes past a 16-byte boundary), one range (the
    long axis one tile) and several (a block's axis one or two tiles against
    a long one), rows with g = 0. Both repeat bit for bit. Tolerance: logZ
    rtol 1e-5, atol 1e-4 (sums of up to 20,000 terms in another order);
    ditems atol 1e-4 times its largest magnitude, rtol 1e-3 (sums over up
    to 20,000 rows)."""
    from recstudio_torch.ops.softmax_z import DITEMS_PLAN, FWD_PLAN, splits
    q, items, g = _clse_inputs(M, N, D, dev, M + N + D)
    if misaligned:            # 4-byte copies at any width: rows start off 16 bytes
        q = torch.cat([torch.zeros(1, device=dev), q.flatten()])[1:].view(M, D)
        items = torch.cat([torch.zeros(1, device=dev), items.flatten()])[1:].view(N, D)
        assert q.data_ptr() % 16 and items.data_ptr() % 16
    for kind, want in zip((FWD_PLAN, DITEMS_PLAN), ranges):
        if want is not None:
            assert (splits(M, N, D, kind) == 1) == (want == 1), (kind, want)
    logz = catalog_logsumexp_fwd(q, items)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(logz, catalog_logsumexp_plain(q, items), rtol=1e-5, atol=1e-4)
    want = catalog_logsumexp_ditems_plain(q, items, logz, g)
    torch.testing.assert_close(ditems, want, rtol=1e-3,
                               atol=1e-4 * max(float(want.abs().max()), 1e-6))
    assert torch.equal(logz, catalog_logsumexp_fwd(q, items))
    assert torch.equal(ditems, catalog_logsumexp_ditems(q, items, logz, g))


@pytest.mark.parametrize("M,D", [(300, 64), (20000, 33), (70, 256)])
def test_catalog_kernels_share_one_score_at_one_item(dev, M, D):
    """With one item logZ is the score itself, so P = exp(s - logZ) = 1
    exactly where K8 and K9 recompute K7's score bit for bit: K8's dq is g
    item bit for bit, and K9's ditems is sum_m g_m q_m (rtol 1e-5, atol 1e-5
    times its largest magnitude: the same sum in another order), bit for bit
    g_m q_m when only row m has a gradient (the other rows add exact
    zeros)."""
    q, items, g = _clse_inputs(M, 1, D, dev, M + D)
    logz = catalog_logsumexp_fwd(q, items)
    torch.testing.assert_close(logz, (q @ items.t())[:, 0], rtol=1e-5, atol=1e-5)
    assert torch.equal(catalog_logsumexp_dq(q, items, logz, g), g[:, None] * items)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    want = (g[:, None].double() * q.double()).sum(0, keepdim=True).float()
    torch.testing.assert_close(ditems, want, rtol=1e-5,
                               atol=1e-5 * max(float(want.abs().max()), 1e-6))
    one = torch.zeros_like(g)
    one[M // 2] = g[g != 0][0]
    assert torch.equal(catalog_logsumexp_ditems(q, items, logz, one),
                       one[M // 2] * q[M // 2:M // 2 + 1])


def test_catalog_logsumexp_autograd_on_the_card(dev):
    q, items, g = _clse_inputs(700, 2000, 64, dev)
    qs, its = q.clone().requires_grad_(), items.clone().requires_grad_()
    before = catalog_logsumexp_dq.launches, catalog_logsumexp_ditems.launches
    (catalog_logsumexp(qs, its) * g).sum().backward()
    torch.cuda.synchronize()
    assert (catalog_logsumexp_dq.launches, catalog_logsumexp_ditems.launches) == \
        (before[0] + 1, before[1] + 1)
    logz = catalog_logsumexp_fwd(q, items)
    assert torch.equal(qs.grad, catalog_logsumexp_dq(q, items, logz, g))
    assert torch.equal(its.grad, catalog_logsumexp_ditems(q, items, logz, g))


def test_catalog_logsumexp_refuses_what_it_does_not_take(dev):
    q, items, g = _clse_inputs(8, 16, 64, dev)
    with pytest.raises(ValueError, match="width"):
        catalog_logsumexp_fwd(torch.zeros((8, 300), device=dev), torch.zeros((16, 300),
                                                                             device=dev))
    with pytest.raises(ValueError):
        catalog_logsumexp_fwd(q.double(), items.double())
    with pytest.raises(ValueError):
        catalog_logsumexp_dq(q, items, torch.zeros(7, device=dev), g)


def test_catalog_kernels_at_a_pooled_batch(dev):
    """K7, K8, K9 at NARM's and STAMP's training shape (phases K and L): one
    query row a sequence, M 512 against 3,706 items at D 64, every row with
    the cotangent 1 / 512 of a mean over the batch. Tolerances as
    ``test_catalog_logsumexp_kernels_match_plain``; each repeats bit for
    bit."""
    M, N, D = 512, 3706, 64
    q, items, _ = _clse_inputs(M, N, D, dev, 2031)
    g = torch.full((M,), 1.0 / M, device=dev)
    counts = [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                   catalog_logsumexp_ditems)]
    logz = catalog_logsumexp_fwd(q, items)
    dq = catalog_logsumexp_dq(q, items, logz, g)
    ditems = catalog_logsumexp_ditems(q, items, logz, g)
    torch.cuda.synchronize()
    assert [f.launches for f in (catalog_logsumexp_fwd, catalog_logsumexp_dq,
                                 catalog_logsumexp_ditems)] == [c + 1 for c in counts]
    torch.testing.assert_close(logz, catalog_logsumexp_plain(q, items), rtol=1e-5, atol=1e-4)
    for got, want in ((dq, catalog_logsumexp_dq_plain(q, items, logz, g)),
                      (ditems, catalog_logsumexp_ditems_plain(q, items, logz, g))):
        torch.testing.assert_close(got, want, rtol=1e-3,
                                   atol=1e-4 * max(float(want.abs().max()), 1e-6))
    assert torch.equal(logz, catalog_logsumexp_fwd(q, items))
    assert torch.equal(dq, catalog_logsumexp_dq(q, items, logz, g))
    assert torch.equal(ditems, catalog_logsumexp_ditems(q, items, logz, g))


@pytest.mark.parametrize("num_layer,B,L,D,H", [(1, 512, 200, 64, 128), (2, 33, 57, 40, 72)])
def test_gru_layer_on_the_card_matches_plain(dev, num_layer, B, L, D, H):
    """``GRULayer`` through cuDNN against ``gru_layer_plain`` (its time loop
    on cuBLAS, TF32 off) on the card, with TF32 allowed for cuDNN outside
    the wrapper, as PyTorch's default has it: outputs to atol 2e-5, rtol
    1e-4, and every gradient to 1e-4 of its largest magnitude + rtol 1e-3:
    float32 sums in another order. TF32 products (10-bit mantissas) miss
    these by orders of magnitude. The wrapper leaves the caller's cuDNN
    setting as it found it, counts one launch a layer, and the padded
    positions run through the recurrence as the JAX package's do."""
    from recstudio_torch.models.module.layers import GRULayer, gru_layer
    torch.manual_seed(num_layer)
    layer = GRULayer(D, H, num_layer).to(dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.uniform_(-H ** -0.5, H ** -0.5)
    rng = np.random.default_rng(B + L)
    x0 = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.normal(size=(B, L, H)).astype(np.float32)).to(dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        res = []
        for plain in (False, True):
            layer.plain = plain
            x = x0.clone().requires_grad_()
            before = gru_layer.launches
            out = layer(x)
            res.append([out] + list(torch.autograd.grad(out, [x, *layer.parameters()], cot)))
            assert gru_layer.launches == before + (0 if plain else num_layer)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (out, *grads), (want, *want_grads) = res
    torch.testing.assert_close(out, want, rtol=1e-4, atol=2e-5)
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got, w, rtol=1e-3, atol=1e-4 * float(w.abs().max()))


def test_gru_layer_refuses_what_cudnn_cannot_take(dev):
    from recstudio_torch.models.module.layers import gru_layer
    w = [torch.zeros(s, device=dev, dtype=torch.float64) for s in ((24, 4), (24, 8), (24,),
                                                                  (24,))]
    with pytest.raises(RuntimeError, match="cuDNN"):
        gru_layer(torch.zeros((2, 3, 4), device=dev, dtype=torch.float64), *w)
