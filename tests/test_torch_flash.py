"""Long-sequence attention (Lk > 512): the port's flash route against the
JAX package's.

The JAX side runs its flash kernels (``_mha_flash``: K4; ``_flash_bwd``: K5
and K6) in interpret mode on the CPU, as ``tests/test_ops.py`` does, under
``jax.default_matmul_precision("float32")``; the port runs the kernels'
plain versions, which ``fused_mha`` takes on CPU tensors. Tolerances:
forward rtol 1e-4 / atol 1e-5 (float32 on both sides, sums in another
order); gradients rtol 5e-4 / atol 5e-5 (``tests/test_ops.py`` holds the
JAX flash backward to 5e-4), on examples whose rows all have a key.

The JAX flash path does not give the unpadded function on an example whose
keys are all masked; ``test_fully_masked_example_differs_from_the_jax_flash_path``
pins where, and that the port does.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu.ops import attention as jax_attention
from recstudio_tpu.serving import Predictor as JaxPredictor
from recstudio_tpu.utils import get_model as jax_get_model

from recstudio_torch.ops import (flash_mha_bwd_dkv, flash_mha_bwd_dq, flash_mha_bwd_plain,
                                 flash_mha_fwd, flash_mha_plain, fused_mha, mha_plain)
from recstudio_torch.ops.attention import (FLASH_TILE, _probs_and_dscores, _raw_logits,
                                           additive_masks, mha_tiles)
from recstudio_torch.serving import Predictor
from recstudio_torch.utils import get_model
from recstudio_torch.utils.convert import params_from_jax, params_to_jax
from recstudio_torch.utils.parity import topk_mismatches

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def _inputs(seed, B, H, Lq, Lk, Dh, causal, all_masked=False):
    """q, g [B, H, Lq, Dh], k, v [B, H, Lk, Dh], right padding with every
    length >= 1 (example 0 fully masked if asked), the causal mask or None."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, H, Lq, Dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, H, Lk, Dh)).astype(np.float32) for _ in range(2))
    lens = rng.integers(1, Lk + 1, size=B)
    pad = np.arange(Lk)[None, :] >= lens[:, None]
    if all_masked:
        pad[0] = True
    mask = np.triu(np.ones((Lq, Lk), bool), 1) if causal else None
    return q, k, v, g, pad, mask


def _jax_masks(pad, mask):
    def add(m):
        return None if m is None else jnp.where(jnp.asarray(m), NEG, 0.0).astype(jnp.float32)
    return add(pad), add(mask)


def _torch_masks(pad, mask):
    return additive_masks(torch.from_numpy(pad),
                          None if mask is None else torch.from_numpy(mask))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [(640, 640, 16, True), (1024, 1024, 32, True), (1024, 1024, 16, False)]
CASE_IDS = ["causal-640", "causal-1024", "bidir-1024"]


@pytest.mark.parametrize("Lq,Lk,Dh,causal", CASES, ids=CASE_IDS)
def test_flash_plain_matches_jax_kernel(Lq, Lk, Dh, causal):
    """The plain K4: out, and lse = max + log(sum) from its row statistics,
    against the JAX ``_mha_flash`` (interpret mode)."""
    q, k, v, _, pad, mask = _inputs(Lq + Dh, 2, 2, Lq, Lk, Dh, causal)
    with jax.default_matmul_precision("float32"):
        jout, jlse = jax_attention._mha_flash(*(jnp.asarray(t) for t in (q, k, v)),
                                              *_jax_masks(pad, mask))
    out, stats = flash_mha_plain(*_t(q, k, v), *_torch_masks(pad, mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    lse = (stats[..., 0] + torch.log(stats[..., 1])).numpy()
    np.testing.assert_allclose(lse, np.asarray(jlse)[:, :, :Lq, 0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Lq,Lk,Dh,causal", CASES, ids=CASE_IDS)
def test_flash_bwd_plain_matches_jax_kernels_and_autograd(Lq, Lk, Dh, causal):
    """The plain K5 and K6, on the plain K4's out and statistics, against the
    JAX ``_flash_bwd`` (interpret mode, on its own out and lse) and against
    autograd of ``mha_plain``; the wrappers take the plain versions on CPU
    tensors and count no launch."""
    q, k, v, g, pad, mask = _inputs(Lq + Dh + 1, 2, 2, Lq, Lk, Dh, causal)
    jmasks = _jax_masks(pad, mask)
    with jax.default_matmul_precision("float32"):
        jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
        jout, jlse = jax_attention._mha_flash(jq, jk, jv, *jmasks)
        jgrads = jax_attention._flash_bwd(jq, jk, jv, *jmasks, jout, jlse, jnp.asarray(g))
    tq, tk, tv, tg = _t(q, k, v, g)
    masks = _torch_masks(pad, mask)
    out, stats = flash_mha_plain(tq, tk, tv, *masks)
    grads = flash_mha_bwd_plain(tq, tk, tv, *masks, out, stats, tg)
    qs, ks, vs = (t.clone().requires_grad_() for t in (tq, tk, tv))
    auto = torch.autograd.grad(mha_plain(qs, ks, vs, *masks), (qs, ks, vs), tg)
    counts = flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches
    dq, delta = flash_mha_bwd_dq(tq, tk, tv, *masks, out, stats, tg)
    dk, dv = flash_mha_bwd_dkv(tq, tk, tv, *masks, stats, tg, delta)
    assert (flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches) == counts
    for name, got, jgot, agot, wrapped in zip(("dq", "dk", "dv"), grads, jgrads, auto,
                                              (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), agot.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
        assert torch.equal(got, wrapped), name


@pytest.mark.parametrize("Lq,Lk,Dh,causal", [(640, 640, 16, True), (300, 700, 8, False)],
                         ids=["causal-640", "lq-ne-lk-bidir"])
def test_fused_mha_long_matches_jax_fused_mha_and_grad(Lq, Lk, Dh, causal):
    """``fused_mha`` on CPU tensors at Lk > 512 (the ``_FlashMha`` route with
    the plain versions inside) against the JAX ``fused_mha`` and its
    ``jax.grad``, which run the flash kernels K4, K5, K6 in interpret mode."""
    q, k, v, g, pad, mask = _inputs(Lq + Lk, 2, 2, Lq, Lk, Dh, causal)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jax_attention.fused_mha(q_, k_, v_, jnp.asarray(pad), jmask)
        return (out * jnp.asarray(g)).sum()

    with jax.default_matmul_precision("float32"):
        jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
        jout = jax_attention.fused_mha(jq, jk, jv, jnp.asarray(pad), jmask)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    qs, ks, vs = (t.requires_grad_() for t in _t(q, k, v))
    counts = flash_mha_fwd.launches, fused_mha.launches
    out = fused_mha(qs, ks, vs, torch.from_numpy(pad),
                    None if mask is None else torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (qs, ks, vs), torch.from_numpy(g))
    assert (flash_mha_fwd.launches, fused_mha.launches) == counts
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_fully_masked_example_differs_from_the_jax_flash_path():
    """Example 0 has every key masked (seqlen 0); example 1 does not. The
    port gives the unpadded function there, the uniform average of its L
    values, and autograd's gradient of ``mha_plain`` (P = 1 / L). The JAX
    flash path does not: ``_mha_flash`` pads Lk to its 512-key tile with
    masked zero keys that the uniform average takes in, and its lse, max +
    log(sum), rounds to finfo.min, so ``_flash_bwd`` takes P = 1 for every
    key. Example 1 agrees."""
    q, k, v, g, pad, mask = _inputs(7, 2, 1, 640, 640, 16, True, all_masked=True)

    def jloss(q_, k_, v_):
        return (jax_attention.fused_mha(q_, k_, v_, jnp.asarray(pad), jnp.asarray(mask))
                * jnp.asarray(g)).sum()

    with jax.default_matmul_precision("float32"):
        jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
        jout = np.asarray(jax_attention.fused_mha(jq, jk, jv, jnp.asarray(pad),
                                                  jnp.asarray(mask)))
        jgrads = [np.asarray(t) for t in jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)]
    qs, ks, vs = (t.requires_grad_() for t in _t(q, k, v))
    out = fused_mha(qs, ks, vs, torch.from_numpy(pad), torch.from_numpy(mask))
    grads = [t.numpy() for t in torch.autograd.grad(out, (qs, ks, vs), torch.from_numpy(g))]
    out = out.detach().numpy()
    masks = _torch_masks(pad, mask)
    qa, ka, va = (t.requires_grad_() for t in _t(q, k, v))
    auto = [t.numpy() for t in torch.autograd.grad(mha_plain(qa, ka, va, *masks), (qa, ka, va),
                                                   torch.from_numpy(g))]

    mean = np.broadcast_to(v[0].mean(1, keepdims=True), out[0].shape)
    np.testing.assert_allclose(out[0], mean, rtol=RTOL, atol=ATOL)
    for got, want in zip(grads, auto):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(out[1], jout[1], rtol=RTOL, atol=ATOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got[1], want[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the JAX flash path on example 0: its average shrinks by 640 / 1024 (the
    # padded zero keys), and its gradients, from P = 1, are off by more than
    # ten times their own size
    np.testing.assert_allclose(jout[0], mean * 640 / 1024, rtol=RTOL, atol=ATOL)
    assert np.abs(mean).max() > 100 * ATOL
    for got, want in zip(grads, jgrads):
        assert np.abs(got[0] - want[0]).max() > 10 * np.abs(got[0]).max()


def test_flash_tile_constant_is_the_kernel_plan():
    """``FLASH_TILE``, with which ``mha_tiles`` reports the pairs of tiles K4,
    K5 and K6 compute, is the plan the CUDA source compiles at Dh <= 128, and
    each of the three launchers takes it there."""
    src = (Path(__file__).resolve().parents[1] / "recstudio_torch" / "csrc"
           / "flash_attention.cu").read_text()
    plan = re.search(r"constexpr int kFlashRows = (\d+), kFlashKeys = (\d+);", src)
    assert plan is not None and tuple(map(int, plan.groups())) == FLASH_TILE
    for name, first, second in (("rs_flash_fwd", "Rows", "Keys"),
                                ("rs_flash_bwd_dq", "Rows", "Keys"),
                                ("rs_flash_bwd_dkv", "Keys", "Rows")):
        body = src[src.index(f'extern "C" int {name}('):]
        body = body[:body.index("\n}\n")]
        assert f"constexpr int RI = kFlash{first} / 16, CJ = kFlash{second} / 16;" in body, name
        assert re.search(r"if \(Dh <= 128\) return \(int\)launch_\w+<RI, CJ, 8>", body), name


def _tile_skipped_flash_bwd(q, k, v, pad, attn, out, stats, g):
    """The flash backward as K5 and K6 compute it: only the pairs of
    ``FLASH_TILE`` tiles that hold an allowed pair (``mha_tiles``) or whose
    query tile holds a row with no allowed key; every other pair dropped.
    Returns ``(dq, dk, dv)`` and the bool ``[B, Lq, Lk]`` pairs computed."""
    tq, tk = FLASH_TILE
    Lq, Lk = q.shape[2], k.shape[2]
    tiles, empty = mha_tiles(pad, attn, Lq, Lk, tq, tk)
    computed = (tiles | empty[:, :, None]).repeat_interleave(tq, 1) \
        .repeat_interleave(tk, 2)[:, :Lq, :Lk]
    pad_add, attn_add = additive_masks(pad, attn)
    delta = (g * out).sum(dim=-1)
    p, ds = _probs_and_dscores(q, k, v, pad_add, attn_add, stats, g, delta)
    keep = computed[:, None]
    p, ds = torch.where(keep, p, 0.0), torch.where(keep, ds, 0.0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return (ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ g), computed


@pytest.mark.parametrize("Lq,Lk,lens,causal", [
    (200, 200, (0, 63, 64, 65), True), (130, 200, (63, 64, 65, 200), True),
    (150, 200, (0, 63, 64, 65), False)],
    ids=["causal-tile-borders-padded", "lq-ne-lk", "no-attn-mask-padded"])
def test_skipping_masked_flash_tiles_keeps_the_backward(Lq, Lk, lens, causal):
    """K5's and K6's skip rule: dropping the pairs outside ``mha_tiles(...)[0]
    | empty[:, :, None]`` at ``FLASH_TILE`` gives ``flash_mha_bwd_plain``'s
    dq, dk and dv, with right padding at the tile borders (lengths 63, 64,
    65). An example whose keys are all masked (length 0) keeps every pair of
    its query tiles: its P = 1 / Lk weighs every key, and its dS passes the
    clamp wherever only one mask is finfo.min."""
    rng = np.random.default_rng(Lq + Lk + len(lens))
    B, H, Dh = len(lens), 2, 8
    q, g = (torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32))
            for _ in range(2))
    pad = torch.from_numpy(np.arange(Lk)[None, :] >= np.asarray(lens)[:, None])
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool), 1) if causal else None
    masks = additive_masks(pad, attn)
    out, stats = flash_mha_plain(q, k, v, *masks)
    want = flash_mha_bwd_plain(q, k, v, *masks, out, stats, g)
    got, computed = _tile_skipped_flash_bwd(q, k, v, pad, attn, out, stats, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert not bool(computed.all())
    if lens[0] == 0:
        assert bool(computed[0].all()) and float(want[0][0].abs().max()) > 100 * GRAD_ATOL
    # examples 1 and 2 (lengths <= 65) reach no key tile from the third on
    assert not bool(computed[1:3, :, 2 * FLASH_TILE[1]:].any())


def _tile_skipped_flash_fwd(q, k, v, pad, attn):
    """The flash forward as K4 computes it: an online softmax over only the
    key tiles of ``FLASH_TILE`` that ``mha_tiles`` marks for each query tile,
    in order; then a row left with max <= finfo.min (no allowed key) takes
    the mean of all Lk values and the statistics (finfo.min, Lk), K4's one
    more pass. Returns ``(out, stats)``, the bool ``[B, Lq, Lk]`` pairs
    computed and the bool ``[B, nq]`` query tiles that make the extra pass."""
    tq, tk = FLASH_TILE
    (B, H, Lq, Dh), Lk = q.shape, k.shape[2]
    tiles, _ = mha_tiles(pad, attn, Lq, Lk, tq, tk)
    rows = tiles.repeat_interleave(tq, 1)[:, :Lq]                 # [B, Lq, nk]
    raw = _raw_logits(q, k, *additive_masks(pad, attn))
    m = torch.full((B, H, Lq, 1), -math.inf)
    total = torch.zeros((B, H, Lq, 1))
    acc = torch.zeros_like(q)
    for t in range(tiles.shape[2]):
        keys = slice(t * tk, min((t + 1) * tk, Lk))
        s = torch.clamp_min(raw[..., keys], NEG)
        mnew = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr, p = torch.exp(m - mnew), torch.exp(s - mnew)
        on = rows[:, None, :, t, None]
        total = torch.where(on, total * corr + p.sum(dim=-1, keepdim=True), total)
        acc = torch.where(on, acc * corr + p @ v[..., keys, :], acc)
        m = torch.where(on, mnew, m)
    empty = ~(m > NEG)
    out = torch.where(empty, v.mean(dim=2, keepdim=True), acc / total)
    stats = torch.cat([torch.where(empty, NEG, m), torch.where(empty, float(Lk), total)], -1)
    computed = rows.repeat_interleave(tk, 2)[:, :, :Lk]
    nq = tiles.shape[1]
    padded = torch.zeros((B, nq * tq), dtype=torch.bool)
    padded[:, :Lq] = empty.any(dim=1)[..., 0]
    return out, stats, computed, padded.view(B, nq, tq).any(dim=-1)


@pytest.mark.parametrize("Lq,Lk,lens,causal", [
    (200, 200, (0, 63, 64, 65), True), (130, 200, (63, 64, 65, 200), True),
    (150, 200, (0, 63, 64, 65), False), (601, 601, (0, 1, 333, 601), True)],
    ids=["causal-tile-borders-padded", "lq-ne-lk", "no-attn-mask-padded", "lk-601"])
def test_skipping_masked_flash_tiles_keeps_the_forward(Lq, Lk, lens, causal):
    """K4's skip rule: the online softmax over only the pairs of
    ``FLASH_TILE`` tiles that ``mha_tiles`` marks, with the extra pass for
    rows with no allowed key, gives ``flash_mha_plain``'s out (rtol 1e-4,
    atol 1e-5: float32 sums in another order) and statistics: the max
    exactly, the sum to the same tolerance. An example whose keys are all
    masked (length 0) computes no pair, and its rows come out as the mean of
    their Lk values with statistics (finfo.min, Lk); the query tiles that
    make the extra pass are those ``mha_tiles`` reports."""
    rng = np.random.default_rng(Lq + Lk + len(lens) + 1)
    B, H, Dh = len(lens), 2, 8
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32))
            for _ in range(2))
    pad = torch.from_numpy(np.arange(Lk)[None, :] >= np.asarray(lens)[:, None])
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool), 1) if causal else None
    want, want_stats = flash_mha_plain(q, k, v, *additive_masks(pad, attn))
    out, stats, computed, extra = _tile_skipped_flash_fwd(q, k, v, pad, attn)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(stats[..., 0], want_stats[..., 0])
    np.testing.assert_allclose(stats[..., 1].numpy(), want_stats[..., 1].numpy(), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(extra, mha_tiles(pad, attn, Lq, Lk, *FLASH_TILE)[1])
    assert not bool(computed.all())
    if lens[0] == 0:
        assert not bool(computed[0].any()) and bool(extra[0].all())
        assert bool((stats[0, ..., 0] == NEG).all() and (stats[0, ..., 1] == Lk).all())
        assert float(want[0].abs().max()) > 100 * ATOL
    else:
        assert not bool(extra.any())


@pytest.mark.parametrize("dropout,training,branch", [
    (0.0, True, "fused_mha"), (0.1, False, "fused_mha"), (0.1, True, "plain")])
def test_long_layer_dispatch(monkeypatch, dropout, training, branch):
    """At L > 256, outside the fused layer's gate, an eval call or a
    training call with dropout 0 takes the projections + ``fused_mha``
    branch (the flash route at L > 512); a training call with dropout > 0
    takes the dense plain layer, as the JAX ``_xla_layer`` does
    (``layers.py:413``: its attention kernels have no dropout inside)."""
    from recstudio_torch.models.module import TransformerLayer, layers
    taken = []
    for name in ("fused_mha", "transformer_layer_plain"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **k:
                            taken.append(_n) or _f(*a, **k))
    layer = TransformerLayer(16, 2, 32, dropout, "gelu", 1e-12).train(training)
    out = layer(torch.randn(2, 600, 16), rng=torch.Generator().manual_seed(0))
    assert out.shape == (2, 600, 16)
    assert taken == ["fused_mha" if branch == "fused_mha" else "transformer_layer_plain"]


# ---------------------------------------------------------------------------
# SASRec at max_seq_len 600 (d 16, dropout 0): every layer's attention takes
# the flash route in the port; the JAX model on the CPU runs ``_xla_layer``'s
# dense attention (``supports_pallas()`` is False there), the same function.
L_LONG, D, ROWS = 600, 16, 24


@pytest.fixture(scope="module")
def long_pair():
    jcls, jconf = jax_get_model("SASRec")
    jconf["model"].update(embed_dim=D, dropout_rate=0.0)
    jds = jcls._get_dataset_class()("ml-100k", config={"max_seq_len": L_LONG})
    jtrn, _, jtst = jds.build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params)

    cls, conf = get_model("SASRec")
    conf["model"].update(embed_dim=D, dropout_rate=0.0)
    ds = cls._get_dataset_class()("ml-100k", config={"max_seq_len": L_LONG})
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))
    assert ds.max_seq_len == jds.max_seq_len == L_LONG
    return jmodel, jtst, model, trn, tst


def test_long_sasrec_training_step_matches_jax(long_pair):
    """One step's loss and every gradient (after ``zero_pad_rows_in_grads``)
    against the JAX model's, with the same numpy negatives injected into
    both; the batch holds the longest training windows (ml-100k's longest
    is 506 items; every layer attends over all 600 keys, masked or not) and
    evenly spaced rows, every one with seqlen >= 1."""
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    jmodel, _, model, trn, _ = long_pair
    rows = trn.data_index
    seqlen = rows[:, 2] - rows[:, 1]
    idx = np.concatenate([np.argsort(-seqlen, kind="stable")[:ROWS // 2],
                          np.arange(0, len(rows), len(rows) // (ROWS // 2))[:ROWS // 2]])
    assert seqlen[idx].max() == seqlen.max() and seqlen[idx].min() >= 1
    batch = trn._get_pos_batch(idx)
    neg = np.random.default_rng(23).integers(1, trn.num_items, size=(ROWS, 1))
    zeros = np.zeros((ROWS, 1), np.float32)
    jmodel.sampling = lambda *a, **k: (jnp.zeros(ROWS), jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (torch.zeros(ROWS), torch.from_numpy(neg),
                                      torch.from_numpy(zeros))
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jmodel.states)
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    counts = flash_mha_fwd.launches, flash_mha_bwd_dq.launches, flash_mha_bwd_dkv.launches
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    assert (flash_mha_fwd.launches, flash_mha_bwd_dq.launches,
            flash_mha_bwd_dkv.launches) == counts      # the CPU counts no launch
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})

    def compare(ours, theirs, path=""):
        if isinstance(theirs, dict):
            assert sorted(ours) == sorted(theirs), path
            for key in theirs:
                compare(ours[key], theirs[key], f"{path}/{key}")
            return
        np.testing.assert_allclose(ours, theirs, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(theirs).max()), 1e-3),
                                   err_msg=path)

    compare(grads, jgrads)


def test_long_sasrec_served_topk_matches_jax(long_pair):
    """Served top-20 lists of the test users with the longest histories and
    of the first ones, from the same weights, against the JAX Predictor's."""
    jmodel, jtst, model, _, tst = long_pair
    batch = next(iter(tst.eval_loader(len(tst.data_index))))
    n = int(batch["_size"])
    longest = np.argsort(-batch["seqlen"][:n], kind="stable")[:16]
    pred = Predictor(model, max_batch=16, k=20, train_data=tst)
    jpred = JaxPredictor(jmodel, max_batch=16, k=20, train_data=jtst)
    for rows in (longest, np.arange(16)):
        req = {f: batch[f][rows] for f in ("in_item_id", "seqlen", "user_id")}
        s, i = pred(req)
        with jax.default_matmul_precision("float32"):
            js, ji = jpred(req)
        np.testing.assert_allclose(s, np.asarray(js), rtol=RTOL, atol=ATOL)
        assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0
