"""CUDA kernels of recstudio_torch against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and nvcc; elsewhere they skip. Run on the
card with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``
(``--noconftest``: the shared conftest imports JAX, which the card lacks).
Tolerances: float32 throughout (TF32 off); sums are taken in another order
than PyTorch's, so results agree to float32 rounding, not bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from recstudio_torch.ops.attention import additive_masks, fused_mha, mha_plain
from recstudio_torch.ops.transformer_layer import (fused_transformer_layer,
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


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,causal", [
    (3, 2, 20, 20, 32, True), (2, 2, 200, 200, 64, True), (2, 1, 384, 384, 128, True),
    (2, 4, 7, 45, 16, False), (1, 1, 33, 512, 256, False)])
def test_fused_mha_matches_plain(dev, B, H, Lq, Lk, Dh, causal):
    rng = np.random.default_rng(Lq + Lk + Dh)
    q = torch.from_numpy(rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)).to(dev)
    k, v = (torch.from_numpy(rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    pad = torch.from_numpy(rng.random((B, Lk)) < 0.3).to(dev)
    pad[:, 0] = False
    attn = torch.triu(torch.ones((Lq, Lk), dtype=torch.bool, device=dev), 1) if causal else None
    before = fused_mha.launches
    got = fused_mha(q, k, v, pad, attn)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    want = mha_plain(q, k, v, *additive_masks(pad, attn))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


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
    with pytest.raises(NotImplementedError):
        big = torch.zeros((1, 1, 600, 16), device=dev)
        fused_mha(big, big, big)


@pytest.mark.parametrize("B,L,D,F,H,act,eps", [
    (5, 20, 64, 128, 2, "gelu", 1e-12), (3, 200, 128, 128, 2, "gelu", 1e-12),
    (4, 37, 96, 160, 3, "relu", 1e-6), (2, 256, 256, 1024, 4, "gelu", 1e-5)])
def test_fused_transformer_layer_matches_plain(dev, B, L, D, F, H, act, eps):
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


def test_fused_transformer_layer_refuses_training_dropout(dev):
    tree = random_sasrec_params(0, 2, 32, 1, 64, 1)
    params = {n: t.to(dev) for n, t in
              layer_params_from_jax(tree["query_encoder"]["transformer"]["layer_0"]).items()}
    x = torch.zeros((2, 4, 32), device=dev)
    with pytest.raises(NotImplementedError):
        fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, True)
    assert math.isfinite(float(
        fused_transformer_layer(x, params, None, None, 2, 0.1, "gelu", 1e-12, False).sum()))
