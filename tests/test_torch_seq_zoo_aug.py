"""The six sequence augmentations against the JAX package's, bit for bit.

Each port augmentation is a draw and a map (``models/module/
data_augmentation.py``); the map is fed the JAX package's own draws (the
uniforms and integers ``jax.random`` gives the JAX function's key, split
as it splits it) and must return the JAX view exactly: the same ids, the
same lengths, int32. The batch holds the edge rows: a history of length 0,
1 and L, a full row that ``item_insert`` overflows (it keeps the last L
items), and ordinary ones; twenty keys each.
"""
import numpy as np
import pytest
import torch

B, L, N = 10, 12, 40
KEYS = range(20)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    seqlen = np.array([1, L, 5, 3, L, 7, 2, 11, 0, L], np.int32)
    seq = np.zeros((B, L), np.int32)
    for b in range(B):
        seq[b, :seqlen[b]] = rng.integers(1, N, seqlen[b])
    top1 = rng.integers(1, N, N).astype(np.int32)
    top1[0] = 0
    return seq, seqlen, top1


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_view(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("eta", [0.2, 0.6])
def test_item_crop_matches_jax(batch, eta):
    """``(eta * seqlen)`` in float32, truncated: the crop lengths of 0.2 and
    0.6 of lengths 1 to 12."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_crop
    from recstudio_torch.models.module.data_augmentation import crop_map
    seq, seqlen, _ = batch
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_crop(key, jnp.asarray(seq), jnp.asarray(seqlen), eta)
        _assert_view(crop_map(_t(seq), _t(seqlen), _t(jax.random.uniform(key, (B,))), eta), want)


def test_item_mask_matches_jax(batch):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_mask
    from recstudio_torch.models.module.data_augmentation import mask_map
    seq, seqlen, _ = batch
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_mask(key, jnp.asarray(seq), jnp.asarray(seqlen), mask_id=N)
        got = mask_map(_t(seq), _t(seqlen), _t(jax.random.uniform(key, (B, L))), 0.3, N)
        _assert_view(got, want)


def test_item_reorder_matches_jax(batch):
    """The window shuffled by a stable sort of ``start + noise``."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_reorder
    from recstudio_torch.models.module.data_augmentation import reorder_map
    seq, seqlen, _ = batch
    moved = 0
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_reorder(key, jnp.asarray(seq), jnp.asarray(seqlen))
        got = reorder_map(_t(seq), _t(seqlen), _t(jax.random.uniform(key, (B,))),
                          _t(jax.random.uniform(jax.random.fold_in(key, 1), (B, L))))
        _assert_view(got, want)
        moved += int((got[0].numpy() != seq).any())
    assert moved == len(KEYS)


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_item_substitute_matches_jax(batch, rate):
    """At least one substitution a row (the argmin of the uniforms over true
    positions), at a rate that leaves only that one and at one that does
    not."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_substitute
    from recstudio_torch.models.module.data_augmentation import substitute_map
    seq, seqlen, top1 = batch
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_substitute(key, jnp.asarray(seq), jnp.asarray(seqlen), jnp.asarray(top1),
                               rate)
        got = substitute_map(_t(seq), _t(seqlen), _t(jax.random.uniform(key, (B, L))),
                             _t(top1), rate)
        _assert_view(got, want)


@pytest.mark.parametrize("rate", [0.05, 0.5, 1.0])
def test_item_insert_matches_jax(batch, rate):
    """Insertions before the picked positions, left-compacted by a stable
    sort; full rows overflow and keep their last L items (rate 1 doubles
    every row)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_insert
    from recstudio_torch.models.module.data_augmentation import insert_map
    seq, seqlen, top1 = batch
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_insert(key, jnp.asarray(seq), jnp.asarray(seqlen), jnp.asarray(top1), rate)
        got = insert_map(_t(seq), _t(seqlen), _t(jax.random.uniform(key, (B, L))), _t(top1),
                         rate)
        _assert_view(got, want)
        assert int(got[1][1]) == L                     # row 1 was full: it overflowed
        if rate == 1.0:
            real = seqlen > 0
            np.testing.assert_array_equal(got[1].numpy()[real], np.minimum(2 * seqlen, L)[real])


def test_item_random_matches_jax(batch):
    """Each row's crop, mask or reorder view by its drawn choice."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_random
    from recstudio_torch.models.module.data_augmentation import random_map
    seq, seqlen, _ = batch
    seen = set()
    for s in KEYS:
        key = jax.random.PRNGKey(s)
        want = item_random(key, jnp.asarray(seq), jnp.asarray(seqlen), mask_id=N)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        draws = {"crop": _t(jax.random.uniform(k1, (B,))),
                 "mask": _t(jax.random.uniform(k2, (B, L))),
                 "reorder": _t(jax.random.uniform(k3, (B,))),
                 "reorder_noise": _t(jax.random.uniform(jax.random.fold_in(k3, 1), (B, L))),
                 "choice": _t(jax.random.randint(k4, (B, 1), 0, 3)[:, 0])}
        seen |= set(draws["choice"].tolist())
        _assert_view(random_map(_t(seq), _t(seqlen), draws, N), want)
    assert seen == {0, 1, 2}


def test_draws_come_from_the_generator(batch):
    """The augmentations' draws: from the generator given, on the batch's
    device; the same seed gives the same view, another seed another."""
    from recstudio_torch.models.module import data_augmentation as A
    seq, seqlen, top1 = (_t(a) for a in batch)

    def views(seed):
        g = torch.Generator().manual_seed(seed)
        return [A.item_crop(seq, seqlen, 0.6, generator=g), A.item_mask(seq, seqlen, 0.3, N, g),
                A.item_reorder(seq, seqlen, generator=g),
                A.item_random(seq, seqlen, N, generator=g),
                A.item_substitute(seq, seqlen, top1, generator=g),
                A.item_insert(seq, seqlen, top1, generator=g)]
    a, b, c = views(1), views(1), views(2)
    for (sa, la), (sb, lb) in zip(a, b):
        assert torch.equal(sa, sb) and torch.equal(la, lb)
        assert sa.shape == (B, L) and la.shape == (B,) and int(la.max()) <= L
    assert any(not torch.equal(x[0], y[0]) for x, y in zip(a, c))
    draws = A.random_draws((B, L), torch.Generator().manual_seed(0), torch.device("cpu"))
    assert draws["choice"].shape == (B,) and set(draws["choice"].tolist()) <= {0, 1, 2}
