"""The port's k-means and CSR index against the JAX package's.

Both start from the same rows: the test draws the JAX run's initial rows
(a permutation's first ``k``) and each round's reseed rows with the JAX
function's own keys and passes them to the port. Centres agree to rtol
1e-5 (atol 1e-6), assignments exactly; the data are well-separated
clusters, so no distance ties. ``construct_index`` agrees bit for bit.
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _blobs(seed, n, d, centres, spread=0.05, dup_share=0.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, (centres, d))
    x = c[rng.integers(0, centres, n)] + rng.normal(0.0, spread, (n, d))
    if dup_share:                       # many copies of one row: identical initial centres
        x[: int(n * dup_share)] = x[0]
    return x.astype(np.float32)


def _jax_draws(key, n, k, max_iter):
    """The rows the JAX ``kmeans`` draws from ``key`` (``kmeans.py:26-45``)."""
    import jax
    init_key, loop_key = jax.random.split(key)
    init_idx = np.array(jax.random.permutation(init_key, n)[:k])
    reseed = np.stack([np.array(jax.random.randint(jax.random.fold_in(loop_key, i), (k,), 0, n))
                       for i in range(max_iter)])
    return init_idx, reseed


@pytest.mark.parametrize("n,d,k,centres,dup", [(400, 6, 8, 8, 0.0), (300, 4, 5, 3, 0.0),
                                               (256, 8, 6, 6, 0.6)],
                         ids=["matched", "more-centres-than-blobs", "duplicate-rows"])
def test_kmeans_matches_jax_from_the_same_rows(n, d, k, centres, dup):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.ops.kmeans import kmeans as jax_kmeans
    from recstudio_torch.ops.kmeans import kmeans
    x = _blobs(n + d, n, d, centres, dup_share=dup)
    key = jax.random.PRNGKey(n)
    max_iter = 12
    with jax.default_matmul_precision("float32"):
        jc, ja = jax_kmeans(key, jnp.asarray(x), k, max_iter)
    init_idx, reseed = _jax_draws(key, n, k, max_iter)
    c, a = kmeans(torch.from_numpy(x), k, max_iter, init_idx=torch.from_numpy(init_idx),
                  reseed_idx=torch.from_numpy(reseed))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)


def test_kmeans_reseeds_empty_clusters():
    """Identical initial centres leave all but one empty; each round moves
    the empty ones to that round's reseed rows."""
    from recstudio_torch.ops.kmeans import kmeans
    x = torch.from_numpy(_blobs(3, 60, 3, 3))
    init = torch.zeros(4, dtype=torch.long)             # four copies of row 0
    reseed = torch.tensor([[5, 17, 33, 41]])
    c, _ = kmeans(x, 4, 1, init_idx=init, reseed_idx=reseed)
    np.testing.assert_array_equal(c[1:].numpy(), x[[17, 33, 41]].numpy())
    np.testing.assert_allclose(c[0].numpy(), x.mean(0).numpy(), rtol=1e-5, atol=1e-6)


def test_kmeans_repeats_bit_for_bit_from_a_generator():
    from recstudio_torch.ops.kmeans import kmeans
    x = torch.from_numpy(_blobs(5, 500, 8, 10))
    runs = [kmeans(x, 10, 30, torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    other = kmeans(x, 10, 30, torch.Generator().manual_seed(10))[0]
    assert not torch.equal(runs[0][0], other)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_construct_index_bitwise(k):
    import jax.numpy as jnp
    from recstudio_tpu.ops.kmeans import construct_index as jax_index
    from recstudio_torch.ops.kmeans import construct_index
    assign = np.random.default_rng(k).integers(0, k, 777)
    assign[assign == k - 1] = 0                          # an empty last cluster (k > 1)
    ji, jp = jax_index(jnp.asarray(assign, jnp.int32), k)
    i, p = construct_index(torch.from_numpy(assign), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert int(p[-1]) == 777 and p.shape == (k + 1,)
