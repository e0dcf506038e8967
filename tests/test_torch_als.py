"""``ALSDataset`` and ``item_freq`` against the JAX package's on ml-100k.

From the same numpy seed the grouped training split (``data_index``,
``_row_pool``, ``_pool_width``) and its batches are the JAX package's,
exactly, by user and transposed by item; evaluation batches are a
``TripletDataset``'s; the device staging (``device_epoch_arrays``) gives
``_get_pos_batch``'s batches; ``item_freq`` counts each split's items as
the JAX property does.
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(scope="module")
def als_pair():
    from recstudio_tpu.data.advance_dataset import ALSDataset as JaxALS
    from recstudio_torch.data import ALSDataset
    np.random.seed(SPLIT_SEED)
    ours = ALSDataset("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    np.random.seed(SPLIT_SEED)
    theirs = JaxALS("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    return ours, theirs


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("transposed", [False, True], ids=["by-user", "by-item"])
def test_grouped_split_and_batches_match_jax(als_pair, transposed):
    ours, theirs = als_pair
    a, b = ours[0], theirs[0]
    if transposed:
        a, b = a.transpose(), b.transpose()
    np.testing.assert_array_equal(a.data_index, b.data_index)
    np.testing.assert_array_equal(a._row_pool, b._row_pool)
    assert a._pool_width() == b._pool_width() > 1
    a.eval_mode = b.eval_mode = False
    sel = np.random.default_rng(1).integers(0, len(a.data_index), 64)
    _same(a._get_pos_batch(sel), b._get_pos_batch(sel))


def test_eval_batches_match_jax(als_pair):
    ours, theirs = als_pair
    for k in (1, 2):
        _same(next(iter(ours[k].eval_loader(32))), next(iter(theirs[k].eval_loader(32))))


def test_device_staging_gives_the_host_batches(als_pair):
    trn = als_pair[0][0]
    host, batch_fn = trn.device_epoch_arrays()
    arrays = {k: torch.from_numpy(v) for k, v in host.items()}
    sel = np.random.default_rng(2).integers(0, len(trn.data_index), 50)
    trn.eval_mode = False
    want = trn._get_pos_batch(sel)
    got = {k: v.numpy() for k, v in batch_fn(arrays, torch.from_numpy(sel)).items()}
    _same(got, want)
    assert got["item_id"].shape == (50, trn._pool_width())


def test_dataset_side_negatives_raise():
    from recstudio_torch.data import ALSDataset
    with pytest.raises(NotImplementedError, match="dataset-side negatives"):
        ALSDataset("ml-100k").build(neg_count=2)


def test_item_freq_matches_jax(als_pair):
    from recstudio_tpu.data import TripletDataset as JaxTriplet
    from recstudio_torch.data import TripletDataset
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    np.random.seed(SPLIT_SEED)
    theirs = JaxTriplet("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.item_freq, b.item_freq)
        assert a.item_freq.shape == (a.num_items,) and a.item_freq[0] == 0
    assert ours[0].item_freq.sum() == len(ours[0].data_index)
