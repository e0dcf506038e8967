"""The port's ``UserDataset`` against the JAX package's on ml-100k.

Both build the same splits from the same numpy seed (the ratio split draws
its permutations from numpy's global stream) in ``user_entry`` mode, the
one the autoencoder configs use, and in ``user`` mode (whole users per
split); ``entry`` mode has no per-user rows and raises in both. Every
split's ``data_index``, history tables and windows must be equal; at
evaluation ``user_hist`` is the history window; the device staging's
batches equal the host batches.
"""
import numpy as np
import pytest
import torch

from recstudio_tpu.data.dataset import UserDataset as JaxUserDataset

from recstudio_torch.data import UserDataset

MODES = ("user_entry", "user")
SEED = 2022


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def build(cls, mode):
    np.random.seed(SEED)
    return cls("ml-100k").build(split_mode=mode)


@pytest.fixture(scope="module", params=MODES)
def pair(request):
    return request.param, build(UserDataset, request.param), build(JaxUserDataset, request.param)


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("split", [0, 1, 2], ids=["train", "val", "test"])
def test_data_index_and_histories(pair, split):
    mode, ours, theirs = pair
    got, want = ours[split], theirs[split]
    assert got.data_index.shape[1] == 6
    np.testing.assert_array_equal(got.data_index, want.data_index)
    np.testing.assert_array_equal(got.inter_feat_subset, want.inter_feat_subset)
    np.testing.assert_array_equal(got.user_hist, want.user_hist)
    np.testing.assert_array_equal(got.user_count, want.user_count)
    assert (got._in_width(), got._eval_target_width()) == \
        (want._in_width(), want._eval_target_width())
    if mode == "user_entry" and split == 1:     # every user keeps a validation window
        assert (got.data_index[:, 5] > got.data_index[:, 4]).all()


@pytest.mark.parametrize("split", [0, 1, 2], ids=["train", "val", "test"])
def test_windows_on_every_row(pair, split):
    _, ours, theirs = pair
    idx = np.arange(len(ours[split].data_index))
    got = ours[split]._get_pos_batch(idx)
    assert_batches_equal(got, theirs[split]._get_pos_batch(idx))
    assert sorted(got) == ["in_item_id", "in_rating", "item_id", "rating", "user_id"]


@pytest.mark.parametrize("split", [1, 2], ids=["val", "test"])
def test_eval_user_hist_is_the_history_window(pair, split):
    """``UserDataset._make_batch``: at evaluation the mask is the history
    window (the user's training items), not the split's ``user_hist``
    table, which for the test split also holds the validation items."""
    mode, ours, theirs = pair
    for got, want in zip(ours[split].eval_loader(128), theirs[split].eval_loader(128)):
        np.testing.assert_array_equal(got["user_hist"], got["in_item_id"])
        assert_batches_equal(got, want)
    if split == 2 and mode == "user_entry":     # the two masks differ here
        data = ours[split]
        table = data.user_hist[data.data_index[:, 0]]
        window = data._get_pos_batch(np.arange(len(data.data_index)))["in_item_id"]
        assert (table > 0).sum() > (window > 0).sum()


@pytest.mark.parametrize("split", [0, 2], ids=["train", "test"])
def test_device_batches_equal_host_batches(pair, split):
    """``device_epoch_arrays``'s batch function on a strided selection (CPU
    tensors here) against ``_get_pos_batch`` of the same rows."""
    _, ours, _ = pair
    data = ours[split]
    host, batch_fn = data.device_epoch_arrays()
    assert sorted(host) == ["_fiid", "_rating", "_rows"]
    arrays = {k: torch.as_tensor(v) for k, v in host.items()}
    n = len(data.data_index)
    sel = np.r_[np.arange(0, n, 7), n - 1]
    got = batch_fn(arrays, torch.as_tensor(sel))
    want = data._get_pos_batch(sel)
    assert_batches_equal({k: v.numpy() for k, v in got.items()}, want)


def test_entry_mode_raises():
    """A ratio split over all rows gives no per-user rows, so there is no
    history window: the JAX ``UserDataset`` fails there, and the port
    says why."""
    np.random.seed(SEED)
    with pytest.raises(ValueError, match="one split row per user"):
        UserDataset("ml-100k").build(split_mode="entry")
    np.random.seed(SEED)
    with pytest.raises(Exception):
        JaxUserDataset("ml-100k").build(split_mode="entry")


def test_dataset_side_negatives_raise():
    with pytest.raises(NotImplementedError, match="negatives"):
        UserDataset("ml-100k").build(neg_count=1)
