"""``SeqToSeqDataset`` and ``FullSeqDataset`` against the JAX package's on
the in-tree ml-100k, exactly (ids, windows and batches are integers;
ratings float32 copies).

- ``data_index`` of the three splits, with repeated targets kept
  (``train_rep``/``test_rep`` true, the seq family's default) and dropped;
- ``_get_pos_batch`` in training (the source window and the target window
  shifted by one) and in evaluation (the single target at the window's
  end), and the loaders' batches with ``user_hist``;
- the device staging (one ``[L + 1, C]`` slice an example) against the
  host batches, ``inter_feat_subset`` and the history tables.
"""
import numpy as np
import pytest
import torch

L = 12


@pytest.fixture(scope="module")
def jax_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def _splits(pkg, cls_name, rep, jax_csv=None):
    if pkg == "jax":
        from recstudio_tpu.data import dataset as mod
    else:
        from recstudio_torch.data import dataset as mod
    cls = getattr(mod, cls_name)
    return cls("ml-100k", config={"max_seq_len": L}).build(split_ratio=2, test_rep=rep,
                                                           train_rep=rep)


@pytest.fixture(scope="module", params=[True, False], ids=["rep", "no-rep"])
def pairs(request, jax_csv):
    rep = request.param
    return _splits("jax", "SeqToSeqDataset", rep), _splits("port", "SeqToSeqDataset", rep)


def _assert_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_data_index_matches_jax(pairs):
    jax_splits, port_splits = pairs
    for j, p in zip(jax_splits, port_splits):
        np.testing.assert_array_equal(p.data_index, j.data_index)
        assert p.data_index.dtype == np.int64 and len(p.data_index) > 0
    trn = port_splits[0]
    lens = trn.data_index[:, 2] - trn.data_index[:, 1]
    assert lens.max() == L and lens.min() >= 1


def test_training_batches_match_jax(pairs):
    """Every training row: the source window, the shifted targets (0 past
    the window) and the user's id, as the JAX package builds them."""
    (jtrn, _, _), (trn, _, _) = pairs
    idx = np.arange(len(trn.data_index))
    got, want = trn._get_pos_batch(idx), jtrn._get_pos_batch(idx)
    _assert_batches(got, want)
    assert got["item_id"].shape == (len(idx), L)
    n = got["seqlen"]
    np.testing.assert_array_equal(got["item_id"][:, :-1][got["in_item_id"][:, 1:] > 0],
                                  got["in_item_id"][:, 1:][got["in_item_id"][:, 1:] > 0])
    assert (got["item_id"][np.arange(L)[None] >= n[:, None]] == 0).all()


@pytest.mark.parametrize("split", [1, 2], ids=["val", "test"])
def test_evaluation_batches_match_jax(pairs, split):
    """The evaluation loaders' padded batches: the window, the one target
    at its end, the history table and the true row count."""
    jax_splits, port_splits = pairs
    j, p = jax_splits[split], port_splits[split]
    for got, want in zip(p.eval_loader(128), j.eval_loader(128)):
        _assert_batches(got, want)
        assert got["item_id"].ndim == 1 and "user_hist" in got


def test_device_staging_matches_the_host_batches(pairs):
    """``device_epoch_arrays``: one gather of ``[L + 1, C]`` an example gives
    the host batch of any rows, in any order."""
    _, (trn, _, _) = pairs
    host, batch_fn = trn.device_epoch_arrays()
    assert host["_interpack"].shape == (trn.num_inters + L + 1, 2)
    arrays = {k: torch.from_numpy(v) for k, v in host.items()}
    sel = np.random.default_rng(0).permutation(len(trn.data_index))[:300]
    got = batch_fn(arrays, torch.from_numpy(sel))
    want = trn._get_pos_batch(sel)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_histories_match_jax(pairs):
    """The training rows an item table and a history mask are built from
    (``inter_feat_subset``: each window and its last target), and the
    splits' ``user_hist``."""
    (jtrn, jval, jtst), (trn, val, tst) = pairs
    np.testing.assert_array_equal(trn.inter_feat_subset, jtrn.inter_feat_subset)
    for j, p in ((jtrn, trn), (jval, val), (jtst, tst)):
        np.testing.assert_array_equal(p.user_hist, j.user_hist)
    np.testing.assert_array_equal(trn.item_freq, np.bincount(
        trn.inter_feat.get_col("item_id")[trn.inter_feat_subset], minlength=trn.num_items))


def test_full_seq_dataset_matches_jax(jax_csv):
    """One truncated sequence a user a split, and its batches."""
    jax_splits = _splits("jax", "FullSeqDataset", True)
    port_splits = _splits("port", "FullSeqDataset", True)
    for j, p in zip(jax_splits, port_splits):
        np.testing.assert_array_equal(p.data_index, j.data_index)
        assert len(p.data_index) == p.num_users - 1
    j, p = jax_splits[0], port_splits[0]
    idx = np.arange(len(p.data_index))
    _assert_batches(p._get_pos_batch(idx), j._get_pos_batch(idx))


def test_single_user_split_raises():
    from recstudio_torch.data.dataset import _user_splits
    with pytest.raises(NotImplementedError):
        _user_splits((np.zeros((1, 4), np.int64), None))
