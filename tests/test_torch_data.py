"""The port's ETL gives exactly the JAX package's datasets on ml-100k."""
import filecmp

import numpy as np
import pytest

from recstudio_tpu.data import SeqDataset as JaxSeqDataset
from recstudio_tpu.data import TripletDataset as JaxTripletDataset
from recstudio_tpu.data.synthetic import _write_inter as jax_write_inter

from recstudio_torch.data import SeqDataset, TripletDataset
from recstudio_torch.data.synthetic import generate, write_inter

SEQ_BUILD = dict(split_ratio=2, test_rep=True, train_rep=True)


@pytest.fixture(scope="module")
def seq_pair():
    ours = SeqDataset("ml-100k")
    theirs = JaxSeqDataset("ml-100k")
    return (ours, ours.build(**SEQ_BUILD)), (theirs, theirs.build(**SEQ_BUILD))


def test_sizes_and_vocab(seq_pair):
    (ours, _), (theirs, _) = seq_pair
    assert (ours.num_users, ours.num_items) == (theirs.num_users, theirs.num_items) == (944, 1575)
    for field in ("user_id", "item_id"):
        assert list(ours.field2tokens[field]) == list(theirs.field2tokens[field])


@pytest.mark.parametrize("split", [0, 1, 2], ids=["train", "val", "test"])
def test_split_index_and_history(seq_pair, split):
    (_, ours), (_, theirs) = seq_pair
    np.testing.assert_array_equal(ours[split].data_index, theirs[split].data_index)
    np.testing.assert_array_equal(ours[split].user_hist, theirs[split].user_hist)
    np.testing.assert_array_equal(ours[split].user_count, theirs[split].user_count)


@pytest.mark.parametrize("split", [1, 2], ids=["val", "test"])
def test_first_eval_batch(seq_pair, split):
    (_, ours), (_, theirs) = seq_pair
    got = next(iter(ours[split].eval_loader(128)))
    want = next(iter(theirs[split].eval_loader(128)))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_padded_tail_batch(seq_pair):
    (_, ours), (_, theirs) = seq_pair
    got = list(ours[2].eval_loader(128))[-1]
    want = list(theirs[2].eval_loader(128))[-1]
    assert int(got["_size"]) == int(want["_size"]) == 943 % 128
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("shuffle", [False, True])
def test_triplet_leave_one_out(shuffle):
    """TripletDataset drops duplicate pairs and splits leave-one-out over
    the first occurrences (``rep=False``), shuffling within users."""
    np.random.seed(5)
    ours = TripletDataset("ml-100k").build(split_ratio=2, shuffle=shuffle)
    np.random.seed(5)
    theirs = JaxTripletDataset("ml-100k").build(split_ratio=2, shuffle=shuffle)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.data_index, b.data_index)
        np.testing.assert_array_equal(a.user_hist, b.user_hist)
    got = next(iter(ours[2].eval_loader(64)))
    want = next(iter(theirs[2].eval_loader(64)))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("shape,seed", [((50, 40, 900), 7), ((300, 200, 20000), 3)])
def test_synthetic_file_is_byte_identical(tmp_path, shape, seed):
    write_inter(str(tmp_path / "ours.inter"), *shape, seed)
    jax_write_inter(str(tmp_path / "theirs.inter"), *shape, seed, 2000)
    assert filecmp.cmp(tmp_path / "ours.inter", tmp_path / "theirs.inter", shallow=False)


def test_synthetic_dataset_loads(tmp_path):
    name, config = generate("tiny-shape", 60, 50, 3000, out_dir=str(tmp_path), seed=1)
    config["max_seq_len"] = 30
    ds = SeqDataset(name, config=config)
    trn, val, tst = ds.build(**SEQ_BUILD)
    assert ds.num_users == 61 and ds.num_inters == 3000
    assert len(val.data_index) == len(tst.data_index) == 60
    batch = next(iter(tst.eval_loader(16)))
    assert batch["in_item_id"].shape == (16, 30)


@pytest.mark.parametrize("which", ["first", "tail"])
def test_train_loader_matches_jax(seq_pair, which):
    """Unshuffled training batches equal the JAX loader's, the tail batch
    wrapped to the epoch's head in both."""
    (_, ours), (_, theirs) = seq_pair
    got = list(ours[0].train_loader(512, shuffle=False))
    want = list(theirs[0].train_loader(512, shuffle=False))
    assert len(got) == len(want) == -(-len(ours[0].data_index) // 512)
    g, w = (got[0], want[0]) if which == "first" else (got[-1], want[-1])
    assert sorted(g) == sorted(w) and int(g["_size"]) == 512
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_device_batch_fn_matches_jax_pos_batch(seq_pair):
    """The device-resident window gather gives the JAX package's
    ``_get_pos_batch`` batch for the same indices (here on the CPU)."""
    import torch
    (_, ours), (_, theirs) = seq_pair
    host, batch_fn = ours[0].device_epoch_arrays()
    arrays = {k: torch.from_numpy(v) for k, v in host.items()}
    n = len(ours[0].data_index)
    sel = np.random.default_rng(0).integers(0, n, 300)
    sel[:2] = [0, n - 1]
    got = batch_fn(arrays, torch.from_numpy(sel))
    want = theirs[0]._get_pos_batch(sel)
    assert sorted(got) == sorted(want)
    for key in want:
        assert str(got[key].dtype).replace("torch.", "") == str(want[key].dtype), key
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)


def test_device_staging_raises_instead_of_truncating(seq_pair):
    import copy
    (_, ours), _ = seq_pair
    trn = copy.copy(ours[0])
    trn._use_field = {trn.fuid}                    # nothing left to stage
    with pytest.raises(ValueError, match="no interaction column"):
        trn.device_epoch_arrays()
    for col, match in ((np.full(ours[0].num_inters, 2 ** 31, np.int64), "outside int32"),
                       (np.full(ours[0].num_inters, 0.1, np.float64), "not exact in float32")):
        trn = copy.copy(ours[0])
        trn.inter_feat = copy.copy(trn.inter_feat)
        trn.inter_feat._data = dict(trn.inter_feat._data, rating=col)
        with pytest.raises(ValueError, match=match):
            trn.device_epoch_arrays()
