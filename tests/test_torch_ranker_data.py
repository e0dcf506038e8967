"""The rankers' data against the JAX package.

- ml-100k under the fm family's config (``low_rating_thres: 0.0``, so
  every rating is kept; ratings binarized at 3.0; ``fmeval``; a per-user
  ratio split shuffled from one numpy seed): the same field types, the
  same flat split rows, the same labels, token ids and float columns, the
  same first eval batch (no ``user_hist`` under ``fmeval``) and the same
  field specs, exactly. The JAX datasets read CSV through the JAX
  package's native library (``test_torch_jax_csv.jax_native_csv``).
- An id-less ``generate_ctr`` dataset (4,000 rows, ``n_float=3``,
  ``vocabs=(1600, 300, 40, 6)``, as ``tests/test_sparse_rows.py`` builds
  it): both generators write the same file, byte for byte, and both
  datasets parse it to the same columns and split it (``entry``, one
  permutation) into the same rows.
"""
import filecmp
import os

import numpy as np
import pytest

SPLIT_SEED = 42
FM_DATA = {"low_rating_thres": 0.0}
FM_BUILD = dict(fmeval=True, binarized_rating_thres=3.0, split_ratio=[0.8, 0.1, 0.1])
CTR_KW = dict(n_float=3, vocabs=(1600, 300, 40, 6))


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def _build(ours_ds, theirs_ds, build):
    np.random.seed(SPLIT_SEED)
    ours = ours_ds.build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = theirs_ds.build(**build)
    return ours, theirs


@pytest.fixture(scope="module")
def ml100k_fm():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    ours, theirs = _build(TripletDataset("ml-100k", config=dict(FM_DATA)),
                          JaxTripletDataset("ml-100k", config=dict(FM_DATA)), FM_BUILD)
    for d in ours + theirs:                        # BaseRanker._set_data_field
        d.use_field = set(d.field2type.keys())
    return ours, theirs


def _assert_same_columns(ours, theirs, fields):
    for f in fields:
        a, b = ours.inter_feat.get_col(f), theirs.inter_feat.get_col(f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_ml100k_fm_fields_and_rows(ml100k_fm):
    ours, theirs = ml100k_fm
    assert ours[0].field2type == theirs[0].field2type
    assert ours[0].num_inters == theirs[0].num_inters == 100_000   # threshold 0.0 keeps all
    for f in ours[0].field2type:
        assert ours[0].num_values(f) == theirs[0].num_values(f), f
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a.data_index.ndim == 1 and a.data_index.dtype == b.data_index.dtype
        np.testing.assert_array_equal(a.data_index, b.data_index, err_msg=f"split {k}")
    assert sum(len(d.data_index) for d in ours) == 100_000
    _assert_same_columns(ours[0], theirs[0], ours[0].inter_feat.fields)


def test_ml100k_labels_are_binarized_at_3(ml100k_fm):
    """Every rating kept (the family's 0.0 overrides ml-100k's 3.0), then
    ratings below 3 are 0.0 and the others 1.0."""
    ours, _ = ml100k_fm
    label = ours[0].inter_feat.get_col("rating")
    assert set(np.unique(label).tolist()) == {0.0, 1.0}
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "recstudio_tpu", "dataset_demo", "ml-100k", "ml-100k.inter")
    raw = np.loadtxt(path, delimiter="\t", skiprows=1, usecols=2)
    assert int(label.sum()) == int((raw >= 3.0).sum())


def test_ml100k_fm_batches(ml100k_fm):
    ours, theirs = ml100k_fm
    sel = np.random.default_rng(0).integers(0, len(ours[0].data_index), 300)
    got, want = ours[0]._get_pos_batch(sel), theirs[0]._get_pos_batch(sel)
    assert sorted(got) == sorted(want) == ["age", "gender", "item_id", "occupation",
                                           "rating", "timestamp", "user_id", "zip_code"]
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for k in (1, 2):
        got = next(iter(ours[k].eval_loader(128)))
        want = next(iter(theirs[k].eval_loader(128)))
        assert "user_hist" not in got and sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_ml100k_field_specs(ml100k_fm):
    from recstudio_tpu.models.module.ctr import make_field_specs as jax_specs
    from recstudio_torch.models.module.ctr import make_field_specs
    ours, theirs = ml100k_fm
    got = make_field_specs(ours[0].use_field, ours[0])
    assert got == jax_specs(theirs[0].use_field, theirs[0])
    assert [t for _, t, _ in got].count("float") == 1 and len(got) == 7


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ctr_pair(tmp_path_factory):
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_tpu.data.synthetic import generate_ctr as jax_generate_ctr
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.data.synthetic import generate_ctr
    base = tmp_path_factory.mktemp("ctr")
    name, config = generate_ctr("ctr-4k", 4000, out_dir=str(base / "port"), seed=0, **CTR_KW)
    jname, jconfig = jax_generate_ctr("ctr-4k", 4000, out_dir=str(base / "jax"), seed=0,
                                      **CTR_KW)
    jconfig["save_cache"] = False
    assert config == {**jconfig, "url": config["url"], "save_cache": True}
    same = filecmp.cmp(os.path.join(config["url"], "ctr-4k.inter"),
                       os.path.join(jconfig["url"], "ctr-4k.inter"), shallow=False)
    ours, theirs = _build(TripletDataset(name, config=config),
                          JaxTripletDataset(jname, config=jconfig),
                          dict(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1]))
    for d in ours + theirs:
        d.use_field = set(d.field2type.keys())
    return same, ours, theirs


def test_ctr_generators_write_the_same_file(ctr_pair):
    assert ctr_pair[0]


def test_ctr_dataset_has_no_ids_and_matches_jax(ctr_pair):
    _, ours, theirs = ctr_pair
    trn = ours[0]
    assert trn.fuid is None and trn.fiid is None and trn.user_feat is None
    assert not hasattr(trn, "user_hist")
    assert trn.field2type == theirs[0].field2type and len(trn.field2type) == 8
    for f in trn.field2type:
        assert trn.num_values(f) == theirs[0].num_values(f), f
    assert [len(d.data_index) for d in ours] == [3200, 400, 400]
    for k, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a.data_index, b.data_index, err_msg=f"split {k}")
    _assert_same_columns(trn, theirs[0], trn.inter_feat.fields)
    got = next(iter(ours[2].eval_loader(256)))
    want = next(iter(theirs[2].eval_loader(256)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
