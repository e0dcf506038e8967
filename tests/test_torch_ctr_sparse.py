"""The packed row-sparse CTR step: the port against the JAX package.

- ``fused_table_lazy_adam_packed`` and ``_blocked_dedup`` against the JAX
  functions on the same numpy inputs: vocabularies on both sides of 1024
  (the JAX package sums the small ones by one-hot products, the port by the
  same sort as the big ones: equal up to float32 order), duplicate ids, the
  global id 0 and rows whose summed gradient is zero; rtol 1e-5, atol
  1e-6 (the JAX package's own, ``tests/test_sparse_rows.py``), untouched
  rows bit for bit;
- two steps of DeepFM's ``_ctr_sparse_grad_step`` (dropout off) on an
  id-less criteo-layout split with a vocabulary past 1024, from the same
  weights, against the JAX package's packed step and against the port's
  dense ``LazyAdam`` (``sparse_rows: false``): parameters, the packed
  moment columns against the dense moments, rtol 2e-4, atol 1e-6; rows no
  batch touched bitwise unchanged; no gradient of the table; a bitwise
  repeat;
- the gate's rejections (``test_ctr_sparse_gate_rejects_ineligible``);
- a packed checkpoint through ``ranker_params_{from,to}_jax``, a saved
  and loaded checkpoint, and ``ScorePredictor`` of a packed model;
- ``write_ctr`` in chunks writes the JAX writer's bytes.
"""
import copy
import hashlib
import os

import numpy as np
import pytest
import torch

SIZES = (40, 2000, 8, 1500)          # fields 1 and 3 past the JAX one-hot cutoff
CTR_ROWS = 4000
CTR_KW = dict(n_float=3, vocabs=(1600, 300, 40, 6))
BUILD = dict(fmeval=True, split_mode="entry", split_ratio=[0.8, 0.1, 0.1])
SPLIT_SEED = 5
BATCH = 256
TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


def _table_case(seed, B=64, D=8):
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(SIZES)[:-1]])
    N = int(sum(SIZES))
    packed = np.concatenate([rng.normal(size=(N, D)), rng.normal(size=(N, D)) * 0.1,
                             rng.random((N, D)) * 0.01], axis=1).astype(np.float32)
    ids2 = np.stack([rng.integers(0, v, size=B) + o for v, o in zip(SIZES, offs)], axis=-1)
    ids2[0, 0] = 0                        # the global [PAD] row
    ids2[5, 1] = ids2[9, 1]               # a duplicate in a big field
    ids2[3, 2] = ids2[4, 2]               # and in a small one
    g = rng.normal(size=(B, len(SIZES), D)).astype(np.float32)
    g[7, 3] = 0.0                         # a row whose summed gradient is zero
    ids2[7, 3] = offs[3] + 1499
    ids2 = ids2.astype(np.int32)
    return packed, ids2, g


@pytest.mark.parametrize("seed", [1, 2])
def test_fused_table_lazy_adam_packed_matches_jax(seed):
    import jax.numpy as jnp
    from recstudio_tpu.models.optim import fused_table_lazy_adam_packed as jax_packed
    from recstudio_torch.models.optim import fused_table_lazy_adam_packed
    packed, ids2, g = _table_case(seed)
    want = np.asarray(jax_packed(SIZES, jnp.asarray(packed), jnp.asarray(ids2),
                                 jnp.asarray(g), jnp.asarray(3, jnp.int32), 1e-2))
    got = torch.from_numpy(packed.copy())
    fused_table_lazy_adam_packed(SIZES, got, torch.from_numpy(ids2).long(),
                                 torch.from_numpy(g), 3, 1e-2)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    touched = np.zeros(len(packed), bool)
    touched[ids2.reshape(-1)] = True
    touched[0] = False
    assert np.array_equal(got[~touched], packed[~touched])          # bit for bit
    assert np.array_equal(got[ids2[7, 3]], packed[ids2[7, 3]])      # zero gradient: untouched
    assert not np.array_equal(got[ids2[5, 1]], packed[ids2[5, 1]])


def test_blocked_dedup_matches_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.optim import _blocked_dedup as jax_dedup
    from recstudio_torch.models.optim import _blocked_dedup
    _, ids2, g = _table_case(3)
    ids, agg = _blocked_dedup(torch.from_numpy(ids2.T.copy()).long(),
                              torch.from_numpy(g.transpose(1, 0, 2).copy()))
    jids, jagg = jax_dedup(jnp.asarray(ids2.T), jnp.asarray(g.transpose(1, 0, 2)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-6, atol=1e-6)


def test_unpack_table_params():
    from recstudio_torch.models.optim import unpack_table_params
    t = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(unpack_table_params(t), t[:, :2])


@pytest.fixture(scope="module")
def ctr_splits(tmp_path_factory):
    """A criteo-layout split with one vocabulary past 1024, read by both
    packages from the JAX writer's file."""
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_tpu.data.synthetic import generate_ctr
    from recstudio_torch.data import TripletDataset
    name, config = generate_ctr("ctr-sparse", CTR_ROWS, seed=5, **CTR_KW,
                                out_dir=str(tmp_path_factory.mktemp("ctr")))
    config["save_cache"] = False
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset(name, config=dict(config)).build(**BUILD)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset(name, config=dict(config)).build(**BUILD)
    return ours, theirs


_BUILT = {}


def _jax_deepfm(theirs, sparse_rows, tmp):
    """A JAX DeepFM fitted for no epoch (so it holds its optimizer state),
    its weights drawn from numpy, N(0, 0.01), the packed tables' moment
    columns and row 0 zero. At the initialisation's scale the split's
    unscaled lognormal floats saturate some logits, whose BCE gradient (a
    few 1e-9) the two packages round some 10 % apart; Adam's first step
    divides each gradient by its own size (eps 1e-8) and turns that into a
    2e-4 move: an ill-conditioned comparison, not a difference of the
    step."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    key = ("jax", sparse_rows)
    if key not in _BUILT:
        cls, conf = jax_get_model("DeepFM")
        conf["train"].update(epochs=0, batch_size=BATCH, learner="sparse_adam",
                             sparse_rows=sparse_rows, epoch_scan="true", seed=11)
        conf["model"]["dropout"] = 0.0
        conf["eval"].update(batch_size=512, val_metrics=["auc"], test_metrics=["auc"],
                            save_path=str(tmp))
        m = cls(conf)
        m.fit(theirs[0], None, run_mode="light")
        rng = np.random.default_rng(7)
        D = conf["model"]["embed_dim"]

        def draw(path, leaf):
            a = rng.normal(0.0, 0.01, leaf.shape).astype(np.float32)
            name = str(getattr(path[-1], "key", path[-1]))
            if name == "token_embedding":
                a[0] = 0.0
                d = 1 if str(getattr(path[0], "key", path[0])) == "linear" else D
                a[:, d:] = 0.0
            return jnp.asarray(a)
        m.params = jax.tree_util.tree_map_with_path(draw, m.params)
        _BUILT[key] = m
    return _BUILT[key]


def _port_deepfm(ours, sparse_rows, tree):
    """The port's DeepFM on the CPU under ``sparse_adam`` and ``sparse_rows``,
    given the weights of the JAX ``tree`` (a packed model takes packed
    tables whole, an unpacked one their first D columns) and a fresh
    optimizer."""
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax
    cls, conf = get_model("DeepFM")
    conf["train"].update(batch_size=BATCH, learner="sparse_adam", sparse_rows=sparse_rows)
    conf["model"]["dropout"] = 0.0
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    model.load_state_dict(ranker_params_from_jax(tree, model.net))
    model.optimizer = model._get_optimizer()
    return model


def _batches(ours, n=2):
    data = ours[0]
    return [{k: torch.from_numpy(v) for k, v in data._get_pos_batch(
        np.arange(i * BATCH, (i + 1) * BATCH)).items()} for i in range(n)]


def _tables(model):
    return {k for k, v in model.net.state_dict().items() if k.endswith("token_embedding.weight")}


def test_packed_step_matches_jax_and_dense_lazy_adam(ctr_splits, tmp_path):
    import jax
    import jax.numpy as jnp
    from recstudio_torch.models.optim import LazyAdam
    from recstudio_torch.utils.convert import ranker_moments_from_jax, ranker_params_to_jax
    ours, theirs = ctr_splits
    jm = _jax_deepfm(theirs, "auto", tmp_path)
    assert jm._ctr_sparse_enabled()
    D = jm.config["model"]["embed_dim"]
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    sparse = _port_deepfm(ours, "auto", params)
    dense = _port_deepfm(ours, "false", params)
    assert sparse._ctr_sparse_enabled() and not dense._ctr_sparse_enabled()
    assert isinstance(dense.optimizer, LazyAdam)
    tables = _tables(sparse)
    assert tables == {"embedding.token_embedding.weight", "linear.embedding.token_embedding.weight"}
    assert max(sparse.net.embedding.sizes) > 1024
    before = {k: v.clone() for k, v in sparse.net.state_dict().items()}
    batches = _batches(ours)
    opt = jm.optimizers[0]["optimizer"]
    p, s = jm.params, jm.opt_states[0]
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        p, s, jloss = jm._grad_step(opt, p, s, jb, jax.random.PRNGKey(i), jm.states)
        sparse.net.train()
        dense.net.train()
        loss_s, loss_d = sparse._grad_step(b), dense._grad_step(b)
        np.testing.assert_allclose(float(loss_s), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-6)
    for name in tables:
        w = sparse.net.get_parameter(name)
        assert w.grad is None and not w.requires_grad           # no [N, D] gradient
    # against the JAX packed step: every leaf, packed tables whole
    got = ranker_params_to_jax(sparse.net.state_dict(), sparse.net)
    want = jax.tree_util.tree_map(np.asarray, p)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        names = [str(getattr(x, "key", x)) for x in path]
        node = got
        for k in names:
            node = node[k]
        np.testing.assert_allclose(node, leaf, **TOL, err_msg="/".join(names))
    # against the dense LazyAdam: parameters, and the packed moment columns
    # against the dense moments
    sd_s, sd_d = sparse.net.state_dict(), dense.net.state_dict()
    moments = ranker_moments_from_jax(ranker_params_to_jax(sd_s, sparse.net), dense.net)
    assert sorted(moments) == sorted(tables)
    for name, p_d in sd_d.items():
        p_s = sd_s[name]
        if name in tables:
            d = p_d.shape[1]
            np.testing.assert_allclose(p_s[:, :d], p_d, **TOL, err_msg=name)
            mu, nu = dense.optimizer.moments(dense.net.get_parameter(name))
            np.testing.assert_allclose(moments[name][0], mu, **TOL, err_msg=f"mu {name}")
            np.testing.assert_allclose(moments[name][1], nu, **TOL, err_msg=f"nu {name}")
        else:
            np.testing.assert_allclose(p_s, p_d, **TOL, err_msg=name)
    assert sparse.optimizer.param_groups[0]["count"] == int(s[0].count) == 2
    # rows no batch touched: bitwise unchanged, moments included
    for m in (sparse.net.embedding, sparse.net.linear.embedding):
        touched = torch.zeros(m.token_embedding.weight.shape[0], dtype=torch.bool)
        for b in batches:
            touched[torch.stack([b[f] for _, f in m.token], -1).long().add(m.offsets)
                    .reshape(-1)] = True
        name = [k for k in tables if m.token_embedding.weight is sparse.net.get_parameter(k)][0]
        assert torch.equal(sd_s[name][~touched], before[name][~touched]), name
        assert not torch.equal(sd_s[name][touched], before[name][touched]), name


def test_packed_step_repeats_bit_for_bit(ctr_splits, tmp_path):
    import jax
    ours, theirs = ctr_splits
    jm = _jax_deepfm(theirs, "auto", tmp_path)
    weights = jax.tree_util.tree_map(np.asarray, jm.params)
    runs = []
    for _ in range(2):
        model = _port_deepfm(ours, "true", weights)
        model.net.train()
        losses = [float(model._grad_step(b)) for b in _batches(ours)]
        runs.append((losses, model.net.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_sparse_rows_true_engages_the_packed_step(ctr_splits):
    from recstudio_torch.utils import get_model
    ours, _ = ctr_splits
    cls, conf = get_model("DeepFM")
    conf["train"].update(learner="sparse_adam", sparse_rows="true", batch_size=BATCH)
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    assert model._ctr_sparse_enabled()
    w = model.net.embedding.token_embedding.weight
    assert w.shape == (sum(model.net.embedding.sizes), 3 * model.embed_dim)
    assert not w.requires_grad and float(w[:, model.embed_dim:].abs().max()) == 0.0
    assert float(w[1:, :model.embed_dim].abs().max()) > 0


def test_ctr_sparse_gate_rejects_ineligible(ctr_splits):
    """The JAX gate's cases: each of these turns the packed step off; the
    net is then built with plain tables."""
    from recstudio_torch.utils import get_model
    ours, _ = ctr_splits
    cls, conf = get_model("DeepFM")
    conf["train"].update(learner="sparse_adam", sparse_rows="auto", batch_size=BATCH)
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    assert model._ctr_sparse_config_ok() and model._ctr_sparse_enabled()
    for key, val in (("learner", "adam"), ("weight_decay", 0.01), ("grad_clip_norm", 1.0),
                     ("scheduler", "exponential"), ("sparse_rows", "false"),
                     ("mesh", {"dp": 1})):
        old = model.config["train"].get(key)
        model.config["train"][key] = val
        assert not model._ctr_sparse_config_ok() and not model._ctr_sparse_enabled(), key
        model.config["train"][key] = old
    assert model._ctr_sparse_enabled()
    # a model whose gate is off at initialisation unpacks its tables
    model.config["train"]["sparse_rows"] = "false"
    model._init_parameter(ours[0])
    assert model.net.embedding.token_embedding.weight.shape[1] == model.embed_dim
    assert model.net.embedding.token_embedding.weight.requires_grad
    other = cls(dict(conf, train=dict(conf["train"], learner="adam")), device="cpu")
    other._init_model(ours[0])
    assert not other.net.embedding.packed and not other._ctr_sparse_enabled()


def test_packed_checkpoint_and_serving(ctr_splits, tmp_path):
    """A JAX packed state gives the port's packed model its tables whole;
    the port's state goes back to the JAX layout unchanged; a saved and
    loaded checkpoint keeps the moments; ``ScorePredictor`` and
    ``evaluate`` read the first D columns, as the JAX package's do."""
    import jax
    from recstudio_tpu.serving import ScorePredictor as JaxScorePredictor
    from recstudio_torch.serving import ScorePredictor
    from recstudio_torch.utils.convert import ranker_params_to_jax
    ours, theirs = ctr_splits
    jm = _jax_deepfm(theirs, "auto", tmp_path)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    D = jm.config["model"]["embed_dim"]
    rng = np.random.default_rng(0)
    tab = params["embedding"]["token_embedding"]
    params = copy.deepcopy(params)
    params["embedding"]["token_embedding"] = np.concatenate(   # nonzero moments
        [tab[:, :D], rng.normal(size=tab[:, D:].shape).astype(np.float32)], axis=1)
    model = _port_deepfm(ours, "auto", params)
    back = ranker_params_to_jax(model.net.state_dict(), model.net)
    np.testing.assert_array_equal(back["embedding"]["token_embedding"],
                                  params["embedding"]["token_embedding"])
    path = str(tmp_path / "packed.ckpt")
    model.save_checkpoint(path)
    again = _port_deepfm(ours, "auto", jax.tree_util.tree_map(np.asarray, jm.params))
    again.load_checkpoint(path)
    assert torch.equal(again.net.embedding.token_embedding.weight,
                       model.net.embedding.token_embedding.weight)
    assert not again.net.embedding.token_embedding.weight.requires_grad
    tst, jtst = ours[2], theirs[2]
    rows = tst.data_index[:300]
    fields = [f for f in tst.inter_feat.fields if f != model.frating]
    request = {f: tst.inter_feat.get_col(f)[rows] for f in fields}
    jm.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    with jax.default_matmul_precision("float32"):
        want = JaxScorePredictor(jm, max_batch=512, train_data=theirs[0])(request)
    got = ScorePredictor(model, max_batch=512, train_data=ours[0])(request)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    tst.use_field = model.fields
    full = tst._get_pos_batch(np.arange(300))
    np.testing.assert_allclose(got, model.predict(full), rtol=0, atol=1e-6)
    unpacked = _port_deepfm(ours, "false", params)
    np.testing.assert_allclose(unpacked.predict(full), got, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [500_000, 997])
def test_chunked_write_ctr_writes_the_jax_bytes(tmp_path, chunk_rows, monkeypatch):
    from recstudio_tpu.data.synthetic import generate_ctr as jax_generate_ctr
    from recstudio_torch.data import synthetic
    from recstudio_torch.data.synthetic import ctr_shape_vocabs, write_ctr
    vocabs = ctr_shape_vocabs("criteo-1m-shape")
    ours = str(tmp_path / "ours.inter")
    monkeypatch.setattr(synthetic, "CTR_CHUNK_ROWS", chunk_rows)
    write_ctr(ours, 5000, 11, 13, vocabs)
    name, _ = jax_generate_ctr("theirs", 5000, out_dir=str(tmp_path), seed=11, vocabs=vocabs)
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in (ours, os.path.join(str(tmp_path), f"{name}.inter"))]
    assert digest[0] == digest[1]
