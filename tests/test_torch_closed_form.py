"""``TripletDataset.get_graph`` and the closed-form retrievers EASE, ItemKNN
and SLIM: the port against the JAX package on the CPU.

Both packages build the same ml-100k split (numpy seed 42, the ``mf``
family's ratio split). Checks:

- ``get_graph`` against the JAX package's scipy matrix (``.toarray()``),
  one-directional and bidirectional, with offsets and a shape, in every
  form; network graphs and ``value_fields`` raise;
- EASE's ``B`` on the whole split, to ``TOL_B`` (float32 inverses of a
  1683-wide Gram matrix by two LAPACK routes), its residual, and the
  top-20 lists of 256 users with their histories masked (tie-aware,
  ``TOL_SCORE``);
- ItemKNN's ``B`` under cosine and Jaccard similarity on the columns whose
  ``knn``-th and ``knn + 1``-th similarities differ by more than
  ``TOL_B``: there both packages keep the same entries. The columns with a
  tie at the threshold are counted and printed (``-s``), not compared;
- SLIM's ``B`` with ``positive_only`` on and off, on the split's first 400
  items (``G`` 400 wide, so 200 ISTA steps stay cheap) at ``alpha`` 0.1
  (at the config's 1.0 fewer than 1% of the entries survive and none is
  negative), and its lists;
- the served lists of each from the JAX package's own ``R`` and ``B``
  (``closed_form_states_from_jax``); snapshots and checkpoints carry
  ``R`` and ``B`` and a fit drops neither; SLIM's ``train.knn`` is read by
  nothing (``B`` is the same at another value).
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42
USERS = 256
K = 20
TOL_B = dict(rtol=1e-4, atol=1e-6)
TOL_SCORE = 1e-5
SLIM_ITEMS = 400


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    build = get_model("EASE")[1]["data"]
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k").build(**build)
    return ours, theirs


def _pair(splits, name, **train):
    """The JAX and the port's ``name`` on the split, fields set up, the
    config's ``train`` group updated by ``train``."""
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    ours, theirs = splits
    jcls, jconf = jax_get_model(name)
    cls, conf = get_model(name)
    jconf["train"].update(train)
    conf["train"].update(train)
    jmodel, model = jcls(jconf), cls(conf, device="cpu")
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    jmodel.trainloaders = jmodel._get_train_loaders(theirs[0])
    model.trainloaders = model._get_train_loaders(ours[0])
    return jmodel, model


def _solve_both(jmodel, model, items=None):
    """Each package's training epoch, on the split's matrix or on its first
    ``items`` columns."""
    import jax
    if items is not None:
        jmodel.trainloaders = {"user_item_matrix":
                               jmodel.trainloaders["user_item_matrix"][:, :items].tocsr()}
        model.trainloaders = {"user_item_matrix": model.trainloaders["user_item_matrix"]
                              .to_dense()[:, :items].to_sparse_csr()}
    with jax.default_matmul_precision("float32"):
        jout = jmodel.training_epoch(0)
    out = model.training_epoch(0)
    return jout, out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("form", ["coo", "csr", "dense"])
def test_get_graph_matches_jax(splits, bidirectional, form):
    ours, theirs = splits
    trn, jtrn = ours[0], theirs[0]
    kw = dict(bidirectional=bidirectional)
    if bidirectional:                          # the users and items as one node set
        n = trn.num_users + trn.num_items
        kw.update(col_offset=trn.num_users, shape=(n, n))
    got = trn.get_graph(0, form, **kw)
    want = jtrn.get_graph(0, form if form != "dense" else "coo", **kw).toarray()
    assert got.dtype == torch.float32
    assert got.layout == {"coo": torch.sparse_coo, "csr": torch.sparse_csr,
                          "dense": torch.strided}[form]
    dense = _np(got.to_dense() if form != "dense" else got)
    np.testing.assert_array_equal(dense, want)
    if bidirectional:
        np.testing.assert_array_equal(dense, dense.T)


def test_get_graph_sums_duplicates_and_refuses_network_graphs(splits):
    trn = splits[0][0]
    once = trn.get_graph(0).to_dense()
    twice = trn.get_graph([0, 0]).to_dense()        # every pair given twice
    np.testing.assert_array_equal(_np(twice), 2 * _np(once))
    assert trn.get_graph(0).is_coalesced()
    with pytest.raises(NotImplementedError, match="network graphs"):
        trn.get_graph(1)
    with pytest.raises(NotImplementedError, match="value_fields"):
        trn.get_graph(0, value_fields="rating")


# ---------------------------------------------------------------------------
def _lists_agree(jmodel, model, tst, jtst, jstates=None, states=None):
    """Top-``K`` lists of ``USERS`` test users, history masked, from each
    package's states (or the given ones)."""
    import jax.numpy as jnp
    users = tst.data_index[:USERS, 0].astype(np.int32)
    hist = tst.user_hist[users]
    if states is not None:
        model.states.update(states)
    s, i = model.topk({model.fuid: torch.from_numpy(users)}, K, torch.from_numpy(hist))
    js, ji = jmodel.topk({}, {jmodel.fuid: jnp.asarray(users)}, K, jnp.asarray(hist),
                         states=jstates)
    from recstudio_torch.utils.parity import topk_mismatches
    assert topk_mismatches(_np(i), _np(s), np.asarray(ji), np.asarray(js), TOL_SCORE) == 0
    assert not any(np.isin(_np(i)[r], hist[r][hist[r] > 0]).any() for r in range(USERS))


def test_ease_matches_jax(splits):
    jmodel, model = _pair(splits, "EASE")
    jresid, resid = _solve_both(jmodel, model)
    B, jB = _np(model.states["B"]), np.asarray(jmodel.states["B"])
    assert B.shape == (splits[0][0].num_items,) * 2
    assert np.all(np.diag(B) == 0.0)
    np.testing.assert_allclose(B, jB, rtol=TOL_B["rtol"], atol=TOL_B["rtol"] * np.abs(jB).max())
    np.testing.assert_array_equal(_np(model.states["R"]), np.asarray(jmodel.states["R"]))
    np.testing.assert_allclose(resid, jresid, rtol=1e-3)   # float32 sums of 1.6M squares
    _lists_agree(jmodel, model, splits[0][2], splits[1][2])


def _knn_columns(S, knn, tol):
    """Columns of ``S`` (zero diagonal) whose ``knn``-th and ``knn + 1``-th
    largest values differ by more than ``tol``."""
    top = -np.sort(-S, axis=0)[knn - 1:knn + 1]
    return np.flatnonzero(top[0] - top[1] > tol)


@pytest.mark.parametrize("similarity", ["cosine", "jaccard"])
def test_itemknn_matches_jax_away_from_ties(splits, similarity):
    jmodel, model = _pair(splits, "ItemKNN", similarity=similarity)
    _solve_both(jmodel, model)
    B, jB = _np(model.states["B"]), np.asarray(jmodel.states["B"])
    R = _np(model.states["R"]).astype(np.float64)
    G = R.T @ R
    np.fill_diagonal(G, 0.0)
    if similarity == "cosine":
        norm = np.sqrt((R * R).sum(0))
        S = G / (norm[:, None] * norm[None, :] + 1e-6)
    else:
        nz = (R > 0).sum(0)
        S = G / (nz[:, None] + nz[None, :] - G + 1e-6)
    knn = model.config["train"]["knn"]
    cols = _knn_columns(S, knn, TOL_B["rtol"])
    tied = B.shape[1] - len(cols)
    print(f"ItemKNN {similarity}: {len(cols)} columns compared, {tied} with a tie at the "
          f"{knn}-th similarity left out")
    assert len(cols) >= B.shape[1] // 3
    np.testing.assert_allclose(B[:, cols], jB[:, cols], **TOL_B)
    assert ((B[:, cols] != 0).sum(0) == (jB[:, cols] != 0).sum(0)).all()
    assert np.all(np.diag(B) == 0.0)
    _lists_agree(jmodel, model, splits[0][2], splits[1][2],
                 states={"R": torch.from_numpy(np.array(jmodel.states["R"])),
                         "B": torch.from_numpy(np.array(jmodel.states["B"]))})


def test_itemknn_refuses_other_similarities(splits):
    with pytest.raises(ValueError, match="similarity"):
        _pair(splits, "ItemKNN", similarity="pearson")


@pytest.mark.parametrize("positive_only", [True, False])
def test_slim_matches_jax(splits, positive_only):
    jmodel, model = _pair(splits, "SLIM", positive_only=positive_only, alpha=0.1)
    _solve_both(jmodel, model, items=SLIM_ITEMS)
    B, jB = _np(model.states["B"]), np.asarray(jmodel.states["B"])
    assert B.shape == (SLIM_ITEMS, SLIM_ITEMS) and np.all(np.diag(B) == 0.0)
    assert (B.min() >= 0.0) == positive_only
    assert (B != 0).mean() < 0.5                     # the l1 term made it sparse
    np.testing.assert_allclose(B, jB, rtol=1e-4, atol=1e-4 * np.abs(jB).max())
    users = splits[0][2].data_index[:USERS, 0].astype(np.int32)
    hist = np.where(splits[0][2].user_hist[users] < SLIM_ITEMS, splits[0][2].user_hist[users], 0)
    s, _ = model.topk({model.fuid: torch.from_numpy(users)}, K, torch.from_numpy(hist))
    import jax.numpy as jnp
    js, _ = jmodel.topk({}, {jmodel.fuid: jnp.asarray(users)}, K, jnp.asarray(hist))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-4, atol=1e-6)


def test_slim_knn_is_read_by_nothing(splits):
    """The config's ``knn`` (100) is read by no code of either package: at
    another value ``B`` is the same, bit for bit."""
    Bs = []
    for knn in (100, 3):
        _, model = _pair(splits, "SLIM", knn=knn, max_iter=20)
        model.trainloaders = {"user_item_matrix": model.trainloaders["user_item_matrix"]
                              .to_dense()[:, :SLIM_ITEMS].to_sparse_csr()}
        model.training_epoch(0)
        Bs.append(_np(model.states["B"]))
    np.testing.assert_array_equal(Bs[0], Bs[1])


def test_closed_form_weights_in_snapshots_and_checkpoints(splits, tmp_path):
    """``R`` and ``B`` are a netless model's weights: a fit keeps them, a
    snapshot and ``restore`` carry them, a checkpoint saves and loads them,
    and ``load_state_dict`` takes them (``closed_form_states_from_jax``)."""
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import closed_form_states_from_jax
    ours = splits[0]
    cls, conf = get_model("EASE")
    conf["eval"]["save_path"] = str(tmp_path)
    model = cls(conf, device="cpu").fit(ours[0], ours[1])
    assert model.net is None and model.optimizer is None and model.optimizers == []
    assert set(model.states) == {"R", "B"}
    snap = model.snapshot()
    model.states["B"].zero_()
    model.restore(snap)
    assert float(model.states["B"].abs().sum()) > 0.0
    before = model.evaluate(ours[2], verbose=False)
    other = cls(conf, device="cpu")
    other._init_model(ours[0])
    payload = other.load_checkpoint(model.ckpt_path)
    assert payload["params"] == {} and payload["optimizers"] == []
    for key in ("R", "B"):
        np.testing.assert_array_equal(_np(other.states[key]), _np(model.states[key]))
    third = cls(conf, device="cpu")
    third._init_model(ours[0])
    third.load_state_dict(closed_form_states_from_jax(
        {k: _np(v) for k, v in model.states.items()}))
    assert third.evaluate(ours[2], verbose=False) == before
