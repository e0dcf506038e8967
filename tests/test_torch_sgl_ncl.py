"""SGL and NCL: the port against the JAX package on the CPU.

Both packages build the same ml-100k split (numpy seed 42, the graph
configs' ratio split) at d 16 and hold the same seeded weights
(``graph_params_from_jax``); both take the same numpy negatives. Checks:

- SGL's edge-dropout views with the JAX package's keep masks, ``ED`` (one
  mask for every layer) and ``RW`` (one a layer), each mask carried from
  the JAX edge order into the port's by matching (src, dst) pairs: the
  views to 1e-5 relative + 1e-6; one whole training step (LightGCN's BPR
  loss, the L2 penalty and the views' InfoNCE) with those masks: the loss
  to 1e-5 relative, each gradient to ``TOL_GRAD`` (1e-4 of its largest
  magnitude + 1e-3 relative); a view repeats bit for bit from the same
  masks (``segment_sum_sorted``); ``aug_type: ND`` raises;
- NCL's step with the JAX package's k-means centroids in ``states``, the
  prototype term on: at the config's weights, and with the structure term
  alone and the prototype term alone at weight 1, so neither hides in the
  other's tolerance; the refresh schedule (the epochs at which the
  centroids are recomputed, and ``proto_on``) against the JAX package's;
  the config's ``num_m_epoch`` is read by nothing (the schedule is the same
  at another value).
"""
import numpy as np
import pytest
import torch

SPLIT_SEED, WEIGHT_SEED, NEG_SEED = 42, 5, 17
D = 16
ROWS = 256
TOL_SAME = dict(rtol=1e-5, atol=1e-6)
TOL_LOSS = 1e-5
TOL_GRAD = (1e-4, 1e-3)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    build = get_model("SGL")[1]["data"]
    assert build == get_model("NCL")[1]["data"]
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k").build(**build)
    return ours, theirs


def _pair(splits, name, model_over=None, train_over=None):
    """The JAX and the port's ``name`` at d 16 on the split, holding the same
    seeded tables."""
    from test_torch_graph import _jnp_tree, random_graph_params
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import graph_params_from_jax
    ours, theirs = splits
    jcls, jconf = jax_get_model(name)
    cls, conf = get_model(name)
    for c in (jconf, conf):
        c["model"].update(embed_dim=D, **(model_over or {}))
        c["train"].update(train_over or {})
    jmodel, model = jcls(jconf), cls(conf, device="cpu")
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    tree = random_graph_params(WEIGHT_SEED, ours[0].num_users, ours[0].num_items, D)
    jmodel.params = _jnp_tree(tree, jnp)
    jmodel.val_check = False
    model.load_state_dict(graph_params_from_jax(tree))
    return jmodel, model


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _edge_perm(jmodel, model):
    """``perm`` with the port's edge k the JAX package's edge ``perm[k]``."""
    n = model._num_nodes
    key = _np(model._edges[0]).astype(np.int64) * n + _np(model._edges[1])
    jkey = np.asarray(jmodel._edges[0]).astype(np.int64) * n + np.asarray(jmodel._edges[1])
    order, jorder = np.argsort(key, kind="stable"), np.argsort(jkey, kind="stable")
    perm = np.empty_like(order)
    perm[order] = jorder
    np.testing.assert_array_equal(jkey[perm], key)
    return perm


def _jax_masks(jmodel, rng):
    """The JAX step's keep masks of its two views (``sgl.py:41-44,51``)."""
    import jax
    mc = jmodel.config["model"]
    _, rng_v1, rng_v2 = jax.random.split(rng, 3)
    n_edges = jmodel._edges[0].shape[0]
    out = []
    for r in (rng_v1, rng_v2):
        keep0 = jax.random.bernoulli(r, 1.0 - mc["ssl_ratio"], (n_edges,))
        if mc.get("aug_type", "ED") == "RW":
            out.append([np.asarray(jax.random.bernoulli(jax.random.fold_in(r, i + 1),
                                                        1.0 - mc["ssl_ratio"], (n_edges,)))
                        for i in range(mc["n_layers"])])
        else:
            out.append([np.asarray(keep0)] * mc["n_layers"])
    return out


def _batch(trn):
    n = len(trn.data_index)
    return trn._get_pos_batch(np.arange(0, n, n // ROWS)[:ROWS])


def _compare_steps(jmodel, model, batch, neg, rng, **kwargs):
    from test_torch_graph import _jax_step, _leaves, _port_step
    jloss, jgrads = _jax_step(jmodel, batch, neg, rng)
    loss, grads = _port_step(model, batch, neg, **kwargs)
    np.testing.assert_allclose(loss, jloss, rtol=TOL_LOSS)
    want, got = dict(_leaves(jgrads)), dict(_leaves(grads))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(w).max()), err_msg=key)
        assert float(np.abs(got[key]).max()) > 0.0, key
    return loss


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aug", ["ED", "RW"])
def test_sgl_views_and_step_match_jax(splits, aug):
    import jax
    jmodel, model = _pair(splits, "SGL", {"aug_type": aug})
    assert model._prop_m is not None             # the main loss keeps LightGCN's route
    perm = _edge_perm(jmodel, model)
    rng = jax.random.PRNGKey(2)
    jmasks = _jax_masks(jmodel, rng)
    masks = [[torch.from_numpy(m[perm].copy()) for m in view] for view in jmasks]
    same = [bool((a == b).all()) for a, b in zip(masks[0][:-1], masks[0][1:])]
    assert all(same) == (aug == "ED")
    _, rng_v1, _ = jax.random.split(rng, 3)
    with jax.default_matmul_precision("float32"):
        ju, ji = jmodel._propagate_view(jmodel.params, rng_v1)
    with torch.no_grad():
        u, i = model.propagate_view(masks[0])
        again = model.propagate_view(masks[0])
    np.testing.assert_allclose(_np(u), np.asarray(ju), **TOL_SAME)
    np.testing.assert_allclose(_np(i), np.asarray(ji), **TOL_SAME)
    assert torch.equal(u, again[0]) and torch.equal(i, again[1])
    trn = splits[0][0]
    neg = np.random.default_rng(NEG_SEED).integers(1, trn.num_items, size=(ROWS, 1))
    _compare_steps(jmodel, model, _batch(trn), neg, rng, keep=masks)


def test_sgl_draws_its_own_masks(splits):
    _, model = _pair(splits, "SGL", {"aug_type": "RW"})
    masks = model.keep_masks()
    assert len(masks) == 3 and not torch.equal(masks[0], masks[1])
    kept = float(torch.stack(masks).float().mean())
    assert abs(kept - 0.9) < 0.01


def test_sgl_refuses_other_aug_types(splits):
    """The JAX package runs ``ED`` for any ``aug_type`` but ``RW``; the port
    raises on anything but ``ED`` and ``RW``."""
    from recstudio_torch.utils import get_model
    cls, conf = get_model("SGL")
    conf["model"]["aug_type"] = "ND"
    with pytest.raises(NotImplementedError, match="aug_type 'ND'"):
        cls(conf, device="cpu")._init_model(splits[0][0])


# ---------------------------------------------------------------------------
def _jax_centroids(jmodel, model):
    """The JAX package's first refresh, its centroids put in the port's
    ``states``."""
    jmodel._epoch_refresh(0)
    model.states.update({k: torch.from_numpy(np.array(jmodel.states[k])) for k in
                         ("user_centroids", "item_centroids", "user_2cluster", "item_2cluster",
                          "proto_on")})
    assert float(model.states["proto_on"]) == 1.0


@pytest.mark.parametrize("terms", ["config", "structure", "prototype"])
def test_ncl_step_matches_jax(splits, terms):
    import jax
    over = {"config": {}, "structure": {"ssl_reg": 1.0, "proto_reg": 0.0},
            "prototype": {"ssl_reg": 0.0, "proto_reg": 1.0}}[terms]
    jmodel, model = _pair(splits, "NCL", over, {"warm_up_epoch": 0})
    assert model._prop_m is None and model._adj is not None
    _jax_centroids(jmodel, model)
    assert model.states["user_centroids"].shape == (10, D)
    trn = splits[0][0]
    neg = np.random.default_rng(NEG_SEED).integers(1, trn.num_items, size=(ROWS, 1))
    _compare_steps(jmodel, model, _batch(trn), neg, jax.random.PRNGKey(4))


def _refresh_schedule(model, epochs, mp, target):
    """The epochs (``-1`` an evaluation) at which ``model._epoch_refresh``
    runs k-means, and ``proto_on`` after each."""
    calls = []
    real = target.kmeans
    mp.setattr(target, "kmeans", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    out = []
    for e in epochs:
        before = len(calls)
        model._epoch_refresh(e)
        out.append((e, len(calls) > before, float(model.states["proto_on"])))
    return out


@pytest.mark.parametrize("num_m_epoch", [1, 3])
def test_ncl_refresh_schedule_matches_jax(splits, num_m_epoch):
    """The centroids are computed at the first epoch, at every epoch from
    ``warm_up_epoch`` on and at each evaluation (``-1``), as in the JAX
    package, whatever ``num_m_epoch`` says."""
    import recstudio_tpu.models.graph.ncl as jax_ncl
    import recstudio_torch.models.graph.ncl as ncl
    epochs = [0, 1, 2, -1, 3, 4, 5, -1]
    jmodel, model = _pair(splits, "NCL", None, {"warm_up_epoch": 3, "num_m_epoch": num_m_epoch})
    with pytest.MonkeyPatch.context() as mp:
        got = _refresh_schedule(model, epochs, mp, ncl)
        want = _refresh_schedule(jmodel, epochs, mp, jax_ncl)
    assert got == want
    assert [e for e, ran, _ in got if ran] == [0, -1, 3, 4, 5, -1]
    assert [p for _, _, p in got] == [0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]
