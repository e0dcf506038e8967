"""LightGCN, NGCF and SimGCL: the port against the JAX package on the CPU.

Both packages build the model on the same ml-100k split (numpy seed 42,
the graph configs' ratio split) at d 16 (NGCF's layers [16, 16, 16, 16]),
and hold the same seeded weights (``graph_params_from_jax``). Checks:

- the graph (``_build_graph``): edges, norms, edge weights and the dense
  adjacency, exactly; the ELL tables of both packages forced past the dense
  budget (``_DENSE_ADJ_BYTES = 0``, set on each class for the test), exactly;
- each propagation route against the same JAX route, to 1e-5 relative +
  1e-6 absolute: the collapsed operator M (LightGCN), the dense per-layer
  loop (SimGCL), the edge list (LightGCN with M dropped) and ELL; the
  routes against each other at the JAX package's own 2e-4 / 2e-5
  (``tests/test_training_pipeline.py``); ``_SymPropagate``'s gradient
  against autograd of the edge-list form; ``prop_dtype: bf16``;
- one ``training_step`` each of LightGCN (M and ELL), NGCF (message dropout
  off) and SimGCL (the JAX package's noise draws given to the port), with
  the same negatives: the loss to 1e-5 relative, each gradient to 1e-4 of
  its largest magnitude + 1e-3 relative (``chip_smoke.TOL_GRAD``);
- ``info_nce``'s three negative types and ``l2_reg_loss_fn``;
- the parameter maps' round trips, the ``user_all`` cache (filled by one
  propagation per evaluation pass, dropped after ``fit`` and ``restore``),
  evaluation and ``Predictor``'s lists against the JAX package's, and a
  one-epoch ``quickstart.run`` of each model.

``recstudio_torch/assets/{lightgcn,ngcf,simgcl}_ml100k_train_reference.json``
hold the JAX package's test NDCG@10 bands that ``chip_smoke.py`` (phase U)
holds the card's runs to; ``scripts/torch_graph_seeds.py`` writes them.
"""
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "recstudio_torch", "assets")
SPLIT_SEED, WEIGHT_SEED, NEG_SEED, EMB_SEED = 42, 5, 17, 3
D = 16
ROWS = 256
MODEL_OVERRIDES = {"LightGCN": {"embed_dim": D}, "SimGCL": {"embed_dim": D},
                   "NGCF": {"embed_dim": D, "layer_size": [D] * 4,
                            "mess_dropout": [0.0, 0.0, 0.0]}}
TOL_SAME = dict(rtol=1e-5, atol=1e-6)       # a route against the same JAX route
TOL_ROUTES = dict(rtol=2e-4, atol=2e-5)     # routes against each other (JAX's own)
TOL_LOSS = 1e-5
TOL_GRAD = (1e-4, 1e-3)                    # (atol as a share of max |g|, rtol)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in each test (see ``test_torch_bpr.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    build = get_model("LightGCN")[1]["data"]
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k").build(**build)
    return ours, theirs


def random_graph_params(seed, num_users, num_items, embed_dim, layer_size=None):
    """Seeded tables in the JAX layout, N(0, 0.1), [PAD] rows 0; NGCF's
    layers with nonzero biases, so a wrong map shows."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    tree = {}
    for name, n in (("user_embedding", num_users), ("item_embedding", num_items)):
        table = f32(rng.normal(0.0, 0.1, (n, embed_dim)))
        table[0] = 0.0
        tree[name] = table
    for i, (d_in, d_out) in enumerate(zip((layer_size or [])[:-1], (layer_size or [])[1:])):
        tree[f"layer_{i}"] = {
            w: {"kernel": f32(rng.normal(0.0, d_in ** -0.5, (d_in, d_out))),
                "bias": f32(rng.normal(0.0, 0.05, d_out))} for w in ("W1", "W2")}
    return tree


def _pair(splits, name, force_ell=False, **model):
    """The JAX and the port's ``name`` on the same split, holding the same
    seeded weights; ``force_ell`` builds both past the dense budget."""
    import jax.numpy as jnp
    from recstudio_tpu.models.graph.base import BaseGraphRetriever as JaxBase
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.models.graph.base import BaseGraphRetriever
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import graph_params_from_jax
    ours, theirs = splits
    over = dict(MODEL_OVERRIDES[name], **model)
    budget = 0 if force_ell else JaxBase._DENSE_ADJ_BYTES
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBase, "_DENSE_ADJ_BYTES", budget)
        mp.setattr(BaseGraphRetriever, "_DENSE_ADJ_BYTES", budget)
        jcls, jconf = jax_get_model(name)
        jconf["model"].update(over)
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_parameter(theirs[0])
        cls, conf = get_model(name)
        conf["model"].update(over)
        model = cls(conf, device="cpu")
        model._init_model(ours[0])
        model._init_parameter(ours[0])
    tree = random_graph_params(WEIGHT_SEED, ours[0].num_users, ours[0].num_items, D,
                               over.get("layer_size"))
    jmodel.params = _jnp_tree(tree, jnp)
    jmodel.val_check = False
    model.load_state_dict(graph_params_from_jax(tree))
    return jmodel, model


def _jnp_tree(tree, jnp):
    return {k: _jnp_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, tol, tag):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=tag, **tol)


@pytest.fixture(scope="module")
def lightgcn(splits):
    return _pair(splits, "LightGCN")


@pytest.fixture(scope="module")
def lightgcn_ell(splits):
    return _pair(splits, "LightGCN", force_ell=True)


@pytest.fixture(scope="module")
def simgcl(splits):
    return _pair(splits, "SimGCL")


# ---------------------------------------------------------------------------
def test_build_graph_matches_jax(splits, simgcl):
    jmodel, model = simgcl
    trn = splits[0][0]
    n = trn.num_users + trn.num_items
    assert model._num_nodes == jmodel._num_nodes == n == 944 + 1575
    for got, want in zip(model._edges, jmodel._edges):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(model._edge_norm), _np(jmodel._edge_norm))
    np.testing.assert_array_equal(_np(model._edge_w), _np(jmodel._edge_w))
    np.testing.assert_array_equal(_np(model._adj), _np(jmodel._adj))
    assert float(model._adj[0].abs().max()) == 0.0                 # [PAD] user: no edge
    np.testing.assert_array_equal(_np(model._adj), _np(model._adj).T)  # symmetric
    dst = _np(model._edges[1])
    assert (np.diff(dst) >= 0).all()
    np.testing.assert_array_equal(_np(model._deg_in), np.bincount(dst, minlength=n))


def test_ell_tables_match_jax(lightgcn_ell):
    jmodel, model = lightgcn_ell
    assert model._adj is None and model._prop_m is None and model._sym_spmm is not None
    assert jmodel._adj is None and jmodel._prop_m is None
    tables, hub, slot = model._ell
    jtables, jhub, jslot = jmodel._ell
    assert len(tables) == len(jtables)
    for (s, w), (js, jw) in zip(tables, jtables):
        assert s.dtype == torch.int32
        np.testing.assert_array_equal(_np(s), _np(js))
        np.testing.assert_array_equal(_np(w), _np(jw))
    np.testing.assert_array_equal(_np(slot), _np(jslot))
    # hubs (deg > 128) exist on ml-100k; each hub's padded row of virtual
    # rows lists the virtual rows the JAX segment ids give it, in order
    seg, n_hub, n_virtual = jhub
    rows, nv = hub
    assert n_hub > 0 and nv == n_virtual and rows.shape[0] == n_hub
    seg = _np(seg)
    for h in range(n_hub):
        r = _np(rows[h])
        np.testing.assert_array_equal(r[r < nv], np.flatnonzero(seg == h))
    stats = model.ell_stats()
    assert stats["edges"] == len(_np(model._edges[0])) and stats["slots"] >= stats["edges"]


def _emb(n, d=D):
    return np.random.default_rng(EMB_SEED).normal(0.0, 0.1, (n, d)).astype(np.float32)


def test_ell_apply_matches_jax_and_edge_list(lightgcn_ell):
    import jax.numpy as jnp
    jmodel, model = lightgcn_ell
    emb = _emb(model._num_nodes)
    got = model._ell_apply(torch.from_numpy(emb))
    _assert_close(got, jmodel._ell_apply(jnp.asarray(emb)), TOL_SAME, "ELL vs JAX ELL")
    _assert_close(model._edge_apply(torch.from_numpy(emb)), got, TOL_ROUTES, "edge list vs ELL")


def test_sym_propagate_gradient_matches_edge_list_autograd(lightgcn_ell):
    """The Function's backward (the operator again) against autograd of the
    edge-list form, and against the JAX custom VJP; nothing is saved for
    the backward."""
    import jax
    import jax.numpy as jnp
    jmodel, model = lightgcn_ell
    emb0 = torch.from_numpy(_emb(model._num_nodes))
    grads = {}
    for tag, fn in (("ell", model._sym_spmm), ("edges", model._edge_apply)):
        emb = emb0.clone().requires_grad_()
        out = fn(emb)
        if tag == "ell":
            assert out.grad_fn.saved_tensors == ()
        (out ** 2).sum().backward()
        grads[tag] = emb.grad
    _assert_close(grads["ell"], grads["edges"], TOL_SAME, "ELL grad vs edge-list autograd")
    want = jax.grad(lambda e: (jmodel._sym_spmm(e) ** 2).sum())(jnp.asarray(_np(emb0)))
    _assert_close(grads["ell"], want, TOL_SAME, "ELL grad vs JAX custom VJP")


def _propagate_jax(jmodel):
    import jax
    with jax.default_matmul_precision("float32"):
        return jmodel.propagate(jmodel.params)


@pytest.mark.parametrize("route", ["collapsed", "edge_list"])
def test_lightgcn_propagation_matches_jax(lightgcn, route):
    jmodel, model = lightgcn
    assert model._prop_m is not None and model._adj is None
    assert model._prop_m.dtype == torch.float32
    m, jm = model._prop_m, jmodel._prop_m
    try:
        if route == "edge_list":
            model._prop_m = jmodel._prop_m = None      # the per-layer loop, no _adj
        got, want = model.propagate(), _propagate_jax(jmodel)
    finally:
        model._prop_m, jmodel._prop_m = m, jm
    for g, w, tag in zip(got, want, ("users", "items")):
        _assert_close(g, w, TOL_SAME, f"{route} {tag}")


def test_dense_layer_loop_matches_jax(simgcl):
    jmodel, model = simgcl
    assert model._adj is not None and model._prop_m is None
    for g, w in zip(model.propagate(), _propagate_jax(jmodel)):
        _assert_close(g, w, TOL_SAME, "dense per-layer loop")


def test_ell_propagation_matches_jax(lightgcn_ell):
    jmodel, model = lightgcn_ell
    for g, w in zip(model.propagate(), _propagate_jax(jmodel)):
        _assert_close(g, w, TOL_SAME, "ELL")


def test_routes_agree(lightgcn, lightgcn_ell, simgcl):
    """M, the dense per-layer loop, the edge list and ELL on the same
    weights, at the JAX package's cross-route tolerance."""
    _, model = lightgcn
    collapsed = torch.cat(model.propagate())
    m = model._prop_m
    model._prop_m = None
    try:
        edges = torch.cat(model.propagate())
    finally:
        model._prop_m = m
    ell = torch.cat(lightgcn_ell[1].propagate())
    dense = torch.cat(simgcl[1].propagate())           # SimGCL's readout is LightGCN's
    for got, tag in ((edges, "edge list"), (ell, "ELL"), (dense, "dense loop")):
        _assert_close(got, collapsed, TOL_ROUTES, f"{tag} vs collapsed M")


def test_bf16_operator(splits, lightgcn):
    """``prop_dtype: bf16`` stores M's float32 entries rounded to bfloat16
    and upcasts them in the product: against the JAX package's bf16 route
    (1e-5 / 1e-6), and within the JAX test's bf16 tolerance of the float32
    operator."""
    jmodel, model = _pair(splits, "LightGCN", prop_dtype="bf16")
    assert model._prop_m.dtype == torch.bfloat16 and str(jmodel._prop_m.dtype) == "bfloat16"
    m32 = lightgcn[1]._prop_m
    assert torch.equal(model._prop_m, m32.to(torch.bfloat16))
    # float32 M from products summed in another order: an entry next to a
    # bfloat16 rounding boundary may round the other way (6.5e-6 of them)
    differ = float((model._prop_m.float() != torch.from_numpy(
        np.asarray(jmodel._prop_m, np.float32))).float().mean())
    assert differ < 1e-4
    got, want = model.propagate(), _propagate_jax(jmodel)
    full = lightgcn[1].propagate()
    for g, w, f in zip(got, want, full):
        _assert_close(g, w, TOL_SAME, "bf16 vs JAX bf16")
        _assert_close(g, f, dict(rtol=2e-2, atol=1e-4), "bf16 vs fp32")


# ---------------------------------------------------------------------------
def _batch(trn):
    n = len(trn.data_index)
    idx = np.arange(0, n, n // ROWS)[:ROWS]
    idx[1] = idx[0]                        # a repeated (user, item) row
    return trn._get_pos_batch(idx)


def _jax_step(jmodel, batch, neg, rng):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads
    zeros = jnp.zeros(neg.shape, jnp.float32)
    jmodel.sampler = lambda *a, **k: (jnp.zeros(neg.shape[0]), jnp.asarray(neg), zeros)
    with jax.default_matmul_precision("float32"):
        (loss, _), grads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, jmodel.states)
    return float(loss), jax.tree_util.tree_map(np.asarray, zero_pad_rows_in_grads(grads))


def _port_step(model, batch, neg, **kwargs):
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import graph_params_to_jax
    zeros = torch.zeros(neg.shape)
    model.sampling = lambda *a, **k: (None, torch.from_numpy(neg), zeros)
    try:
        model.net.train()
        model.net.zero_grad(set_to_none=True)
        loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()}, **kwargs)
        loss.backward()
        zero_pad_rows_in_grads(model.net)
    finally:
        del model.sampling
        model.net.eval()
    return float(loss.detach()), graph_params_to_jax(
        {n: p.grad for n, p in model.net.named_parameters()})


def _simgcl_noise(jmodel, rng, shape):
    """The JAX step's two views' draws (``simgcl.py:36-39,47``)."""
    import jax
    _, rng_v1, rng_v2 = jax.random.split(rng, 3)
    n_layers = jmodel.config["model"]["n_layers"]
    return [[torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(r, i), shape)))
             for i in range(n_layers)] for r in (rng_v1, rng_v2)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("case", ["LightGCN", "LightGCN-ell", "NGCF", "SimGCL"])
def test_training_step_matches_jax(splits, lightgcn, lightgcn_ell, simgcl, case):
    import jax
    if case == "LightGCN":
        jmodel, model = lightgcn
    elif case == "LightGCN-ell":
        jmodel, model = lightgcn_ell
    elif case == "SimGCL":
        jmodel, model = simgcl
    else:
        jmodel, model = _pair(splits, "NGCF")
    trn = splits[0][0]
    batch = _batch(trn)
    neg = np.random.default_rng(NEG_SEED).integers(1, trn.num_items, size=(ROWS, 1))
    rng = jax.random.PRNGKey(0)
    kwargs = {}
    if case == "SimGCL":
        kwargs["noise"] = _simgcl_noise(jmodel, rng, (model._num_nodes, D))
    jloss, jgrads = _jax_step(jmodel, batch, neg, rng)
    loss, grads = _port_step(model, batch, neg, **kwargs)
    np.testing.assert_allclose(loss, jloss, rtol=TOL_LOSS)
    want, got = dict(_leaves(jgrads)), dict(_leaves(grads))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(w).max()), err_msg=key)
        assert float(np.abs(got[key]).max()) > 0.0, key
    assert float(np.abs(got["item_embedding"][0]).max()) == 0.0


def test_ngcf_message_dropout(splits):
    """With message dropout on, a step draws its masks from the model's
    generator: the same generator state repeats the step bit for bit, and
    the loss differs from the step without dropout."""
    _, model = _pair(splits, "NGCF", mess_dropout=[0.1, 0.1, 0.1])
    trn = splits[0][0]
    batch = _batch(trn)
    neg = np.random.default_rng(NEG_SEED).integers(1, trn.num_items, size=(ROWS, 1))
    state = model.generator.get_state()
    runs = []
    for _ in range(2):
        model.generator.set_state(state)
        runs.append(_port_step(model, batch, neg))
    assert runs[0][0] == runs[1][0]
    for key, g in _leaves(runs[0][1]):
        np.testing.assert_array_equal(g, dict(_leaves(runs[1][1]))[key])
    model.config["model"]["mess_dropout"] = [0.0, 0.0, 0.0]
    assert _port_step(model, batch, neg)[0] != runs[0][0]


@pytest.mark.parametrize("neg_type,labels", [("all", False), ("batch_both", False),
                                             ("batch_both", True), ("batch_single", False),
                                             ("batch_single", True)])
def test_info_nce_matches_jax(neg_type, labels):
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import info_nce as jax_info_nce
    from recstudio_torch.models.module.data_augmentation import info_nce
    rng = np.random.default_rng(7)
    a, b = (rng.normal(size=(12, 8)).astype(np.float32) for _ in range(2))
    reps = rng.normal(size=(30, 8)).astype(np.float32)
    reps[3] = 0.0                                      # a zero row: normalized to 0
    lab = np.array([0, 1, 2, 0, 3, 4, 5, 1, 6, 7, 8, 9]) if labels else None
    for sim in ("cosine", "inner_product"):
        want = jax_info_nce(jnp.asarray(a), jnp.asarray(b), 0.2, sim, neg_type,
                            all_reps=jnp.asarray(reps),
                            instance_labels=None if lab is None else jnp.asarray(lab))
        got = info_nce(torch.from_numpy(a), torch.from_numpy(b), 0.2, sim, neg_type,
                       all_reps=torch.from_numpy(reps),
                       instance_labels=None if lab is None else torch.from_numpy(lab))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_l2_reg_loss_matches_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.loss_func import l2_reg_loss_fn as jax_l2
    from recstudio_torch.models.loss_func import l2_reg_loss_fn
    rng = np.random.default_rng(1)
    embs = [rng.normal(size=s).astype(np.float32) for s in ((5, 4), (5, 4), (15, 4))]
    np.testing.assert_allclose(float(l2_reg_loss_fn(*map(torch.from_numpy, embs))),
                               float(jax_l2(*map(jnp.asarray, embs))), rtol=1e-6)


@pytest.mark.parametrize("layer_size", [None, [4, 6, 5]], ids=["tables", "ngcf"])
def test_graph_params_round_trip(layer_size):
    from recstudio_torch.models.graph.ngcf import NGCFLayer
    from recstudio_torch.models.graph.base import GraphNet
    from recstudio_torch.utils.convert import graph_params_from_jax, graph_params_to_jax
    tree = random_graph_params(1, 10, 12, 4, layer_size)
    sd = graph_params_from_jax(tree)
    net = GraphNet(10, 12, 4)
    for i, (d_in, d_out) in enumerate(zip((layer_size or [])[:-1], (layer_size or [])[1:])):
        net.add_module(f"layer_{i}", NGCFLayer(d_in, d_out))
    net.load_state_dict(sd)                       # every name and shape fits
    if layer_size:
        np.testing.assert_array_equal(net.layer_1.W2.weight.detach().numpy(),
                                      tree["layer_1"]["W2"]["kernel"].T)
    back = graph_params_to_jax(net.state_dict())
    assert sorted(dict(_leaves(back))) == sorted(dict(_leaves(tree)))
    for key, value in _leaves(tree):
        np.testing.assert_array_equal(dict(_leaves(back))[key], value)


# ---------------------------------------------------------------------------
def test_user_all_cache(splits, tmp_path):
    """An evaluation pass propagates once; ``fit`` leaves no cache of its
    last weights, and ``restore`` drops the cache of the old ones."""
    from recstudio_torch.utils import get_model
    trn, val, tst = splits[0]
    cls, conf = get_model("LightGCN")
    conf["model"]["embed_dim"] = D
    conf["train"].update(epochs=1, batch_size=2048)
    conf["eval"].update(save_path=str(tmp_path), val_metrics=["ndcg"])
    model = cls(conf, device="cpu")
    calls = []
    original = cls.propagate
    model.propagate = lambda: calls.append(1) or original(model)
    model.fit(trn, val)
    assert len(calls) == model._steps_per_epoch + 1      # each step, then one validation pass
    assert "user_all" not in model.states and "item_vector" not in model.states
    snap = model.snapshot()
    calls.clear()
    model.evaluate(tst, verbose=False)
    assert calls == [1] and {"user_all", "item_vector"} <= set(model.states)
    assert model.states["user_all"].shape == (trn.num_users, D)
    with torch.no_grad():
        model.net.user_embedding.weight.add_(1.0)
    model.restore(snap)
    assert "user_all" not in model.states and "item_vector" not in model.states
    assert torch.equal(model.net.user_embedding.weight, snap["user_embedding.weight"])


@pytest.fixture(scope="module")
def eval_pair(splits):
    return _pair(splits, "LightGCN")


def test_evaluate_matches_jax(splits, eval_pair):
    import jax
    jmodel, model = eval_pair
    tst, jtst = splits[0][2], splits[1][2]
    assert model._cutoffs() == [5, 10, 20]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
    got = model.evaluate(tst, verbose=False)
    assert sorted(got) == sorted(want) and len(got) == 18
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5, atol=1e-7, err_msg=key)


def test_served_lists_match_jax(splits, eval_pair):
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    jmodel, model = eval_pair
    tst, jtst = splits[0][2], splits[1][2]
    pred = Predictor(model, max_batch=128, k=20, train_data=tst).warm()
    assert set(pred._dummy()) == {"user_id"}
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=20, train_data=jtst).warm()
        for offset, n in ((0, 128), (900, 43)):
            users = tst.data_index[offset:offset + n, 0].astype(np.int32)
            s, i = pred({"user_id": users})
            js, ji = jpred({"user_id": users})
            assert s.shape == (n, 20)
            np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0
            hist = tst.user_hist[users]
            assert not any(np.isin(i[r], hist[r][hist[r] > 0]).any() for r in range(n))


@pytest.mark.parametrize("name", ["LightGCN", "NGCF", "SimGCL"])
def test_quickstart_fits_one_epoch(name, tmp_path):
    """``quickstart.run`` on the CPU at d 16, one epoch: finite loss and
    metrics, and the test metrics of the cutoffs configured."""
    from recstudio_torch.quickstart import run
    over = dict(MODEL_OVERRIDES[name])
    over.pop("mess_dropout", None)
    model, (trn, _, tst), result = run(
        name, "ml-100k", verbose=False, device="cpu",
        model_config={"model": over, "train": {"epochs": 1},
                      "eval": {"save_path": str(tmp_path)}})
    assert np.isfinite(model.epoch_log[0]["train_loss"])
    assert len(result) == 18 and all(np.isfinite(v) for v in result.values())
    assert model.device == torch.device("cpu") and type(model).__name__ == name


@pytest.mark.parametrize("name", ["lightgcn", "ngcf", "simgcl"])
def test_training_reference_file(name):
    with open(os.path.join(ASSETS, f"{name}_ml100k_train_reference.json")) as f:
        ref = json.load(f)
    ndcg = [r["ndcg@10"] for r in ref["runs"]]
    spread = max(ndcg) - min(ndcg)
    assert ref["ndcg@10_band"] == [min(ndcg) - spread, max(ndcg) + spread]
    assert ref["untrained_ndcg@10"] == max(r["untrained_ndcg@10"] for r in ref["runs"])
    assert [r["seed"] for r in ref["runs"]] == list(range(2022, 2022 + len(ref["runs"])))
    assert len(ref["runs"]) >= 3 and ref["epochs"] > 0 and ref["about"]
    margin = ref["ndcg@10_band"][0] - ref["untrained_ndcg@10"]
    assert ref["learning_gate"] == ("ndcg" if margin >= 0.05 else "train_loss")
    loss = [r["train_loss_last"] for r in ref["runs"]]
    spread = max(loss) - min(loss)
    assert ref["train_loss_last_band"] == [min(loss) - spread, max(loss) + spread]
    if ref["learning_gate"] == "train_loss":   # the loss fell: the model trains
        assert all(r["train_loss_last"] < r["train_loss_first"] - 0.5 for r in ref["runs"])
