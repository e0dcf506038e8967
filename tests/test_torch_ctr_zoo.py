"""The CTR interaction zoo, InterHAt and DIFM: the port against the JAX
package.

On ml-100k under the fm family's config (7 fields), both packages hold the
same numpy weights and batch-norm statistics (``ranker_params_from_jax``
with ``batch_stats``) and see the same batch of
512 rows, dropout off:

- each model's logits in evaluation (calibrated statistics, and the
  batch's while the count is 0, where it has batch norms) and in
  training, to 1e-5 absolute + 1e-5 relative (``TOL_OUT``); one step's
  loss to 1e-5 relative and every gradient to 1e-4 of its largest
  magnitude + 1e-3 relative (``TOL_GRAD``; AFN's 1e-3 of the largest,
  ``TOL_GRAD_LOG``: its log and exp neurons). A bias whose shift a batch
  norm in training mode or a softmax removes has a zero gradient in exact
  arithmetic: both packages' float32 noise there is held under 1e-6 of the
  net's largest gradient, not to each other;
- ``ranker_params_to_jax(ranker_params_from_jax(tree))`` gives the tree
  back bit for bit; PNN's outer-product kernel is drawn far from its
  transpose over the first and last axes, which the converter gave before
  it transposed only 2-D kernels;
- this file: InterHAt (its ``TransformerLayer`` through K1 and K2 under
  the JAX gate) and DIFM (its attention through K3 in evaluation, the plain
  softmax in training with dropout), their evaluation and
  ``ScorePredictor``; ``test_torch_ctr_zoo_{cross,fm,deep}.py`` the other
  thirteen models, with ``_VARIANTS``' config variants, and
  ``test_torch_ctr_zoo_fit.py`` the JAX bands of phase AF.
"""
import numpy as np
import pytest
import torch

SPLIT_SEED = 42
WEIGHT_SEED = 6
ROWS = 512
TOL_OUT = (1e-5, 1e-5)     # (atol, rtol) of logits
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)
TOL_ZERO_GRAD = 1e-6       # a zero-in-exact-arithmetic gradient, share of max |g|
# AFN's gradients: its logarithmic neurons are exp of sums of logs,
# batch-normalized in training mode, which magnifies float32 rounding. At
# the drawn weights the JAX package's float32 gradients (XLA on the CPU) lie
# up to 6.1e-4 of the largest from the same step in float64 (afn_mlp/dense_1:
# 2.5e-4 of 0.41), the port's within 1.5e-6: the bound is JAX's error
TOL_GRAD_LOG = (1e-3, 1e-3)

# variant id -> (model, config overrides): every option the JAX models read
_VARIANTS = {
    "InterHAt": ("InterHAt", {}),
    "DIFM": ("DIFM", {}),
    "xDeepFM": ("xDeepFM", {}),
    "xDeepFM-direct": ("xDeepFM", {"direct": True}),
    "DCNv2": ("DCNv2", {}),
    "DCNv2-stacked": ("DCNv2", {"combination": "stacked"}),
    "DCNv2-lowrank": ("DCNv2", {"low_rank": 4}),
    "PNN": ("PNN", {}),
    "PNN-outer": ("PNN", {"product_type": "outer"}),
    "DLRM": ("DLRM", {}),
    "DLRM-dot": ("DLRM", {"op": "dot"}),
    "DLRM-cat": ("DLRM", {"op": "cat"}),
    "FwFM": ("FwFM", {}),
    "FwFM-lw": ("FwFM", {"linear_type": "lw"}),
    "FwFM-felv": ("FwFM", {"linear_type": "felv"}),
    "AFM": ("AFM", {}),
    "FFM": ("FFM", {}),
    "FmFM": ("FmFM", {}),
    "FiBiNET": ("FiBiNET", {}),
    "FiBiNET-all": ("FiBiNET", {"bilinear_type": "all"}),
    "FiBiNET-each": ("FiBiNET", {"bilinear_type": "each", "shared_bilinear": False}),
    "MaskNet": ("MaskNet", {}),
    "MaskNet-parallel": ("MaskNet", {"parallel": True, "hidden_layer_norm": True}),
    "ONN": ("ONN", {}),
    "HFM": ("HFM", {}),
    "HFM-convolution": ("HFM", {"op": "circular_convolution"}),
    "HFM-product": ("HFM", {"op": "product", "deep": False}),
    "AFN": ("AFN", {}),
    "AFN-single": ("AFN", {"ensemble": False}),
    "DeepCrossing": ("DeepCrossing", {}),
    "IFM": ("IFM", {}),
    "IFM-bn": ("IFM", {"batch_norm": True}),
    "DeepIM": ("DeepIM", {}),
    "DeepIM-order5": ("DeepIM", {"order": 5, "batch_norm": True}),
    "LorentzFM": ("LorentzFM", {}),
    "PPNet": ("PPNet", {}),
    "PPNet-bn": ("PPNet", {"batch_norm": True, "gate_fields": ["age", "gender"]}),
    "FinalMLP": ("FinalMLP", {}),
    "FinalMLP-bn": ("FinalMLP", {"batch_norm1": True, "batch_norm2": True,
                                 "fields1": ["user_id", "age"], "fields2": ["item_id"]}),
    "FinalMLP-nofs": ("FinalMLP", {"feature_selection": False}),
    "EDCN": ("EDCN", {}),
    "EDCN-attention": ("EDCN", {"bridge_type": "attention_pooling", "temperature": 0.5}),
    "EDCN-concat": ("EDCN", {"bridge_type": "concatenation", "num_layers": 2}),
    "FLEN": ("FLEN", {}),
    "FLEN-groups": ("FLEN", {"fields": [["user_id", "age"], ["item_id"], ["gender"]]}),
    "SAM": ("SAM", {}),
    "SAM-sam3a": ("SAM", {"interaction_type": "sam3a", "aggregation": "weighted_pooling"}),
    "AOANet": ("AOANet", {}),
    "DESTINE": ("DESTINE", {}),
    "DESTINE-relu": ("DESTINE", {"relu_before_att": True, "wide": False, "n_head": 1}),
    "DESTINE-res-mode": ("DESTINE", {"res_mode": "last_layer"}),
    "FiGNN": ("FiGNN", {}),
    "CCPM": ("CCPM", {}),
    "FGCNN": ("FGCNN", {}),
    # the groups phase AI sets on criteo's columns, at the id-less test
    # split's 13 float and 4 token fields
    "FLEN-criteo": ("FLEN", {"fields": [[f"I{i}" for i in range(1, 14)],
                                        [f"C{i}" for i in range(1, 5)]]}),
    "FinalMLP-criteo": ("FinalMLP", {"fields1": [f"I{i}" for i in range(1, 14)],
                                     "fields2": [f"C{i}" for i in range(1, 5)]}),
    "PPNet-criteo": ("PPNet", {"gate_fields": [f"C{i}" for i in range(1, 5)]}),
}
VARIANTS = ("InterHAt", "DIFM")


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


def build_splits():
    from recstudio_tpu.data import TripletDataset as JaxTripletDataset
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.utils import get_model
    conf = get_model("NFM")[1]["data"]
    data = {"low_rating_thres": conf["low_rating_thres"]}
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k", config=dict(data)).build(**conf)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k", config=dict(data)).build(**conf)
    return ours, theirs


@pytest.fixture(scope="module")
def splits():
    return build_splits()


def draw_state(params, batch_stats, seed=WEIGHT_SEED):
    """Numpy weights N(0, 0.1) in ``params``' layout (token tables' row 0
    zero, scales near 1) and calibrated-looking statistics."""
    import jax
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(1.0 if name == "scale" else 0.0, 0.1, leaf.shape).astype(np.float32)
        if name.endswith("_embedding") and name != "dense_embedding":
            a[0] = 0.0
        return a

    def stat(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "count":
            return np.float32(4.0)
        if name == "var":
            return (rng.random(leaf.shape) + 0.5).astype(np.float32)
        return rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
    return (jax.tree_util.tree_map_with_path(draw, params),
            jax.tree_util.tree_map_with_path(stat, batch_stats))


_BUILT = {}


def models(variant, splits):
    """The JAX and the port's model of ``variant`` on the same split,
    dropout off, both holding the same drawn weights and statistics (fresh
    at each call)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax
    ours, theirs = splits
    key = (variant, id(splits))
    if key not in _BUILT:
        name, over = _VARIANTS[variant]
        out = []
        for getter in (jax_get_model, get_model):
            cls, conf = getter(name)
            conf["model"].update(over)
            for k in [k for k in conf["model"] if "dropout" in k] + ["dropout"]:
                conf["model"][k] = 0.0
            out.append((cls, conf))
        (jcls, jconf), (cls, conf) = out
        jmodel = jcls(jconf)
        jmodel._init_model(theirs[0])
        jmodel._init_variables = jax.jit(jmodel._init_variables)
        jmodel._init_parameter(theirs[0])
        jmodel.val_check = False
        model = cls(conf, device="cpu")
        model._init_model(ours[0])
        stats = jmodel.states.get("net", {}).get("batch_stats", {})
        _BUILT[key] = (jmodel, model, draw_state(
            jax.tree_util.tree_map(np.asarray, jmodel.params), stats))
    jmodel, model, (params, stats) = _BUILT[key]
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    if stats:
        jmodel.states["net"] = {"batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    model.net.load_state_dict(ranker_params_from_jax(params, model.net, batch_stats=stats))
    model._calib_batches = None
    return jmodel, model


def batch_of(trn, start=0):
    n = len(trn.data_index)
    return trn._get_pos_batch((np.arange(start, start + ROWS) * (n // ROWS)) % n)


def assert_tree(got, want, tol, tag):
    for key in want:
        if isinstance(want[key], dict):
            assert_tree(got[key], want[key], tol, f"{tag}/{key}")
            continue
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=tol[1],
                                   atol=tol[0] * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{tag}/{key}")
    assert sorted(got) == sorted(want), tag


def zero_counts(jmodel, model):
    import jax
    from recstudio_torch.models.module.layers import SimpleBatchNorm
    if "net" in jmodel.states:
        jmodel.states["net"] = jax.tree_util.tree_map_with_path(
            lambda p, v: v * 0 if str(getattr(p[-1], "key", "")) == "count" else v,
            jmodel.states["net"])
    for m in model.net.modules():
        if isinstance(m, SimpleBatchNorm):
            m.count.zero_()


def check_forward(variant, splits):
    """Logits in evaluation (calibrated statistics, then the batch's with the
    counts at 0, where there are batch norms) and in training."""
    import jax
    import jax.numpy as jnp
    jmodel, model = models(variant, splits)
    batch = batch_of(splits[0][0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    score = jax.jit(jmodel.score, static_argnames=("training",))
    tags = ("calibrated", "uncalibrated", "training") if "net" in jmodel.states else \
        ("eval", "training")
    with jax.default_matmul_precision("float32"):
        for tag in tags:
            if tag == "uncalibrated":
                zero_counts(jmodel, model)
            training = tag == "training"
            want = np.asarray(score(jmodel.params, jb, training=training,
                                    net_state=jmodel.states.get("net")))
            model.net.train(training)
            with torch.no_grad():
                got = model.score(tb).numpy()
            model.net.eval()
            assert np.isfinite(want).all() and np.abs(want).max() > 1e-3, tag
            np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1],
                                       err_msg=f"{variant} {tag}")


def _pop_noise(grads, want, path, largest):
    for tree in (grads, want):
        node = tree
        for key in path[:-1]:
            node = node[key]
        assert float(np.abs(node.pop(path[-1])).max()) < TOL_ZERO_GRAD * largest, path


def check_gradients(variant, splits):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import ranker_params_to_jax
    jmodel, model = models(variant, splits)
    batch = batch_of(splits[0][0], 7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_and_grads = jax.jit(jax.value_and_grad(jmodel._loss_and_aux, has_aux=True))
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = loss_and_grads(jmodel.params, jb, jax.random.PRNGKey(0),
                                            jmodel.states)
    model.net.train()
    model.net.zero_grad(set_to_none=True)
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ranker_params_to_jax({n: p.grad for n, p in model.net.named_parameters()}, model.net)
    want = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want))
    # a Linear's bias that feeds a batch norm in training mode (the norm
    # subtracts the batch mean), and a bias that moves a softmax's scores
    # alike (an attention's key bias; AFM's attention bias here), which the
    # softmax removes
    def bn_fed_biases(node, path=()):
        for key, sub in node.items():
            if isinstance(sub, dict):
                yield from bn_fed_biases(sub, path + (key,))
            if key.startswith("bn_") and "bias" in node.get(f"dense_{key[3:]}", {}):
                yield path + (f"dense_{key[3:]}", "bias")
    for path in list(bn_fed_biases(want)):
        _pop_noise(grads, want, path, largest)
    if "afm" in want:
        # every pair's attention input is positive at these weights (the bias
        # outweighs the products), so its bias moves each pair's score alike
        _pop_noise(grads, want, ("afm", "attn_w", "bias"), largest)
    if "vector_fen" in want:
        _pop_noise(grads, want, ("vector_fen", "attn", "k_proj", "bias"), largest)
    if "fwbi_fc" in want:
        # FLEN's first-order score enters fwbi_fc's batch norm in training
        # mode through a bias-free layer: the norm removes its bias
        _pop_noise(grads, want, ("linear", "bias"), largest)
    # DESTINE: the unary softmax over the fields removes its logits' bias,
    # the whitening (q and k minus their means over the fields) q's and k's
    for i in range(sum(k.startswith("attn_") and k != "attn_fc" for k in want)):
        for leaf in ("unary", "Wq", "Wk"):
            _pop_noise(grads, want, (f"attn_{i}", leaf, "bias"), largest)
    if "trm" in want:
        d = want["trm"]["out_bias"].shape[0]
        for tree in (grads, want):
            b = tree["trm"]["qkv_bias"]
            assert np.abs(b[d:2 * d]).max() < TOL_ZERO_GRAD * largest
            tree["trm"]["qkv_bias"] = np.concatenate([b[:d], b[2 * d:]])
    tol = TOL_GRAD_LOG if _VARIANTS[variant][0] == "AFN" else TOL_GRAD
    assert_tree(grads, want, tol, f"{variant} grad")


def check_round_trip(variant, splits):
    """``ranker_params_to_jax(ranker_params_from_jax(tree)) == tree`` and the
    batch statistics back, bit for bit."""
    import jax
    from recstudio_torch.utils.convert import (ranker_batch_stats_to_jax, ranker_params_from_jax,
                                               ranker_params_to_jax)
    _, model = models(variant, splits)
    params, stats = _BUILT[(variant, id(splits))][2]
    sd = ranker_params_from_jax(params, model.net, batch_stats=stats)
    assert sorted(sd) == sorted(model.net.state_dict())
    for key, value in model.net.state_dict().items():
        assert sd[key].shape == value.shape, key

    def same(got, want, tag):
        assert sorted(got) == sorted(want), tag
        for key in want:
            if isinstance(want[key], dict):
                same(got[key], want[key], f"{tag}/{key}")
            else:
                assert got[key].shape == np.shape(want[key]), f"{tag}/{key}"
                assert np.array_equal(got[key], want[key]), f"{tag}/{key}"
    same(ranker_params_to_jax(sd, model.net), params, variant)
    same(ranker_batch_stats_to_jax(sd), jax.tree_util.tree_map(np.asarray, stats), variant)


def check_refresh_net_state(variant, splits):
    """``_refresh_net_state`` (the first 32 training batches, statistics
    reset first) gives the JAX package's statistics."""
    import jax
    from recstudio_torch.utils.convert import ranker_batch_stats_to_jax
    jmodel, model = models(variant, splits)
    jmodel._train_data, model._train_data = splits[1][0], splits[0][0]
    with jax.default_matmul_precision("float32"):
        jmodel._refresh_net_state()
    model._refresh_net_state()
    want = jax.tree_util.tree_map(np.asarray, jmodel.states["net"]["batch_stats"])
    got = ranker_batch_stats_to_jax(model.net.state_dict())
    counts = [float(v) for p, v in jax.tree_util.tree_flatten_with_path(want)[0]
              if str(getattr(p[-1], "key", "")) == "count"]
    assert counts and set(counts) == {32.0}
    assert_tree(got, want, (1e-5, 1e-5), f"{variant} batch_stats")


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant, splits):
    check_forward(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_loss_and_gradients_match_jax(variant, splits):
    check_gradients(variant, splits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_round_trip_is_exact(variant, splits):
    check_round_trip(variant, splits)


@pytest.mark.parametrize("name", VARIANTS)
def test_evaluate_and_score_predictor_match_jax(name, splits):
    check_evaluate(name, splits)


def check_evaluate(name, splits):
    """``evaluate``'s AUC and logloss on the test split, and
    ``ScorePredictor``'s probabilities for 300 test rows, against the JAX
    package's; the served probabilities against ``predict``."""
    import jax
    from recstudio_tpu.serving import ScorePredictor as JaxScorePredictor
    from recstudio_torch.serving import ScorePredictor
    jmodel, model = models(name, splits)
    tst, jtst = splits[0][2], splits[1][2]
    jmodel._train_data, model._train_data = splits[1][0], splits[0][0]
    fields = [f for f in tst.inter_feat.fields if f != "rating"]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
        rows = tst.data_index[:300]
        request = {f: tst.inter_feat.get_col(f)[rows] for f in fields}
        served = JaxScorePredictor(jmodel, max_batch=512, train_data=splits[1][0])(request)
    got = model.evaluate(tst, verbose=False)
    np.testing.assert_allclose(got["auc"], float(want["auc"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["logloss"], float(want["logloss"]), rtol=1e-5)
    pred = ScorePredictor(model, max_batch=512, train_data=splits[0][0])(request)
    np.testing.assert_allclose(pred, served, rtol=0, atol=1e-5)
    tst.use_field = model.fields
    np.testing.assert_allclose(pred, model.predict(tst._get_pos_batch(np.arange(300))),
                               rtol=0, atol=1e-6)


def test_interhat_takes_the_fused_layer_with_the_rankers_generator(splits, monkeypatch):
    """InterHAt's layer has no key padding mask and no attention mask and is
    inside the fused layer's gate: evaluation and training (dropout 0.3)
    both call ``fused_transformer_layer`` (K1, with K2 as its backward in
    training, on the card), its seeds drawn from the model's generator: a
    step repeats from the same generator state and moves with another."""
    from recstudio_torch.models.module import layers
    from recstudio_torch.ops.transformer_layer import supports_fused_layer
    _, model = models("InterHAt", splits)
    trm = model.net.trm
    assert supports_fused_layer(16, 7, 2, 64, "relu") and trm.activation == "relu"
    calls = []
    real = layers.fused_transformer_layer
    monkeypatch.setattr(layers, "fused_transformer_layer",
                        lambda *a: calls.append((a[2], a[3], a[8])) or real(*a))
    batch = {k: torch.from_numpy(v) for k, v in batch_of(splits[0][0]).items()}
    trm.dropout = 0.3
    try:
        model.net.eval()
        with torch.no_grad():
            model.score(batch)
        assert calls == [(None, None, False)]
        state = model.generator.get_state()
        model.net.train()
        a = model.training_step(batch)
        a.backward()
        grad = trm.in_proj_weight.grad.clone()
        model.generator.set_state(state)
        b = model.training_step(batch)
        c = model.training_step(batch)
        assert calls[1:] == [(None, None, True)] * 3
        assert a.item() == b.item() != c.item() and torch.isfinite(grad).all()
    finally:
        trm.dropout = 0.0
        model.net.eval()


def test_difm_routes_attention_as_the_jax_gate(splits, monkeypatch):
    """Training with dropout 0.3 takes the plain softmax (seeds from the
    model's generator); evaluation and serving take ``fused_mha`` (K3 on the
    card), once a call, with no mask, at Dh 5."""
    from recstudio_torch.models.module import layers
    _, model = models("DIFM", splits)
    calls = []
    real = layers.fused_mha
    monkeypatch.setattr(layers, "fused_mha",
                        lambda *a: calls.append((a[0].shape, a[3], a[4])) or real(*a))
    batch = {k: torch.from_numpy(v) for k, v in batch_of(splits[0][0]).items()}
    attn = model.net.vector_fen.attn
    attn.dropout = 0.3
    try:
        state = model.generator.get_state()
        model.net.train()
        with torch.no_grad():
            a = model.training_step(batch)
            model.generator.set_state(state)
            b = model.training_step(batch)
        assert calls == [] and float(a) == float(b)
        model.net.eval()
        with torch.no_grad():
            model.score(batch)
        assert calls == [((ROWS, 2, 7, 5), None, None)]
    finally:
        attn.dropout = 0.0
        model.net.eval()


def _table_net(width):
    """A net with a token table ``width`` wide over 9 rows, and the linear
    part's 1 wide."""
    from recstudio_torch.models.module.ctr import Embeddings
    specs = [("a", "token", 4), ("b", "token", 5)]
    net = torch.nn.Module()
    net.embedding = Embeddings(specs, width)
    net.linear = torch.nn.Module()
    net.linear.embedding = Embeddings(specs, 1)
    net.linear.bias = torch.nn.Parameter(torch.zeros(1))
    return net


def test_wide_tables_are_read_by_their_own_width():
    """A JAX table reads whole into a port table as wide (ONN's on 3
    fields is ``F D = 3 D`` wide, FFM's on 4 fields ``(F - 1) D``), and
    gives its first D columns to a table a third as wide (a packed params
    | mu | nu table); the linear part's 3-wide table is a packed table of D
    1. Any other width raises, as does a leaf the net has no tensor for."""
    from recstudio_torch.utils.convert import ranker_params_from_jax
    rng = np.random.default_rng(0)
    table = rng.normal(size=(9, 12)).astype(np.float32)
    tree = {"embedding": {"token_embedding": table},
            "linear": {"embedding": {"token_embedding": table[:, :3]}, "bias": np.zeros(1)}}
    wide = ranker_params_from_jax(tree, _table_net(12))
    np.testing.assert_array_equal(wide["embedding.token_embedding.weight"], table)
    np.testing.assert_array_equal(wide["linear.embedding.token_embedding.weight"], table[:, :1])
    packed = ranker_params_from_jax(tree, _table_net(4))
    np.testing.assert_array_equal(packed["embedding.token_embedding.weight"], table[:, :4])
    with pytest.raises(ValueError):
        ranker_params_from_jax(tree, _table_net(5))
    with pytest.raises(KeyError):
        ranker_params_from_jax({**tree, "extra": {"kernel": np.ones((2, 2))}}, _table_net(4))
