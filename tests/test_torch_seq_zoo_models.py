"""Caser, FPMC, TransRec, HGN and NPE: the port against the JAX package on
the CPU, and the helpers the other ``test_torch_seq_zoo_*`` files share.

Both packages build each model on ml-100k at d 16 and L 10 (the dataset's
``max_seq_len``) with dropout 0; the JAX model's initial weights plus
seeded noise on every leaf (``perturbed``) go into both through the
converter, and the same numpy negatives replace both samplers. Batches are
rows of the training split, one with a history of length 1 among them.
Tolerances, float32 on both sides with sums in other orders:

- the query encoder in eval mode: rtol 1e-4, atol 1e-5;
- one training step: the loss to rtol 1e-5; each gradient to 1e-5 of its
  largest magnitude + rtol 1e-4;
- three Adam (Caser: AdamW, weight decay 1e-5) steps: every parameter to
  atol 2e-6 (``test_torch_narm_stamp.py``'s bound);
- served top-20 lists: scores rtol 1e-4 / atol 1e-5, ids up to ties;
- the converter round trip: bit for bit;
- the port's initial weights: each leaf's standard deviation within 15 %
  of the JAX package's (leaves of at least 256 entries).
"""
import numpy as np
import pytest
import torch

D, L, ROWS, WEIGHT_SEED, NEG_SEED, K = 16, 10, 48, 7, 19, 20
MODELS = ("Caser", "FPMC", "TransRec", "HGN", "NPE")
CL_MODELS = ("CL4SRec", "CoSeRec", "ICLRec")
# model overrides of the parity tests: narrow, dropout off
TEST_MODEL = {"Caser": {"embed_dim": D, "dropout": 0.0}, "FPMC": {"embed_dim": D},
              "TransRec": {"embed_dim": D}, "HGN": {"embed_dim": D},
              "NPE": {"embed_dim": D, "dropout_rate": 0.0},
              **{m: {"embed_dim": D, "dropout_rate": 0.0, "hidden_size": 32} for m in CL_MODELS}}
DATA = {"max_seq_len": L}
TOL_ENCODE = dict(rtol=1e-4, atol=1e-5)
TOL_GRAD = (1e-5, 1e-4)        # (atol as a share of the largest magnitude, rtol)
TOL_ADAM = 2e-6
TOL_INIT_STD = 0.15


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def leaves_of(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from leaves_of(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def zoo_pair(name):
    """The JAX and the port's ``name`` on the same ml-100k splits, holding
    the same perturbed weights: (JAX model, port model, JAX test split,
    port train and test splits, the weights as a JAX tree, the JAX model's
    initial tree)."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax
    from test_torch_gru import perturbed
    jcls, jconf = jax_get_model(name)
    jconf["model"].update(TEST_MODEL[name])
    jtrn, _, jtst = jcls._get_dataset_class()("ml-100k", config=DATA).build(**jconf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(jtrn)
    jmodel._init_parameter(jtrn)
    init = jax.tree_util.tree_map(np.asarray, jmodel.params)
    tree = perturbed(init, WEIGHT_SEED)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jmodel.val_check = False            # set by fit, which these tests skip,
    jmodel._train_data = jtrn           # as is the split ICLRec's refresh encodes
    cls, conf = get_model(name)
    conf["model"].update(TEST_MODEL[name])
    trn, _, tst = cls._get_dataset_class()("ml-100k", config=DATA).build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, model, jtst, trn, tst, tree, init


def inject_negatives(jmodel, model, shape, num_items):
    """The same uniform negatives ``shape + (1,)`` in both packages'
    ``sampling``."""
    import jax.numpy as jnp
    neg = np.random.default_rng(NEG_SEED).integers(1, num_items, size=shape + (1,))
    zeros = np.zeros(shape + (1,), np.float32)
    jmodel.sampling = lambda *a, **k: (jnp.zeros(shape), jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (torch.zeros(shape), torch.from_numpy(neg),
                                      torch.from_numpy(zeros))


def train_batch(trn, rows=ROWS):
    """``rows`` rows spread over the training split, the first one whose
    history has length 1, some shorter than L. A ``SeqToSeqDataset``'s
    windows (one a user, L long on ml-100k) are cut to 1, 3 and 6 in its
    first three rows, every window field zeroed past the cut."""
    n = len(trn.data_index)
    idx = np.arange(0, n, n // rows)[:rows]
    seqlen = trn._get_pos_batch(np.arange(n))["seqlen"]
    ones = np.flatnonzero(seqlen == 1)
    if ones.size:
        idx[0] = int(ones[0])
    batch = trn._get_pos_batch(idx)
    if not ones.size:
        for r, cut in enumerate((1, 3, 6)):
            batch["seqlen"][r] = cut
            for k, v in batch.items():
                if v.ndim == 2:
                    v[r, cut:] = 0
    assert batch["seqlen"][0] == 1 and (batch["seqlen"] < L).any()
    return batch


def query_feat(model, batch):
    return {f: batch[f] for f in sorted(model.query_fields)}


def check_encoder(jmodel, model, batch, width):
    import jax
    import jax.numpy as jnp
    feat = query_feat(model, batch)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel._apply(jmodel.params, "encode_query",
                                        {k: jnp.asarray(v) for k, v in feat.items()}))
    with torch.no_grad():
        got = model.net.encode_query({k: torch.from_numpy(v) for k, v in feat.items()})
    assert got.shape == (len(batch["seqlen"]), width)
    np.testing.assert_allclose(got.numpy(), want, **TOL_ENCODE)


def check_training_step(jmodel, model, batch):
    """One step's loss and every gradient against the JAX step's."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    with jax.default_matmul_precision("float32"):
        (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
            jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jmodel.states)
    jgrads = jax.tree_util.tree_map(np.asarray, jax_zero_pad(jgrads))
    model.net.train()
    model.net.zero_grad()
    loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    zero_pad_rows_in_grads(model.net)
    model.net.eval()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = params_to_jax({n: p.grad for n, p in model.net.named_parameters()})
    for path, a, b in leaves_of(grads, jgrads):
        np.testing.assert_allclose(a, b, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * max(float(np.abs(b).max()), 1e-3),
                                   err_msg=path)
    return float(loss.detach()), grads


def check_adam_steps(jmodel, model, batch, n=3):
    """``n`` steps of the config's learner from the same weights: every
    parameter after them."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_to_jax
    wd = float(model.config["train"].get("weight_decay") or 0.0)
    opt = jmodel._make_optax("adam", 1e-3, wd)
    params, state = jmodel.params, opt.init(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        for i in range(n):
            params, state, _ = jmodel._grad_step(opt, params, state, jbatch,
                                                 jax.random.PRNGKey(i), jmodel.states)
    model.optimizer = model._make_optimizer("adam", 1e-3, wd)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.net.train()
    for _ in range(n):
        model._grad_step(tbatch)
    model.net.eval()
    got = params_to_jax(model.net.state_dict())
    for path, a, b in leaves_of(got, jax.tree_util.tree_map(np.asarray, params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_ADAM, err_msg=path)


def check_serving(jmodel, model, jtst, tst):
    import jax
    from recstudio_tpu.serving import Predictor as JaxPredictor
    from recstudio_torch.serving import Predictor
    from recstudio_torch.utils.parity import topk_mismatches
    pred = Predictor(model, max_batch=64, k=K, train_data=tst)
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=64, k=K, train_data=jtst)
        batch = next(iter(tst.eval_loader(64)))
        req = query_feat(model, batch)
        s, i = pred(req)
        js, ji = jpred(req)
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-4, atol=1e-5)
    assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), 1e-5) == 0


def check_round_trip(model, tree):
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    for path, a, b in leaves_of(params_to_jax(params_from_jax(tree)), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)
    for path, a, b in leaves_of(params_to_jax(model.net.state_dict()), tree):
        np.testing.assert_array_equal(a, b, err_msg=path)


def check_init_spreads(name, init):
    """The port's own initial weights spread as the JAX package's do, leaf
    by leaf (the rule by name, the modules' raw initializers)."""
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_to_jax
    cls, conf = get_model(name)
    conf["model"].update(TEST_MODEL[name])
    trn, _, _ = cls._get_dataset_class()("ml-100k", config=DATA).build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    checked = 0
    for path, a, b in leaves_of(params_to_jax(model.net.state_dict()), init):
        assert a.shape == b.shape, path
        if b.size >= 256:
            assert abs(a.std() / b.std() - 1) < TOL_INIT_STD, (path, a.std(), b.std())
            checked += 1
        elif not np.any(b):
            assert not np.any(a), path
    assert checked > 0


def check_quickstart_fit(name, tmp_path, **train):
    """``quickstart.run(name, "ml-100k", device="cpu")`` for one epoch at d
    16 and L 10 (``train`` overriding the config): finite losses and
    metrics, and a served request."""
    from recstudio_torch.quickstart import run
    from recstudio_torch.serving import Predictor
    model, (trn, _, tst), result = run(
        name, "ml-100k", verbose=False, device="cpu", data_config=dict(DATA),
        model_config={"model": dict(TEST_MODEL[name]), "train": {"epochs": 1, **train},
                      "eval": {"save_path": str(tmp_path)}})
    assert type(model).__name__ == name and model.device.type == "cpu"
    assert np.isfinite(model.epoch_log[0]["train_loss"])
    assert np.isfinite(list(result.values())).all() and result["ndcg@10"] > 0
    batch = next(iter(tst.eval_loader(8)))
    s, i = Predictor(model, max_batch=8, k=10, train_data=tst).warm()(query_feat(model, batch))
    assert s.shape == (8, 10) and ((i >= 1) & (i < trn.num_items)).all()
    return model


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    name = request.param
    jmodel, model, jtst, trn, tst, tree, init = zoo_pair(name)
    inject_negatives(jmodel, model, (ROWS,), trn.num_items)
    return name, jmodel, model, jtst, trn, tst, tree, init


def test_model_parts(pair):
    from recstudio_torch.ann.sampler import UniformSampler
    from recstudio_torch.models.basemodel.baseretriever import SharedItemTowerNet, TwoTowerNet
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss, BPRLoss
    name, _, model, _, trn, _, _, _ = pair
    two_tower = name in ("Caser", "FPMC")
    assert type(model.net) is (TwoTowerNet if two_tower else SharedItemTowerNet)
    assert isinstance(model.loss_fn, BinaryCrossEntropyLoss if name == "NPE" else BPRLoss)
    assert isinstance(model.sampler, UniformSampler) and model.neg_count == 1
    width = 2 * D if two_tower else D
    assert model._compute_item_vector().shape == (trn.num_items - 1, width)


def test_encoder_matches_jax(pair):
    name, jmodel, model, _, trn, _, _, _ = pair
    check_encoder(jmodel, model, train_batch(trn), 2 * D if name in ("Caser", "FPMC") else D)


def test_training_step_matches_jax(pair):
    _, jmodel, model, _, trn, _, _, _ = pair
    _, grads = check_training_step(jmodel, model, train_batch(trn))
    assert all(float(np.abs(a).max()) > 0 for _, a, _ in leaves_of(grads, grads))


def test_three_adam_steps_match_jax(pair):
    from recstudio_torch.utils.convert import params_from_jax
    _, jmodel, model, _, trn, _, tree, _ = pair
    try:
        check_adam_steps(jmodel, model, train_batch(trn))
    finally:                            # the module's other tests hold the first weights
        model.load_state_dict(params_from_jax(tree))


def test_served_topk_matches_jax(pair):
    _, jmodel, model, jtst, _, tst, _, _ = pair
    check_serving(jmodel, model, jtst, tst)


def test_params_round_trip(pair):
    _, _, model, _, _, _, tree, _ = pair
    check_round_trip(model, tree)


def test_initial_weight_spreads_match_jax(pair):
    name, _, _, _, _, _, _, init = pair
    check_init_spreads(name, init)


@pytest.mark.parametrize("name", MODELS)
def test_quickstart_fit_on_the_cpu(name, tmp_path):
    """An epoch at batch 2048 (the configs' 512 give 156 steps)."""
    model = check_quickstart_fit(name, tmp_path, batch_size=2048)
    assert model.max_seq_len == L


def test_caser_kernel_layouts():
    """Caser's horizontal kernel ``(h, D, n_h)`` is the conv1d weight ``[n_h,
    D, h]`` (axes reversed) and back; a conv1d with it equals the JAX
    package's NWC/WIO convolution."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import params_from_jax, params_to_jax
    rng = np.random.default_rng(3)
    for h in (1, 3, 10):
        w = rng.normal(size=(h, 5, 4)).astype(np.float32)
        tree = {"query_encoder": {f"horizontal_kernel_{h}": w}}
        sd = params_from_jax(tree)
        assert tuple(sd[f"query_encoder.horizontal_kernel_{h}"].shape) == (4, 5, h)
        np.testing.assert_array_equal(params_to_jax(sd)["query_encoder"][f"horizontal_kernel_{h}"],
                                      w)
        x = rng.normal(size=(2, 12, 5)).astype(np.float32)
        want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1,), "VALID",
                                            dimension_numbers=("NWC", "WIO", "NWC"))
        got = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2),
                                         sd[f"query_encoder.horizontal_kernel_{h}"])
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_hgn_pooling_matches_jax(pooling):
    """HGN's query under both of its poolings, on the same weights."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module import Embedding as JaxEmbedding
    from recstudio_tpu.models.seq.hgn import HGNQueryEncoder as JaxHGN
    from recstudio_torch.models.module import Embedding
    from recstudio_torch.models.seq.hgn import HGNQueryEncoder
    from recstudio_torch.utils.convert import params_from_jax
    from test_torch_gru import perturbed
    rng = np.random.default_rng(11)
    B, N, U = 6, 30, 9
    jmod = JaxHGN(fuid="user_id", fiid="item_id", num_users=U, embed_dim=D, max_seq_len=L,
                  item_encoder=JaxEmbedding(N, D), pooling_type=pooling)
    seqlen = np.array([1, 3, L, 5, 2, 7], np.int32)
    hist = np.where(np.arange(L)[None] < seqlen[:, None], rng.integers(1, N, (B, L)), 0)
    batch = {"user_id": rng.integers(1, U, B).astype(np.int32), "seqlen": seqlen,
             "in_item_id": hist.astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = perturbed(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jb)["params"]), 5)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmod.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                     jb))
    mod = HGNQueryEncoder("user_id", "item_id", U, D, L, Embedding(N, D), pooling)
    mod.load_state_dict({k[len("query_encoder."):]: v for k, v in
                         params_from_jax({"query_encoder": params}).items()})
    with torch.no_grad():
        got = mod({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, **TOL_ENCODE)


def test_registry_resolves_the_seq_family():
    """Every model of the JAX package's ``seq`` family resolves through the
    port's registry, with the JAX configs' values."""
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_tpu.utils import list_models as jax_list_models
    from recstudio_torch.utils import get_model, list_models
    seq = sorted(n for n, f in jax_list_models().items() if f == "seq")
    assert seq == sorted(n for n, f in list_models().items() if f == "seq")
    for name in seq:
        cls, conf = get_model(name)
        _, jconf = jax_get_model(name)
        for group in ("model", "train", "eval", "data"):
            for key, value in jconf[group].items():
                if key in conf[group]:
                    assert conf[group][key] == value or float(conf[group][key]) == float(value), \
                        (name, group, key)
        assert cls.__name__.lower() == name


def test_last_item_reads_the_last_true_position():
    from recstudio_torch.models.seq.fpmc import last_item
    batch = {"in_item_id": torch.tensor([[4, 5, 0], [7, 0, 0], [1, 2, 3], [0, 0, 0]]),
             "seqlen": torch.tensor([2, 1, 3, 0])}
    assert last_item(batch, "item_id").tolist() == [5, 7, 3, 0]


@pytest.mark.parametrize("k", [20, 100])
def test_topk_orders_equal_scores_by_item_as_jax(k):
    """``ops.topk`` lists equal scores lower column first, as
    ``jax.lax.top_k`` does, so a top-20 is the first 20 of a top-100 where
    no tie straddles the 20th place (the tie that parted phase G's served
    lists from ``evaluate``'s at 10 epochs); rows with no tie at the k-th
    place equal JAX's exactly."""
    import jax
    from recstudio_torch.ops.topk import topk
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 40, size=(64, 300)).astype(np.float32)   # many ties
    vals, idx = topk(torch.from_numpy(scores), k)
    jvals, jidx = jax.lax.top_k(scores, k)
    desc = -np.sort(-scores, axis=1)
    clean = desc[:, k - 1] != desc[:, k]
    assert clean.sum() >= 4
    np.testing.assert_array_equal(idx.numpy()[clean], np.asarray(jidx)[clean])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    tied = np.diff(vals.numpy(), axis=1) == 0
    assert (np.diff(idx.numpy(), axis=1)[tied] > 0).all()
    if k == 100:
        v20, i20 = topk(torch.from_numpy(scores), 20)
        clean20 = desc[:, 19] != desc[:, 20]
        np.testing.assert_array_equal(i20.numpy()[clean20], idx.numpy()[clean20, :20])
