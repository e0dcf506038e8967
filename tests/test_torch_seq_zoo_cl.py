"""CL4SRec, CoSeRec and ICLRec: the port against the JAX package on the CPU.

Both packages build each model on ml-100k as a ``SeqToSeqDataset`` at d 16,
F 32, one layer, L 10, dropout 0, holding the same perturbed weights
(``test_torch_seq_zoo_models.zoo_pair``); the same negatives (one a
position) replace both samplers and the same two augmented views (the
JAX package's own crop and mask of the batch) replace both models' views.
The JAX layers run K1 and K2 in interpret mode, as the JAX package's own
tests run them; the port's plain layer runs here. ICLRec's intent centres
are the same seeded ``[8, d]`` array in both (48 rows: some share an
intent). Tolerances as ``test_torch_seq_zoo_models.py``: the encoder rtol
1e-4 / atol 1e-5, one step's loss rtol 1e-5 and each gradient 1e-5 of its
largest magnitude + rtol 1e-4, three Adam steps atol 2e-6, the served
lists' scores rtol 1e-4 / atol 1e-5 with ids up to ties; the similar-item
tables and the augmented views exactly.
"""
import numpy as np
import pytest
import torch

from test_torch_seq_zoo_models import (CL_MODELS, D, L, ROWS, TOL_ENCODE, check_adam_steps,
                                       check_encoder, check_init_spreads, check_quickstart_fit,
                                       check_round_trip, check_serving, check_training_step,
                                       inject_negatives, train_batch, zoo_pair)

N_INTENTS, CENTRE_SEED = 8, 23


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


def inject_views(jmodel, model, batch):
    """The JAX package's crop and mask views of ``batch`` as both models'
    two views: the JAX model's augmentation returns them in turn."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.module.data_augmentation import item_crop, item_mask
    seq, seqlen = jnp.asarray(batch["in_item_id"]), jnp.asarray(batch["seqlen"])
    views = [tuple(np.array(a) for a in item_crop(jax.random.PRNGKey(1), seq, seqlen, 0.5)),
             tuple(np.array(a) for a in item_mask(jax.random.PRNGKey(2), seq, seqlen,
                                                  mask_id=model.mask_id))]
    turn = iter(range(10 ** 6))

    def jax_view(*args):
        return tuple(jnp.asarray(a) for a in views[next(turn) % 2])
    if type(model).__name__ == "CoSeRec":
        jmodel._augment_view = jax_view
    else:
        jmodel._augment = jax_view
    model._views = lambda b: tuple(tuple(torch.from_numpy(a) for a in v) for v in views)
    return views


_PAIRS = {}


def get_pair(name):
    """``name``'s JAX and port models, built once in this process."""
    if name not in _PAIRS:
        _PAIRS[name] = _build_pair(name)
    return _PAIRS[name]


@pytest.fixture(scope="module", params=CL_MODELS)
def pair(request):
    return get_pair(request.param)


def _build_pair(name):
    import jax.numpy as jnp
    jmodel, model, jtst, trn, tst, tree, init = zoo_pair(name)
    inject_negatives(jmodel, model, (ROWS, L), trn.num_items)
    batch = train_batch(trn)
    inject_views(jmodel, model, batch)
    if name == "ICLRec":
        centres = np.random.default_rng(CENTRE_SEED).normal(size=(N_INTENTS, D))
        jmodel.states["intent_centroids"] = jnp.asarray(centres.astype(np.float32))
        model.states["intent_centroids"] = torch.from_numpy(centres.astype(np.float32))
    if name == "CoSeRec":
        jmodel.states["top1_sim"] = jnp.arange(trn.num_items, dtype=jnp.int32)
    return name, jmodel, model, jtst, trn, tst, tree, init, batch


def test_model_parts(pair):
    from recstudio_torch.data import SeqToSeqDataset
    from recstudio_torch.models.basemodel.baseretriever import SharedItemTowerNet
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    name, _, model, _, trn, _, _, _, batch = pair
    assert isinstance(trn, SeqToSeqDataset) and type(model.net) is SharedItemTowerNet
    assert isinstance(model.loss_fn, BinaryCrossEntropyLoss) and model.neg_count == 1
    assert model.mask_id == trn.num_items
    assert model.query_encoder.item_encoder.weight.shape == (trn.num_items + 1, D)
    assert model._compute_item_vector().shape == (trn.num_items - 1, D)
    assert batch["item_id"].shape == (ROWS, L)
    layer = model.query_encoder.transformer.layers[0]
    assert layer.layer_norm_eps == (1e-5 if name == "ICLRec" else 1e-12)


def test_encoder_matches_jax(pair):
    _, jmodel, model, _, _, _, _, _, batch = pair
    check_encoder(jmodel, model, batch, D)


def test_training_step_matches_jax(pair):
    """SASRec's BCE over every position, the views' InfoNCE and, for ICLRec,
    the intent InfoNCE, against the JAX step (its K1 and K2 interpreted)."""
    _, jmodel, model, _, _, _, _, _, batch = pair
    check_training_step(jmodel, model, batch)


def test_three_adam_steps_match_jax(pair):
    from recstudio_torch.utils.convert import params_from_jax
    _, jmodel, model, _, _, _, tree, _, batch = pair
    try:
        check_adam_steps(jmodel, model, batch)
    finally:
        model.load_state_dict(params_from_jax(tree))
        if type(model).__name__ == "ICLRec":         # load_state_dict clears the states
            centres = np.random.default_rng(CENTRE_SEED).normal(size=(N_INTENTS, D))
            model.states["intent_centroids"] = torch.from_numpy(centres.astype(np.float32))


def test_served_topk_matches_jax(pair):
    _, jmodel, model, jtst, _, tst, _, _, _ = pair
    check_serving(jmodel, model, jtst, tst)


def test_params_round_trip(pair):
    _, _, model, _, _, _, tree, _, _ = pair
    check_round_trip(model, tree)


def test_initial_weight_spreads_match_jax(pair):
    name, _, _, _, _, _, _, init, _ = pair
    check_init_spreads(name, init)


def test_intent_encode_is_the_eval_encode_and_keeps_training_mode():
    """ICLRec's intent encode inside a training step: dropout off (equal to
    the evaluation encode, pooled at the last position) with the net left
    in training mode; the intent loss with several rows of one intent."""
    _, _, model, _, _, _, _, _, batch = get_pair("ICLRec")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.config["model"]["dropout_rate"] = 0.5
    for layer in model.query_encoder.transformer.layers:
        layer.dropout = 0.5
    model.query_encoder.dropout = 0.5
    try:
        model.net.train()
        got = model._encode_eval(tb["in_item_id"], tb["seqlen"])
        assert model.net.training
        model.net.eval()
        with torch.no_grad():
            want = model.net.encode_query({"in_item_id": tb["in_item_id"],
                                           "seqlen": tb["seqlen"]})
        assert torch.equal(got, want) and got.shape == (ROWS, D)
        centres = model.states["intent_centroids"]
        ids = torch.argmin(torch.cdist(got, centres), dim=-1)
        assert len(torch.unique(ids)) < ROWS
    finally:
        for layer in model.query_encoder.transformer.layers:
            layer.dropout = 0.0
        model.query_encoder.dropout = 0.0
        model.net.eval()


def test_iclrec_refresh_clusters_every_training_window():
    """``_epoch_refresh`` before a training epoch: the centres of the eval
    encodes of every training window (JAX's encode of them to TOL_ENCODE),
    the net's mode kept; an evaluation refresh leaves them."""
    import jax
    import jax.numpy as jnp
    _, jmodel, model, _, trn, _, _, _, _ = get_pair("ICLRec")
    before = model.states["intent_centroids"]
    model.config["train"]["batch_size"] = 256
    model._setup_scan_epoch(trn)
    rows = torch.arange(model._epoch_rows)
    windows = model._batch_fn(model._epoch_arrays, rows)
    reps = model._encode_eval(windows["in_item_id"], windows["seqlen"])
    with jax.default_matmul_precision("float32"):
        want = jmodel._encode_mean(jmodel.params, jnp.asarray(windows["in_item_id"].numpy()),
                                   jnp.asarray(windows["seqlen"].numpy()), None,
                                   training=False)
    np.testing.assert_allclose(reps.numpy(), np.asarray(want), **TOL_ENCODE)
    model.config["model"]["num_intent_clusters"] = N_INTENTS
    try:
        model._epoch_refresh(-1)
        assert model.states["intent_centroids"] is before
        model.net.train()
        model._epoch_refresh(0)
        assert model.net.training
        centres = model.states["intent_centroids"]
        assert centres.shape == (N_INTENTS, D) and torch.isfinite(centres).all()
        assert not torch.equal(centres, before)
    finally:
        model.net.eval()
        model.config["model"]["num_intent_clusters"] = 256
        model.states["intent_centroids"] = before


def test_coserec_similar_item_tables_match_jax():
    """The offline co-occurrence table (numpy on the host) and the online
    one from the current weights, equal to the JAX package's."""
    import jax
    _, jmodel, model, _, trn, _, _, _, _ = get_pair("CoSeRec")
    want = np.asarray(jmodel._offline_top1)
    got = model._offline_top1.numpy()
    assert got.shape == (trn.num_items,) and got[0] == 0
    np.testing.assert_array_equal(got, want)
    assert (got[1:] != np.arange(1, trn.num_items)).mean() > 0.5
    states = {}
    jmodel_states, jmodel.states = jmodel.states, states
    try:
        jmodel.config["model"]["augmentation_warm_up_epochs"] = 0
        with jax.default_matmul_precision("float32"):
            jax_refresh = type(jmodel)._epoch_refresh
            jax_refresh(jmodel, 0)
        online = np.asarray(states["top1_sim"])
    finally:
        jmodel.states = jmodel_states
        jmodel.config["model"]["augmentation_warm_up_epochs"] = 5
    np.testing.assert_array_equal(model._online_top1().numpy(), online)
    model.states.pop("top1_sim", None)
    model._epoch_refresh(4)
    assert torch.equal(model.states["top1_sim"], model._offline_top1)
    model._epoch_refresh(5)
    np.testing.assert_array_equal(model.states["top1_sim"].numpy(), online)


def test_coserec_view_matches_jax_on_jax_draws():
    """A CoSeRec view (each row's choice among five, short rows among two)
    bit for bit the JAX package's ``_augment_view`` on its own draws."""
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.seq.coserec import CoSeRec as JaxCoSeRec
    from recstudio_torch.models.seq.coserec import view_map
    _, jmodel, model, _, _, _, _, _, batch = get_pair("CoSeRec")
    mc = model.config["model"]
    top1 = np.asarray(jmodel._offline_top1)
    seq, seqlen = batch["in_item_id"], batch["seqlen"]
    B = seq.shape[0]
    for s in range(4):
        rng = jax.random.PRNGKey(100 + s)
        want = JaxCoSeRec._augment_view(jmodel, rng, jnp.asarray(seq), jnp.asarray(seqlen),
                                        jnp.asarray(top1))
        k1, k2, k3, k4, k5, k6 = jax.random.split(rng, 6)
        u = lambda k, shape: torch.from_numpy(np.array(jax.random.uniform(k, shape)))
        draws = {"insert": u(k1, seq.shape), "substitute": u(k2, seq.shape),
                 "crop": u(k3, (B,)), "mask": u(k4, seq.shape), "reorder": u(k5, (B,)),
                 "reorder_noise": u(jax.random.fold_in(k5, 1), seq.shape),
                 "short": torch.from_numpy(np.asarray(jax.random.randint(k6, (B,), 0, 2))),
                 "long": torch.from_numpy(np.asarray(
                     jax.random.randint(jax.random.fold_in(k6, 1), (B,), 0, 5)))}
        got = view_map(torch.from_numpy(seq), torch.from_numpy(seqlen), torch.from_numpy(top1),
                       draws, mc["insert_rate"], mc["substitute_rate"], model.mask_id,
                       mc["augment_threshold"])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", CL_MODELS)
def test_quickstart_fit_on_the_cpu(name, tmp_path):
    """An epoch of ``quickstart.run`` at the config's batch (256: four steps
    on ml-100k), with the model's own views, negatives and refresh."""
    model = check_quickstart_fit(name, tmp_path)
    assert model.max_seq_len == L
