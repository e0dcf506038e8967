"""DSSM, IPSBPR and PDA: the port against the JAX package on ml-100k.

Both packages build the same split (numpy seed 42, each model's config),
the port holding the JAX model's initial weights (DSSM's towers through
``ranker_params_from_jax``, the debias models' two tables through
``params_from_jax``), and both take the same numpy negative ids (each
model's ``sampling`` replaced on the instance). Checks:

- DSSM's query tower (the five user fields of ml-100k, fused into one
  token table) and item tower (the item id alone) on the batch, to 1e-5
  relative + 1e-6, with dropout off (the port's dropout masks are its own
  Philox draws);
- one training step of each: the loss to 1e-5 relative, each gradient to
  ``TOL_GRAD`` (1e-4 of its largest magnitude + 1e-3 relative), after
  ``zero_pad_rows_in_grads``; PDA's loss reads the sampled ids
  (``forward(return_neg_id=True)``), IPSBPR's the clipped inverse
  propensities, held to the JAX package's;
- the row-sparse step's gate stays shut for IPSBPR and PDA (it computes
  plain BPR); a multi-field DSSM item tower raises, and DSSM's evaluation
  reads the user's fields.
"""
import copy

import numpy as np
import pytest
import torch

SPLIT_SEED = 42
NEG_SEED = 17
ROWS = 128
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
    build = get_model("DSSM")[1]["data"]
    assert build == get_model("IPSBPR")[1]["data"] == get_model("PDA")[1]["data"]
    np.random.seed(SPLIT_SEED)
    ours = TripletDataset("ml-100k").build(**build)
    np.random.seed(SPLIT_SEED)
    theirs = JaxTripletDataset("ml-100k").build(**build)
    return ours, theirs


def _models(splits, name):
    """The JAX and the port's ``name`` (DSSM with dropout off), the port
    holding the JAX model's initial weights, and the training splits they
    were built on (DSSM's copies of them, since it puts every field in use)."""
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax, ranker_params_from_jax
    ours, theirs = (split[0] for split in splits)
    if name == "DSSM":
        ours, theirs = copy.copy(ours), copy.copy(theirs)
    jcls, jconf = jax_get_model(name)
    cls, conf = get_model(name)
    if name == "DSSM":
        jconf["model"]["dropout"] = conf["model"]["dropout"] = 0.0
    jmodel = jcls(jconf)
    jmodel._init_model(theirs)
    jmodel._init_parameter(theirs)
    jmodel.val_check = False
    model = cls(conf, device="cpu")
    model._init_model(ours)
    model._init_parameter(ours)
    tree = jax.tree_util.tree_map(np.asarray, jmodel.params)
    model.load_state_dict(ranker_params_from_jax(tree, model.net) if name == "DSSM"
                          else params_from_jax(tree))
    return jmodel, model, ours, theirs


@pytest.fixture(scope="module")
def dssm(splits):
    return _models(splits, "DSSM")


def _batch(trn):
    n = len(trn.data_index)
    trn.eval_mode = False
    return trn._get_pos_batch(np.arange(0, n, n // ROWS)[:ROWS])


def test_dssm_fields_and_towers_match_jax(splits, dssm):
    import jax
    import jax.numpy as jnp
    jmodel, model, trn, jtrn = dssm
    assert model.query_fields == jmodel.query_fields == \
        {"user_id", "age", "gender", "occupation", "zip_code"}
    assert model.item_fields == jmodel.item_fields == {"item_id"}
    assert type(model.net.query_encoder.embedding.token_embedding).__name__ == "Embedding"
    batch = _batch(trn)
    assert set(batch) >= model.query_fields
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jtrn).items()}
    for k in batch:
        np.testing.assert_array_equal(batch[k], np.asarray(jbatch[k]), err_msg=k)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        jq = jmodel._apply(jmodel.params, "encode_query", jmodel._get_query_feat(jbatch))
        ji = jmodel._apply(jmodel.params, "encode_item", jbatch["item_id"])
    with torch.no_grad():
        q = model.net.encode_query(model._get_query_feat(tb))
        i = model.net.encode_item(tb["item_id"])
    assert q.shape == (ROWS, 128) == i.shape
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def _inject_negatives(jmodel, model, shape, num_items):
    import jax.numpy as jnp
    neg = np.random.default_rng(NEG_SEED).integers(1, num_items, size=shape)
    zeros = np.zeros(shape, np.float32)
    jmodel.sampling = lambda *a, **k: (None, jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (None, torch.from_numpy(neg), torch.from_numpy(zeros))


def _grad_tree(name, model):
    from recstudio_torch.utils.convert import params_to_jax, ranker_params_to_jax
    grads = {k: p.grad for k, p in model.net.named_parameters()}
    return ranker_params_to_jax(grads, model.net) if name == "DSSM" else params_to_jax(grads)


@pytest.mark.parametrize("name", ["DSSM", "IPSBPR", "PDA"])
def test_training_step_matches_jax(splits, dssm, name):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    jmodel, model, trn, _ = dssm if name == "DSSM" else _models(splits, name)
    batch = _batch(trn)
    _inject_negatives(jmodel, model, (ROWS, model.neg_count), trn.num_items)
    try:
        with jax.default_matmul_precision("float32"):
            (jloss, _), jgrads = jax.value_and_grad(jmodel._loss_and_aux, has_aux=True)(
                jmodel.params, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0), jmodel.states)
        model.net.train()
        model.net.zero_grad(set_to_none=True)
        loss = model.training_step({k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        zero_pad_rows_in_grads(model.net)
    finally:
        model.net.eval()
        del model.sampling, jmodel.sampling
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = _grad_tree(name, model)
    leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                        jax_zero_pad(jgrads)))
    assert len(leaves) == len(list(model.net.parameters()))
    for path, want in leaves:
        node = grads
        for k in path:
            node = node[k.key]
        assert float(np.abs(want).max()) > 0.0, str(path)
        np.testing.assert_allclose(node, want, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(want).max()), err_msg=str(path))
    if name == "IPSBPR":
        np.testing.assert_allclose(model._ips_weight.numpy(), np.asarray(jmodel._ips_weight))
        assert float(model._ips_weight.max()) <= 100.0
    if name == "PDA":
        np.testing.assert_allclose(model._pop_weight.numpy(), np.asarray(jmodel._pop_weight))


@pytest.mark.parametrize("name", ["IPSBPR", "PDA"])
def test_debias_models_keep_the_dense_step(splits, name):
    """Under ``sparse_adam`` the row-sparse step would train plain BPR: its
    gate stays shut, and the lazy-Adam step runs the model's own loss."""
    from recstudio_torch.utils import get_model
    cls, conf = get_model(name)
    conf["train"]["learner"] = "sparse_adam"
    model = cls(conf, device="cpu")
    model._init_model(splits[0][0])
    assert model._sparse_rows_enabled() is False


def test_forward_returns_the_negative_ids_when_asked(splits):
    _, model, trn, _ = _models(splits, "PDA")
    batch = {k: torch.from_numpy(v) for k, v in _batch(trn).items()}
    torch.manual_seed(0)
    out = model.forward(batch, return_neg_id=True)
    assert out["neg_id"].shape == (ROWS, 1) and int(out["neg_id"].min()) >= 1
    assert "neg_id" not in model.forward(batch)


def test_multi_field_dssm_item_tower_raises(splits):
    """An item tower over several fields needs the catalog's feature table
    on the device, which is not ported: it raises."""
    from types import SimpleNamespace
    from recstudio_torch.utils import get_model
    cls, conf = get_model("DSSM")
    model = cls(conf, device="cpu")
    model.fiid = "item_id"
    fake = SimpleNamespace(item_feat=SimpleNamespace(fields=["item_id", "release_year"]),
                           use_field={"item_id", "release_year", "user_id"})
    with pytest.raises(NotImplementedError, match="multi-field DSSM item tower"):
        model._get_item_encoder(fake)


def test_dssm_evaluation_reads_the_user_fields(splits, dssm):
    import jax
    jmodel, model, _, _ = dssm
    tst, jtst = splits[0][2], splits[1][2]
    with jax.default_matmul_precision("float32"):
        want = jmodel.evaluate(jtst, verbose=False)
    got = model.evaluate(tst, verbose=False)
    assert "age" in tst.use_field
    for key in ("ndcg@10", "recall@20", "hit@50"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-5, atol=1e-6, err_msg=key)
