"""PMF, CML, NCF and LogisticMF, and the retriever's sampler machinery,
against the JAX package on ml-100k.

- One training step: both packages hold the JAX model's initial weights
  (``params_from_jax``, NCF's fusion scorer's too) and take the same numpy
  negatives (each model's ``sampling`` replaced on the instance): the loss
  to rtol 1e-5, the gradients, after ``zero_pad_rows_in_grads``, to rtol
  1e-3 and 1e-4 of each gradient's largest magnitude (``chip_smoke``'s
  ``grad_errors``). CML trains on ``ALSDataset`` rows (a user's items
  ``[B, W]``), PMF on ratings with no sampler.
- A one-epoch ``quickstart.run`` of each on the CPU: finite loss and
  metrics; LogisticMF's ``adagrad``.
- The retriever: every ``train.sampler`` builds, an unknown one raises;
  each training epoch re-indexes a stateful sampler into
  ``states["sampler"]``, bit for bit again from the same generator state;
  a checkpoint carries ``states``; composition from parts (the counterpart
  of ``tests/test_compositional.py``); the row-sparse gate takes the
  popularity sampler.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

SPLIT_SEED = 42
NEG_SEED = 17
ROWS = 128
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol): chip_smoke.grad_errors


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


def _models(name):
    """The JAX and the port's ``name`` at the repo's config on the same
    ml-100k split, the port holding the JAX model's initial weights."""
    import jax
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import params_from_jax
    jcls, jconf = jax_get_model(name)
    cls, conf = get_model(name)
    np.random.seed(SPLIT_SEED)
    theirs = jcls._get_dataset_class()("ml-100k").build(**jconf["data"])
    np.random.seed(SPLIT_SEED)
    ours = cls._get_dataset_class()("ml-100k").build(**conf["data"])
    jmodel = jcls(jconf)
    jmodel._init_model(theirs[0])
    jmodel._init_parameter(theirs[0])
    jmodel.val_check = False
    model = cls(conf, device="cpu")
    model._init_model(ours[0])
    model._init_parameter(ours[0])
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params)))
    return jmodel, model, ours, theirs


def _inject_negatives(jmodel, model, shape, num_items):
    import jax.numpy as jnp
    neg = np.random.default_rng(NEG_SEED).integers(1, num_items, size=shape)
    zeros = np.zeros(shape, np.float32)
    jmodel.sampling = lambda *a, **k: (None, jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (None, torch.from_numpy(neg), torch.from_numpy(zeros))


@pytest.mark.parametrize("name", ["PMF", "CML", "NCF", "LogisticMF"])
def test_training_step_matches_jax(name):
    import jax
    import jax.numpy as jnp
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_torch.models.init import zero_pad_rows_in_grads
    from recstudio_torch.utils.convert import params_to_jax
    jmodel, model, ours, _ = _models(name)
    trn = ours[0]
    n = len(trn.data_index)
    idx = np.arange(0, n, max(n // ROWS, 1))[:ROWS]
    trn.eval_mode = False
    batch = trn._get_pos_batch(idx)
    if model.sampler is not None:
        _inject_negatives(jmodel, model, (len(idx), model.neg_count), trn.num_items)
    else:
        assert name == "PMF" and jmodel.sampler is None
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
    grads = params_to_jax({k: p.grad for k, p in model.net.named_parameters()})
    want_leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(want_leaves) == len(list(model.net.parameters()))
    for path, want in want_leaves:
        node = grads
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, want, rtol=TOL_GRAD[1],
                                   atol=TOL_GRAD[0] * float(np.abs(want).max()), err_msg=str(path))


@pytest.mark.parametrize("name", ["PMF", "CML", "NCF", "LogisticMF"])
def test_one_epoch_quickstart_fit(name):
    from recstudio_torch.quickstart import run
    with tempfile.TemporaryDirectory() as tmp:
        model, _, result = run(name, "ml-100k", verbose=False, device="cpu",
                                    model_config={"train": {"epochs": 1},
                                                  "eval": {"save_path": tmp}})
    assert len(model.epoch_log) == 1 and np.isfinite(model.epoch_log[0]["train_loss"])
    assert np.isfinite(result["ndcg@10"]) and 0.0 <= result["ndcg@10"] <= 1.0
    if name == "LogisticMF":
        from recstudio_torch.models.optim import OptaxAdagrad
        assert isinstance(model.optimizer, OptaxAdagrad)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bpr_split():
    from recstudio_torch.data import TripletDataset
    np.random.seed(SPLIT_SEED)
    return TripletDataset("ml-100k").build(split_ratio=[0.8, 0.1, 0.1])


def _bpr(trn, **train):
    from recstudio_torch.utils import get_model
    cls, conf = get_model("BPR")
    conf["train"].update(train)
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    return model


@pytest.mark.parametrize("name", ["uniform", "masked_uniform", "pop", "midx-uni", "midx-pop",
                                  "cluster-uni", "cluster-pop", "lsh"])
def test_every_sampler_name_builds(bpr_split, name):
    from recstudio_torch.ann import sampler as S
    model = _bpr(bpr_split[0], sampler=name, sampler_num_clusters=8)
    want = {"uniform": S.UniformSampler, "masked_uniform": S.MaskedUniformSampler,
            "pop": S.PopularSamplerModel, "midx-uni": S.MIDXSamplerUniform,
            "midx-pop": S.MIDXSamplerPop, "cluster-uni": S.ClusterSamplerUniform,
            "cluster-pop": S.ClusterSamplerPop, "lsh": S.LSHSampler}[name]
    assert type(model.sampler) is want
    model._epoch_refresh(0)
    stateful = name not in ("uniform", "masked_uniform")
    assert ("sampler" in model.states) is stateful
    batch = {k: torch.from_numpy(v) for k, v in bpr_split[0]._get_pos_batch(np.arange(64)).items()}
    batch["user_hist"] = torch.from_numpy(bpr_split[0].user_hist[batch["user_id"].numpy()])
    loss = model.training_step(batch)
    assert torch.isfinite(loss)


def test_unknown_sampler_raises_and_lsh_defaults(bpr_split):
    with pytest.raises(ValueError, match="unknown train.sampler"):
        _bpr(bpr_split[0], sampler="ivf")
    lsh = _bpr(bpr_split[0], sampler="lsh").sampler
    assert (lsh.n_bits, lsh.n_table) == (4, 8)            # _get_sampler's, not the class's 16


def test_epoch_refresh_reindexes_and_repeats_bitwise(bpr_split):
    model = _bpr(bpr_split[0], sampler="midx-pop", sampler_num_clusters=8)
    state = model.device_generator.get_state()
    model._epoch_refresh(0)
    first = {k: v.clone() for k, v in model.states["sampler"].items()}
    model.device_generator.set_state(state)
    model._epoch_refresh(0)
    assert all(torch.equal(first[k], v) for k, v in model.states["sampler"].items())
    with torch.no_grad():
        model.item_encoder.weight.mul_(1.5)
    model._epoch_refresh(1)
    assert not torch.equal(first["wkk"], model.states["sampler"]["wkk"]) or \
        not torch.equal(first["c0"], model.states["sampler"]["c0"])
    # inference refreshes the catalog and leaves the sampler's index alone
    again = {k: v.clone() for k, v in model.states["sampler"].items()}
    model._epoch_refresh(-1)
    assert all(torch.equal(again[k], v) for k, v in model.states["sampler"].items())


def test_stateless_models_skip_the_training_refresh(bpr_split):
    model = _bpr(bpr_split[0])
    model._epoch_refresh(0)
    assert "item_vector" not in model.states and "sampler" not in model.states
    mined = _bpr(bpr_split[0], sampling_method="dns", negative_count=[10, 2])
    mined._epoch_refresh(0)
    assert mined.states["item_vector"].shape == (bpr_split[0].num_items - 1, 64)


def test_checkpoint_carries_states(bpr_split):
    model = _bpr(bpr_split[0], sampler="cluster-pop", sampler_num_clusters=8)
    model.optimizer = model._get_optimizer()
    model._epoch_refresh(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        model.save_checkpoint(path, epoch=0)
        other = _bpr(bpr_split[0], sampler="cluster-pop", sampler_num_clusters=8)
        other.load_checkpoint(path)
    assert sorted(other.states) == sorted(model.states)
    for k, v in model.states["sampler"].items():
        assert torch.equal(other.states["sampler"][k], v), k
    assert torch.equal(other.states["item_vector"], model.states["item_vector"])


def test_row_sparse_gate_takes_the_popularity_sampler(bpr_split):
    model = _bpr(bpr_split[0], sampler="pop", learner="sparse_adam")
    assert model._sparse_rows_enabled()
    assert not _bpr(bpr_split[0], sampler="midx-uni", learner="sparse_adam")._sparse_rows_enabled()


def test_compositional_retriever(bpr_split):
    """A retriever assembled from parts given to the constructor (the port's
    ``tests/test_compositional.py``): an item tower, a cosine scorer, the
    binary cross-entropy and the popularity sampler. As in the JAX test,
    only the metrics are held finite: the popularity proposal gives
    ``[PAD]`` a weight of 1, and the cosine of its zero row is 0 / 0, so
    the training loss is NaN in both packages."""
    from recstudio_torch.ann.sampler import PopularSamplerModel
    from recstudio_torch.data import TripletDataset
    from recstudio_torch.models.basemodel import BaseRetriever
    from recstudio_torch.models.loss_func import BinaryCrossEntropyLoss
    from recstudio_torch.models.module import Embedding
    from recstudio_torch.models.scorer import CosineScorer
    from recstudio_torch.utils import get_base_model_config

    class UserTowerRetriever(BaseRetriever):
        @staticmethod
        def _get_dataset_class():
            return TripletDataset

        def _get_query_encoder(self, train_data):
            return Embedding(train_data.num_users, self.embed_dim)

    trn, val, tst = bpr_split
    conf = get_base_model_config()
    conf["train"].update(epochs=2, batch_size=512, negative_count=2)
    conf["eval"].update(batch_size=64, cutoff=[5], val_metrics=["ndcg"],
                        test_metrics=["ndcg", "recall"], topk=20)
    with tempfile.TemporaryDirectory() as tmp:
        conf["eval"]["save_path"] = tmp
        scorer, loss, sampler = CosineScorer(), BinaryCrossEntropyLoss(), \
            PopularSamplerModel(trn.item_freq)
        model = UserTowerRetriever(conf, device="cpu",
                                   item_encoder=Embedding(trn.num_items, conf["model"]["embed_dim"]),
                                   scorer=scorer, loss=loss, sampler=sampler)
        model.fit(trn, val)
        res = model.evaluate(tst, verbose=False)
    assert model.score_func is scorer and model.loss_fn is loss and model.sampler is sampler
    assert np.isfinite(res["ndcg@5"]) and res["recall@5"] >= 0
    assert len(model.epoch_log) == 2


SAMPLER_LAYER_MODULES = ("recstudio_torch.ann.sampler", "recstudio_torch.ops.kmeans",
                         "recstudio_torch.data.advance_dataset", "recstudio_torch.models.scorer",
                         "recstudio_torch.models.loss_func", "recstudio_torch.models.mf.pmf",
                         "recstudio_torch.models.mf.cml", "recstudio_torch.models.mf.ncf",
                         "recstudio_torch.models.mf.logisticmf")


def test_sampler_layer_modules_import_with_jax_blocked():
    """The sampler layer's and the four models' modules import where jax,
    flax, optax, pandas and yaml cannot, and load nothing of
    recstudio_tpu."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {SAMPLER_LAYER_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from recstudio_torch.utils import get_model\n"
        "assert [get_model(n)[0].__name__ for n in ('PMF', 'CML', 'NCF', 'LogisticMF')] == "
        "['PMF', 'CML', 'NCF', 'LogisticMF']\n"
        "assert not [m for m in sys.modules if m.startswith('recstudio_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", ["PMF", "CML", "NCF", "LogisticMF"])
def test_mf_models_need_cuda_unless_cpu_is_asked(monkeypatch, name):
    from recstudio_torch.utils import get_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls, conf = get_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(conf)
    assert cls(conf, device="cpu").device == torch.device("cpu")


def test_retriever_sampler_draws_from_a_frozen_proposal(bpr_split):
    """A trained retriever as another model's proposal
    (``RetrieverSampler``): its state is a frozen snapshot
    (``make_sampling_state``), and the draws' log probabilities are the
    snapshot's catalog log-softmax at the drawn ids, unchanged when the
    proposal's own weights move afterwards."""
    from recstudio_torch.ann.sampler import RetrieverSampler
    trn = bpr_split[0]
    proposal = _bpr(trn)
    model = _bpr(trn, negative_count=4)
    model.sampler = RetrieverSampler(trn.num_items, retriever=proposal, method="brute")
    model._epoch_refresh(0)
    snap = model.states["sampler"]
    with torch.no_grad():
        proposal.item_encoder.weight.mul_(3.0)             # the snapshot must not move
    batch = {k: torch.from_numpy(v) for k, v in trn._get_pos_batch(np.arange(32)).items()}
    q = model.net.encode_query(batch["user_id"]).detach()
    lpp, neg, lnp = model.sampling(batch, 4, q)
    pq = snap["net"].encode_query(batch["user_id"])
    want = torch.log_softmax(pq @ snap["item_vector"].t(), -1).gather(1, neg - 1)
    np.testing.assert_allclose(lnp.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert neg.shape == (32, 4) and lpp.shape == (32,)
    assert torch.isfinite(model.training_step(batch))
