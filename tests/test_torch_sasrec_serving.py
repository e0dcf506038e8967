"""SASRec top-k serving: the port against the JAX package on ml-100k.

Both packages build SASRec at the repo's ml-100k config and load the same
seeded numpy weights (``utils/convert.py``). Query encodings, catalog
scores and served top-20 lists must agree: float32 on both sides, so
values to rtol 1e-4 / atol 1e-5 and ids up to ties within 1e-5.

``sasrec_ml100k_reference.json`` holds the JAX package's served lists for
the first 64 test users; ``chip_smoke.py`` holds the card to it. Rewrite it
with ``JAX_PLATFORMS=cpu python tests/test_torch_sasrec_serving.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recstudio_tpu import eval as jax_eval
from recstudio_tpu.serving import Predictor as JaxPredictor
from recstudio_tpu.utils import get_model as jax_get_model

from recstudio_torch import eval as torch_eval
from recstudio_torch.serving import Predictor
from recstudio_torch.utils import get_model
from recstudio_torch.utils.convert import params_from_jax, random_sasrec_params
from recstudio_torch.utils.parity import topk_mismatches

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "recstudio_torch", "assets", "sasrec_ml100k_reference.json")
SEED = 2022


@pytest.fixture(scope="module", autouse=True)
def _jax_native_csv(tmp_path_factory):
    """The JAX datasets of this file go through the JAX package's native CSV
    path, whose token order the port follows."""
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        yield
N_REF, K = 64, 20
RTOL, ATOL, TIE_TOL = 1e-4, 1e-5, 1e-5


def _jax_model():
    cls, conf = jax_get_model("SASRec")
    ds = cls._get_dataset_class()("ml-100k")
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf)
    model._init_model(trn)
    model._init_parameter(trn)
    mc = conf["model"]
    tree = random_sasrec_params(SEED, ds.num_items, conf["model"]["embed_dim"],
                                ds.config["max_seq_len"], mc["hidden_size"], mc["layer_num"])
    model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return model, tst, tree


def _request(split, n, offset=0):
    batch = next(iter(split.eval_loader(offset + n)))
    return {f: batch[f][offset:offset + n] for f in ("in_item_id", "seqlen", "user_id")}


def jax_reference():
    """The JAX package's served top-K for the first N_REF test users (CPU, f32)."""
    model, tst, _ = _jax_model()
    with jax.default_matmul_precision("float32"):
        scores, ids = JaxPredictor(model, max_batch=N_REF, k=K, train_data=tst)(
            _request(tst, N_REF))
    return {"about": "recstudio_tpu SASRec served top-k on ml-100k, CPU float32, "
                     "weights random_sasrec_params(seed); rows = first test users",
            "seed": SEED, "k": K, "user_ids": tst.data_index[:N_REF, 0].tolist(),
            "item_ids": np.asarray(ids).tolist(),
            "scores": [[float(s) for s in row] for row in np.asarray(scores)]}


@pytest.fixture(scope="module")
def pair():
    jmodel, jtst, tree = _jax_model()
    cls, conf = get_model("SASRec")
    ds = cls._get_dataset_class()("ml-100k")
    trn, _, tst = ds.build(**conf["data"])
    model = cls(conf, device="cpu")
    model._init_model(trn)
    model._init_parameter(trn)
    model.load_state_dict(params_from_jax(tree))
    return model, tst, jmodel, jtst


def test_query_fields(pair):
    model, _, jmodel, _ = pair
    assert model.query_fields == jmodel.query_fields == {"in_item_id", "seqlen", "user_id"}


def test_query_encodings_and_catalog_scores(pair):
    model, tst, jmodel, _ = pair
    req = _request(tst, 128)
    with jax.default_matmul_precision("float32"):
        jq = jmodel._apply(jmodel.params, "encode_query",
                           {k: jnp.asarray(v) for k, v in req.items()})
        jitems = jmodel._compute_item_vector(jmodel.params)
        jscores = jq @ jitems.T
    with torch.no_grad():
        q = model.net.encode_query({k: torch.from_numpy(v) for k, v in req.items()})
        items = model._compute_item_vector()
        scores = model.score_func.catalog(q, items)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(items.numpy(), np.asarray(jitems))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=RTOL, atol=ATOL)


def test_served_topk_matches_jax(pair):
    model, tst, jmodel, jtst = pair
    pred = Predictor(model, max_batch=128, k=K, train_data=tst)
    with jax.default_matmul_precision("float32"):
        jpred = JaxPredictor(jmodel, max_batch=128, k=K, train_data=jtst)
        for offset in (0, 128, 896):
            req = _request(tst, 128 if offset < 896 else 47, offset)
            s, i = pred(req)
            js, ji = jpred(req)
            np.testing.assert_allclose(s, np.asarray(js), rtol=RTOL, atol=ATOL)
            assert topk_mismatches(i, s, np.asarray(ji), np.asarray(js), TIE_TOL) == 0


def test_reference_file_is_current():
    with open(REFERENCE) as f:
        committed = json.load(f)
    fresh = jax_reference()
    assert committed["user_ids"] == fresh["user_ids"]
    assert (committed["seed"], committed["k"]) == (fresh["seed"], fresh["k"])
    np.testing.assert_allclose(committed["scores"], fresh["scores"], rtol=0, atol=1e-6)
    assert topk_mismatches(np.asarray(committed["item_ids"]), committed["scores"],
                           np.asarray(fresh["item_ids"]), fresh["scores"], 1e-6) == 0


def test_port_serves_the_reference(pair):
    model, tst, _, _ = pair
    with open(REFERENCE) as f:
        ref = json.load(f)
    s, i = Predictor(model, max_batch=N_REF, k=K, train_data=tst)(_request(tst, N_REF))
    np.testing.assert_allclose(s, ref["scores"], rtol=RTOL, atol=ATOL)
    assert topk_mismatches(i, s, np.asarray(ref["item_ids"]), ref["scores"], TIE_TOL) == 0


def test_warm_works_for_sasrec(pair):
    """The port's warm-up builds its dummy from the query fields; the JAX
    Predictor builds it from the user id alone and SASRec rejects it."""
    model, tst, jmodel, jtst = pair
    pred = Predictor(model, max_batch=16, k=K, train_data=tst)
    assert pred.warm() is pred
    assert sorted(pred._dummy()) == ["in_item_id", "seqlen", "user_id"]
    assert pred._dummy()["in_item_id"].shape == (16, 20)
    with pytest.raises(KeyError, match="in_item_id"):
        JaxPredictor(jmodel, max_batch=16, k=K, train_data=jtst).warm()


class _UserTowerRetriever:
    """A retriever whose query tower embeds the user id alone: its encoder
    has no ``max_seq_len``."""

    def __init__(self, num_users=10, num_items=30, dim=8):
        gen = torch.Generator().manual_seed(0)
        self.query_encoder = torch.nn.Embedding(num_users, dim)
        self.items = torch.randn(num_items, dim, generator=gen)
        self.query_fields = {"user_id"}
        self.fuid = "user_id"
        self.device = torch.device("cpu")

    def _epoch_refresh(self, nepoch):
        pass

    def topk(self, batch, k, user_hist=None):
        with torch.no_grad():
            scores = self.query_encoder(batch["user_id"].long()) @ self.items.T
        return torch.topk(scores, k)


def test_warm_works_for_a_non_sequence_query_tower():
    """The dummy request reads the sequence length only for a sequence
    field (``in_*``): a user-id tower warms up without one."""
    pred = Predictor(_UserTowerRetriever(), max_batch=4, k=5)
    assert not hasattr(pred.model.query_encoder, "max_seq_len")
    assert pred.warm() is pred
    dummy = pred._dummy()
    assert sorted(dummy) == ["user_id"] and dummy["user_id"].shape == (4,)
    scores, ids = pred({"user_id": np.array([1, 3], np.int32)})
    assert scores.shape == ids.shape == (2, 5)


def test_padding_is_exact(pair):
    """A request's rows come out the same alone (padded to max_batch) as
    inside a full request."""
    model, tst, _, _ = pair
    pred = Predictor(model, max_batch=64, k=K, train_data=tst)
    full_s, full_i = pred(_request(tst, 64))
    part_s, part_i = pred(_request(tst, 5, offset=10))
    assert part_s.shape == (5, K)
    np.testing.assert_array_equal(part_s, full_s[10:15])
    np.testing.assert_array_equal(part_i, full_i[10:15])
    with pytest.raises(ValueError, match="max_batch"):
        pred(_request(tst, 65))


def test_history_is_never_served(pair):
    model, tst, _, _ = pair
    pred = Predictor(model, max_batch=128, k=100, train_data=tst)
    for batch in tst.eval_loader(128):
        n = int(batch["_size"])
        _, ids = pred({f: batch[f][:n] for f in ("in_item_id", "seqlen", "user_id")})
        hist = tst.user_hist[batch["user_id"][:n]]
        assert not (ids[:, :, None] == hist[:, None, :]).any()
    unmasked = Predictor(model, max_batch=128, k=100, train_data=tst, exclude_history=False)
    _, ids = unmasked(_request(tst, 128))
    hist = tst.user_hist[tst.data_index[:128, 0]]
    assert ((ids[:, :, None] == hist[:, None, :]) & (hist[:, None, :] > 0)).any()


def test_mask_hist_scores_drops_pad_entries(pair):
    model = pair[0]
    scores = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    hist = torch.tensor([[1, 0, 6], [0, 0, 0]], dtype=torch.int32)
    out = model._mask_hist_scores(scores, hist)
    assert torch.isinf(out[0, [0, 5]]).all() and torch.isfinite(out[0, 1:5]).all()
    assert torch.equal(out[1], scores[1])


def test_catalog_scoring_is_explicit():
    """A batch as large as the catalog still gets a [B, N] catalog score,
    where the JAX scorer's shape test (``_is_catalog``) reads it pairwise."""
    from recstudio_torch.models.scorer import InnerProductScorer
    q, items = torch.randn(5, 8), torch.randn(5, 8)
    assert InnerProductScorer().catalog(q, items).shape == (5, 5)
    assert InnerProductScorer()(q, items).shape == (5,)


@pytest.mark.parametrize("name", ["recall", "precision", "map", "ndcg", "mrr", "hit"])
def test_rank_metrics_match_jax(pair, name):
    model, tst, _, _ = pair
    pred = Predictor(model, max_batch=128, k=K, train_data=tst)
    batch = next(iter(tst.eval_loader(128)))
    _, ids = pred({f: batch[f] for f in ("in_item_id", "seqlen", "user_id")})
    target = batch["item_id"][:, None]
    # a few hits so the metrics are not all zero
    hit_rows = np.arange(0, 128, 3)
    ids[hit_rows, hit_rows % K] = target[hit_rows, 0]
    rating = batch["rating"][:, None]
    hit = torch_eval.hit_matrix(torch.from_numpy(ids), torch.from_numpy(target))
    jhit = jnp.any((jnp.asarray(ids)[:, :, None] == jnp.asarray(target)[:, None, :])
                   & (jnp.asarray(target)[:, None, :] > 0), axis=-1)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    for cutoff in (5, 10, 20):
        got = torch_eval.metric_dict[name](hit, torch.from_numpy(rating), cutoff)
        want = jax_eval.metric_dict[name](jhit, jnp.asarray(rating), cutoff)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_predict_matches_predictor(pair):
    model, tst, _, _ = pair
    req = _request(tst, 32)
    req["user_hist"] = tst.user_hist[req["user_id"]]
    s, i = model.predict(req, K)
    ps, pi = Predictor(model, max_batch=32, k=K, train_data=tst)(
        {k: v for k, v in req.items() if k != "user_hist"})
    np.testing.assert_array_equal(s, ps)
    np.testing.assert_array_equal(i, pi)


if __name__ == "__main__":
    import tempfile
    from test_torch_jax_csv import jax_native_csv
    os.makedirs(os.path.dirname(REFERENCE), exist_ok=True)
    with jax_native_csv(tempfile.mkdtemp()), open(REFERENCE, "w") as f:
        json.dump(jax_reference(), f)
        f.write("\n")
    print(f"wrote {REFERENCE}")
