"""The CTR field embeddings, the FM term and the prediction metrics against
the JAX package.

- ``Embeddings`` (one and several token fields, one and several float
  fields), ``LinearLayer`` and ``FMLayer``:
  the same numpy weights in both packages (``ranker_params_from_jax``),
  the same batch with repeated ids and [PAD] ids; the outputs agree to
  1e-5 absolute + 1e-5 relative, and the gradients of a random linear
  function of them to 1e-4 of each gradient's largest magnitude + 1e-3
  relative (``chip_smoke``'s ``grad_errors`` tolerance). The fused table's
  gradient is the sum of each id's cotangents, exactly the JAX
  ``_fused_gather`` backward's.
- ``auc``, ``logloss``, ``mse``, ``mae`` and ``accuracy`` on the same
  float32 inputs: ties, all-positive and all-negative splits, weight-0
  padded rows. AUC agrees to 1e-6, the per-row metrics to 1e-6 relative.
- ``BCEWithLogitLoss`` to 1e-6 relative.
"""
import numpy as np
import pytest
import torch

TOL_OUT = (1e-5, 1e-5)     # (atol, rtol) of logits and embeddings
TOL_GRAD = (1e-4, 1e-3)    # (atol as a share of max |g|, rtol)
B = 64


def _specs(n_token, n_float, vocabs=(50, 7, 300, 3, 12)):
    specs = [(f"t{i}", "token", vocabs[i]) for i in range(n_token)]
    specs += [(f"f{i}", "float", 1) for i in range(n_float)]
    return tuple(sorted(specs))


def _batch(specs, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, t, n in specs:
        if t == "token":
            ids = rng.integers(0, n, B).astype(np.int32)
            ids[:3] = 0                       # [PAD] rows
            ids[3:6] = ids[6]                 # repeated ids
            out[name] = ids
        else:
            out[name] = rng.normal(0.0, 1.5, B).astype(np.float32)
    return out


def _jax_params(module, batch, seed=1):
    """The module's JAX parameter tree with every leaf redrawn from numpy."""
    import jax
    import jax.numpy as jnp
    params = module.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0.0, 0.3, x.shape), jnp.float32), params["params"])


def _assert_grad(got, want, tag):
    np.testing.assert_allclose(got, want, rtol=TOL_GRAD[1],
                               atol=TOL_GRAD[0] * max(float(np.abs(want).max()), 1e-30),
                               err_msg=tag)


def _compare(jmodule, tmodule, batch, embed_dim):
    """Forward and gradients of ``sum(out * ct)`` in both packages."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    params = _jax_params(jmodule, batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(p):
        return jmodule.apply({"params": p}, jbatch)

    want = np.asarray(jfn(params))
    ct = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        jgrads = jax.grad(lambda p: jnp.sum(jfn(p) * ct))(params)
    tmodule.load_state_dict(ranker_params_from_jax(params, embed_dim))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tmodule(tbatch)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL_OUT[0], rtol=TOL_OUT[1])
    (out * torch.from_numpy(ct)).sum().backward()
    got = ranker_params_to_jax({n: p.grad for n, p in tmodule.named_parameters()})
    flat_want = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrads)))
    flat_got = dict(_flat(got))
    assert sorted(flat_got) == sorted(flat_want)
    for key, g in flat_want.items():
        _assert_grad(flat_got[key], g, "/".join(key))
    return flat_got


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


CASES = {"1tok-1float": (1, 1), "3tok-1float": (3, 1), "1tok-3float": (1, 3),
         "5tok-3float": (5, 3), "2tok": (2, 0), "2float": (0, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_embeddings_match_jax(case):
    from recstudio_tpu.models.module.ctr import Embeddings as JaxEmbeddings
    from recstudio_torch.models.module.ctr import Embeddings
    specs = _specs(*CASES[case])
    D = 6
    grads = _compare(JaxEmbeddings(specs, D), Embeddings(specs, D), _batch(specs), D)
    names = {"/".join(k) for k in grads}
    n_token = CASES[case][0]
    if n_token > 1:
        assert "token_embedding" in names
    elif n_token == 1:
        assert f"{specs[[s[1] for s in specs].index('token')][0]}_embedding" in names
    if CASES[case][1] > 1:
        assert "dense_embedding" in names


def test_fused_table_gradient_sums_each_ids_cotangents():
    """Two fields, repeated ids: the table's gradient row of an id is the
    sum of the cotangents of every lookup of it, in its field's slab."""
    from recstudio_torch.models.module.ctr import Embeddings
    specs = (("a", "token", 4), ("b", "token", 3))
    emb = Embeddings(specs, 2)
    batch = {"a": torch.tensor([1, 1, 3]), "b": torch.tensor([2, 0, 2])}
    ct = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    (emb(batch) * ct).sum().backward()
    want = torch.zeros(7, 2)
    for r in range(3):
        want[int(batch["a"][r])] += ct[r, 0]
        want[4 + int(batch["b"][r])] += ct[r, 1]
    assert torch.equal(emb.token_embedding.weight.grad, want)


def test_linear_and_fm_layers_match_jax():
    from recstudio_tpu.models.module.ctr import FMLayer as JaxFMLayer
    from recstudio_tpu.models.module.ctr import LinearLayer as JaxLinearLayer
    from recstudio_torch.models.module.ctr import FMLayer, LinearLayer
    specs = _specs(4, 2)
    _compare(JaxLinearLayer(specs), LinearLayer(specs), _batch(specs), 1)
    x = np.random.default_rng(4).normal(size=(B, 5, 8)).astype(np.float32)
    for red in (None, "sum"):
        want = np.asarray(JaxFMLayer(red).apply({}, x))
        got = FMLayer(red)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=TOL_OUT[0], rtol=TOL_OUT[1])


def test_token_seq_fields_raise():
    from recstudio_torch.models.module.ctr import Embeddings
    with pytest.raises(NotImplementedError, match="token_seq"):
        Embeddings((("genres", "token_seq", 10), ("u", "token", 5)), 4)


def test_dense_embedding_init_zeroes_row_0_as_jax():
    """The JAX rule by name re-initialises every ``*embedding*`` leaf, the
    float kernel ``dense_embedding`` too, with row 0 set to 0; its gradient
    row 0 is kept (it is the first float field's, not a [PAD] row)."""
    from recstudio_torch.models.init import init_parameters, zero_pad_rows_in_grads
    from recstudio_torch.models.module.ctr import Embeddings
    emb = Embeddings(_specs(3, 3), 5)
    init_parameters(emb, torch.Generator().manual_seed(0))
    dense, table = emb.dense_embedding.detach(), emb.token_embedding.weight.detach()
    assert float(dense[0].abs().max()) == 0.0 and float(dense[1:].abs().min()) > 0.0
    assert float(table[0].abs().max()) == 0.0
    emb(_as_torch(_batch(_specs(3, 3)))).sum().backward()
    zero_pad_rows_in_grads(emb)
    assert float(emb.dense_embedding.grad[0].abs().max()) > 0.0
    assert float(emb.token_embedding.weight.grad[0].abs().max()) == 0.0


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# prediction metrics
# ---------------------------------------------------------------------------
def _metric_cases():
    rng = np.random.default_rng(7)
    n = 500
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    ties = np.round(scores * 2) / 2                       # heavy ties
    weights = np.ones(n, np.float32)
    weights[-37:] = 0.0                                   # padded rows
    return {
        "plain": (scores, labels, None),
        "ties": (ties.astype(np.float32), labels, None),
        "ties-padded": (ties.astype(np.float32), labels, weights),
        "all-tied": (np.zeros(n, np.float32), labels, weights),
        "all-positive": (scores, np.ones(n, np.float32), weights),
        "all-negative": (scores, np.zeros(n, np.float32), weights),
        "fractional-weights": (ties.astype(np.float32), labels,
                               rng.random(n).astype(np.float32)),
    }


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_auc_matches_jax(case):
    import jax.numpy as jnp
    from recstudio_tpu import eval as jeval
    from recstudio_torch import eval as teval
    scores, labels, weights = _metric_cases()[case]
    want = float(jeval.auc(jnp.asarray(scores), jnp.asarray(labels),
                           None if weights is None else jnp.asarray(weights)))
    got = teval.auc(torch.from_numpy(scores), torch.from_numpy(labels),
                    None if weights is None else torch.from_numpy(weights))
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)
    if case in ("all-positive", "all-negative"):
        assert float(got) == 0.0
    if case == "all-tied":
        assert float(got) == 0.5


def test_auc_padded_rows_drop_out_exactly():
    """Rows of weight 0 change nothing, whatever their scores and labels."""
    from recstudio_torch import eval as teval
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    y = torch.from_numpy((rng.random(300) < 0.4).astype(np.float32))
    pad_s = torch.cat([s, torch.full((50,), 9.0)])
    pad_y = torch.cat([y, torch.ones(50)])
    w = torch.cat([torch.ones(300), torch.zeros(50)])
    assert float(teval.auc(pad_s, pad_y, w)) == float(teval.auc(s, y))


@pytest.mark.parametrize("name", ["logloss", "mse", "mae", "accuracy"])
def test_pred_metrics_match_jax(name):
    import jax.numpy as jnp
    from recstudio_tpu import eval as jeval
    from recstudio_torch import eval as teval
    scores, labels, _ = _metric_cases()["ties"]
    scores = np.concatenate([scores, [40.0, -40.0, 0.0]]).astype(np.float32)
    labels = np.concatenate([labels, [0.0, 1.0, 1.0]]).astype(np.float32)
    args = (1 / (1 + np.exp(-scores))).astype(np.float32) if name != "logloss" else scores
    want = np.asarray(getattr(jeval, name)(jnp.asarray(args), jnp.asarray(labels)))
    got = getattr(teval, name)(torch.from_numpy(args), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_metric_families_match_jax():
    from recstudio_tpu import eval as jeval
    from recstudio_torch import eval as teval
    names = ["auc", "logloss", "mse", "mae", "accuracy", "ndcg", "recall"]
    for fam in ("get_pred_metrics", "get_global_metrics", "get_rank_metrics"):
        assert [m for m, _ in getattr(teval, fam)(names)] == \
            [m for m, _ in getattr(jeval, fam)(names)], fam
    for cut in (None, [5, 10]):
        assert teval.get_eval_metrics(names, cut) == jeval.get_eval_metrics(names, cut)
        assert teval.get_eval_metrics(names, cut, True) == jeval.get_eval_metrics(names, cut, True)


def test_bce_with_logit_loss_matches_jax():
    import jax.numpy as jnp
    from recstudio_tpu.models.loss_func import BCEWithLogitLoss as JaxBCE
    from recstudio_torch.models.loss_func import BCEWithLogitLoss
    scores, labels, _ = _metric_cases()["plain"]
    for red in ("mean", "none"):
        want = np.asarray(JaxBCE(red)(jnp.asarray(labels), jnp.asarray(scores)))
        got = BCEWithLogitLoss(red)(torch.from_numpy(labels), torch.from_numpy(scores)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
