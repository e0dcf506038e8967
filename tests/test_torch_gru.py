"""The GRU, feedforward attention and MLP layers, and GRU4Rec: the port
against the JAX package on the CPU.

GRU4Rec's model-level checks are those of NARM and STAMP
(``test_torch_narm_stamp.py``, whose helpers and tolerances they use), with
the same seeded negatives injected into both packages' samplers.

Inputs are seeded numpy; weights are the JAX modules' own initial weights
with seeded noise added to every leaf (so every bias is nonzero and a wrong
mapping shows), loaded into the port with ``params_from_jax``. Tolerances,
float32 on both sides with sums in other orders:

- layers (outputs, and the gradients of ``sum(out * c)`` for a seeded
  cotangent ``c``): atol 2e-5, rtol 1e-4 (``TOL_LAYER``);
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOL_LAYER = dict(rtol=1e-4, atol=2e-5)
B, L, D, H = 6, 12, 16, 24


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread in each test: these shapes gain nothing from
    more, and torch's spinning worker threads slow every other test process
    that shares the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def perturbed(tree, seed, scale=0.05):
    """``tree`` (a JAX-layout dict of arrays) plus seeded N(0, scale) noise
    on every leaf; embedding tables keep a zero ``[PAD]`` row."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in sorted(node.items())}
        a = np.asarray(node, np.float32)
        a = (a + rng.normal(0.0, scale, a.shape)).astype(np.float32)
        if name == "embedding":
            a[0] = 0.0
        return a
    return walk(tree)


def leaves(a, b, path=""):
    """Pairs of leaves of two trees with the same keys."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _port_module(module, jax_params, name):
    """``module`` holding ``jax_params`` (the JAX sub-module ``name``'s tree)."""
    from recstudio_torch.utils.convert import params_from_jax
    sd = params_from_jax({"query_encoder": {name: jax_params}})
    prefix = f"query_encoder.{name}."
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return module


def _grad_tree(module, name):
    from recstudio_torch.utils.convert import params_to_jax
    grads = {f"query_encoder.{name}.{n}": p.grad for n, p in module.named_parameters()}
    return params_to_jax(grads)["query_encoder"][name]


def _jax_and_port(jax_module, port_module, name, inputs, seed, port_fn=None, **call):
    """Outputs, input gradients and parameter gradients of ``sum(out * c)``
    on both sides, for JAX and port modules of the same function
    (``port_fn`` calls the port module, by default with ``call``)."""
    import jax
    import jax.numpy as jnp
    params = jax_module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs), **call)
    params = perturbed(params["params"], seed)
    _port_module(port_module, params, name)
    out_shape = jax_module.apply({"params": params}, *map(jnp.asarray, inputs), **call).shape
    cot = np.random.default_rng(seed + 1).normal(size=out_shape).astype(np.float32)

    def f(p, *xs):
        return (jax_module.apply({"params": p}, *xs, **call) * cot).sum()

    with jax.default_matmul_precision("float32"):
        jout = np.asarray(jax_module.apply({"params": params}, *map(jnp.asarray, inputs), **call))
        jgrads = jax.grad(f, argnums=tuple(range(len(inputs) + 1)))(
            params, *map(jnp.asarray, inputs))
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = port_fn(*xs) if port_fn else port_module(*xs, **call)
    (out * torch.from_numpy(cot)).sum().backward()
    return (out.detach().numpy(), jout, [x.grad.numpy() for x in xs],
            [np.asarray(g) for g in jgrads[1:]], _grad_tree(port_module, name),
            jax.tree_util.tree_map(np.asarray, jgrads[0]))


def _assert_pair(got, tol=TOL_LAYER):
    out, jout, gx, jgx, gp, jgp = got
    np.testing.assert_allclose(out, jout, err_msg="output", **tol)
    for i, (a, b) in enumerate(zip(gx, jgx)):
        np.testing.assert_allclose(a, b, err_msg=f"input gradient {i}", **tol)
    for path, a, b in leaves(gp, jgp):
        np.testing.assert_allclose(a, b, err_msg=path, **tol)


# ---------------------------------------------------------------------------
ACTS = ["relu", "sigmoid", "tanh", "leakyrelu", "leaky_relu", "identity", "none", "gelu",
        "elu", "softmax", "softplus", "prelu"]


@pytest.mark.parametrize("name", ACTS)
def test_get_act_matches_jax(name):
    import jax.numpy as jnp
    from recstudio_tpu.models.module.layers import get_act as jax_get_act
    from recstudio_torch.models.module import get_act
    x = (np.random.default_rng(0).normal(size=(5, 7)) * 4).astype(np.float32)
    want = np.asarray(jax_get_act(name)(jnp.asarray(x)))
    got = get_act(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_get_act_refuses_dice_and_unknown_names():
    """``dice`` needs its width (a ``Dice`` module a layer, ported with
    ``SimpleBatchNorm``); unknown names raise."""
    from recstudio_torch.models.module import MLPModule, get_act
    from recstudio_torch.models.module.layers import Dice, SimpleBatchNorm
    with pytest.raises(ValueError, match="dimension"):
        get_act("dice")
    assert isinstance(get_act("dice", 4), Dice)
    assert isinstance(MLPModule([4, 4], batch_norm=True).bn_0, SimpleBatchNorm)
    with pytest.raises(ValueError):
        get_act("swishy")
    assert get_act(None)(torch.ones(2)).tolist() == [1.0, 1.0]


@pytest.mark.parametrize("last_activation", [True, False])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_mlp_module_matches_jax(act, last_activation):
    from recstudio_tpu.models.module.layers import MLPModule as JaxMLP
    from recstudio_torch.models.module import MLPModule
    sizes = [D, 20, 12]
    x = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    got = _jax_and_port(JaxMLP(sizes, activation_func=act, last_activation=last_activation),
                        MLPModule(sizes, act, last_activation=last_activation), "mlp", [x], 3)
    _assert_pair(got)


def _sequence(seed, lens=(L, 7, 1, 3, L, 5)):
    """``[B, L, D]`` inputs and the right-padding mask of rows of ``lens``
    (one full row, one of length 1)."""
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    pad = np.arange(L)[None, :] >= np.asarray(lens)[:, None]
    return x, pad


@pytest.mark.parametrize("num_layer", [1, 2])
def test_gru_layer_matches_jax(num_layer):
    from recstudio_tpu.models.module.layers import GRULayer as JaxGRULayer
    from recstudio_torch.models.module import GRULayer
    x, _ = _sequence(4)
    got = _jax_and_port(JaxGRULayer(D, H, num_layer), GRULayer(D, H, num_layer), "gru", [x], 5)
    assert got[0].shape == (B, L, H)
    _assert_pair(got)


@pytest.mark.parametrize("num_layer", [1, 2])
def test_gru_layer_plain_matches_gru_layer(num_layer):
    """The plain time loop against the port's ``GRULayer`` on the CPU
    (PyTorch's own GRU), outputs and every gradient."""
    from recstudio_torch.models.module import GRULayer
    torch.manual_seed(0)
    layer = GRULayer(D, H, num_layer)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2)
    x0, _ = _sequence(6)
    cot = torch.from_numpy(np.random.default_rng(7).normal(size=(B, L, H)).astype(np.float32))
    res = []
    for plain in (False, True):
        layer.plain = plain
        layer.zero_grad()
        x = torch.from_numpy(x0).requires_grad_()
        out = layer(x)
        (out * cot).sum().backward()
        res.append([out.detach(), x.grad] + [p.grad.clone() for p in layer.parameters()])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, **TOL_LAYER)


def test_gru_layer_dropout_between_layers():
    """Dropout after each layer in training mode draws one seed a layer from
    the generator; eval mode and rate 0 leave the output as it is."""
    from recstudio_torch.models.module import GRULayer
    layer = GRULayer(D, H, 2, dropout=0.5)
    x = torch.from_numpy(_sequence(8)[0])
    with torch.no_grad():
        want = layer.eval()(x)
        gen = torch.Generator().manual_seed(3)
        state = gen.get_state()
        a = layer.train()(x, gen)
        gen.set_state(state)
        b = layer(x, gen)
    assert torch.equal(a, b) and not torch.equal(a, want)
    assert 0.3 < float((a == 0).float().mean()) < 0.7
    assert not torch.equal(gen.get_state(), state)


ATTENTION = {
    # NARM's: q_dim = k_dim, no MLP bias, mlp_out's bias
    "narm": dict(q_dim=H, mlp_layers=[H], bias=False, q=H, k=H, softmax=False),
    # STAMP's: k_dim != q_dim, biases
    "stamp": dict(q_dim=2 * D, k_dim=D, mlp_layers=[D], bias=True, q=2 * D, k=D, softmax=False),
    "softmax": dict(q_dim=D, mlp_layers=[D, 8], bias=True, q=D, k=D, softmax=True),
    "dot": dict(q_dim=D, attention_type="scaled-dot-product", q=D, k=D, softmax=True),
}


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_layer_matches_jax(case):
    """Padded keys weighted 0 (``softmax=False``) or -inf before the softmax;
    every row keeps at least one key, one row exactly one."""
    from recstudio_tpu.models.module.layers import AttentionLayer as JaxAttention
    from recstudio_torch.models.module import AttentionLayer
    conf = dict(ATTENTION[case])
    dq, dk, softmax = conf.pop("q"), conf.pop("k"), conf.pop("softmax")
    rng = np.random.default_rng(9)
    query = rng.normal(size=(B, 1, dq)).astype(np.float32)
    key = rng.normal(size=(B, L, dk)).astype(np.float32)
    _, pad = _sequence(10)
    jax_mod = JaxAttention(**conf)
    port = AttentionLayer(**conf)
    import jax
    import jax.numpy as jnp
    if conf.get("attention_type") == "scaled-dot-product":   # no parameters
        def f(q, k, v):
            return jax_mod.apply({}, q, k, v, key_padding_mask=jnp.asarray(pad),
                                 softmax=softmax)
        cot = rng.normal(size=(B, 1, dk)).astype(np.float32)
        want = np.asarray(f(query, key, key))
        jg = jax.grad(lambda *a: (f(*a) * cot).sum(), argnums=(0, 1, 2))(query, key, key)
        xs = [torch.from_numpy(a).requires_grad_() for a in (query, key, key.copy())]
        out = port(*xs, key_padding_mask=torch.from_numpy(pad), softmax=softmax)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want, **TOL_LAYER)
        for x, g in zip(xs, jg):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **TOL_LAYER)
        return

    class JaxWrapped:                       # the key is the value, as NARM and STAMP pass it
        def init(self, rng_key, q, k):
            return jax_mod.init(rng_key, q, k, k, key_padding_mask=jnp.asarray(pad),
                                softmax=softmax)

        def apply(self, variables, q, k):
            return jax_mod.apply(variables, q, k, k, key_padding_mask=jnp.asarray(pad),
                                 softmax=softmax)

    got = _jax_and_port(JaxWrapped(), port, "attn", [query, key], 11,
                        port_fn=lambda q, k: port(q, k, k, key_padding_mask=torch.from_numpy(pad),
                                                  softmax=softmax))
    _assert_pair(got)
    jgp = got[5]
    assert set(jgp) == {"mlp", "mlp_out"} and "bias" in jgp["mlp_out"]
    assert ("bias" in jgp["mlp"]["dense_0"]) == conf["bias"]


def test_multi_head_attention_is_not_ported():
    """``multi-head`` is ported (a ``MultiHeadAttention``, held to the JAX
    module in ``test_torch_rankers_bn_autoint.py``); an unknown type
    raises."""
    from recstudio_torch.models.module import AttentionLayer
    from recstudio_torch.models.module.layers import MultiHeadAttention
    assert isinstance(AttentionLayer(D, attention_type="multi-head").attn, MultiHeadAttention)
    with pytest.raises(ValueError, match="attention_type"):
        AttentionLayer(D, attention_type="additive")


# ---------------------------------------------------------------------------
# GRU4Rec
NEG_SEED = 13


@pytest.fixture(scope="module")
def gru4rec_pair(tmp_path_factory):
    import jax.numpy as jnp
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    from test_torch_narm_stamp import ROWS, model_pair
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        jmodel, model, jtst, trn, tst, tree = model_pair("GRU4Rec")
    neg = np.random.default_rng(NEG_SEED).integers(1, trn.num_items, size=(ROWS, 1))
    zeros = np.zeros((ROWS, 1), np.float32)
    jmodel.sampling = lambda *a, **k: (jnp.zeros(ROWS), jnp.asarray(neg), jnp.asarray(zeros))
    model.sampling = lambda *a, **k: (torch.zeros(ROWS), torch.from_numpy(neg),
                                      torch.from_numpy(zeros))
    return jmodel, model, jtst, trn, tst, tree


def test_gru4rec_model_shape(gru4rec_pair):
    from recstudio_torch.ann.sampler import UniformSampler
    from recstudio_torch.models.basemodel.baseretriever import SharedItemTowerNet
    from recstudio_torch.models.loss_func import BPRLoss
    _, model, _, _, _, _ = gru4rec_pair
    assert type(model.net) is SharedItemTowerNet and isinstance(model.loss_fn, BPRLoss)
    assert isinstance(model.sampler, UniformSampler) and model.neg_count == 1
    assert not model._use_fused_softmax()
    assert sorted(n for n, _ in model.net.named_parameters()) == [
        "query_encoder.gru.layers.0.bias_hh_l0", "query_encoder.gru.layers.0.bias_ih_l0",
        "query_encoder.gru.layers.0.weight_hh_l0", "query_encoder.gru.layers.0.weight_ih_l0",
        "query_encoder.item_encoder.weight", "query_encoder.proj.bias",
        "query_encoder.proj.weight"]


def test_gru4rec_encoder_matches_jax(gru4rec_pair):
    from test_torch_narm_stamp import check_encoder, train_batch
    jmodel, model, _, trn, _, _ = gru4rec_pair
    check_encoder(jmodel, model, train_batch(trn))


def test_gru4rec_training_step_matches_jax(gru4rec_pair):
    from test_torch_narm_stamp import check_training_step, train_batch
    jmodel, model, _, trn, _, _ = gru4rec_pair
    check_training_step(jmodel, model, train_batch(trn))


def test_gru4rec_three_adam_steps_match_jax(gru4rec_pair):
    from recstudio_torch.utils.convert import params_from_jax
    from test_torch_narm_stamp import check_adam_steps, train_batch
    jmodel, model, _, trn, _, tree = gru4rec_pair
    try:
        check_adam_steps(jmodel, model, train_batch(trn))
    finally:
        model.load_state_dict(params_from_jax(tree))


def test_gru4rec_served_topk_matches_jax(gru4rec_pair):
    from test_torch_narm_stamp import check_serving
    jmodel, model, jtst, _, tst, _ = gru4rec_pair
    check_serving(jmodel, model, jtst, tst)


def test_gru4rec_params_round_trip(gru4rec_pair):
    from test_torch_narm_stamp import check_round_trip
    _, model, _, _, _, tree = gru4rec_pair
    check_round_trip(model, tree)


def test_gru4rec_quickstart_fit_on_the_cpu(tmp_path):
    from test_torch_narm_stamp import check_quickstart_fit
    check_quickstart_fit("GRU4Rec", tmp_path)
