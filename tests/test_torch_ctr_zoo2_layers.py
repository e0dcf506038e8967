"""The layers of the rest of the CTR ranker zoo (DeepIM, EDCN, SAM, AOANet,
DESTINE, FinalMLP, FiGNN, CCPM, FGCNN): the port against the JAX package.

- Each flax module against the port's on the same numpy inputs and
  weights (``test_torch_ctr_layers.check_layer``: the output to 1e-5
  absolute + 1e-5 relative, the gradients of ``sum(out * g)`` with respect
  to the inputs and every weight to 1e-5 of their largest + 1e-4
  relative): ``GRUCell`` with the state first (input and state widths
  apart, so swapped arguments cannot pass), every ``BridgeLayer`` type,
  ``RegulationLayer``, DeepIM's ``InteractionMachine`` at orders 2 to 5,
  every SAM ``interaction_type``, AOANet's fusion (the port contracts
  ``alpha`` with ``bi`` first) at its first layer and a later one,
  ``DisentangledSelfAttention`` with and without relus (the biases its
  softmax over the fields and its whitening remove are held as float32
  noise), FinalMLP's
  bilinear fusion, ``FGCNNLayer`` at 9 fields (pools of 2 leave a row
  over, heights 3 and 2).
- FiGNN's edge weights from two ``[B, F]`` projections against the JAX
  module's own ``[B, F^2, 2D]`` concatenation, and ``FieldConv`` at an odd
  and an even height against ``jax.lax.conv_general_dilated`` (SAME,
  NHWC/HWIO), outputs and gradients to the same tolerances; CCPM's k-max
  pooling against ``jax.lax.top_k`` over planted ties, values, order and
  gradients exactly.
- The initial spreads of the raw parameters (``check_spreads``): AOANet's
  and SAM's ``W`` (a kernel to the JAX rule by name, ``w``), FinalMLP's
  ``bilinear``, FiGNN's ``W_out``/``W_in``, EDCN's ``cross_w``, CCPM's and
  FGCNN's convolutions.
"""
import numpy as np
import pytest
import torch

from test_torch_ctr_layers import TOL_GRAD, TOL_OUT, _assert_close, check_layer

B, F, D = 8, 5, 4


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _regulation_pair():
    """``RegulationLayer``'s two outputs side by side, in both packages."""
    import flax.linen as fnn
    import jax.numpy as jnp
    from recstudio_tpu.models.fm import edcn as j
    from recstudio_torch.models.fm import edcn as t

    class JaxPair(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jnp.concatenate(j.RegulationLayer(F, D, 0.7, name="reg")(x), -1)

    class PortPair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.reg = t.RegulationLayer(F, D, 0.7)

        def forward(self, x):
            return torch.cat(self.reg(x), dim=-1)
    return JaxPair, PortPair


def _cases():
    """id -> (JAX module factory, port module factory, input shapes)."""
    from recstudio_tpu.models.fm import (aoanet as ja, deepim as jd, destine as jde, edcn as je,
                                         fgcnn as jf, finalmlp as jfm, sam as js)
    from recstudio_tpu.models.module.layers import GRUCell as JaxGRUCell
    from recstudio_torch.models.fm import (aoanet as ta, deepim as td, destine as tde,
                                           edcn as te, fgcnn as tf, finalmlp as tfm, sam as ts)
    from recstudio_torch.models.module.layers import GRUCell
    W = F * D
    cases = {
        "gru_cell": (lambda: JaxGRUCell(D), lambda: GRUCell(D + 3, D), [(B, D), (B, D + 3)]),
        "regulation": (*(lambda c: (lambda: c[0](), lambda: c[1]()))(_regulation_pair()),
                       [(B, W)]),
        "fgcnn_layer": (lambda: jf.FGCNNLayer(9, D, (3, 2), (3, 2), (2, 2), (2, 1)),
                        lambda: tf.FGCNNLayer(9, D, (3, 2), (3, 2), (2, 2), (2, 1)),
                        [(B, 9, D)]),
        "aoanet_first": (lambda: ja.GeneralizedInteractionFusion(F, D, F, 3),
                         lambda: ta.GeneralizedInteractionFusion(F, D, F, 3),
                         [(B, F, D), (B, F, D)]),
        "aoanet_later": (lambda: ja.GeneralizedInteractionFusion(F, D, 3, 2),
                         lambda: ta.GeneralizedInteractionFusion(F, D, 3, 2),
                         [(B, F, D), (B, 3, D)]),
        "destine": (lambda: jde.DisentangledSelfAttention(6, 8, 2),
                    lambda: tde.DisentangledSelfAttention(6, 8, 2), [(B, F, 6)]),
        "destine_relu": (lambda: jde.DisentangledSelfAttention(6, 6, 1, relu_before_att=True),
                         lambda: tde.DisentangledSelfAttention(6, 6, 1, relu_before_att=True),
                         [(B, F, 6)]),
        "bilinear_fusion": (lambda: jfm.MultiHeadBilinearFusion(2, 6, 8),
                            lambda: tfm.MultiHeadBilinearFusion(2, 6, 8), [(B, 6), (B, 8)]),
    }
    for bt in ("pointwise_addition", "hadamard_product", "concatenation", "attention_pooling"):
        cases[f"bridge_{bt}"] = (lambda bt=bt: je.BridgeLayer(W, bt),
                                 lambda bt=bt: te.BridgeLayer(W, bt), [(B, W), (B, W)])
    for order in (2, 3, 4, 5):
        cases[f"interaction_machine_{order}"] = (
            lambda o=order: jd.InteractionMachine(D, o), lambda o=order: td.InteractionMachine(D, o),
            [(B, F, D)])
    for it in ("sam1", "sam2a", "sam2e", "sam3a", "sam3e"):
        cases[f"sam_{it}"] = (lambda it=it: js.SAMInteraction(it, D, F),
                              lambda it=it: ts.SAMInteraction(it, D, F), [(B, F, D)])
    return cases


# DESTINE: the unary softmax over the fields removes its logits' bias, the
# whitening (q and k minus their means over the fields) q's and k's
ZERO_GRADIENTS = {"destine": ("unary/bias", "Wq/bias", "Wk/bias"),
                  "destine_relu": ("unary/bias",)}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_layer_matches_flax_module(case):
    jax_make, port_make, shapes = _cases()[case]
    check_layer(case, jax_make, port_make, shapes, TOL_OUT, 100 + sorted(_cases()).index(case),
                ZERO_GRADIENTS.get(case, ()))


def test_fignn_edge_weights_match_the_concatenated_form():
    """``FiGNNNet.graph`` (two ``[B, F]`` projections) against
    ``fignn.py:30-36`` (``edge_w`` over ``[repeat(e), tile(e)]``, leaky
    relu, row softmax, the diagonal zeroed)."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.models.fm.fignn import FiGNNNet
    rng = np.random.default_rng(7)
    nf, d = 6, 4
    emb = rng.normal(size=(B, nf, d)).astype(np.float32)
    kernel = rng.normal(0.0, 0.5, (2 * d, 1)).astype(np.float32)
    g = rng.normal(size=(B, nf, nf)).astype(np.float32)

    def jax_form(e, k):
        e_i = jnp.repeat(e, nf, axis=1)
        e_j = jnp.tile(e, (1, nf, 1))
        w = (jnp.concatenate([e_i, e_j], -1) @ k).squeeze(-1)
        w = jax.nn.softmax(jax.nn.leaky_relu(w).reshape(e.shape[0], nf, nf), axis=-1)
        return w * (1.0 - jnp.eye(nf))

    with jax.default_matmul_precision("float32"):
        want = jax_form(jnp.asarray(emb), jnp.asarray(kernel))
        jde, jdk = jax.grad(lambda e, k: (jax_form(e, k) * g).sum(), argnums=(0, 1))(
            jnp.asarray(emb), jnp.asarray(kernel))
    net = FiGNNNet((("a", "token", 3),) * nf, d, 1)
    net.edge_w.weight.data = torch.from_numpy(kernel.T.copy())
    te = torch.from_numpy(emb).requires_grad_()
    got = net.graph(te)
    (got * torch.from_numpy(g)).sum().backward()
    _assert_close(got.detach(), want, TOL_OUT, "edge weights")
    assert not got.detach()[:, range(nf), range(nf)].any()
    _assert_close(te.grad, jde, TOL_GRAD, "d emb")
    _assert_close(net.edge_w.weight.grad.T, jdk, TOL_GRAD, "d kernel")


@pytest.mark.parametrize("height", [4, 5])
def test_field_conv_matches_xla_same_convolution(height):
    """An even height puts XLA's extra SAME row at the end; the HWIO kernel
    is the port's OIHW weight permuted (``utils/convert``)."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.models.module.ctr import FieldConv
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    rng = np.random.default_rng(height)
    x = rng.normal(size=(B, 7, D, 2)).astype(np.float32)             # NHWC
    kernel = rng.normal(0.0, 0.5, (height, 1, 2, 3)).astype(np.float32)
    g = rng.normal(size=(B, 7, D, 3)).astype(np.float32)

    def conv(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    with jax.default_matmul_precision("float32"):
        want = conv(jnp.asarray(x), jnp.asarray(kernel))
        jdx, jdk = jax.grad(lambda x, k: (conv(x, k) * g).sum(), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(kernel))
    net = torch.nn.Module()
    net.conv_0 = FieldConv(2, 3, height)
    net.load_state_dict(ranker_params_from_jax({"conv_0": kernel}, net))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = net.conv_0(tx)
    (got * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    _assert_close(got.detach().permute(0, 2, 3, 1), want, TOL_OUT, "conv")
    _assert_close(tx.grad.permute(0, 2, 3, 1), jdx, TOL_GRAD, "d x")
    dk = ranker_params_to_jax({"conv_0.weight": net.conv_0.weight.grad}, net)["conv_0"]
    _assert_close(dk, jdk, TOL_GRAD, "d kernel")


def test_kmax_pool_orders_planted_ties_as_jax_top_k():
    """Values, their order (descending, a tie lower field first) and the
    gradient each selected value passes back, exactly, against
    ``jax.lax.top_k`` over the NHWC map's field axis (``ccpm.py:47``)."""
    import jax
    import jax.numpy as jnp
    from recstudio_torch.models.fm.ccpm import kmax_pool
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 7, D, 2)).astype(np.float32)             # NHWC
    # fields 1, 2 and 5 tie in every column, above every other field (N(0, 1)
    # draws): the top 3 of 4, whose order and gradients the tie decides
    x[:, 1] = np.abs(x[:, 1]) + 6.0
    x[:, 2], x[:, 5] = x[:, 1], x[:, 1]
    g = rng.normal(size=(B, 4, D, 2)).astype(np.float32)

    def pool(x):
        return jax.lax.top_k(x.transpose(0, 2, 3, 1), 4)[0].transpose(0, 3, 1, 2)

    want = np.asarray(pool(jnp.asarray(x)))
    jdx = np.asarray(jax.grad(lambda x: (pool(x) * g).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = kmax_pool(tx, 4)
    (got * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert np.array_equal(got.detach().permute(0, 2, 3, 1).numpy(), want)
    assert np.array_equal(tx.grad.permute(0, 2, 3, 1).numpy(), jdx)
    assert (want[:, 0] == want[:, 1]).all() and (want[:, 1] == want[:, 2]).all()


SPREAD_CASES = [
    ("AOANet", {"num_subspaces": 8}, ("gin_0.W", "gin_1.W")),
    ("SAM", {"interaction_type": "sam2a", "embed_dim": 12}, ("interaction.W",)),
    ("FinalMLP", {}, ("fusion.bilinear",)),
    ("FiGNN", {}, ("W_out_0", "W_in_0", "W_out_1", "W_in_1")),
    ("EDCN", {"embed_dim": 80}, ("cross_w_0", "cross_w_2")),
    ("CCPM", {"channels": [100, 40]}, (("conv_0.weight", "conv_0"),
                                       ("conv_1.weight", "conv_1"))),
    ("FGCNN", {"channels": [80, 8]}, (("fgcnn.conv_0.weight", "fgcnn.conv_0"),
                                      ("fgcnn.conv_1.weight", "fgcnn.conv_1"))),
]


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    from test_torch_ctr_zoo import build_splits
    from test_torch_jax_csv import jax_native_csv, worker_lib_dir
    with jax_native_csv(worker_lib_dir(tmp_path_factory)):
        return build_splits()


@pytest.mark.parametrize("name,over,leaves", SPREAD_CASES,
                         ids=["aoanet_w", "sam_w", "bilinear", "fignn", "edcn_cross",
                              "ccpm_conv", "fgcnn_conv"])
def test_initial_spreads_match_jax(name, over, leaves, splits):
    """AOANet's ``W`` is declared as copies of the identity and SAM's as
    ones, but the JAX rule by name draws both again (``w`` is a kernel
    name): xavier normal over flax's fans, as the port draws them."""
    from test_torch_ctr_zoo_init import check_spreads
    check_spreads(name, over, leaves, splits)
