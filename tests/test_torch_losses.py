"""The port's losses against the JAX package's: values and the gradients
with respect to the scores, to rtol 1e-5 and atol 1e-6 (float32 on both
sides). Each loss that masks padded positions (``pos_score = -inf``:
``_not_pad`` or ``isinf`` in ``loss_func.py``) is run with pads, flat
(``[B]`` against ``[B, n]``) and per position (``[B, L]`` against
``[B, L, n]``); the others are run without, as their models feed them.
The proposal log probabilities are nonzero, so every correction shows.
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"flat": ((32,), 6), "per-position": ((6, 9), 4)}


def _scores(shape, neg, pads, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=shape) * 2).astype(np.float32)
    negs = (rng.normal(size=(*shape, neg)) * 2).astype(np.float32)
    lpp = rng.normal(-3.0, 1.0, shape).astype(np.float32)
    lnp = rng.normal(-3.0, 1.0, (*shape, neg)).astype(np.float32)
    if pads:
        pos.reshape(-1)[::5] = -np.inf
    return pos, negs, lpp, lnp


def _check(jfn, tfn, arrays, grad_of=(0, 1), label=None):
    """Value and gradients (with respect to the arrays at ``grad_of``)."""
    import jax
    import jax.numpy as jnp
    label = np.ones(arrays[0].shape, np.float32) if label is None else label

    def jloss(*xs):
        return jfn(jnp.asarray(label), *xs)

    jx = [jnp.asarray(a) for a in arrays]
    want, wgrads = jax.value_and_grad(jloss, argnums=grad_of)(*jx)
    tx = [torch.from_numpy(a.copy()) for a in arrays]
    for i in grad_of:
        tx[i].requires_grad_()
    got = tfn(torch.from_numpy(label), *tx)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for i, wg in zip(grad_of, wgrads):
        np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(wg), err_msg=f"grad {i}", **TOL)


PAIRWISE = ["Top1Loss", "Top1Loss-dns", "SampledSoftmaxLoss", "InfoNCELoss", "WeightedBPRLoss",
            "BinaryCrossEntropyLoss-dns", "WeightedBinaryCrossEntropyLoss", "HingeLoss",
            "HingeLoss-rank", "NCELoss", "CCLLoss"]
MASKING = {"SampledSoftmaxLoss", "InfoNCELoss", "WeightedBinaryCrossEntropyLoss", "CCLLoss"}


def _pairwise(lib, name):
    cls = getattr(lib, name.split("-")[0])
    if name.endswith("-dns"):
        return cls(dns=True)
    if name == "HingeLoss-rank":
        return cls(margin=1.5, num_items=500)
    if name == "CCLLoss":
        return cls(margin=0.6, neg_weight=0.4)
    return cls()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", PAIRWISE)
def test_pairwise_loss_matches_jax(name, shape):
    from recstudio_tpu.models import loss_func as J
    from recstudio_torch.models import loss_func as P
    dims, neg = SHAPES[shape]
    pos, negs, lpp, lnp = _scores(dims, neg, name in MASKING, len(name) + neg)
    jl, tl = _pairwise(J, name), _pairwise(P, name)
    _check(lambda lab, p, n, a, b: jl(lab, p, a, n, b),
           lambda lab, p, n, a, b: tl(lab, p, a, n, b), [pos, negs, lpp, lnp])


def test_masked_positions_get_no_gradient():
    """The sampled softmax gives padded positions a zero loss and a zero
    gradient, and each position, padded or not, counts in the mean (one
    finite position of four here)."""
    from recstudio_torch.models.loss_func import SampledSoftmaxLoss
    pos = torch.tensor([[1.0, float("-inf")], [float("-inf"), float("-inf")]],
                       requires_grad=True)
    neg = torch.zeros(2, 2, 3, requires_grad=True)
    loss = SampledSoftmaxLoss()(None, pos, torch.zeros(2, 2), neg, torch.zeros(2, 2, 3))
    loss.backward()
    assert torch.isfinite(loss) and pos.grad[0, 1] == 0 and pos.grad[1].abs().sum() == 0
    assert neg.grad[1].abs().sum() == 0 and neg.grad[0, 1].abs().sum() == 0
    np.testing.assert_allclose(float(loss.detach()), (np.log(np.e + 3.0) - 1.0) / 4, rtol=1e-6)


@pytest.mark.parametrize("name", ["SquareLoss", "SquareLoss-rows", "BCELoss", "BCELoss-none",
                                  "MSELoss", "MSELoss-threshold"])
def test_pointwise_loss_matches_jax(name):
    from recstudio_tpu.models import loss_func as J
    from recstudio_torch.models import loss_func as P
    rng = np.random.default_rng(len(name))
    shape = (12, 7) if name.endswith("rows") else (40,)
    label = rng.integers(0, 6, shape).astype(np.float32)
    score = rng.normal(2.0, 2.0, shape).astype(np.float32)
    kwargs = {}
    if name.startswith("BCELoss"):
        label = (label > 2).astype(np.float32)
        score = rng.uniform(-0.1, 1.1, shape).astype(np.float32)   # outside [0, 1] too
        kwargs = {"reduction": "none"} if name.endswith("none") else {}
    if name == "MSELoss-threshold":
        kwargs = {"threshold": 3.0}
    cls = name.split("-")[0]
    jl, tl = getattr(J, cls)(**kwargs), getattr(P, cls)(**kwargs)
    if kwargs.get("reduction") == "none":
        _check(lambda lab, s: jl(lab, s).sum(), lambda lab, s: tl(lab, s).sum(), [score],
               grad_of=(0,), label=label)
    else:
        _check(lambda lab, s: jl(lab, s), lambda lab, s: tl(lab, s), [score], grad_of=(0,),
               label=label)


@pytest.mark.parametrize("rank_weight", [None, False])
def test_cml_loss_matches_jax(rank_weight):
    """CML's hinge over ``[B, W]`` positives with pads (flipped to ``+inf``)
    against ``[B, n]`` negatives; ``use_rank_weight`` not ``None`` (even
    ``False``) weights by the estimated rank, as the JAX loss does."""
    from recstudio_tpu.models.mf.cml import CMLoss as JaxCMLoss
    from recstudio_torch.models.mf.cml import CMLoss
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(10, 7)).astype(np.float32)
    pos[:, 5:] = -np.inf
    negs = rng.normal(size=(10, 5)).astype(np.float32)
    jl, tl = JaxCMLoss(1.0, rank_weight, 300), CMLoss(1.0, rank_weight, 300)
    zeros = np.zeros_like(negs)
    _check(lambda lab, p, n: jl(lab, p, None, n, zeros),
           lambda lab, p, n: tl(lab, p, None, n, torch.from_numpy(zeros)), [pos, negs])


def test_logit_loss_matches_jax():
    from recstudio_tpu.models.mf.logisticmf import LogitLoss as JaxLogit
    from recstudio_torch.models.mf.logisticmf import LogitLoss
    pos, negs, _, _ = _scores((24,), 10, False, 5)
    _check(lambda lab, p, n: JaxLogit(0.5)(lab, p, None, n, None),
           lambda lab, p, n: LogitLoss(0.5)(lab, p, None, n, None), [pos * 4, negs * 4])
