"""``learner: adagrad`` and ``rmsprop`` against optax 0.2.6, whose
defaults are not ``torch.optim``'s (Adagrad's accumulator starts at 0.1
and its eps is 1e-7 inside the square root; RMSprop decays by 0.9 with
eps 1e-8 inside it). Three steps from the same parameters and gradients,
a zero gradient entry, a zero row and a tensor with no gradient among
them: parameters and the optimizer's state agree to rtol 1e-6 (atol
1e-7).
"""
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-6, atol=1e-7)


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    params = {"table": rng.normal(0, 0.1, (7, 5)).astype(np.float32),
              "bias": rng.normal(0, 0.1, 5).astype(np.float32),
              "idle": rng.normal(0, 0.1, 3).astype(np.float32)}
    grads = []
    for _ in range(3):
        g = {k: rng.normal(0, 1.0, v.shape).astype(np.float32) for k, v in params.items()}
        g["table"][2] = 0.0                   # an untouched row
        g["bias"][1] = 0.0
        g["idle"][:] = 0.0                    # no gradient at all on the port's side
        grads.append(g)
    return params, grads


@pytest.mark.parametrize("name", ["adagrad", "rmsprop"])
def test_three_steps_match_optax(name):
    import jax.numpy as jnp
    import optax
    from recstudio_torch.models.basemodel.recommender import Recommender
    params, grads = _params_and_grads(len(name))
    lr = 0.05
    tx = getattr(optax, name)(lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    holder = type("Holder", (), {})()
    holder.net = torch.nn.ParameterDict(tp)
    opt = Recommender._make_optimizer(holder, name, lr)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = None if k == "idle" else torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    key = "sum" if name == "adagrad" else "nu"
    inner = state[0]
    acc = inner.sum_of_squares if name == "adagrad" else inner.nu
    for k in params:
        np.testing.assert_allclose(opt.state[tp[k]][key].numpy(), np.asarray(acc[k]),
                                   err_msg=k, **TOL)


def test_defaults_differ_from_torch_optim():
    """The optax formulas are not ``torch.optim``'s defaults: one step of
    each from the same gradient moves a parameter differently."""
    from recstudio_torch.models.optim import OptaxAdagrad, OptaxRMSprop
    for ours, theirs in ((OptaxAdagrad, torch.optim.Adagrad), (OptaxRMSprop, torch.optim.RMSprop)):
        a, b = torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.ones(4))
        a.grad = b.grad = torch.full((4,), 0.5)
        ours([a], lr=0.1).step()
        theirs([b], lr=0.1).step()
        assert not torch.allclose(a, b)


def test_unknown_learner_raises():
    from recstudio_torch.models.basemodel.recommender import Recommender
    holder = type("Holder", (), {})()
    holder.net = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="unknown learner"):
        Recommender._make_optimizer(holder, "adadelta", 0.1)
