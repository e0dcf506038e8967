#!/usr/bin/env python3
"""DIEN at the repo's config on ml-100k, the port against the JAX package on
the CPU, with the randomness of a fit taken out:

    JAX_PLATFORMS=cpu python scripts/torch_dien_parity.py [STEPS]

- the initial weights: each package draws its own (``_init_parameter``);
  the standard deviation and largest magnitude of every parameter, side
  by side;
- the training trajectory: the JAX model's initial weights loaded into the
  port, dropout 0, both packages stepping Adam (1e-3) through the same
  ``STEPS`` batches of 256 (default 380, one epoch) drawn from one numpy
  permutation; the loss every 50 steps, the largest relative parameter
  difference at the end, and both packages' validation AUC and logloss.

What is left between two fits of the packages is then the random streams:
the initial draw, the dropout masks and the epoch permutations.
"""
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 256


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def main(steps: int) -> int:
    import jax
    import jax.numpy as jnp
    import optax
    from recstudio_tpu.data import SeqDataset as JaxSeqDataset
    from recstudio_tpu.models.init import zero_pad_rows_in_grads as jax_zero_pad
    from recstudio_tpu.utils import get_model as jax_get_model
    from recstudio_torch.data import SeqDataset
    from recstudio_torch.utils import get_model
    from recstudio_torch.utils.convert import ranker_params_from_jax, ranker_params_to_jax
    torch.set_num_threads(4)
    built = []
    for getter, dcls, kw in ((jax_get_model, JaxSeqDataset, {}),
                             (get_model, SeqDataset, {"device": "cpu"})):
        cls, conf = getter("DIEN")
        np.random.seed(42)
        splits = dcls("ml-100k", config={"low_rating_thres": conf["data"]["low_rating_thres"]}
                      ).build(**conf["data"])
        model = cls(conf, **kw)
        model._init_model(splits[0])
        model._init_parameter(splits[0])
        built.append((model, conf, splits))
    (jm, jconf, jsplits), (m, conf, splits) = built

    own = dict(leaves(ranker_params_to_jax({k: v.detach() for k, v in
                                            m.net.named_parameters()}, m.net)))
    print("initial weights: parameter, shape, JAX std / max, port std / max")
    for name, w in leaves(jax.tree_util.tree_map(np.asarray, jm.params)):
        p = own[name]
        print(f"  {name:34s} {str(w.shape):12s} {w.std():.5f} / {np.abs(w).max():.4f}   "
              f"{p.std():.5f} / {np.abs(p).max():.4f}")

    for c in (jconf, conf):
        c["model"]["dropout"] = 0.0
    jm = type(jm)(jconf)
    jm._init_model(jsplits[0])
    jm._init_parameter(jsplits[0])
    jm.val_check = False
    m = type(m)(conf, device="cpu")
    m._init_model(splits[0])
    m.load_state_dict(ranker_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                             m.net))
    m.optimizer = m._get_optimizer()
    opt = optax.adam(float(jconf["train"].get("learning_rate", 1e-3)))
    params, opt_state = jm.params, opt.init(jm.params)
    loss_and_grads = jax.jit(jax.value_and_grad(jm._loss_and_aux, has_aux=True))

    @jax.jit
    def update(p, g, s):
        u, s = opt.update(jax_zero_pad(g), s, p)
        return optax.apply_updates(p, u), s

    jtrn, trn = jsplits[0], splits[0]
    trn.use_field = m.fields
    n = len(jtrn.data_index)
    perm = np.random.default_rng(0).permutation(n)
    print(f"trajectory: {steps} Adam steps of {BATCH}, dropout 0 (step, JAX loss, port loss)")
    for i in range(steps):
        start = (i * BATCH) % n
        idx = perm[start:start + BATCH]
        jb, b = jtrn._get_pos_batch(idx), trn._get_pos_batch(idx)
        assert all(np.array_equal(jb[k], b[k]) for k in jb)
        with jax.default_matmul_precision("float32"):
            (jloss, _), grads = loss_and_grads(params, {k: jnp.asarray(v) for k, v in jb.items()},
                                               jax.random.PRNGKey(i), jm.states)
            params, opt_state = update(params, grads, opt_state)
        m.net.train()
        loss = m._grad_step({k: torch.from_numpy(v) for k, v in b.items()})
        m.net.eval()
        if i % 50 == 0 or i == steps - 1:
            print(f"  {i:4d} {float(jloss):.6f} {float(loss):.6f}", flush=True)
    got = dict(leaves(ranker_params_to_jax({k: v.detach() for k, v in
                                            m.net.named_parameters()}, m.net)))
    worst = max(float(np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-12))
                for k, w in leaves(jax.tree_util.tree_map(np.asarray, params)))
    print(f"largest relative parameter difference after {steps} steps: {worst:.3g}")
    jm.params = params
    jm._train_data, m._train_data = jtrn, trn
    with jax.default_matmul_precision("float32"):
        jval = jm.evaluate(jsplits[1], verbose=False)
    val = m.evaluate(splits[1], verbose=False)
    print("validation: JAX", {k: float(v) for k, v in jval.items()}, "port", val)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_jax_csv import jax_native_csv
    with jax_native_csv(tempfile.mkdtemp()):
        sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 380))
