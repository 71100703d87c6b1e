"""The port's optimizers (hydragnn_tpu_torch/train/optimizer.py) against
the JAX package's `select_optimizer` (optax under inject_hyperparams, with
clip_by_global_norm and MultiSteps), over 5 steps of the same random
gradients from the same parameters.

Bound: rtol 1e-6 / atol 1e-7 on the parameters after every step. The
rules run the same float32 operations in the same order; they may differ
in the last bit of a square root, a reciprocal square root or of the
bias correction 1 - b^count (XLA's pow and torch's), which five steps of
size ~1e-2 keep far below the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hydragnn_tpu.train import optimizer as jopt
from hydragnn_tpu_torch.train import optimizer as topt

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3)}
STEPS = 5


def _run(train_cfg, seed, set_lr_at=None, new_lr=None):
    """Parameters after each of STEPS steps, from optax and from the
    port, on the same gradients."""
    rng = np.random.RandomState(seed)
    params0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    names = sorted(SHAPES)

    tx = jopt.select_optimizer(train_cfg)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    js = tx.init(jp)
    port = topt.select_optimizer(train_cfg)
    tp = [torch.from_numpy(params0[k].copy()) for k in names]
    ts = port.init(tp)
    out = []
    for i, g in enumerate(grads):
        if i == set_lr_at:
            js = jopt.set_learning_rate(js, new_lr)
            topt.set_learning_rate(ts, new_lr)
            assert topt.get_learning_rate(ts) == jopt.get_learning_rate(js)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = port.update([torch.from_numpy(g[k]) for k in names], ts, tp)
        if tu is not None:
            for p, u in zip(tp, tu):
                p.add_(u)
        out.append(([np.asarray(jp[k]) for k in names],
                    [p.numpy().copy() for p in tp]))
    return out, params0


@pytest.mark.parametrize("name", ["SGD", "Adam", "Adadelta", "Adagrad",
                                  "Adamax", "AdamW", "RMSprop", "FusedLAMB"])
def test_optimizer_matches_optax(name):
    out, params0 = _run({"Optimizer": {"type": name,
                                       "learning_rate": 0.01}}, seed=1)
    for step, (want, got) in enumerate(out):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, err_msg=f"{name} step {step}",
                                       **TOL)
    moved = max(float(np.abs(g - params0[k]).max())
                for g, k in zip(out[-1][1], sorted(SHAPES)))
    assert moved > 1e-4, name


@pytest.mark.parametrize("case", ["clip", "accumulate", "set_lr"])
def test_clip_accumulation_and_learning_rate_match_optax(case):
    """grad_clip 0.5 (the gradients' global norm is ~10, so every step
    clips); gradient_accumulation_steps 2 (an update on steps 2 and 4
    only, from the mean of two micro-batches); the learning rate halved
    between steps 3 and 4, as the plateau schedule does."""
    cfg = {"Optimizer": {"type": "AdamW", "learning_rate": 0.01}}
    kw = {}
    if case == "clip":
        cfg["grad_clip"] = 0.5
    elif case == "accumulate":
        cfg["gradient_accumulation_steps"] = 2
    else:
        kw = dict(set_lr_at=3, new_lr=0.005)
    out, params0 = _run(cfg, seed=2, **kw)
    for step, (want, got) in enumerate(out):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, err_msg=f"{case} step {step}",
                                       **TOL)
    if case == "accumulate":
        first = out[0][1]
        for g, k in zip(first, sorted(SHAPES)):
            np.testing.assert_array_equal(g, params0[k])  # micro-step only


def test_select_optimizer_defaults_and_unknown_name():
    opt = topt.select_optimizer({})
    assert (opt.name, opt.weight_decay, opt.momentum) == ("AdamW", 1e-2, 0.9)
    assert opt.learning_rate == float(np.float32(1e-3))
    state = opt.init([torch.zeros(3)])
    topt.set_learning_rate(state, 0.1)
    assert topt.get_learning_rate(state) == float(np.float32(0.1))
    adagrad = topt.select_optimizer({"Optimizer": {"type": "Adagrad"}})
    assert torch.equal(adagrad.init([torch.zeros(2)]).slots[
        "sum_of_squares"][0], torch.full((2,), 0.1))
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.select_optimizer({"Optimizer": {"type": "LBFGS"}})
