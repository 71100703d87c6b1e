"""The port's pipelined energy-force steps
(hydragnn_tpu_torch/parallel/pipeline_trainer.py) against the JAX
package's on the CPU (stages on the CPU, SGD, the same weights):
equivariant SchNet on LJ cells, forces = -dE/dpos through the stages
and the parameter gradient a second derivative through them; three
steps under gpipe and under 1f1b with the "auto" force weight, the
parameters and metrics within the standing SchNet stack bound (rtol
1e-4 / atol 1e-5), `nonfinite_steps` exact; the "auto" weight is the
whole batch's, resolved before the windows.
"""
import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu_torch.datasets.loader import unstack_batch
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from tests.torch_pipeline_fixtures import (STEPS, S, Fixture, assert_trees,
                                           metrics_close, port_tree, tol_for)

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule,force_weight", [
    ("gpipe", 1.0), ("1f1b", "auto")])
def test_ef_train_steps_match_jax(schedule, force_weight):
    """Forces = -dE/dpos through the stages, the parameter gradient a
    second derivative through them; "auto" resolved over the whole batch
    before the windows."""
    fx = Fixture(ef=True)
    model, state, tx, jstate, jtx = fx.states()
    step = tpt.make_pipeline_ef_train_step(model, tx,
                                           force_weight=force_weight,
                                           schedule=schedule)
    jstep = jpt.make_pipeline_ef_train_step(fx.jmcfg, fx.mesh, S, jtx,
                                            force_weight=force_weight,
                                            schedule=schedule)
    for _ in range(STEPS):
        state, metrics = step(state, fx.stacked)
        jstate, jmetrics = jstep(jstate, fx.jstacked)
        metrics_close(metrics, jmetrics, tol_for("SchNet"))
    assert_trees(port_tree(model), jax.device_get(jstate.params),
                 tol_for("SchNet"))


def test_auto_force_weight_is_the_whole_batch_one():
    fx = Fixture(ef=True)
    micros = unstack_batch(fx.stacked)
    got = tpt.resolve_ef_force_weight(micros, 1.0, "auto")
    want = jpt._resolve_ef_force_weight(fx.jstacked, 1.0, "auto")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a window's own ratio differs: the step must not use it
    half = tpt.resolve_ef_force_weight(micros[:2], 1.0, "auto")
    assert float(half) != float(got)
    assert tpt.resolve_ef_force_weight(micros, 1.0, 2.5) == 2.5


def test_ef_step_with_dots_remat_is_the_full_remat_step():
    """Selective checkpointing allows one backward through a region, and
    the EF parameter gradient passes the stages twice: "dots" trains as
    "full" does, bitwise the step without remat."""
    fx = Fixture(ef=True)
    out = []
    for remat, policy in ((False, None), (True, "full"), (True, "dots")):
        model, state, tx, _, _ = fx.states()
        step = tpt.make_pipeline_ef_train_step(model, tx, remat=remat,
                                               remat_policy=policy,
                                               schedule="1f1b")
        state, metrics = step(state, fx.stacked)
        out.append((float(metrics["loss"]),
                    [p.detach().clone() for p in state.params.values()]))
    for loss, params in out[1:]:
        assert loss == out[0][0]
        for a, b in zip(params, out[0][1]):
            assert torch.equal(a, b)
