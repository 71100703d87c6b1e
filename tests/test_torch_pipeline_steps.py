"""The port's pipelined train and eval steps
(hydragnn_tpu_torch/parallel/pipeline_trainer.py) against the JAX
package's on the CPU (stages on the CPU, SGD, the same weights):

* three steps of `make_pipeline_train_step` under gpipe and 1f1b: the
  parameters and metrics within rtol 1e-5 / atol 1e-6 (PNA and SchNet
  within the standing stack bound, rtol 1e-4 / atol 1e-5; see
  tests/torch_pipeline_fixtures.py), `nonfinite_steps` exact;
* (the energy-force steps: tests/test_torch_pipeline_ef.py)
* the eval steps on microbatches with unequal real-graph counts;
* within the port: gpipe, 1f1b and 1f1b with remat give bitwise the same
  first-step metrics, remat's trajectory is bitwise, the pipelined and
  sequential steps' gradients are bitwise; `freeze_conv_layers` keeps the
  blocks still under AdamW; a bf16 1f1b step stays finite.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu_torch.datasets.loader import unstack_batch
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from tests.torch_pipeline_fixtures import (STEPS, S, Fixture, assert_trees,
                                           flat, metrics_close, molecules,
                                           port_tree, tol_for)

torch.set_num_threads(1)


@pytest.mark.parametrize("model_type,dense,schedule", [
    ("GIN", True, "gpipe"), ("GIN", True, "1f1b"),
    ("SAGE", False, "1f1b"), ("PNA", True, "gpipe"),
    ("PNA", False, "1f1b"), ("SchNet", False, "gpipe")])
def test_train_steps_match_jax(model_type, dense, schedule):
    # PNA on five-feature molecules: on the one-feature fixture its std
    # at zero variance amplifies the packages' rounding into the updates
    fx = Fixture(model_type, dense=dense,
                 samples=molecules() if model_type == "PNA" else None)
    model, state, tx, jstate, jtx = fx.states()
    step = tpt.make_pipeline_train_step(model, tx, schedule=schedule)
    jstep = jpt.make_pipeline_train_step(fx.jmcfg, fx.mesh, S, jtx,
                                         schedule=schedule)
    tol = tol_for(model_type)
    for _ in range(STEPS):
        state, metrics = step(state, fx.stacked)
        jstate, jmetrics = jstep(jstate, fx.jstacked)
        metrics_close(metrics, jmetrics, tol)
    assert state.step == STEPS
    assert_trees(port_tree(model), jax.device_get(jstate.params), tol)


@pytest.mark.parametrize("ef", [False, True])
def test_eval_steps_match_jax_on_unequal_graph_counts(ef):
    """15 graphs in 4 microbatches of room 4: the last holds 3 real
    graphs, and each microbatch's metrics weigh by its real graphs."""
    from tests.deterministic_data import deterministic_graph_dataset
    from tests.test_torch_train import to_port_samples
    from tests.torch_pipeline_fixtures import lj_samples
    samples = (lj_samples(15) if ef else
               to_port_samples(deterministic_graph_dataset(num_configs=15)))
    fx = Fixture(ef=ef, samples=samples, n_graphs=16)
    assert fx.stacked.graph_mask.sum(1).tolist() == [4, 4, 4, 3]
    model, state, _, jstate, _ = fx.states()
    if ef:
        step = tpt.make_pipeline_ef_eval_step(model)
        jstep = jpt.make_pipeline_ef_eval_step(fx.jmcfg, fx.mesh, S)
    else:
        step = tpt.make_pipeline_eval_step(model)
        jstep = jpt.make_pipeline_eval_step(fx.jmcfg, fx.mesh, S)
    tol = tol_for("SchNet" if ef else "GIN")
    metrics, out = step(state, fx.stacked)
    assert out is None
    metrics_close(dict(metrics, nonfinite_steps=0.0),
                   dict(jstep(jstate, fx.jstacked), nonfinite_steps=0.0),
                   tol)
    # an unstacked batch is one microbatch, as in JAX
    m1, _ = step(state, unstack_batch(fx.stacked)[3])
    j1 = jstep(jstate, jax.tree_util.tree_map(lambda a: a[3],
                                              fx.jstacked))
    np.testing.assert_allclose(float(m1["loss"]), float(j1["loss"]), **tol)


def test_schedules_and_remat_within_the_port():
    """gpipe, 1f1b and 1f1b + full remat: the first step's metrics
    bitwise; the remat trajectory bitwise 1f1b's; gpipe's parameters
    within float tolerance of 1f1b's (the window sums reassociate)."""
    fx = Fixture("GIN")
    runs = {}
    for name, kw in (("gpipe", dict(schedule="gpipe")),
                     ("1f1b", dict(schedule="1f1b")),
                     ("remat", dict(schedule="1f1b", remat=True,
                                    remat_policy="full")),
                     ("dots", dict(schedule="1f1b", remat=True,
                                   remat_policy="dots"))):
        model, state, tx, _, _ = fx.states()
        step = tpt.make_pipeline_train_step(model, tx, **kw)
        first = None
        for i in range(STEPS):
            state, metrics = step(state, fx.stacked)
            first = first or {k: float(v) for k, v in metrics.items()}
        runs[name] = (first, flat(port_tree(model)))
    assert runs["gpipe"][0] == runs["1f1b"][0] == runs["remat"][0] \
        == runs["dots"][0]
    np.testing.assert_array_equal(runs["remat"][1], runs["1f1b"][1])
    np.testing.assert_array_equal(runs["dots"][1], runs["1f1b"][1])
    np.testing.assert_allclose(runs["gpipe"][1], runs["1f1b"][1],
                               rtol=5e-6, atol=1e-7)


@pytest.mark.parametrize("model_type,dense,ef", [
    ("GIN", True, False), ("PNA", False, False), ("SchNet", False, True)])
def test_pipelined_step_gradients_bitwise_sequential(model_type, dense, ef):
    """One gpipe step through the tick schedule and through the
    sequential stack: the same updated parameters, bit for bit."""
    fx = Fixture(model_type, dense=dense, ef=ef)
    out = []
    for pipelined in (True, False):
        model, state, tx, _, _ = fx.states()
        if ef and pipelined:
            step = tpt.make_pipeline_ef_train_step(model, tx,
                                                   schedule="gpipe")
        elif ef:
            step = _sequential_ef_step(model, tx)
        else:
            step = tpt.make_pipeline_train_step(model, tx, schedule="gpipe",
                                                pipelined=pipelined)
        state, metrics = step(state, fx.stacked)
        out.append((float(metrics["loss"]), flat(port_tree(model))))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def _sequential_ef_step(model, tx):
    """make_pipeline_ef_train_step's body over the sequential forward."""
    from hydragnn_tpu_torch.train.step_graphs import GraphedSteps
    forward = tpt.make_pipeline_forward(model, pipelined=False)

    def body(state, batch, scalars=None):
        micros = unstack_batch(batch)
        params = list(state.params.values())
        grads, rows = tpt._schedule_grads(
            lambda w: tpt.ef_rows(model.cfg, "mse", forward, w, 1.0, 1.0),
            params, micros, "gpipe", model.num_stages,
            forward.stream_devices)
        metrics = {"loss": torch.mean(torch.stack([r[0] for r in rows]))}
        tpt._update(state, model.cfg, tx, grads, scalars)
        return metrics, None
    step = tpt.PipelineTrainStep(model, body, tx)
    assert isinstance(step.steps, GraphedSteps)
    return step


def test_freeze_conv_layers_keeps_the_blocks():
    """freeze_conv_layers zeroes the blocks' gradients and updates (AdamW
    decays a parameter at a zero gradient); embed and heads train."""
    fx = Fixture("GIN")
    fx.mcfg = dataclasses.replace(fx.mcfg, freeze_conv=True)
    model, state, tx, _, _ = fx.states({"type": "AdamW",
                                        "learning_rate": 1e-2})
    before = {k: v.detach().clone() for k, v in state.params.items()}
    step = tpt.make_pipeline_train_step(model, tx)
    for _ in range(STEPS):
        state, metrics = step(state, fx.stacked)
    assert np.isfinite(float(metrics["loss"]))
    for k, v in state.params.items():
        if k.startswith("convs."):
            assert torch.equal(v, before[k]), k
    assert any(not torch.equal(v, before[k])
               for k, v in state.params.items() if k.startswith("heads."))
    assert not torch.equal(state.params["embed.weight"],
                           before["embed.weight"])


def test_bf16_steady_1f1b_step():
    """Architecture.dtype bf16: bf16 compute on float32 masters; a
    steady 1f1b step stays finite and the masters stay float32."""
    fx = Fixture("GIN")
    model, state, tx, _, _ = fx.states()
    step = tpt.make_pipeline_train_step(model, tx, schedule="1f1b",
                                        compute_dtype="bfloat16")
    losses = []
    for _ in range(4):
        state, metrics = step(state, fx.stacked)
        losses.append(float(metrics["loss"]))
        assert float(metrics["nonfinite_steps"]) == 0.0
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in state.params.values())
    # the first bf16 loss lies near the float32 one
    model32, s32, tx32, _, _ = fx.states()
    _, m32 = tpt.make_pipeline_train_step(model32, tx32)(s32, fx.stacked)
    np.testing.assert_allclose(losses[0], float(m32["loss"]), rtol=2 ** -5)


def test_watchdog_counts_a_nonfinite_step():
    fx = Fixture("GIN")
    model, state, tx, _, _ = fx.states()
    with torch.no_grad():
        model.embed.bias.fill_(float("nan"))
    step = tpt.make_pipeline_train_step(model, tx)
    _, metrics = step(state, fx.stacked)
    assert float(metrics["nonfinite_steps"]) == 1.0
    assert tpt._watchdog(torch.tensor(1.0), [torch.ones(3)]) == 0.0
