"""The pipeline's data axis in the port (`Training.pipeline_data_shards`:
D pipe rings on the same stage devices, the stacked batch holding D x M
microbatches in [d * M + m] order), the stages on the CPU:

* `test_pipeline_data_shards_parity` (JAX tests/test_pipeline_config.py
  :472-501): the same 4 microbatches trained as 2 rings x 2 microbatches
  give the pipe-only run's loss bitwise and its parameters within rtol
  5e-6 / atol 1e-7, with and without ZeRO;
* ZeRO on over the data axis bitwise ZeRO off (the rings share one
  device, so the port's update stays replicated);
* the port's pipe x data step against JAX's on a (pipe, data) mesh within
  the standing stack bound, with and without ZeRO;
* `run_training` with pipeline_data_shards 2 against JAX's, with and
  without ZeRO, and its refusals with JAX's messages.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu.parallel.mesh import make_mesh
from hydragnn_tpu.run_training import run_training as j_run_training
from hydragnn_tpu_torch import run_training
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from tests.test_torch_pipeline_run import _cfg, _splits, _with_jax_init
from tests.torch_pipeline_fixtures import (S, Fixture, assert_trees,
                                           metrics_close, molecules,
                                           port_tree, tol_for)

torch.set_num_threads(1)
D = 2
CPU4 = ["cpu"] * (S * D)
PARITY_TOL = dict(rtol=5e-6, atol=1e-7)
ADAMW = {"type": "AdamW", "learning_rate": 0.01}
HISTORY_KEYS = ("train_loss", "val_loss", "test_loss")


def _data_cfg(**train):
    """tests/test_torch_pipeline_run.py's GIN config over 2 stages x 2
    data shards x 2 microbatches of 2 graphs."""
    cfg = _cfg(pipeline_data_shards=D, **train)
    cfg["NeuralNetwork"]["Training"]["pipeline_microbatches"] = 2
    return cfg


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("model_type", ["GIN", "PNA"])
def test_pipeline_data_shards_parity(model_type, zero):
    fx = Fixture(model_type, dense=True, micro=4,
                 samples=molecules() if model_type == "PNA" else None)
    model1, s1, tx1, _, _ = fx.states(optimizer=dict(ADAMW))
    step1 = tpt.make_pipeline_train_step(model1, tx1, schedule="1f1b")
    _, met1 = step1(s1, fx.stacked)
    model2, s2, tx2, _, _ = fx.states(optimizer=dict(ADAMW), devices=CPU4[:S])
    step2 = tpt.make_pipeline_train_step(model2, tx2, schedule="1f1b",
                                         data_shards=D, zero_opt=zero,
                                         zero_min_size=16)
    _, met2 = step2(s2, fx.stacked)
    assert float(met1["loss"]) == float(met2["loss"])
    assert torch.equal(met1["loss"], met2["loss"])
    for k, v in s1.params.items():
        np.testing.assert_allclose(s2.params[k].detach().numpy(),
                                   v.detach().numpy(), err_msg=k,
                                   **PARITY_TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_zero_over_the_rings_is_bitwise_the_replicated_update(schedule):
    fx = Fixture("GIN", dense=False, micro=4)
    states = []
    for zero in (False, True):
        model, state, tx, _, _ = fx.states(optimizer=dict(ADAMW))
        step = tpt.make_pipeline_train_step(model, tx, schedule=schedule,
                                            data_shards=D, zero_opt=zero,
                                            zero_min_size=16)
        for _ in range(2):
            state, _ = step(state, fx.stacked)
        states.append(state)
    assert any(v.numel() >= 16 and v.shape[0] % D == 0
               for v in states[0].params.values())
    for k, v in states[0].params.items():
        assert torch.equal(v, states[1].params[k]), k
    for name, ts in states[0].opt_state.slots.items():
        for a, b in zip(ts, states[1].opt_state.slots[name]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("model_type,zero", [("GIN", False), ("GIN", True),
                                             ("PNA", True)])
def test_pipe_by_data_step_matches_jax(model_type, zero):
    fx = Fixture(model_type, dense=True, micro=4,
                 samples=molecules() if model_type == "PNA" else None)
    model, state, tx, jstate, jtx = fx.states()
    mesh = make_mesh((("pipe", S), ("data", D)),
                     devices=jax.devices()[:S * D])
    placed = jpt.place_pipeline_batch(fx.jstacked, mesh, data_shards=D)
    jstep = jpt.make_pipeline_train_step(fx.jmcfg, mesh, S, jtx,
                                         schedule="1f1b", data_shards=D,
                                         zero_opt=zero, zero_min_size=16)
    step = tpt.make_pipeline_train_step(model, tx, schedule="1f1b",
                                        data_shards=D, zero_opt=zero,
                                        zero_min_size=16)
    tol = tol_for(model_type)
    for _ in range(2):
        state, metrics = step(state, fx.stacked)
        jstate, jmetrics = jstep(jstate, placed)
        metrics_close(metrics, jmetrics, tol)
    assert_trees(port_tree(model), jax.device_get(jstate.params), tol)


@pytest.mark.parametrize("zero", [False, True])
def test_run_training_pipe_by_data_matches_jax(tmp_path, monkeypatch, zero):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    splits, jsplits = _splits()
    cfg = _data_cfg()
    cfg["NeuralNetwork"]["Training"]["Optimizer"].update(
        use_zero_redundancy=zero, zero_min_shard_size=16)
    _with_jax_init(monkeypatch)
    _, want, _, _ = j_run_training(copy.deepcopy(cfg), datasets=jsplits)
    _, got, model, _ = run_training(copy.deepcopy(cfg), datasets=splits,
                                    device="cpu", pipeline_devices=CPU4)
    assert model is None
    for k in HISTORY_KEYS:
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **tol_for("GIN"))


def test_run_training_pipe_by_data_needs_s_times_d_devices(tmp_path,
                                                           monkeypatch):
    """Two stage devices for 2 stages x 2 data shards: JAX's
    "exceeds device count" ValueError, its message with the port's
    count."""
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits(24)
    cfg = _data_cfg()
    with pytest.raises(ValueError, match=(
            r"pipeline_stages=2 x pipeline_data_shards=2 exceeds device "
            r"count 2")):
        run_training(cfg, datasets=splits, device="cpu",
                     pipeline_devices=CPU4[:2])


def test_pipe_by_data_zero_warning_stays_for_one_data_shard(
        tmp_path, monkeypatch, caplog):
    """ZeRO on a pipeline with one data shard: the JAX package's warning,
    and the replicated update."""
    import logging
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits(24)
    cfg = _cfg(epochs=1)
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["use_zero_redundancy"] = \
        True
    with caplog.at_level(logging.WARNING):
        run_training(cfg, datasets=splits, device="cpu",
                     pipeline_devices=CPU4[:S])
    assert any("pipeline_data_shards=1" in r.getMessage()
               for r in caplog.records)
