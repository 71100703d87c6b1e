"""`run_training` with `Training.pipeline_stages` > 1 in the port (stages
on the CPU through `pipeline_devices`), against the JAX package's
`run_training` on the same splits and initial weights:

* a 4-layer GIN and a 4-layer SchNet over 2 stages x 4 microbatches, 3
  epochs, SGD: every epoch's train / val / test loss within rtol 1e-4 /
  atol 1e-5;
* freeze_conv_layers keeps the blocks, an mlp node head trains, an
  energy-force run trains, a checkpoint resumes bitwise, a `continue` of
  another layout raises, telemetry reports the schedule;
* the knobs and errors: every validation and opt-in error with JAX's
  message, `pipeline_data_shards > 1` without S x D stage devices refused
  with JAX's "exceeds device count" (the data axis trains:
  tests/test_torch_pipeline_data.py), graph_shards with pipeline_stages
  refused, too few stage devices refused.
"""
import copy
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.parallel import pipeline_trainer as jpt
from hydragnn_tpu.run_training import run_training as j_run_training
from hydragnn_tpu_torch import run_training
from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
from hydragnn_tpu_torch.train import trainer
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import TRAIN_TOL, to_port_samples
from tests.torch_pipeline_fixtures import lj_samples, ef_config
from tests.utils import make_config

torch.set_num_threads(1)
rt = importlib.import_module("hydragnn_tpu_torch.run_training")
CPU2 = ["cpu", "cpu"]
HISTORY_KEYS = ("train_loss", "val_loss", "test_loss")


def _splits(n=48, heads=("graph",)):
    jsamples = deterministic_graph_dataset(num_configs=n, heads=heads)
    k = int(n * 2 / 3)
    js = (jsamples[:k], jsamples[k:k + n // 6], jsamples[k + n // 6:])
    return tuple(to_port_samples(s) for s in js), js


def _cfg(model_type="GIN", heads=("graph",), epochs=3, **train):
    cfg = make_config(model_type, heads=heads, num_conv_layers=4)
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(pipeline_stages=2, pipeline_norm="layernorm",
              pipeline_microbatches=4, num_epoch=epochs, batch_size=8,
              EarlyStopping=False,
              Optimizer={"type": "SGD", "learning_rate": 0.01}, **train)
    return cfg


def _with_jax_init(monkeypatch):
    """Record the JAX run's initial pipelined parameters and load them
    into the port's model."""
    seen = {}
    init = jpt.init_pipeline_params

    def spy(*a, **k):
        seen["params"] = jax.tree_util.tree_map(np.asarray, init(*a, **k))
        return seen["params"]
    monkeypatch.setattr(jpt, "init_pipeline_params", spy)
    create = rt.create_pipeline_model

    def create_loaded(mcfg, devices, seed=0):
        model = create(mcfg, devices, seed)
        model.load_state_dict(load_jax_variables(
            {"params": seen["params"]}))
        return model
    monkeypatch.setattr(rt, "create_pipeline_model", create_loaded)
    return seen


@pytest.mark.parametrize("model_type", ["GIN", "SchNet"])
def test_run_training_matches_jax(tmp_path, monkeypatch, model_type):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    splits, jsplits = _splits()
    _with_jax_init(monkeypatch)
    _, want, jmodel, _ = j_run_training(_cfg(model_type), datasets=jsplits)
    assert jmodel is None
    state, got, model, completed = run_training(
        _cfg(model_type), datasets=splits, device="cpu",
        pipeline_devices=CPU2)
    assert model is None
    assert completed["NeuralNetwork"]["Training"]["pipeline_stages"] == 2
    for k in HISTORY_KEYS:
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRAIN_TOL)
    assert got["train_loss"][-1] < got["train_loss"][0]
    assert got["graph_captures"] == [0, 0, 0]   # the CPU captures none


def test_freeze_conv_layers_and_node_head(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits(heads=("graph", "node"))
    cfg = _cfg(heads=("graph", "node"))
    cfg["NeuralNetwork"]["Architecture"]["freeze_conv_layers"] = True
    cfg["NeuralNetwork"]["Training"]["Optimizer"] = {"type": "AdamW",
                                                     "learning_rate": 1e-2}
    seen = {}
    create = rt.create_pipeline_model

    def spy(mcfg, devices, seed=0):
        model = create(mcfg, devices, seed)
        seen["before"] = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        return model
    monkeypatch.setattr(rt, "create_pipeline_model", spy)
    state, hist, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                     pipeline_devices=CPU2)
    assert np.isfinite(hist["train_loss"]).all()
    assert "task_1" in hist and np.isfinite(hist["val_task_1"]).all()
    for k, v in state.params.items():
        if k.startswith("convs."):
            assert torch.equal(v, seen["before"][k]), k
    assert not torch.equal(state.params["heads.head_1.dense_0.weight"],
                           seen["before"]["heads.head_1.dense_0.weight"])


def test_energy_force_run_trains(tmp_path, monkeypatch):
    """Equivariant SchNet with compute_grad_energy through the stages
    (1f1b, full remat): finite energy and force losses that fall."""
    monkeypatch.chdir(tmp_path)
    samples = lj_samples(24)
    splits = (samples[:16], samples[16:20], samples[20:])
    cfg = ef_config()
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(pipeline_stages=2, pipeline_norm="layernorm",
              pipeline_microbatches=2, pipeline_remat=True, num_epoch=3,
              batch_size=4, EarlyStopping=False,
              Optimizer={"type": "AdamW", "learning_rate": 1e-3})
    _, hist, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                 pipeline_devices=CPU2)
    for k in ("train_loss", "energy_loss", "force_loss", "val_force_loss"):
        assert np.isfinite(hist[k]).all(), k
    assert hist["train_loss"][-1] < hist["train_loss"][0]


def test_checkpoint_resumes_bitwise(tmp_path, monkeypatch):
    """Saves every epoch, a fault in epoch 2, then `continue`: the
    uninterrupted run's history and parameters bit for bit."""
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits()
    twin, h_twin, _, _ = run_training(_cfg(), datasets=splits,
                                      device="cpu", pipeline_devices=CPU2)
    cfg = _cfg(Checkpoint=True, checkpoint_every_n_epochs=1)
    cut = copy.deepcopy(cfg)
    cut["NeuralNetwork"]["Training"]["fault_plan"] = "forward-step@6"
    from hydragnn_tpu_torch.utils.faults import InjectedFault
    with pytest.raises(InjectedFault):
        run_training(cut, datasets=splits, device="cpu",
                     pipeline_devices=CPU2)
    trainer.clear_preemption()
    cfg["NeuralNetwork"]["Training"]["continue"] = 1
    state, h_res, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                      pipeline_devices=CPU2)
    for k in HISTORY_KEYS + ("lr",):
        assert h_res[k] == h_twin[k], k
    for k, v in twin.params.items():
        assert torch.equal(v, state.params[k]), k
    # a sequential config cannot continue the pipelined run
    seq = copy.deepcopy(cfg)
    seq["NeuralNetwork"]["Training"]["pipeline_stages"] = 1
    with pytest.raises(ValueError, match="continue"):
        run_training(seq, datasets=splits, device="cpu")


def test_telemetry_reports_the_schedule(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits()
    cfg = _cfg(epochs=1)
    tel = str(tmp_path / "tel")
    cfg["NeuralNetwork"]["Training"]["Telemetry"] = {"enabled": True,
                                                     "dir": tel}
    _, history, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                    pipeline_devices=CPU2)
    events = [json.loads(line) for line in open(tel + "/telemetry.jsonl")]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert len(epochs) == 1
    data = epochs[0]["data"]
    assert data["pipeline_schedule"] == "1f1b"
    assert data["pipeline_stages"] == 2 and data["pipeline_microbatches"] == 4
    assert data["pipeline_bubble_frac"] == 1 / 5
    assert data["pipeline_train_bubble_frac"] == 1 - 8 / 12
    assert "achieved_flops_per_s" not in epochs[0]["timing"]
    assert "achieved_flops_per_s" not in history
    prom = open(tel + "/metrics.prom").read()
    assert "hydragnn_pipeline_bubble_frac" in prom
    assert "hydragnn_pipeline_train_bubble_frac" in prom
    trace = json.load(open(tel + "/trace.json"))
    idles = [ev for ev in trace["traceEvents"]
             if ev.get("name") == "pipe.stage_idle"]
    assert len(idles) == 2
    assert all(ev["cat"] == "pipeline-model" for ev in idles)
    assert {ev["args"]["stage"] for ev in idles} == {0, 1}


# ---------------------------------------------------- knobs and errors --
def _validate_both(mcfg_pair, *args, **kwargs):
    """The JAX check's message (with its 8 CPU devices) and the port's
    (with `device_count` stage devices)."""
    jm, tm = mcfg_pair
    count = kwargs.pop("device_count", 8)
    try:
        jpt.validate_pipeline_config(jm, *args, **kwargs)
        want = None
    except ValueError as exc:
        want = str(exc)
    try:
        tpt.validate_pipeline_config(tm, *args, device_count=count,
                                     **kwargs)
        got = None
    except ValueError as exc:
        got = str(exc)
    return got, want


def _mcfgs(model_type="GIN", layers=8, **arch):
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu_torch.config import config as tcfg
    jsamples = deterministic_graph_dataset(num_configs=8)
    cfg = make_config(model_type, num_conv_layers=layers, **arch)
    return (jcfg.build_model_config(jcfg.update_config(
                copy.deepcopy(cfg), jsamples)),
            tcfg.build_model_config(tcfg.update_config(
                copy.deepcopy(cfg), to_port_samples(jsamples))))


@pytest.mark.parametrize("case", [
    dict(args=(4, 24, 6), kw=dict(schedule="1f1b")),
    dict(args=(4, 24, 6), kw=dict(schedule="gpipe")),
    dict(args=(4, 24, 3), kw=dict(schedule="1f1b")),
    dict(args=(4, 32, 4), kw=dict(data_shards=4)),
    dict(args=(2, 12, 4), kw=dict(data_shards=2)),
    dict(args=(2, 16, 4), kw=dict(schedule="interleaved")),
    dict(args=(2, 16, 0), kw={}),
    dict(args=(2, 16, 1), kw={}),
    dict(args=(3, 24, 4), kw={}),
    dict(args=(2, 16, 4), kw=dict(data_shards=0)),
    dict(args=(4, 16, 4), kw=dict(device_count=2)),
])
def test_validation_errors_carry_jax_messages(case):
    kw = dict(case["kw"])
    count = kw.pop("device_count", 8)
    got, want = _validate_both(_mcfgs(), *case["args"], device_count=count,
                               **kw)
    if count != 8:
        # JAX counts its 8 CPU devices; the port its stage devices
        assert want is None and got == (
            "pipeline_stages=4 x pipeline_data_shards=1 exceeds device "
            "count 2")
    else:
        assert got == want


@pytest.mark.parametrize("model_type,arch", [
    ("GAT", {}), ("EGNN", {"equivariance": True})])
def test_model_refusals_carry_jax_messages(model_type, arch):
    got, want = _validate_both(_mcfgs(model_type, 4, **arch), 2, 16, 4)
    assert want is not None and got == want


def test_node_head_kind_refused_with_jax_message():
    jm, tm = _mcfgs(layers=4)
    import dataclasses
    heads_j = [dataclasses.replace(h, head_type="node", node_arch="conv")
               for h in jm.heads]
    heads_t = [dataclasses.replace(h, head_type="node", node_arch="conv")
               for h in tm.heads]
    got, want = _validate_both((dataclasses.replace(jm, heads=heads_j),
                                dataclasses.replace(tm, heads=heads_t)),
                               2, 16, 4)
    assert want is not None and got == want


@pytest.mark.parametrize("norm", [None, "batchnorm"])
def test_norm_optin_required(norm):
    cfg = {} if norm is None else {"pipeline_norm": norm}
    with pytest.raises(ValueError) as want:
        jpt.require_pipeline_norm_optin(cfg)
    with pytest.raises(ValueError) as got:
        tpt.require_pipeline_norm_optin(cfg)
    assert str(got.value) == str(want.value)


def test_run_training_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits(24)
    cfg = _cfg()
    cfg["NeuralNetwork"]["Training"]["pipeline_data_shards"] = 2
    with pytest.raises(ValueError, match="pipeline_stages=2 x "
                       "pipeline_data_shards=2 exceeds device count 2"):
        run_training(cfg, datasets=splits, device="cpu",
                     pipeline_devices=CPU2)
    cfg = _cfg()
    cfg["NeuralNetwork"]["Architecture"]["graph_shards"] = 2
    with pytest.raises(ValueError, match="cannot be combined"):
        run_training(cfg, datasets=splits, device="cpu",
                     pipeline_devices=CPU2)
    cfg = _cfg()
    del cfg["NeuralNetwork"]["Training"]["pipeline_norm"]
    with pytest.raises(ValueError, match="pipeline_norm"):
        run_training(cfg, datasets=splits, device="cpu",
                     pipeline_devices=CPU2)
    with pytest.raises(ValueError, match="exceeds device count 1"):
        run_training(_cfg(), datasets=splits, device="cpu",
                     pipeline_devices=["cpu"])
    with pytest.raises(ValueError, match="names 3 devices"):
        run_training(_cfg(), datasets=splits, device="cpu",
                     pipeline_devices=["cpu"] * 3)
    # without pipeline_devices the stages are the visible cards: none here
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="exceeds device count 0"):
            run_training(_cfg(), datasets=splits, device="cpu")


def test_zero_redundancy_warns_and_packing_falls_back(tmp_path, monkeypatch,
                                                      caplog, capsys):
    import logging
    monkeypatch.chdir(tmp_path)
    splits, _ = _splits(24)
    cfg = _cfg(epochs=1, batch_packing=True)
    cfg["NeuralNetwork"]["Training"]["Optimizer"]["use_zero_redundancy"] = 1
    cfg["Verbosity"] = {"level": 1}
    with caplog.at_level(logging.WARNING, logger="hydragnn_tpu_torch"):
        _, hist, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                     pipeline_devices=CPU2)
    assert any("use_zero_redundancy has no effect" in r.getMessage()
               for r in caplog.records)
    out = capsys.readouterr().out
    assert "falling back to fixed-shape batching" in out
    assert "pipeline: stages=2 microbatches=4 schedule=1f1b" in out
    assert np.isfinite(hist["train_loss"]).all()


def test_deep_stack_example_config_trains(tmp_path, monkeypatch):
    """The repo's deep-stack example (32-layer SchNet, 4 stages x 8
    microbatches, 1f1b, full remat) at its published width, one epoch
    on the CPU's 4 stage devices."""
    monkeypatch.chdir(tmp_path)
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "deep_stack", "deep_stack_32l.json")
    cfg = json.load(open(path))
    tr = cfg["NeuralNetwork"]["Training"]
    assert tr["pipeline_schedule"] == "1f1b" and tr["pipeline_remat"]
    tr["num_epoch"] = 1
    splits, _ = _splits()
    _, hist, _, _ = run_training(cfg, datasets=splits, device="cpu",
                                 pipeline_devices=["cpu"] * 4)
    assert np.isfinite(hist["train_loss"]).all()
