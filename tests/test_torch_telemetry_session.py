"""The port's training telemetry against the JAX package's on the CPU:
the session (telemetry/session.py) through run_training (the JSONL
events, their data keys and counts, the losses, the metric names of
metrics.prom), the MFU arithmetic (telemetry/mfu.py), the FLOP probe
(train/train_step.step_cost_flops) against the closed form of a small
PNA's dense products, the registry and recorder put back after
`finalize` (also when training raises), and the `Profile` section and
`device_trace` tracing exactly their target epoch.

Bounds: counts and keys bitwise; losses within rtol 1e-4 / atol 1e-5
(tests/test_torch_train.py's TRAIN_TOL). The achieved FLOP/s and the
wall-clock timings are not held between the packages: the port counts
matrix-product FLOPs, JAX XLA's cost analysis (which counts elementwise
work too), and `jit_recompiles` counts XLA compilations in JAX and CUDA
graph captures in the port (none on the CPU).
"""
import copy
import glob
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.telemetry import mfu as jmfu
from hydragnn_tpu.telemetry import registry as jregistry
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.models.layers import Dense
from hydragnn_tpu_torch.telemetry import mfu as tmfu
from hydragnn_tpu_torch.telemetry import registry as tregistry
from hydragnn_tpu_torch.telemetry import spans as tspans
from hydragnn_tpu_torch.telemetry.session import (TelemetryConfig,
                                                  start_session)
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import train_step as tstep
from hydragnn_tpu_torch.utils.weights import load_jax_variables
from tests.test_torch_train import (TRAIN_TOL, numpy_tree, to_jax_samples)
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

TEL_ENVS = ("HYDRAGNN_TELEMETRY", "HYDRAGNN_TELEMETRY_DIR",
            "HYDRAGNN_DEVICE_TRACE", "HYDRAGNN_DEVICE_TRACE_EPOCH",
            "HYDRAGNN_PRECISION", "HYDRAGNN_STEPS_PER_CALL",
            "HYDRAGNN_PACKING")


@pytest.fixture
def clean(monkeypatch, tmp_path):
    for name in TEL_ENVS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HYDRAGNN_DISABLE_TB", "1")
    monkeypatch.chdir(tmp_path)
    # fresh process registries, so no earlier test's counters are seeded
    # into either session
    jprev = jregistry.set_registry(jregistry.MetricsRegistry())
    tprev = tregistry.set_registry(tregistry.MetricsRegistry())
    yield monkeypatch
    jregistry.set_registry(jprev)
    tregistry.set_registry(tprev)


def _config(num_epoch=2, **training):
    cfg = make_config("PNA")
    cfg["NeuralNetwork"]["Training"].update(
        num_epoch=num_epoch, batch_size=4, EarlyStopping=False,
        Optimizer={"type": "SGD", "learning_rate": 0.01}, **training)
    return cfg


def _splits():
    s = synthetic_molecules(20, seed=4, min_atoms=3, max_atoms=7,
                            num_features=1)
    return s[:12], s[12:16], s[16:]


def _read_artifacts(out_dir):
    with open(os.path.join(out_dir, "telemetry.jsonl")) as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(out_dir, "metrics.prom")) as f:
        prom = f.read()
    names = sorted(line.split()[2] for line in prom.splitlines()
                   if line.startswith("# TYPE"))
    return events, trace, names


def test_run_training_session_matches_jax(clean, tmp_path):
    """A 2-epoch CPU run_training with Training.Telemetry.enabled in
    both packages, from the same Flax variables on the same samples:
    telemetry.jsonl, trace.json and metrics.prom in <run dir>/telemetry;
    the same event kinds and names in the same order, the same `data`
    and `timing` keys, the counts bitwise and the losses within
    TRAIN_TOL; the same metric names; achieved FLOP/s reported and mfu
    absent (the CPU), in the JSONL and the history."""
    cfg = _config(Telemetry={"enabled": True})
    splits = _splits()
    jrun = importlib.import_module("hydragnn_tpu.run_training")
    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    inits = []

    def spy_init(*args, **kwargs):
        inits.append(numpy_tree(j_init_params(*args, **kwargs)))
        return jax.tree_util.tree_map(jnp.asarray, inits[-1])
    clean.setattr(jrun, "init_params", spy_init)
    os.makedirs("jax")
    os.chdir("jax")
    _, jhist, _, _ = jrun.run_training(
        copy.deepcopy(cfg), datasets=tuple(to_jax_samples(s)
                                           for s in splits), num_shards=1)
    os.chdir(tmp_path)

    def port_model(mcfg, device="cuda", seed=0):
        model = create_model(mcfg, device=device, seed=seed)
        model.load_state_dict(load_jax_variables(inits[0]))
        return model
    clean.setattr(prun, "create_model", port_model)
    os.makedirs("port")
    os.chdir("port")
    reg, rec = tregistry.get_registry(), tspans.current_recorder()
    _, hist, _, done = prun.run_training(copy.deepcopy(cfg),
                                         datasets=splits, device="cpu")
    assert tregistry.get_registry() is reg
    assert tspans.current_recorder() is rec
    run_dir = os.path.join("logs", tcfg.get_log_name_config(done),
                           "telemetry")
    events, trace, names = _read_artifacts(run_dir)
    jevents, jtrace, jnames = _read_artifacts(
        os.path.join(tmp_path, "jax", run_dir))

    assert [(e["kind"], e["name"]) for e in events] == \
        [(e["kind"], e["name"]) for e in jevents]
    assert names == jnames
    for e, je in zip(events, jevents):
        assert set(e.get("data", {})) == set(je.get("data", {})), e["name"]
        assert set(e.get("timing", {})) == set(je.get("timing", {}))
        if e["kind"] != "epoch":
            continue
        for k, v in je["data"].items():
            if k.endswith("_loss") or k == "lr":
                np.testing.assert_allclose(e["data"][k], v, **TRAIN_TOL)
            elif k != "jit_recompiles":
                assert e["data"][k] == v, k
        assert "mfu" not in e["timing"]
        assert e["timing"]["achieved_flops_per_s"] > 0
    for key in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], **TRAIN_TOL)
    assert len(hist["achieved_flops_per_s"]) == 2 and "mfu" not in hist
    spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"train_epoch", "validate", "test", "dataload_wait",
            "step_dispatch"} <= spans
    assert {e["name"] for e in jtrace["traceEvents"]
            if e.get("ph") == "X"} >= {"train_epoch", "dataload_wait"}


MFU_CASES = [(1e9, 10, 2.0), (3.5e7, 1, 0.01), (None, 10, 1.0),
             (1e9, 0, 1.0), (1e9, 5, 0.0)]


@pytest.mark.parametrize("flops,steps,wall", MFU_CASES)
def test_achieved_and_mfu_matches_jax_on_the_cpu(flops, steps, wall):
    """On the CPU both report the achieved rate (the same float) and no
    mfu; unusable inputs give (None, None) in both."""
    for dtype in ("float32", "bfloat16"):
        got = tmfu.achieved_and_mfu(flops, steps, wall, "cpu", "cpu", dtype)
        want = jmfu.achieved_and_mfu(flops, steps, wall, "cpu", "cpu", dtype)
        assert got == want
        assert got[1] is None


def test_mfu_peaks_of_the_card_and_an_unknown_kind(caplog):
    """The H100 row: bf16 tensor-core and float32 CUDA-core peaks; an
    override taken as it is; an unknown card reports the achieved rate
    with mfu None (never a TPU's peak) and logs its name once."""
    kind = "NVIDIA H100 80GB HBM3"
    a, m = tmfu.achieved_and_mfu(6.69e12, 10, 1.0, "cuda", kind)
    assert a == 6.69e13 and m == pytest.approx(1.0)
    a, m = tmfu.achieved_and_mfu(9.894e12, 1, 1.0, "cuda", kind, "bf16")
    assert m == pytest.approx(0.01)
    assert tmfu.peak_flops(kind, "bfloat16", 2e12) == 2e12
    with caplog.at_level("WARNING"):
        for _ in range(3):
            a, m = tmfu.achieved_and_mfu(1e12, 1, 1.0, "cuda", "Some GPU")
            assert a == 1e12 and m is None
    assert sum("Some GPU" in r.getMessage() for r in caplog.records) == 1


def _small_pna_step(dense):
    samples = synthetic_molecules(16, seed=5, min_atoms=3, max_atoms=9,
                                  num_features=3)
    cfg = make_config("PNA", hidden_dim=8, num_conv_layers=2)
    cfg["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = \
        [0, 1, 2]
    mcfg = tcfg.build_model_config(tcfg.update_config(cfg, samples))
    model = create_model(mcfg, device="cpu")
    tx = topt.select_optimizer({"Optimizer": {"type": "AdamW",
                                              "learning_rate": 0.01}})
    state = tstep.TrainState.create(model, tx)
    step = tstep.make_train_step(model, mcfg, tx, "mse")
    batch = next(iter(GraphDataLoader(samples, 8, neighbor_format=dense)))
    return model, state, step, batch


def _closed_form(model, batch, step):
    """Sum over every Dense call of the forward's and the backward's
    products: 2 M K N for the forward and for the weight's gradient, and
    again for the input's gradient where the input needs one."""
    calls = []

    def hook(mod, inp, out):
        x = inp[0]
        m = x.numel() // x.shape[-1]
        calls.append((m, mod.in_features, mod.out_features,
                      x.requires_grad))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Dense)]
    try:
        model.train()
        total, _ = step.steps.body.loss_fn(batch)
        torch.autograd.grad(total, [p for p in model.parameters()],
                            allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    return float(sum(2 * m * k * n * (3 if needs else 2)
                     for m, k, n, needs in calls))


@pytest.mark.parametrize("dense", [True, False])
def test_flop_probe_is_the_closed_form_and_leaves_the_run_alone(dense):
    """step_cost_flops on a small PNA (hidden 8, 2 layers, batch 8) is
    the closed form of its dense products, on both layouts, and leaves
    the parameters, BatchNorm statistics, optimizer state, step, mode
    and RNG as they were; the next optimizer step is bitwise the one
    without the probe. JAX's XLA count of the same step is printed
    beside it (a different definition: XLA counts elementwise work
    too)."""
    model, state, step, batch = _small_pna_step(dense)
    model.eval()
    before = state.copy()
    rng = torch.get_rng_state()
    flops = tstep.step_cost_flops(step, batch)
    assert not model.training
    assert torch.equal(torch.get_rng_state(), rng)
    for live, snap in ((state.params, before.params),
                       (state.batch_stats, before.batch_stats)):
        for k in live:
            assert torch.equal(live[k], snap[k]), k
    assert state.step == 0 and all(p.grad is None
                                   for p in model.parameters())
    model_b, state_b, step_b, _ = _small_pna_step(dense)
    model_b.load_state_dict(model.state_dict())
    _, m_a = step(state, batch)
    _, m_b = step_b(state_b, batch)
    assert torch.equal(m_a["loss"], m_b["loss"])
    for k in state.params:
        assert torch.equal(state.params[k], state_b.params[k]), k
    model_c, _, step_c, batch_c = _small_pna_step(dense)
    assert flops == _closed_form(model_c, batch_c, step_c) > 0
    print(f"\nstep_cost_flops (dense={dense}): {flops:.0f}")


def test_finalize_restores_registry_and_recorder_on_an_exception(clean,
                                                                 monkeypatch):
    """finalize() puts the process registry and span recorder back and
    is idempotent; run_training finalizes its session, writing the three
    artifacts, when training raises."""
    reg, rec = tregistry.get_registry(), tspans.current_recorder()
    session = start_session(TelemetryConfig(enabled=True), "run")
    assert tregistry.get_registry() is session.registry
    assert tspans.current_recorder() is session.recorder
    paths = session.finalize()
    assert session.finalize() == {}
    assert tregistry.get_registry() is reg
    assert tspans.current_recorder() is rec
    assert all(os.path.isfile(p) for p in paths.values())
    assert start_session(TelemetryConfig(), "run") is None

    prun = importlib.import_module("hydragnn_tpu_torch.run_training")
    from hydragnn_tpu_torch.train import trainer

    def boom(*a, **kw):
        raise RuntimeError("training failed")
    monkeypatch.setattr(trainer, "train_validate_test", boom)
    cfg = _config(Telemetry={"enabled": True, "dir": "tel"})
    with pytest.raises(RuntimeError, match="training failed"):
        prun.run_training(cfg, datasets=_splits(), device="cpu")
    assert tregistry.get_registry() is reg
    assert tspans.current_recorder() is rec
    events, _, _ = _read_artifacts("tel")
    assert [e["name"] for e in events] == ["start", "end"]


@pytest.mark.parametrize("how", ["profile", "device_trace", "env"])
def test_device_trace_covers_exactly_the_target_epoch(clean, how):
    """The `Profile` section and `device_trace` (block or env) write one
    torch.profiler trace, of the target epoch's train pass: its step
    spans are that epoch's, none of the others'."""
    from hydragnn_tpu_torch import run_training
    cfg = _config(num_epoch=3)
    if how == "profile":
        cfg["Profile"] = {"enable": 1, "target_epoch": 1}
    elif how == "device_trace":
        cfg["NeuralNetwork"]["Training"]["Telemetry"] = {
            "device_trace": True, "device_trace_epoch": 1, "dir": "tel"}
    else:
        clean.setenv("HYDRAGNN_DEVICE_TRACE", "1")
        clean.setenv("HYDRAGNN_DEVICE_TRACE_EPOCH", "1")
        clean.setenv("HYDRAGNN_TELEMETRY_DIR", "tel")
    traced = []
    real_enter = tspans.EpochDeviceTrace.__enter__

    def spy(self):
        out = real_enter(self)
        if self._prof is not None:
            traced.append(self.current_epoch)
        return out
    clean.setattr(tspans.EpochDeviceTrace, "__enter__", spy)
    _, hist, _, done = run_training(cfg, datasets=_splits(), device="cpu")
    where = (os.path.join("logs", tcfg.get_log_name_config(done), "profile")
             if how == "profile" else os.path.join("tel", "profile"))
    files = glob.glob(os.path.join(where, "*.json"))
    assert traced == [1] and len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    # the train pass's products are in it: 3 steps of 4 graphs
    assert sum(e.get("name") == "aten::addmm"
               for e in trace["traceEvents"]) > 0
    assert len(hist["train_loss"]) == 3


@pytest.mark.parametrize("dense", [True, False])
def test_xla_count_of_the_same_step_beside_the_probe(dense):
    """The JAX package's MFU numerator (XLA's cost analysis of the
    compiled train step) on the same small PNA step, printed beside the
    port's probe. Not held equal: XLA counts elementwise work as well as
    the products, so its count is the larger."""
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.models.create import create_model as j_create_model
    from hydragnn_tpu.train import optimizer as jopt
    from hydragnn_tpu.train import train_step as jstep
    from tests.test_torch_train import _jax_view, jax_batch
    model, _, step, batch = _small_pna_step(dense)
    flops = tstep.step_cost_flops(step, batch)
    samples = synthetic_molecules(16, seed=5, min_atoms=3, max_atoms=9,
                                  num_features=3)
    cfg = make_config("PNA", hidden_dim=8, num_conv_layers=2)
    cfg["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = \
        [0, 1, 2]
    jm = jcfg.build_model_config(jcfg.update_config(
        cfg, to_jax_samples(samples)))
    jmodel = j_create_model(jm)
    jb = jax_batch(_jax_view(batch))
    tx = jopt.select_optimizer({"Optimizer": {"type": "AdamW",
                                              "learning_rate": 0.01}})
    jstate = jstep.TrainState.create(j_init_params(jmodel, jb), tx)
    train = jstep.make_train_step(jmodel, jm, tx, "mse", donate=False)
    xla = jstep.step_cost_flops(train, jstate, jb)
    print(f"\nPNA hidden 8, 2 layers, batch 8 (dense={dense}): port "
          f"matmul FLOPs {flops:.0f}, JAX XLA cost analysis {xla:.0f}")
    assert xla is not None and xla > flops > 0
