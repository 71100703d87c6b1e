"""The port's elastic job supervision (hydragnn_tpu_torch/elastic/)
against the JAX package's (hydragnn_tpu/elastic/) on the CPU.

* The supervisor: every scenario of tests/test_elastic.py's fast lane
  (rank death, rank hang, spawn failure, the coordinated abort, the
  world schedule and its validation, the restart budget, shutdown from
  another thread, the deadline), with the same fake ranks and fault
  plans, driven through both supervisors: their `ledger.data_view()`,
  their job records (timing left out) and their launch logs are equal.
* The child env: every key of JAX's contract but JAX_PLATFORMS and
  XLA_FLAGS, which the port does not set.
* A real job of child ranks: W = 2 gloo ranks on the CPU lose rank 1 at
  its first commit (`rank-kill@1`) and restart at W' = 1
  (`world_schedule=[2, 1]`), one process stacking both data shards;
  against an uninterrupted W = 2 twin the final step and the history
  lengths are equal, every generation logs one plan_fp, the JAX
  package's for the same data, the history and param_norm agree within
  JAX's pinned cross-world bound rtol 5e-4, and no process group
  survives.
* run_training's stacked data shards (`data_devices`), packed, against
  the JAX package's single-process two-device run.
"""
import copy
import glob
import importlib
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import hydragnn_tpu.elastic as jel
import hydragnn_tpu.elastic.process as jproc
import hydragnn_tpu.utils.faults as jfaults
from hydragnn_tpu.telemetry.registry import get_registry as j_registry
import hydragnn_tpu_torch.elastic as tel
import hydragnn_tpu_torch.elastic.process as tproc
import hydragnn_tpu_torch.utils.faults as tfaults
from hydragnn_tpu_torch.telemetry.registry import get_registry as t_registry

torch.set_num_threads(1)

PACKAGES = {
    "jax": types.SimpleNamespace(el=jel, faults=jfaults,
                                 registry=j_registry),
    "torch": types.SimpleNamespace(el=tel, faults=tfaults,
                                   registry=t_registry),
}
CROSS_WORLD_RTOL = 5e-4     # tests/test_elastic.py:490-497


@pytest.fixture(autouse=True)
def _clean_plan():
    for pkg in PACKAGES.values():
        pkg.faults.install_fault_plan(None)
    yield
    for pkg in PACKAGES.values():
        pkg.faults.install_fault_plan(None)


class _Job:
    """Simulated shared on-disk job state."""

    def __init__(self):
        self.committed = None
        self.result = None


def _classes(pkg):
    """tests/test_elastic.py's fake rank and launcher on `pkg`'s
    RankHandle."""

    class FakeHandle(pkg.el.RankHandle):
        def __init__(self, job, rank, mode="ok", polls=5, crash_at=None):
            self.job, self.rank, self.mode = job, rank, mode
            self.polls, self.crash_at = polls, crash_at
            self.killed = False
            self.n = 0

        def poll(self):
            if self.killed:
                return -9
            if self.mode == "hang":
                return None
            self.n += 1
            if self.rank == 0:
                self.job.committed = (self.job.committed or 0) + 1
            if self.crash_at is not None and self.n >= self.crash_at:
                return 7
            if self.n >= self.polls:
                if self.rank == 0:
                    self.job.result = {"objective": 0.5,
                                       "step": self.job.committed}
                return 0
            return None

        def kill(self):
            self.killed = True

        def progress(self):
            if self.mode == "hang":
                return ("frozen",)
            return (self.job.committed, self.n)

        def checkpoint_step(self):
            return self.job.committed

        def result(self):
            return self.job.result if self.rank == 0 else None

    class Launcher:
        def __init__(self, crash=None, polls=5, handle=FakeHandle):
            self.job = _Job()
            self.crash = crash or {}
            self.polls = polls
            self.handle = handle
            self.launches = []
            self.handles = []

        def __call__(self, gen, world, rank, resume, hang):
            self.launches.append((gen, world, rank, resume, hang))
            h = self.handle(self.job, rank, mode="hang" if hang else "ok",
                            polls=self.polls,
                            crash_at=self.crash.get((gen, rank)))
            self.handles.append(h)
            return h

    class NoResult(FakeHandle):
        def result(self):
            return None

    class Forever(FakeHandle):
        def poll(self):
            if self.killed:
                return -9
            self.n += 1
            return None

    return types.SimpleNamespace(Launcher=Launcher, NoResult=NoResult,
                                 Forever=Forever)


def _plan(pkg, spec):
    pkg.faults.install_fault_plan(pkg.faults.parse_fault_plan(spec))


def _sup(pkg, la, **kw):
    kw.setdefault("poll_interval_s", 0.002)
    return pkg.el.JobSupervisor(la, **kw)


# each scenario: pkg -> (supervisor, record, launcher); the JAX test's own
# assertions run on both packages' results

def sc_happy(pkg):
    la = _classes(pkg).Launcher()
    sup = _sup(pkg, la, world_size=3)
    rec = sup.run(deadline_s=20)
    assert rec.state == pkg.el.COMPLETED and rec.world_sizes == [3]
    return sup, rec, la


def sc_rank_death(pkg):
    la = _classes(pkg).Launcher(crash={(0, 1): 2})
    sup = _sup(pkg, la, world_size=3, max_restarts=2, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert rec.restarts == 1 and all(h.killed for h in la.handles[:3])
    return sup, rec, la


def sc_injected_kill(pkg):
    _plan(pkg, "rank-kill@1")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=2, max_restarts=2, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    killed = [e for e in sup.ledger.data_view() if e["event"] == "killed"]
    assert len(killed) == 1 and killed[0]["data"]["committed_step"] >= 1
    return sup, rec, la


def sc_injected_hang(pkg):
    _plan(pkg, "rank-hang@1")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=2, max_restarts=1, heartbeat_s=0.05,
               backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    abort = [e for e in sup.ledger.data_view() if e["event"] == "abort"][0]
    assert abort["data"]["reason"] == "hang"
    return sup, rec, la


def sc_spawn_fail(pkg):
    _plan(pkg, "rank-spawn-fail@1")
    la = _classes(pkg).Launcher()
    sup = _sup(pkg, la, world_size=3, max_restarts=1, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert la.handles[0].killed
    return sup, rec, la


def sc_world_schedule(pkg):
    _plan(pkg, "rank-kill@1")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=4, world_schedule=[4, 2],
               max_restarts=2, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert rec.world_sizes == [4, 2]
    return sup, rec, la


def sc_restarts_exhausted(pkg):
    _plan(pkg, "rank-kill@1,3")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=2, max_restarts=1, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert rec.state == pkg.el.FAILED
    return sup, rec, la


def sc_site_indices(pkg):
    _plan(pkg, "rank-kill@1;rank-hang@2")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=2, max_restarts=3, heartbeat_s=0.05,
               backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert (1, 2, 0, True, True) in la.launches
    return sup, rec, la


def sc_exit_zero_no_result(pkg):
    c = _classes(pkg)
    la = c.Launcher(polls=2, handle=c.NoResult)
    sup = _sup(pkg, la, world_size=2, max_restarts=0, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert "exit-0-without-result" in rec.outcome_reason
    return sup, rec, la


def sc_shutdown_thread(pkg):
    c = _classes(pkg)
    la = c.Launcher(handle=c.Forever)
    sup = _sup(pkg, la, world_size=2)
    t = threading.Timer(0.1, sup.shutdown)
    t.start()
    rec = sup.run(deadline_s=20)
    t.cancel()
    assert rec.outcome_reason == "shutdown"
    assert all(h.killed for h in la.handles)
    return sup, rec, la


def sc_deadline(pkg):
    c = _classes(pkg)
    la = c.Launcher(handle=c.Forever)
    sup = _sup(pkg, la, world_size=2)
    rec = sup.run(deadline_s=0.1)
    assert rec.outcome_reason == "deadline"
    return sup, rec, la


def sc_chaos_schedule(pkg):
    _plan(pkg, "rank-kill@1;rank-hang@2")
    la = _classes(pkg).Launcher(polls=8)
    sup = _sup(pkg, la, world_size=2, world_schedule=[2, 2, 1],
               max_restarts=3, heartbeat_s=0.05, backoff_s=0.0)
    rec = sup.run(deadline_s=20)
    assert rec.state == pkg.el.COMPLETED
    return sup, rec, la


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_happy, sc_rank_death, sc_injected_kill, sc_injected_hang,
    sc_spawn_fail, sc_world_schedule, sc_restarts_exhausted,
    sc_site_indices, sc_exit_zero_no_result, sc_shutdown_thread,
    sc_deadline, sc_chaos_schedule)}


def _record(rec):
    return {k: v for k, v in vars(rec).items() if k != "duration_s"}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_job_supervisor_scenario_matches_jax(name):
    got = {}
    for key, pkg in PACKAGES.items():
        sup, rec, la = SCENARIOS[name](pkg)
        pkg.faults.install_fault_plan(None)
        got[key] = (sup.ledger.data_view(), _record(rec), la.launches,
                    [h.killed for h in la.handles])
    for i in range(4):
        assert got["torch"][i] == got["jax"][i], i


def test_world_schedule_validation_as_in_jax():
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="world_schedule"):
            pkg.el.JobSupervisor(lambda *a: None, world_size=2,
                                 world_schedule=[2, 0])
        with pytest.raises(ValueError, match="generation 0"):
            pkg.el.JobSupervisor(lambda *a: None, world_size=4,
                                 world_schedule=[2, 2])


def test_job_ledger_order_as_in_jax(tmp_path):
    outs = {}
    for key, pkg in PACKAGES.items():
        led = pkg.el.JobLedger()
        led.event(2, "b")
        led.event(pkg.el.JOB, "a", timing={"t": 1.0})
        led.event(2, "c")
        led.event(0, "d")
        assert led.write(str(tmp_path / key)) == 4
        outs[key] = ((tmp_path / key).read_text(), led.data_view())
    assert outs["torch"] == outs["jax"]


def test_job_supervisor_counters_as_in_jax():
    deltas = {}
    names = ("elastic.rank_failures_total", "elastic.restarts_total",
             "elastic.jobs_total")
    for key, pkg in PACKAGES.items():
        reg = pkg.registry()
        before = reg.snapshot()
        _plan(pkg, "rank-kill@1")
        la = _classes(pkg).Launcher(polls=8)
        _sup(pkg, la, world_size=2, world_schedule=[2, 1], max_restarts=2,
             backoff_s=0.0).run(deadline_s=20)
        pkg.faults.install_fault_plan(None)
        after = reg.snapshot()
        d = {}
        for n in names:
            for lab, v in after[n]["values"].items():
                d[(n, lab)] = v - before.get(n, {"values": {}})[
                    "values"].get(lab, 0)
        d["world_size"] = after["elastic.world_size"]["values"]
        d["generations"] = after["elastic.generations_total"]["values"]
        deltas[key] = d
    assert deltas["torch"] == deltas["jax"]


# ------------------------------------------------------------ child env

def test_child_env_keeps_jax_contract_but_the_xla_keys(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FAULT_PLAN", "rank-kill@0")
    monkeypatch.setenv("HYDRAGNN_MASTER_PORT", "1")
    for world in (4, 1):
        want = jproc._child_env(rank=2 % world, world_size=world,
                                devices_per_rank=4 // world,
                                coord_port=12345, rendezvous_timeout_s=60.0,
                                extra={"X_EXTRA": "1"})
        got = tproc._child_env(rank=2 % world, world_size=world,
                               coord_port=12345, rendezvous_timeout_s=60.0,
                               extra={"X_EXTRA": "1"})
        for key in ("JAX_PLATFORMS", "XLA_FLAGS"):
            want.pop(key, None)
            got.pop(key, None)
        assert got == want
        assert got["HYDRAGNN_FAULT_PLAN"] == ""
        assert got["HYDRAGNN_RENDEZVOUS_TIMEOUT_S"] == "60"
        assert ("SLURM_PROCID" in got) == (world > 1)


def test_launcher_requires_divisible_world_and_runs_the_port(tmp_path):
    for mod in (jproc, tproc):
        la = mod.RankProcessLauncher(str(tmp_path), total_shards=4)
        with pytest.raises(ValueError, match="total_shards"):
            la(0, 3, 0, False, False)
    la = tproc.RankProcessLauncher(str(tmp_path), total_shards=2,
                                   num_epochs=3, num_configs=16)
    argv = la.child_argv(2, 1, True, True)
    assert argv[1:3] == ["-m", "hydragnn_tpu_torch.elastic.runner"]
    assert argv[3:] == ["--rank", "1", "--world", "2", "--total-shards",
                        "2", "--num-epochs", "3", "--num-configs", "16",
                        "--data-seed", "0", "--batch-size", "8",
                        "--device", "cuda", "--resume",
                        "--hang-after-epoch", "1"]
    assert tproc.free_port() > 0


# ----------------------------------------------------------- real jobs

def _plan_fps(job_dir):
    fps = []
    for path in sorted(glob.glob(os.path.join(job_dir, "rank_*.log"))):
        with open(path) as f:
            for line in f:
                if "plan_fp=" in line:
                    fps.append(line.split("plan_fp=")[1].split()[0])
    return fps


def _jax_plan_fp(num_configs, batch_size, total_shards):
    """The JAX package's global plan fingerprint for the elastic job's
    data (its runner's dataset and split, its loader)."""
    from hydragnn_tpu.hpo.runner import synthetic_dataset
    from hydragnn_tpu.preprocess.load_data import (create_dataloaders,
                                                   split_dataset)
    tr, va, te = split_dataset(synthetic_dataset(num_configs, seed=0), 0.7)
    ld = create_dataloaders(tr, va, te, batch_size // total_shards,
                            packing=True, pack_nproc=total_shards,
                            async_workers=0)[0]
    return ld.global_plan_fingerprint()


def test_elastic_job_kill_shrink_matches_twin(tmp_path):
    kwargs = dict(total_shards=2, num_epochs=4, num_configs=16,
                  batch_size=8, rendezvous_timeout_s=60.0, device="cpu",
                  extra_env={"OMP_NUM_THREADS": "1"})
    chaos_dir, twin_dir = str(tmp_path / "chaos"), str(tmp_path / "twin")
    tfaults.install_fault_plan(tfaults.parse_fault_plan("rank-kill@1"))
    la = tproc.RankProcessLauncher(chaos_dir, **kwargs)
    sup = tel.JobSupervisor(la, world_size=2, world_schedule=[2, 1],
                            max_restarts=2, heartbeat_s=60.0,
                            backoff_s=0.2, poll_interval_s=0.05)
    rec = sup.run(deadline_s=300)
    tfaults.install_fault_plan(None)
    assert rec.state == tel.COMPLETED, (rec, sup.ledger.data_view())
    assert rec.restarts >= 1 and rec.world_sizes == [2, 1]
    assert la.live_process_groups() == []
    killed = [e for e in sup.ledger.data_view() if e["event"] == "killed"]
    assert len(killed) == 1 and killed[0]["rank"] == 1
    killed_at = killed[0]["data"]["committed_step"]

    la2 = tproc.RankProcessLauncher(twin_dir, **kwargs)
    rec2 = tel.JobSupervisor(la2, world_size=2, max_restarts=0,
                             heartbeat_s=60.0,
                             poll_interval_s=0.05).run(deadline_s=300)
    assert rec2.state == tel.COMPLETED
    assert la2.live_process_groups() == []

    with open(os.path.join(chaos_dir, "result.json")) as f:
        chaos = json.load(f)
    with open(os.path.join(twin_dir, "result.json")) as f:
        twin = json.load(f)
    assert chaos["world_size"] == 1 and twin["world_size"] == 2
    assert chaos["final_step"] == twin["final_step"]
    # the W' = 1 generation trained steps of its own
    assert killed_at < chaos["final_step"], (killed_at, chaos)
    assert [len(v) for v in chaos["history"].values()] == \
        [len(v) for v in twin["history"].values()]
    fps = _plan_fps(chaos_dir)
    # both gen-0 ranks and the W' = 1 rank; one fingerprint, the twin's
    # and the JAX package's
    assert len(fps) >= 3 and len(set(fps)) == 1, fps
    assert set(_plan_fps(twin_dir)) == set(fps)
    assert fps[0] == _jax_plan_fp(16, 8, 2)
    rel = abs(chaos["param_norm"] - twin["param_norm"]) / \
        max(abs(twin["param_norm"]), 1e-12)
    assert rel < CROSS_WORLD_RTOL, (chaos["param_norm"], twin["param_norm"])
    for k in ("train_loss", "val_loss", "test_loss", "lr"):
        np.testing.assert_allclose(chaos["history"][k], twin["history"][k],
                                   rtol=CROSS_WORLD_RTOL, err_msg=k)


# ------------------------------------------------ stacked data shards

def test_stacked_data_shards_match_jax_two_devices(tmp_path, monkeypatch):
    """run_training with two data shards on one device (`data_devices`),
    packed, against the JAX package's run_training(num_shards=2) on two
    devices of its CPU mesh, SGD from the same weights: JAX's step sums
    the two shards' gradients (ROADMAP C9), so it runs at half the
    learning rate; the histories within rtol 1e-4 / atol 1e-5."""
    from hydragnn_tpu.hpo.runner import base_trial_config as j_config
    from hydragnn_tpu.hpo.runner import synthetic_dataset as j_data
    from hydragnn_tpu.preprocess.load_data import split_dataset as j_split
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.hpo.runner import synthetic_dataset
    from hydragnn_tpu_torch.preprocess.load_data import split_dataset
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    from tests.test_torch_train import TRAIN_TOL, numpy_tree

    jrt = importlib.import_module("hydragnn_tpu.run_training")
    trt = importlib.import_module("hydragnn_tpu_torch.run_training")
    cfg = j_config(3)
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(batch_packing=True, Checkpoint=False, batch_size=8,
              Optimizer={"type": "SGD", "learning_rate": 0.01})
    jcfg = copy.deepcopy(cfg)
    jcfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.005
    seen = {}
    j_init = jrt.init_params

    def init_params(*a, **k):
        seen["v"] = j_init(*a, **k)
        return seen["v"]
    monkeypatch.setattr(jrt, "init_params", init_params)
    monkeypatch.chdir(tmp_path)
    _, want, _, _ = jrt.run_training(
        jcfg, datasets=j_split(j_data(24, seed=0), 0.7), num_shards=2)
    variables = numpy_tree(seen["v"])
    create = trt.create_model

    def create_model(mcfg, device="cpu"):
        model = create(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        return model
    monkeypatch.setattr(trt, "create_model", create_model)
    _, got, _, _ = run_training(
        copy.deepcopy(cfg), datasets=split_dataset(synthetic_dataset(24), 0.7),
        device="cpu", num_shards=2, data_devices=["cpu", "cpu"])
    for k in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRAIN_TOL)
