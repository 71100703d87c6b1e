"""The port's HPO trial supervision (hydragnn_tpu_torch/hpo/) against the
JAX package's (hydragnn_tpu/hpo/) on the CPU.

* The supervisor: every scenario of tests/test_hpo_supervisor.py's fast
  lane (the trial-kill / trial-hang / trial-spawn-fail sites, the retry
  budget, prune, shutdown, the deadline, PBT forks, the counters), with
  the same scripted fake handles and fault plans, driven through both
  supervisors: their `ledger.data_view()` and terminal records (timing
  left out) are equal. Where the JAX test prunes at a racing moment, the
  scenario waits for a deterministic one (the trial in its backoff).
* The process launcher: `committed_steps`, the child env, the process
  handle's kill / progress / group probe.
* The runner: `base_trial_config`, `apply_params` (its errors too) and
  `synthetic_dataset` bitwise JAX's; one `run_trial` epoch under SGD from
  JAX's initial weights within rtol 1e-5 of JAX's `run_trial`; and real
  child processes on the CPU under `trial-kill@0;trial-hang@1`, whose
  killed and hung trials write a result.json (history and param_digest)
  bitwise their uninterrupted twins'.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import hydragnn_tpu.hpo as jhpo
import hydragnn_tpu.hpo.process as jprocess
import hydragnn_tpu.hpo.runner as jrunner
import hydragnn_tpu.utils.faults as jfaults
from hydragnn_tpu.telemetry.registry import get_registry as j_registry
import hydragnn_tpu_torch.hpo as thpo
import hydragnn_tpu_torch.hpo.process as tprocess
import hydragnn_tpu_torch.hpo.runner as trunner
import hydragnn_tpu_torch.utils.faults as tfaults
from hydragnn_tpu_torch.telemetry.registry import get_registry as t_registry

torch.set_num_threads(1)

PACKAGES = {
    "jax": types.SimpleNamespace(hpo=jhpo, faults=jfaults,
                                 registry=j_registry),
    "torch": types.SimpleNamespace(hpo=thpo, faults=tfaults,
                                   registry=t_registry),
}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    for pkg in PACKAGES.values():
        pkg.faults.install_fault_plan(None)


def _fake_classes(pkg):
    """tests/test_hpo_supervisor.py's scripted handles, on `pkg`'s
    TrialHandle."""

    class FakeHandle(pkg.hpo.TrialHandle):
        def __init__(self, polls_to_exit=3, rc=0, objective=1.0, hang=False,
                     ckpt_at=1):
            self.n = 0
            self.polls_to_exit = polls_to_exit
            self.rc = rc
            self.objective = objective
            self.hang = hang
            self.ckpt_at = ckpt_at
            self.killed = False

        def poll(self):
            if self.killed:
                return -9
            self.n += 1
            if self.hang or self.n <= self.polls_to_exit:
                return None
            return self.rc

        def kill(self):
            self.killed = True

        def progress(self):
            return ("wedged",) if self.hang else (self.n,)

        def checkpoint_step(self):
            return self.n if self.n >= self.ckpt_at else None

        def result(self):
            if self.rc == 0 and not self.killed and not self.hang:
                return {"objective": self.objective}
            return None

    class NoResult(FakeHandle):
        def result(self):
            return None

    class Immortal(FakeHandle):
        def poll(self):
            self.n += 1
            return -9 if self.killed else None

        def progress(self):
            return (self.n,)

    return FakeHandle, NoResult, Immortal


def _make_launcher(Fake, log, **handle_kw):
    def launch(spec, attempt, resume, hang):
        log.append((spec.trial_id, attempt, resume, hang))
        return Fake(hang=hang, objective=float(spec.params.get("lr", 0.0)),
                    **handle_kw)
    return launch


def _sup(pkg, launch, trials, **kw):
    kw.setdefault("heartbeat_s", 0.15)
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("poll_interval_s", 0.01)
    return pkg.hpo.TrialSupervisor(launch, trials, **kw)


def _records(recs):
    """The terminal records without their wall-clock duration."""
    return {tid: {k: v for k, v in vars(r).items() if k != "duration_s"}
            for tid, r in recs.items()}


def _plan(pkg, spec):
    pkg.faults.install_fault_plan(pkg.faults.parse_fault_plan(spec))


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)


# each scenario: pkg -> (supervisor, records, launch log); the JAX test's
# own assertions run on both packages' results

def sc_all_terminal(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    trials = [pkg.hpo.TrialSpec(i, {"lr": 0.1 * (i + 1)}, seed=i)
              for i in range(3)]
    sup = _sup(pkg, _make_launcher(Fake, log), trials, concurrency=2)
    recs = sup.run(deadline_s=30)
    assert all(r.state == pkg.hpo.COMPLETED for r in recs.values())
    assert [recs[i].objective for i in range(3)] == \
        pytest.approx([0.1, 0.2, 0.3])
    return sup, recs, log


def sc_trial_kill(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    _plan(pkg, "trial-kill@1")
    trials = [pkg.hpo.TrialSpec(i, {"lr": 1.0}, seed=i) for i in range(2)]
    sup = _sup(pkg, _make_launcher(Fake, log), trials, concurrency=1,
               max_retries=2)
    recs = sup.run(deadline_s=30)
    assert recs[1].resumes == 1 and recs[1].preemptions == 1
    assert (1, 1, True, False) in log
    return sup, recs, log


def sc_trial_hang(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    _plan(pkg, "trial-hang@0")
    sup = _sup(pkg, _make_launcher(Fake, log),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})], max_retries=1)
    recs = sup.run(deadline_s=30)
    assert recs[0].state == pkg.hpo.COMPLETED
    assert log == [(0, 0, False, True), (0, 1, True, False)]
    return sup, recs, log


def sc_spawn_fail(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    _plan(pkg, "trial-spawn-fail@0")
    sup = _sup(pkg, _make_launcher(Fake, log),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})], max_retries=1)
    recs = sup.run(deadline_s=30)
    assert recs[0].attempts == 2 and recs[0].resumes == 0
    assert log == [(0, 1, False, False)]
    return sup, recs, log


def sc_launcher_raises(pkg):
    Fake, _, _ = _fake_classes(pkg)
    calls = []

    def flaky(spec, attempt, resume, hang):
        calls.append((spec.trial_id, attempt, resume, hang))
        if attempt == 0:
            raise OSError("scheduler rejected the job")
        return Fake(objective=2.0)

    sup = _sup(pkg, flaky, [pkg.hpo.TrialSpec(0, {"lr": 1.0})],
               max_retries=1)
    recs = sup.run(deadline_s=30)
    assert recs[0].state == pkg.hpo.COMPLETED and recs[0].attempts == 2
    return sup, recs, calls


def sc_retries_exhausted(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    sup = _sup(pkg, _make_launcher(Fake, log, rc=3),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})], max_retries=2)
    recs = sup.run(deadline_s=30)
    assert recs[0].state == pkg.hpo.FAILED and recs[0].attempts == 3
    return sup, recs, log


def sc_exit_zero_no_result(pkg):
    _, NoResult, _ = _fake_classes(pkg)
    log = []

    def launch(spec, attempt, resume, hang):
        log.append((spec.trial_id, attempt, resume, hang))
        return NoResult()

    sup = _sup(pkg, launch, [pkg.hpo.TrialSpec(0, {"lr": 1.0})],
               max_retries=1)
    recs = sup.run(deadline_s=30)
    assert "exit-0-without-result" in recs[0].outcome_reason
    return sup, recs, log


def sc_prune_running(pkg):
    Fake, _, _ = _fake_classes(pkg)
    handles = []

    def launch(spec, attempt, resume, hang):
        h = Fake(hang=True)
        handles.append(h)
        return h

    sup = _sup(pkg, launch, [pkg.hpo.TrialSpec(0, {"lr": 1.0})],
               heartbeat_s=30.0)
    done = {}
    t = threading.Thread(target=lambda: done.update(sup.run(deadline_s=30)))
    t.start()
    _wait(lambda: handles)
    sup.prune(0)
    t.join(timeout=10)
    assert not t.is_alive() and handles[0].killed
    assert done[0].state == pkg.hpo.PRUNED
    return sup, done, [len(handles)]


def sc_prune_before_launch(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    trials = [pkg.hpo.TrialSpec(0, {"lr": 1.0}),
              pkg.hpo.TrialSpec(1, {"lr": 2.0})]
    sup = _sup(pkg, _make_launcher(Fake, log), trials, concurrency=1)
    sup.prune(1)
    recs = sup.run(deadline_s=30)
    assert recs[1].state == pkg.hpo.PRUNED and recs[1].attempts == 0
    return sup, recs, log


def sc_prune_in_backoff(pkg):
    """JAX's test prunes as soon as the first launch is logged, a race
    between the prune and the crash; here the prune lands once the trial
    is in its backoff, so both packages see the same moment."""
    Fake, _, _ = _fake_classes(pkg)
    log = []
    sup = _sup(pkg, _make_launcher(Fake, log, rc=3),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})], max_retries=5,
               backoff_s=2.0)
    done = {}
    t = threading.Thread(target=lambda: done.update(sup.run(deadline_s=30)))
    t.start()
    _wait(lambda: sup.snapshot()[0].state == pkg.hpo.RESUMING)
    sup.prune(0)
    t.join(timeout=10)
    assert not t.is_alive()
    assert done[0].state == pkg.hpo.PRUNED and done[0].attempts == 1
    return sup, done, log


def sc_shutdown(pkg):
    Fake, _, _ = _fake_classes(pkg)
    handles = []

    def launch(spec, attempt, resume, hang):
        h = Fake(hang=True)
        handles.append(h)
        return h

    sup = _sup(pkg, launch, [pkg.hpo.TrialSpec(0, {"lr": 1.0})],
               heartbeat_s=30.0)
    t = threading.Thread(target=lambda: sup.run(deadline_s=30))
    t.start()
    _wait(lambda: handles)
    sup.shutdown()
    t.join(timeout=10)
    assert not t.is_alive() and handles[0].killed
    recs = sup.snapshot()
    assert recs[0].state == pkg.hpo.FAILED
    assert recs[0].outcome_reason == "shutdown"
    d1 = sup.snapshot()[0].duration_s
    time.sleep(0.05)
    assert sup.snapshot()[0].duration_s == d1
    return sup, recs, [len(handles)]


def sc_shutdown_before_run(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    sup = _sup(pkg, _make_launcher(Fake, log),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})])
    sup.shutdown()
    recs = sup.run(deadline_s=5)
    assert log == [] and recs[0].outcome_reason == "shutdown"
    return sup, recs, log


def sc_deadline(pkg):
    _, _, Immortal = _fake_classes(pkg)
    sup = _sup(pkg, lambda *a: Immortal(),
               [pkg.hpo.TrialSpec(0, {"lr": 1.0})])
    recs = sup.run(deadline_s=0.3)
    assert recs[0].state == pkg.hpo.FAILED
    assert recs[0].outcome_reason == "deadline"
    return sup, recs, []


def sc_chaos_concurrent(pkg):
    Fake, _, _ = _fake_classes(pkg)
    _plan(pkg, "trial-kill@1;trial-hang@2;trial-spawn-fail@3")
    trials = [pkg.hpo.TrialSpec(i, {"lr": 0.1 * (i + 1)}, seed=i)
              for i in range(4)]
    sup = _sup(pkg, _make_launcher(Fake, []), trials, concurrency=2,
               max_retries=2)
    recs = sup.run(deadline_s=30)
    events = {e["event"] for e in sup.ledger.data_view()}
    assert {"launched", "killed", "hung", "spawn-failed",
            "terminal"} <= events
    return sup, recs, []


def sc_fork(pkg):
    Fake, _, _ = _fake_classes(pkg)
    log = []
    space = {"lr": (0.001, 0.1), "width": [8, 16, 32]}
    trials = [pkg.hpo.TrialSpec(0, {"lr": 0.01, "width": 16}, seed=0)]
    sup = _sup(pkg, _make_launcher(Fake, log), trials)
    spec = sup.fork_trial(0, 7, space, donor_val=0.5)
    assert spec.forked_from == 0 and spec.fork_val == 0.5
    recs = sup.run(deadline_s=30)
    assert recs[7].state == pkg.hpo.COMPLETED
    return sup, recs, log + [("fork", spec.params)]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_all_terminal, sc_trial_kill, sc_trial_hang, sc_spawn_fail,
    sc_launcher_raises, sc_retries_exhausted, sc_exit_zero_no_result,
    sc_prune_running, sc_prune_before_launch, sc_prune_in_backoff,
    sc_shutdown, sc_shutdown_before_run, sc_deadline, sc_chaos_concurrent,
    sc_fork)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenario_matches_jax(name):
    got = {}
    for key, pkg in PACKAGES.items():
        sup, recs, log = SCENARIOS[name](pkg)
        pkg.faults.install_fault_plan(None)
        got[key] = (sup.ledger.data_view(), _records(recs), log)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]


def test_duplicate_trial_ids_rejected_as_in_jax():
    for pkg in PACKAGES.values():
        Fake, _, _ = _fake_classes(pkg)
        with pytest.raises(ValueError, match="duplicate trial ids"):
            pkg.hpo.TrialSupervisor(
                lambda *a: Fake(),
                [pkg.hpo.TrialSpec(0, {}), pkg.hpo.TrialSpec(0, {})])


def test_ledger_write_canonical_order_as_in_jax(tmp_path):
    outs = {}
    for key, pkg in PACKAGES.items():
        led = pkg.hpo.TrialLedger()
        led.event(1, "launched", data={"attempt": 0})
        led.event(0, "launched", data={"attempt": 0})
        led.event(1, "terminal", data={"state": "completed"},
                  timing={"duration_s": 1.0})
        path = tmp_path / f"{key}.jsonl"
        assert led.write(str(path)) == 3
        outs[key] = path.read_text()
    assert outs["torch"] == outs["jax"]


def test_supervisor_counters_as_in_jax():
    """The same counter and gauge names move by the same amounts."""
    deltas = {}
    names = ("hpo.trials_total", "hpo.preemptions_total",
             "hpo.resumes_total")
    for key, pkg in PACKAGES.items():
        reg = pkg.registry()
        before = reg.snapshot()
        Fake, _, _ = _fake_classes(pkg)
        _plan(pkg, "trial-kill@0")
        sup = _sup(pkg, _make_launcher(Fake, []),
                   [pkg.hpo.TrialSpec(0, {"lr": 1.0})], max_retries=1)
        sup.run(deadline_s=30)
        pkg.faults.install_fault_plan(None)
        after = reg.snapshot()
        d = {}
        for n in names:
            for lab, v in after[n]["values"].items():
                old = before.get(n, {"values": {}})["values"].get(lab, 0)
                d[(n, lab)] = v - old
        deltas[key] = d
        assert "hpo.trials_per_hour" in after
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"][("hpo.trials_total",
                            (("outcome", "completed"),))] == 1


# ------------------------------------------------------------ process.py

def _commit(run_dir, step, latest=True):
    d = os.path.join(run_dir, "checkpoint", f"step_{step}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "COMMITTED"), "w") as f:
        f.write(f"step_{step}")
    if latest:
        with open(os.path.join(run_dir, "checkpoint", "LATEST"), "w") as f:
            f.write(f"step_{step}")


def test_committed_steps_matches_jax(tmp_path):
    logs = tmp_path / "logs"
    _commit(str(logs / "run_a"), 3)
    _commit(str(logs / "run_a"), 12)
    os.makedirs(logs / "run_a" / "checkpoint" / "step_5")   # uncommitted
    _commit(str(logs / "run_b"), 7)
    _commit(str(logs / "_fork_donor"), 40)                  # a donor copy
    os.makedirs(logs / "run_a" / "checkpoint" / "step_x")
    want = jprocess.committed_steps(str(tmp_path))
    assert tprocess.committed_steps(str(tmp_path)) == want == [3, 7, 12]
    assert tprocess._committed_step_under(str(tmp_path)) == 12
    assert tprocess.committed_steps(str(tmp_path / "none")) == []
    # a save whose writer died after COMMITTED, before LATEST, counts as
    # committed (the progress probe, the chaos points), as in JAX
    _commit(str(logs / "run_a"), 20, latest=False)
    assert tprocess.committed_steps(str(tmp_path)) == \
        jprocess.committed_steps(str(tmp_path)) == [3, 7, 12, 20]
    assert tprocess._committed_step_under(str(tmp_path)) == 20


def test_restorable_steps_stop_at_latest(tmp_path):
    """A resume restores only committed saves at or before their dir's
    LATEST: a save killed between COMMITTED and LATEST is not one, and a
    trial killed inside its first save has nothing to resume from."""
    logs = tmp_path / "logs"
    _commit(str(logs / "run_a"), 3)
    _commit(str(logs / "run_a"), 12)
    _commit(str(logs / "run_a"), 20, latest=False)
    _commit(str(logs / "run_b"), 7, latest=False)
    _commit(str(logs / "_fork_donor"), 40)
    assert tprocess.committed_steps(str(tmp_path)) == [3, 7, 12, 20]
    assert tprocess.restorable_steps(str(tmp_path)) == [3, 12]
    assert trunner._has_own_checkpoint(str(tmp_path))
    only_b = tmp_path / "b"
    _commit(str(only_b / "logs" / "run_b"), 7, latest=False)
    _commit(str(only_b / "logs" / "_fork_donor"), 40)
    assert tprocess.committed_steps(str(only_b)) == [7]
    assert tprocess.restorable_steps(str(only_b)) == []
    assert not trunner._has_own_checkpoint(str(only_b))
    assert tprocess.restorable_steps(str(tmp_path / "none")) == []


def test_restore_skips_saves_past_latest(tmp_path):
    """load_existing_model restores the newest verified save LATEST
    covers; with a committed save past LATEST it takes LATEST's, and
    without LATEST it restores nothing."""
    from hydragnn_tpu_torch.utils import checkpoint as ck
    from tests.test_torch_checkpoint import _tiny_state
    run = "window"
    for step in (1, 2, 3):
        target = ck.save_model(_tiny_state(step, float(step)), run,
                               path=str(tmp_path))
    d = os.path.dirname(target)
    assert ck.restorable_steps(d) == [3, 2, 1]
    assert ck.load_existing_model(_tiny_state(), run,
                                  path=str(tmp_path)).step == 3
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_2")        # step 3's writer died before its LATEST
    assert ck.restorable_steps(d) == [2, 1]
    restored = ck.load_existing_model(_tiny_state(), run, path=str(tmp_path))
    assert restored.step == 2
    assert torch.equal(restored.params["weight"], 2.0 * torch.ones(2, 3))
    os.remove(os.path.join(d, "LATEST"))    # died inside its first save
    assert ck.restorable_steps(d) == []
    assert ck.load_existing_model(_tiny_state(), run,
                                  path=str(tmp_path)) is None


def test_child_env_contract_matches_jax(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_FAULT_PLAN", "trial-kill@0")
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    want = jprocess._child_env({"CUDA_VISIBLE_DEVICES": "1"})
    got = tprocess._child_env({"CUDA_VISIBLE_DEVICES": "1"})
    assert got == want
    assert got["HYDRAGNN_FAULT_PLAN"] == ""
    assert got["PYTHONPATH"] == REPO + os.pathsep + "/elsewhere"


def test_process_handle_kill_progress_and_group(tmp_path):
    log = tmp_path / "trial.log"
    with open(log, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import subprocess, sys, time; print('x', flush=True); "
             "subprocess.Popen([sys.executable, '-c', "
             "'import time; time.sleep(60)']); time.sleep(60)"],
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    h = tprocess.ProcessTrialHandle(proc, str(tmp_path), str(log))
    _wait(lambda: os.path.getsize(log) > 0)
    assert h.poll() is None and h.group_alive()
    assert h.progress() == (-1, os.path.getsize(log))
    assert h.checkpoint_step() is None and h.result() is None
    _commit(str(tmp_path / "logs" / "r"), 4)
    assert h.checkpoint_step() == 4 and h.progress()[0] == 4
    (tmp_path / "result.json").write_text(json.dumps({"objective": 1.5}))
    assert h.result() == {"objective": 1.5}
    h.kill()
    h.kill()                        # idempotent
    _wait(lambda: not h.group_alive())
    assert h.poll() == -signal.SIGKILL and not h.group_alive()


def test_launcher_command_line_is_jax_with_the_device(tmp_path):
    spec = thpo.TrialSpec(3, {"learning_rate": 0.01}, seed=3)
    jl = jprocess.ProcessLauncher(str(tmp_path), num_epochs=2,
                                  num_configs=16, hang_after_epoch=1)
    tl = tprocess.ProcessLauncher(str(tmp_path), num_epochs=2,
                                  num_configs=16, hang_after_epoch=1)
    assert tl.trial_dir(3) == jl.trial_dir(3)
    argv = tl.child_argv(spec, True, True)
    assert argv[:3] == [sys.executable, "-m",
                        "hydragnn_tpu_torch.hpo.runner"]
    assert argv[3:] == [
        "--params", '{"learning_rate": 0.01}', "--num-epochs", "2",
        "--num-configs", "16", "--data-seed", "0", "--device", "cuda",
        "--resume", "--hang-after-epoch", "1"]


# ------------------------------------------------------------- runner.py

def test_trial_config_params_and_data_bitwise_jax():
    for epochs in (1, 4):
        assert trunner.base_trial_config(epochs) == \
            jrunner.base_trial_config(epochs)
    params = {"learning_rate": 0.02, "hidden_dim": 16, "batch_size": 4,
              "num_conv_layers": 3, "model_type": "SAGE",
              "NeuralNetwork.Training.patience": 3}
    assert trunner.apply_params(trunner.base_trial_config(2), params) == \
        jrunner.apply_params(jrunner.base_trial_config(2), params)
    for bad in ({"lr": 0.1}, {"NeuralNetwork.Nope.x": 1}):
        errs = []
        for mod in (jrunner, trunner):
            with pytest.raises((ValueError, KeyError)) as err:
                mod.apply_params(mod.base_trial_config(2), bad)
            errs.append((type(err.value), str(err.value)))
        assert errs[0] == errs[1]
    for n, seed in ((7, 0), (16, 3)):
        got = trunner.synthetic_dataset(n, seed=seed)
        want = jrunner.synthetic_dataset(n, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("x", "pos", "senders", "receivers", "y_graph"):
                a, b = getattr(g, f), np.asarray(getattr(w, f))
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_run_trial_one_epoch_sgd_matches_jax(tmp_path, monkeypatch):
    """One epoch under SGD from the same initial weights: the port's
    run_trial's history within rtol 1e-5 of JAX's run_trial's."""
    import importlib
    jrt = importlib.import_module("hydragnn_tpu.run_training")
    trt = importlib.import_module("hydragnn_tpu_torch.run_training")
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    from tests.test_torch_train import numpy_tree

    params = {"NeuralNetwork.Training.Optimizer.type": "SGD",
              "learning_rate": 0.01}
    seen = {}
    j_init = jrt.init_params

    def init_params(*a, **k):
        seen["variables"] = j_init(*a, **k)
        return seen["variables"]
    monkeypatch.setattr(jrt, "init_params", init_params)
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jrunner.run_trial(params, num_epochs=1, num_configs=24,
                             data_seed=0, resume=False)
    variables = numpy_tree(seen["variables"])

    create = trt.create_model

    def create_model(mcfg, device="cpu"):
        model = create(mcfg, device=device)
        model.load_state_dict(load_jax_variables(variables))
        return model
    monkeypatch.setattr(trt, "create_model", create_model)
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "torch")
    got = trunner.run_trial(params, num_epochs=1, num_configs=24,
                            data_seed=0, resume=False, device="cpu")
    assert set(got["history"]) == set(want["history"])
    for k in want["history"]:
        np.testing.assert_allclose(got["history"][k], want["history"][k],
                                   rtol=1e-5, err_msg=k)
    assert got["step"] == want["step"] and got["params"] == want["params"]
    with open(tmp_path / "torch" / "result.json") as f:
        assert json.load(f) == got


# The moments a kill can land in: just after the n-th write of a marker.
# A best save writes COMMITTED, BEST, LATEST; the periodic save of the
# same epoch COMMITTED, LATEST. Under "falling" (SGD) every epoch makes a
# best save; under "rising" (the trial config's AdamW) only the first, so
# the best state is the first save's. The points: inside the first save;
# inside epoch 2's first save (under "falling" before and after its BEST,
# which then runs ahead of LATEST); between two saves.
WINDOW_PARAMS = {
    "falling": {"learning_rate": 0.01,
                "NeuralNetwork.Training.Optimizer.type": "SGD"},
    "rising": {"learning_rate": 0.005},
}
KILL_POINTS = {
    "falling": [("COMMITTED", 1), ("BEST", 1), ("COMMITTED", 3),
                ("BEST", 2), ("LATEST", 3)],
    "rising": [("COMMITTED", 1), ("BEST", 1), ("COMMITTED", 3),
               ("LATEST", 3)],
}
FIRST_SAVE = [("COMMITTED", 1), ("BEST", 1)]


def _twin_with_snapshots(root, regime):
    """One uninterrupted trial (3 epochs) on the CPU, with a copy of its
    logs taken just after each of the regime's KILL_POINTS: the disk a
    SIGKILL at that moment leaves behind. -> (result, {point: dir})."""
    from hydragnn_tpu_torch.utils import checkpoint as ck
    twin = root / "twin"
    twin.mkdir()
    seen, snaps = {}, {}
    write = ck._write_marker

    def write_marker(d, name, content):
        write(d, name, content)
        seen[name] = seen.get(name, 0) + 1
        if (name, seen[name]) in KILL_POINTS[regime]:
            dst = root / f"{name}_{seen[name]}"
            shutil.copytree(twin / "logs", dst / "logs")
            snaps[(name, seen[name])] = dst
    mp = pytest.MonkeyPatch()
    mp.setattr(ck, "_write_marker", write_marker)
    mp.chdir(twin)
    try:
        result = trunner.run_trial(WINDOW_PARAMS[regime], num_epochs=3,
                                   num_configs=16, data_seed=0, resume=False,
                                   trial_dir=str(twin), device="cpu")
        ck.wait_for_checkpoints()
    finally:
        mp.undo()
    return result, snaps


@pytest.fixture(scope="module")
def window_twins(tmp_path_factory):
    cache = {}

    def get(regime):
        if regime not in cache:
            cache[regime] = _twin_with_snapshots(
                tmp_path_factory.mktemp(regime), regime)
        return cache[regime]
    return get


@pytest.mark.parametrize(
    "regime,point", [(r, p) for r in KILL_POINTS for p in KILL_POINTS[r]],
    ids=[f"{r}-{n}{k}" for r in KILL_POINTS for n, k in KILL_POINTS[r]])
def test_kill_inside_a_save_resumes_bitwise(window_twins, regime, point,
                                            monkeypatch):
    """A trial killed at any marker of a save and resumed writes a
    result.json bitwise its uninterrupted twin's: inside the first save
    (nothing LATEST covers) it restarts from scratch, inside a later one
    it resumes from the save LATEST names, with its BEST."""
    want, snaps = window_twins(regime)
    if regime == "rising":
        assert want["step"] == 1      # the best state is the first save's
    work = snaps[point]
    monkeypatch.chdir(work)
    assert trunner._has_own_checkpoint(str(work)) is not (point in FIRST_SAVE)
    got = trunner.run_trial(WINDOW_PARAMS[regime], num_epochs=3,
                            num_configs=16, data_seed=0, resume=True,
                            trial_dir=str(work), device="cpu")
    assert got["history"] == want["history"]
    assert got["param_digest"] == want["param_digest"]
    assert got == want


def _trial_run(work, plan, heartbeat_s):
    """Two trials as child processes on the CPU, concurrency 2 ->
    (records, ledger data view, live process groups)."""
    launcher = tprocess.ProcessLauncher(
        str(work), num_epochs=3, num_configs=16, hang_after_epoch=1,
        device="cpu", extra_env={"OMP_NUM_THREADS": "1"})
    if plan:
        tfaults.install_fault_plan(tfaults.parse_fault_plan(plan))
    trials = [thpo.TrialSpec(i, {"learning_rate": 0.005 * (i + 1)}, seed=i)
              for i in range(2)]
    sup = thpo.TrialSupervisor(launcher, trials, heartbeat_s=heartbeat_s,
                               backoff_s=0.1, concurrency=2,
                               poll_interval_s=0.05)
    recs = sup.run(deadline_s=240)
    tfaults.install_fault_plan(None)
    return recs, sup.ledger.data_view(), launcher


def test_killed_and_hung_trials_resume_bitwise_their_twins(tmp_path):
    """trial-kill@0 (SIGKILL at trial 0's first commit) and trial-hang@1
    (trial 1 stops itself after one commit; the watchdog kills it):
    both resume, complete, and write result.json bitwise their
    uninterrupted twins'; no process group outlives the supervisor."""
    recs, view, launcher = _trial_run(tmp_path / "chaos",
                                      "trial-kill@0;trial-hang@1", 25.0)
    assert launcher.live_process_groups() == []
    assert all(r.state == thpo.COMPLETED for r in recs.values()), recs
    assert recs[0].resumes == 1 and recs[1].resumes == 1
    events = [(e["trial"], e["event"]) for e in view]
    assert (0, "killed") in events and (1, "hung") in events
    twin_recs, _, twin_launcher = _trial_run(tmp_path / "twin", None, 60.0)
    assert twin_launcher.live_process_groups() == []
    assert all(r.resumes == 0 for r in twin_recs.values())
    for tid in (0, 1):
        got = json.loads((tmp_path / "chaos" / f"trial_{tid:04d}"
                          / "result.json").read_text())
        want = json.loads((tmp_path / "twin" / f"trial_{tid:04d}"
                           / "result.json").read_text())
        assert got["history"] == want["history"]
        assert got["param_digest"] == want["param_digest"]
        assert got["objective"] == recs[tid].objective
