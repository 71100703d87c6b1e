"""The training fault sites of the port (utils/faults.py wired into
train/trainer.py `forward-step`, utils/checkpoint.save_model
`checkpoint-write` and datasets/loader.fetch_samples `loader-fetch` with
its bounded retry) against the JAX package's on the CPU: the counterparts
of tests/test_faults.py::test_kill_and_resume_trajectory_bitwise and
test_loader_fetch_retry_recovers_transient_fault.

Held: a run killed at an injected fault raises the JAX package's
`InjectedFault` at the same site index, leaves the same committed saves,
and resumed with `continue` reproduces the uninterrupted run's loss
trajectory bitwise; a killed save leaves no COMMITTED marker; the sites'
counters after a run equal JAX's (run with HYDRAGNN_ASYNC_LOADER=0, its
synchronous loader); one injected fetch failure is recovered with the
stream bitwise intact, and `attempts` consecutive ones surface as an
OSError.
"""
import logging
import os

import numpy as np
import pytest
import torch

from hydragnn_tpu.datasets.loader import GraphDataLoader as JLoader
from hydragnn_tpu.run_training import run_training as j_run_training
from hydragnn_tpu.utils import envflags as jenv
from hydragnn_tpu.utils import faults as jfaults
from hydragnn_tpu_torch import run_training
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.train import trainer
from hydragnn_tpu_torch.utils import envflags as tenv
from hydragnn_tpu_torch.utils import faults as tfaults
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.utils import make_config

torch.set_num_threads(1)

TRAJ_KEYS = ("train_loss", "val_loss", "test_loss", "lr")


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.setenv("HYDRAGNN_ASYNC_LOADER", "0")
    monkeypatch.delenv("HYDRAGNN_FAULT_PLAN", raising=False)
    yield
    tfaults.install_fault_plan(None)
    jfaults.install_fault_plan(None)
    trainer.clear_preemption()
    trainer.restore_sigterm_handler()


@pytest.fixture(scope="module")
def splits():
    jsamples = deterministic_graph_dataset(num_configs=24)
    n = len(jsamples)
    jsplits = (jsamples[:int(0.7 * n)], jsamples[int(0.7 * n):int(0.85 * n)],
               jsamples[int(0.85 * n):])
    return jsplits, tuple(to_port_samples(s) for s in jsplits)


def resume_cfg(num_epoch=5, plan=None, **train):
    """tests/test_faults.py's config: GIN, batch 8 (2 train batches an
    epoch), a save every epoch."""
    cfg = make_config("GIN")
    t = cfg["NeuralNetwork"]["Training"]
    t.update(num_epoch=num_epoch, batch_size=8, EarlyStopping=False,
             Checkpoint=True, checkpoint_every_n_epochs=1, keep_best=False)
    t.update(train)
    if plan is not None:
        t["fault_plan"] = plan
    return cfg


def committed(run_dir):
    """The committed step dirs under a run's checkpoint dir."""
    d = os.path.join(run_dir, "logs")
    out = set()
    for root, dirs, files in os.walk(d):
        if "COMMITTED" in files:
            out.add(os.path.basename(root))
    return out


def all_steps(run_dir):
    out = set()
    for root, dirs, _ in os.walk(os.path.join(run_dir, "logs")):
        out |= {x for x in dirs if x.startswith("step_")}
    return out


def test_forward_step_kill_and_resume_is_bitwise(tmp_path, monkeypatch,
                                                 splits):
    """forward-step@5 (2 train batches an epoch) kills epoch 2 after the
    saves of epochs 0 and 1 committed, in both packages; the port's
    resumed run reproduces its uninterrupted run's trajectory bitwise
    and ends at step 10."""
    jsplits, tsplits = splits
    for name in ("ref", "chaos", "jchaos"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    _, h_ref, _, _ = run_training(resume_cfg(), datasets=tsplits,
                                  device="cpu")
    monkeypatch.chdir(tmp_path / "chaos")
    with pytest.raises(tfaults.InjectedFault, match="forward-step@5"):
        run_training(resume_cfg(plan="forward-step@5"), datasets=tsplits,
                     device="cpu")
    assert tfaults.active_fault_plan().fired() == [("forward-step", 5)]
    monkeypatch.chdir(tmp_path / "jchaos")
    with pytest.raises(jfaults.InjectedFault, match="forward-step@5"):
        j_run_training(resume_cfg(plan="forward-step@5"), datasets=jsplits,
                       num_shards=1)
    assert committed(tmp_path / "chaos") == committed(tmp_path / "jchaos")
    assert committed(tmp_path / "chaos") >= {"step_2", "step_4"}
    monkeypatch.chdir(tmp_path / "chaos")
    state, h_res, _, _ = run_training(resume_cfg(**{"continue": 1}),
                                      datasets=tsplits, device="cpu")
    for key in TRAJ_KEYS:
        assert len(h_res[key]) == len(h_ref[key]) == 5, key
        assert h_res[key] == h_ref[key], key
    assert int(state.step) == 10


def test_checkpoint_write_kill_leaves_no_commit_and_resumes(tmp_path,
                                                            monkeypatch,
                                                            splits):
    """checkpoint-write@1 kills the second save (after epoch 1) at its
    start, in both packages: no step dir of it, the first one committed;
    the resumed run replays from epoch 1 and ends bitwise the
    uninterrupted run."""
    jsplits, tsplits = splits
    for name in ("ref", "chaos", "jchaos"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    _, h_ref, _, _ = run_training(resume_cfg(3), datasets=tsplits,
                                  device="cpu")
    monkeypatch.chdir(tmp_path / "chaos")
    with pytest.raises(tfaults.InjectedFault, match="checkpoint-write@1"):
        run_training(resume_cfg(3, plan="checkpoint-write@1"),
                     datasets=tsplits, device="cpu")
    monkeypatch.chdir(tmp_path / "jchaos")
    with pytest.raises(jfaults.InjectedFault, match="checkpoint-write@1"):
        j_run_training(resume_cfg(3, plan="checkpoint-write@1"),
                       datasets=jsplits, num_shards=1)
    assert committed(tmp_path / "chaos") == all_steps(tmp_path / "chaos") \
        == {"step_2"}
    assert committed(tmp_path / "jchaos") == {"step_2"}
    monkeypatch.chdir(tmp_path / "chaos")
    _, h_res, _, _ = run_training(resume_cfg(3, **{"continue": 1}),
                                  datasets=tsplits, device="cpu")
    for key in TRAJ_KEYS:
        assert h_res[key] == h_ref[key], key


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_site_counts_of_a_run_match_jax(tmp_path, monkeypatch, splits,
                                        steps_per_call):
    """A plan that never fires counts each site: after the same run the
    port's forward-step (one a dispatch: a group of S steps once),
    checkpoint-write and loader-fetch counters equal the JAX package's
    with its synchronous loader. Only the periodic and final saves are
    asked for: whether an epoch's best-validation save happens follows
    the two packages' float32 trajectories."""
    jsplits, tsplits = splits
    plan = "forward-step@999;checkpoint-write@999;loader-fetch@99999"
    counts = []
    for name, run, data in (("port", run_training, tsplits),
                            ("jax", j_run_training, jsplits)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cfg = resume_cfg(3, plan=plan, steps_per_call=steps_per_call,
                         Checkpoint=False)
        if name == "port":
            run(cfg, datasets=data, device="cpu")
            counts.append(tfaults.active_fault_plan().counts())
        else:
            run(cfg, datasets=data, num_shards=1)
            counts.append(jfaults.active_fault_plan().counts())
    assert counts[0] == counts[1]
    assert counts[0]["forward-step"] == 3 * (2 if steps_per_call == 1 else 1)
    assert counts[0]["checkpoint-write"] >= 3
    assert counts[0]["loader-fetch"] > 0


def batches_equal(a, b):
    for name in ("x", "pos", "senders", "receivers", "node_graph",
                 "node_mask", "edge_mask", "graph_mask", "y_graph"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_loader_fetch_retry_recovers_and_surfaces(monkeypatch, caplog):
    """loader-fetch@3: the retry recovers, the stream is bitwise the
    fault-free one and the retry is counted and logged;
    loader-fetch@1,2,3 (3 attempts, the default) surfaces an OSError;
    the attempts made equal the JAX loader's (async_workers=0)."""
    from hydragnn_tpu_torch.telemetry.registry import get_registry
    monkeypatch.setenv("HYDRAGNN_LOADER_RETRY_BACKOFF_S", "0.001")
    jsamples = deterministic_graph_dataset(num_configs=16)
    samples = to_port_samples(jsamples)
    ref = list(GraphDataLoader(samples, 4, shuffle=True, seed=0))

    def retries():
        vals = get_registry().snapshot().get(
            "loader_retries_total", {}).get("values", {})
        return sum(vals.values())
    before = retries()
    plan = tfaults.install_fault_plan(tfaults.parse_fault_plan(
        "loader-fetch@3"))
    with caplog.at_level(logging.WARNING):
        got = list(GraphDataLoader(samples, 4, shuffle=True, seed=0))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        batches_equal(a, b)
    assert plan.fired() == [("loader-fetch", 3)]
    assert retries() == before + 1
    assert any("transient fetch failure" in r.getMessage()
               for r in caplog.records)
    jplan = jfaults.install_fault_plan(jfaults.parse_fault_plan(
        "loader-fetch@3"))
    jgot = list(JLoader(jsamples, batch_size=4, shuffle=True, seed=0,
                        async_workers=0))
    assert jplan.counts() == plan.counts() == {"loader-fetch": 17}
    for a, b in zip(got, jgot):
        batches_equal(a, b)
    tfaults.install_fault_plan(tfaults.parse_fault_plan(
        "loader-fetch@1,2,3"))
    with pytest.raises(OSError, match="loader-fetch@3"):
        list(GraphDataLoader(samples, 4, shuffle=True, seed=0))
    with pytest.raises(tfaults.InjectedTransientIOError):
        tfaults.install_fault_plan(tfaults.parse_fault_plan(
            "loader-fetch@0"))
        monkeypatch.setenv("HYDRAGNN_LOADER_RETRIES", "1")
        list(GraphDataLoader(samples, 4, shuffle=True, seed=0))


@pytest.mark.parametrize("retries,backoff", [
    (None, None), ("5", "0.2"), ("0", "-1"), ("three", "fast"), ("", " ")])
def test_resolve_loader_retries_matches_jax(monkeypatch, caplog, retries,
                                            backoff):
    """HYDRAGNN_LOADER_RETRIES / _RETRY_BACKOFF_S resolve as JAX's
    resolver does: defaults 3 and 0.05 s, at least 1 attempt and 0 s,
    strict (a typo warns and keeps the default)."""
    for name, val in (("HYDRAGNN_LOADER_RETRIES", retries),
                      ("HYDRAGNN_LOADER_RETRY_BACKOFF_S", backoff)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    tenv._LOADER_RETRY_MEMO.clear()
    jenv._LOADER_RETRY_MEMO.clear()
    with caplog.at_level(logging.WARNING):
        got = tenv.resolve_loader_retries()
        want = jenv.resolve_loader_retries()
    assert got == want
    warned = {r.name for r in caplog.records}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)
