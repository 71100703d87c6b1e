"""The port's checkpoints and preemption-safe resume
(hydragnn_tpu_torch/utils/checkpoint.py, train/trainer.py, run_training's
Checkpoint / checkpoint_every_n_epochs / continue / startfrom and
run_prediction from a checkpoint) on the CPU: the port's versions of the
JAX package's tests/test_faults.py checkpoint and preemption cases, with
a real SIGTERM for the kill. Resumed histories and parameters are held
bitwise against the uninterrupted run, at float32 and at bf16.
"""
import copy
import json
import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from hydragnn_tpu_torch import run_prediction, run_training
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.config import get_log_name_config
from hydragnn_tpu_torch.datasets.loader import GraphDataLoader
from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.train import optimizer as topt
from hydragnn_tpu_torch.train import trainer
from hydragnn_tpu_torch.train.train_step import (TrainState, make_eval_step,
                                                 make_train_step)
from hydragnn_tpu_torch.utils import checkpoint as ck

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CSCE = ROOT / "examples" / "csce" / "csce_gap.json"
TRAJ_KEYS = ("train_loss", "val_loss", "test_loss", "lr")


@pytest.fixture(autouse=True)
def _no_preemption_left_behind():
    trainer.clear_preemption()
    yield
    trainer.clear_preemption()
    trainer.restore_sigterm_handler()


def _tiny_state(step=0, scale=1.0):
    model = nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(scale)
        model.bias.fill_(-scale)
    tx = topt.select_optimizer({"Optimizer": {"type": "AdamW",
                                              "learning_rate": 1e-3}})
    state = TrainState.create(model, tx)
    state.step = step
    return state


# ------------------------------------------------------------- layout ----

def test_restore_skips_uncommitted_and_corrupt(tmp_path):
    run = "integrity_test"
    s0, s1 = _tiny_state(0, 1.0), _tiny_state(1, 2.0)
    d = os.path.dirname(ck.save_model(s0, run, path=str(tmp_path)))
    t1 = ck.save_model(s1, run, path=str(tmp_path))
    assert ck.verify_checkpoint(t1) and ck.verify_checkpoint(t1, deep=True)
    # a newest-looking dir without the commit marker (a writer killed
    # mid-save) is skipped
    os.makedirs(os.path.join(d, "step_99"))
    torch.save({"junk": 1}, os.path.join(d, "step_99", ck.PAYLOAD))
    assert ck.load_existing_model(s0, run, path=str(tmp_path)).step == 1
    # the newest committed save loses its payload: fall back to step 0
    os.remove(os.path.join(t1, ck.PAYLOAD))
    restored = ck.load_existing_model(s0, run, path=str(tmp_path))
    assert restored.step == 0
    assert torch.equal(restored.params["weight"], torch.ones(2, 3))
    # metadata round trip
    meta = {"next_epoch": 7, "step": 2, "trainer": {"best_val": 0.25}}
    t2 = ck.save_model(_tiny_state(2), run, path=str(tmp_path),
                       metadata=meta)
    _, got = ck.load_existing_model(s0, run, path=str(tmp_path),
                                    with_metadata=True)
    assert got == meta == ck.load_checkpoint_metadata(t2)


def test_manifest_detects_a_flipped_byte(tmp_path):
    """One flipped byte in a committed payload passes the structural
    check, fails the sha256 manifest, and restore falls back to the
    newest save that verifies; the payload loads with weights_only."""
    run = "manifest_test"
    ck.save_model(_tiny_state(1, 1.0), run, path=str(tmp_path))
    t2 = ck.save_model(_tiny_state(2, 3.0), run, path=str(tmp_path))
    payload = os.path.join(t2, ck.PAYLOAD)
    with open(payload, "r+b") as f:
        f.seek(os.path.getsize(payload) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert ck.verify_checkpoint(t2)
    assert not ck.verify_checkpoint(t2, deep=True)
    assert "sha256" in ck.verify_manifest(t2)
    restored = ck.load_existing_model(_tiny_state(), run, path=str(tmp_path))
    assert restored.step == 1
    assert torch.equal(restored.params["bias"], -torch.ones(2))
    with open(os.path.join(os.path.dirname(t2), "COMMITTED"), "w"):
        pass   # a stray marker outside a step dir is not a checkpoint
    assert ck.load_existing_model(_tiny_state(), run,
                                  path=str(tmp_path)).step == 1


def test_resume_meta_schema_tolerance():
    meta = {"next_epoch": 2, "step": 10, "loader_epoch": 2,
            "world_size": 4, "some_future_key": {"x": 1}}
    assert ck.validate_resume_meta(meta) is meta
    with pytest.raises(ValueError, match="'next_epoch'"):
        ck.validate_resume_meta({"step": 1})
    with pytest.raises(ValueError, match="'step'"):
        ck.validate_resume_meta({"next_epoch": 1, "extra": True})


def test_retention_gc_keeps_best_and_last_k(tmp_path):
    run = "retention_test"
    for step in range(1, 6):
        ck.save_model(_tiny_state(step), run, path=str(tmp_path),
                      mark_best=(step == 2), best_val=0.5,
                      keep_last_k=2)
    d = ck._ckpt_dir(run, path=str(tmp_path))
    os.makedirs(os.path.join(d, ".gc-step_99"))     # an interrupted delete
    os.makedirs(os.path.join(d, "step_0"))          # a dead writer
    ck.save_model(_tiny_state(6), run, path=str(tmp_path), keep_last_k=2)
    assert not os.path.exists(os.path.join(d, ".gc-step_99"))
    assert not os.path.exists(os.path.join(d, "step_0"))
    assert sorted(p for p in os.listdir(d) if p.startswith("step_")) == \
        ["step_2", "step_5", "step_6"]
    assert ck.marker_target(run, str(tmp_path), "latest").endswith("step_6")
    assert ck.marker_target(run, str(tmp_path), "best").endswith("step_2")
    best, val = ck.load_best_model(_tiny_state(), run, path=str(tmp_path),
                                   with_val=True)
    assert (best.step, val) == (2, 0.5)


def test_async_saves_commit_in_order_and_failures_escalate(tmp_path,
                                                           monkeypatch):
    """Asynchronous best-validation saves are committed in order by the
    writer thread (BEST and LATEST name the last one after
    wait_for_checkpoints); a save path that fails 3 times in a row
    raises, any success resets the count."""
    fn = ck.make_async_best_checkpoint_fn("async_test", path=str(tmp_path))
    for step in range(1, 4):
        fn(_tiny_state(step, float(step)), step, 1.0 / step,
           meta={"next_epoch": step, "step": step})
    ck.wait_for_checkpoints()
    assert ck.marker_target("async_test", str(tmp_path), "best").endswith(
        "step_3")
    best = ck.load_best_model(_tiny_state(), "async_test", path=str(tmp_path))
    assert torch.equal(best.params["weight"], torch.full((2, 3), 3.0))

    calls = []

    def failing(*a, **kw):
        calls.append(1)
        raise OSError("disk full")
    monkeypatch.setattr(ck, "save_model", failing)
    fn = ck.make_async_best_checkpoint_fn("escalation_test")
    fn(None, 0, 1.0)
    fn(None, 1, 0.9)
    with pytest.raises(RuntimeError, match="3 times in a row"):
        fn(None, 2, 0.8)
    assert len(calls) == 3
    outcomes = iter(["fail", "fail", "ok", "fail", "fail", "fail"])

    def flaky(*a, **kw):
        if next(outcomes) == "fail":
            raise OSError("transient")
    monkeypatch.setattr(ck, "save_model", flaky)
    fn = ck.make_async_best_checkpoint_fn("escalation_test")
    for epoch in range(5):
        fn(None, epoch, 1.0)
    with pytest.raises(RuntimeError):
        fn(None, 5, 1.0)


# ---------------------------------------------------------- preemption ---

def test_sigterm_sets_the_preemption_flag():
    assert trainer.install_sigterm_handler()
    assert not trainer.preemption_requested()
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.time() + 5
    while not trainer.preemption_requested() and time.time() < deadline:
        time.sleep(0.01)
    assert trainer.preemption_requested()
    trainer.restore_sigterm_handler()
    assert signal.getsignal(signal.SIGTERM) is not None


def _small_loop(samples):
    with open(CSCE) as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"].update(hidden_dim=8,
                                                num_conv_layers=1)
    cfg = tcfg.update_config(cfg, samples)
    mcfg = tcfg.build_model_config(cfg)
    model = create_model(mcfg, device="cpu")
    tx = topt.select_optimizer(cfg["NeuralNetwork"]["Training"])
    loader = GraphDataLoader(samples, 8, shuffle=True, seed=0)
    return (make_train_step(model, mcfg, tx), make_eval_step(model, mcfg),
            TrainState.create(model, tx), loader)


def test_preempt_save_fires_exactly_once():
    """A preemption seen by the step-boundary check makes ONE save, of
    the epoch to replay, and the loop returns without a finished epoch."""
    step, eval_step, state, loader = _small_loop(
        synthetic_molecules(16, seed=1, min_atoms=4, max_atoms=8))
    saves = []
    trainer.request_preemption()
    trainer.request_preemption()
    _, hist = trainer.train_validate_test(
        step, eval_step, state, loader, None, None, num_epochs=3,
        use_early_stopping=False, keep_best=False,
        checkpoint_every_n_epochs=1,
        periodic_checkpoint_fn=lambda s, m: saves.append(("periodic", m)),
        preempt_save_fn=lambda s, m: saves.append(("preempt", m)))
    assert [k for k, _ in saves] == ["preempt"]
    assert saves[0][1]["next_epoch"] == 0
    assert "history" in saves[0][1]["trainer"]
    assert hist["train_loss"] == []


def test_mid_epoch_preemption_saves_the_epoch_start_state():
    """SIGTERM inside epoch 1 saves the state from epoch 1's start (2
    steps), with next_epoch 1: resume replays the whole epoch."""
    step, eval_step, state, loader = _small_loop(
        synthetic_molecules(16, seed=1, min_atoms=4, max_atoms=8))
    calls = []

    def counting_step(s, batch):
        calls.append(1)
        if len(calls) == 3:       # 2 batches an epoch: epoch 1's first
            trainer.request_preemption()
        return step(s, batch)
    saves = []
    _, hist = trainer.train_validate_test(
        counting_step, eval_step, state, loader, None, None, num_epochs=4,
        use_early_stopping=False, keep_best=False,
        preempt_save_fn=lambda s, m: saves.append((s, m)))
    assert len(saves) == 1
    saved, meta = saves[0]
    assert (meta["next_epoch"], meta["step"], saved.step) == (1, 2, 2)
    assert state.step == 3            # the live state ran one more step
    assert not all(torch.equal(saved.params[k], v)
                   for k, v in state.params.items())
    assert len(hist["train_loss"]) == 1


# ------------------------------------------------ run_training resume ----

def _run_cfg(dtype="float32", num_epoch=4):
    with open(CSCE) as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"].update(hidden_dim=8,
                                                num_conv_layers=2,
                                                dtype=dtype)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=num_epoch,
                                            batch_size=4)
    cfg["Dataset"] = {"name": f"ckpt_{dtype}"}
    return cfg


@pytest.fixture(scope="module")
def splits():
    s = synthetic_molecules(24, seed=3, min_atoms=4, max_atoms=9)
    return s[:16], s[16:20], s[20:]


def _sigterm_after_first_save(monkeypatch):
    """After the run's first synchronous save returns, a thread sends the
    process a real SIGTERM, and the save waits until the handler has set
    the preemption flag: the run stops at that epoch boundary on every
    machine, however fast."""
    real = ck.save_model
    sent = []

    def save_then_kill(*args, **kwargs):
        out = real(*args, **kwargs)
        if not sent:
            sent.append(threading.Thread(
                target=os.kill, args=(os.getpid(), signal.SIGTERM)))
            sent[0].start()
            deadline = time.time() + 30
            while not trainer.preemption_requested() \
                    and time.time() < deadline:
                time.sleep(0.001)
        return out
    monkeypatch.setattr(ck, "save_model", save_then_kill)
    return sent


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_kill_and_resume_is_bitwise(tmp_path, monkeypatch, splits, dtype):
    """A run with Checkpoint and checkpoint_every_n_epochs 1, sent a real
    SIGTERM once its first save is committed, stops with a resume point
    (that save);
    `continue: 1` then ends with the uninterrupted run's train/val/test/lr
    history and parameters bit for bit; run_prediction from the BEST and
    the LATEST checkpoint equals the in-memory state's predictions."""
    monkeypatch.chdir(tmp_path)
    twin, h_twin, _, _ = run_training(_run_cfg(dtype), splits, device="cpu")
    cfg = _run_cfg(dtype)
    cfg["NeuralNetwork"]["Training"].update(Checkpoint=True,
                                            checkpoint_every_n_epochs=1)
    with monkeypatch.context() as m:
        sent = _sigterm_after_first_save(m)
        _, h_cut, _, _ = run_training(copy.deepcopy(cfg), splits,
                                      device="cpu")
    sent[0].join(timeout=60)
    assert trainer.preemption_requested()
    assert len(h_cut["train_loss"]) == 1
    trainer.clear_preemption()
    cfg["NeuralNetwork"]["Training"]["continue"] = 1
    state, h_res, model, completed = run_training(copy.deepcopy(cfg), splits,
                                                  device="cpu")
    for k in TRAJ_KEYS:
        assert h_res[k] == h_twin[k], k
    for k, v in twin.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, state.state_dict()[k]), k
    _, mem = run_prediction(completed, splits, state=state, model=model,
                            device="cpu")
    for which in ("best", "latest"):
        _, got = run_prediction(completed, splits, device="cpu",
                                checkpoint=which)
        assert np.array_equal(got[0], mem[0]), which


def test_resume_of_a_completed_run_is_a_noop(tmp_path, monkeypatch, splits):
    """The final save marks the run complete (next_epoch = num_epoch):
    `continue` trains no epoch and returns the saved history and state."""
    monkeypatch.chdir(tmp_path)
    cfg = _run_cfg(num_epoch=2)
    cfg["NeuralNetwork"]["Training"]["Checkpoint"] = True
    s1, h1, _, _ = run_training(copy.deepcopy(cfg), splits, device="cpu")
    cfg["NeuralNetwork"]["Training"]["continue"] = 1
    s2, h2, _, _ = run_training(copy.deepcopy(cfg), splits, device="cpu")
    assert s2.step == s1.step
    for k in TRAJ_KEYS:
        assert h2[k] == h1[k], k
    for k, v in s1.state_dict().items():
        assert torch.equal(v, s2.state_dict()[k]), k


def test_startfrom_transfers_weights_and_trains_from_epoch_0(
        tmp_path, monkeypatch, splits):
    """`continue` with `startfrom` naming another run seeds this run's
    weights and optimizer state from that run's newest save, without its
    history: 0 epochs return that state; 1 epoch starts from it."""
    monkeypatch.chdir(tmp_path)
    src = _run_cfg(num_epoch=2)
    src["NeuralNetwork"]["Training"].update(Checkpoint=True, keep_best=False)
    s_src, _, _, _ = run_training(copy.deepcopy(src), splits, device="cpu")
    dst = _run_cfg(num_epoch=0)
    dst["Dataset"]["name"] = "transfer"
    dst["NeuralNetwork"]["Training"].update(
        {"continue": 1, "startfrom": get_log_name_config(src)})
    s0, h0, _, _ = run_training(copy.deepcopy(dst), splits, device="cpu")
    assert h0["train_loss"] == [] and s0.step == s_src.step
    for k, v in s_src.state_dict().items():
        assert torch.equal(v, s0.state_dict()[k]), k
    dst["NeuralNetwork"]["Training"]["num_epoch"] = 1
    _, h1, _, _ = run_training(copy.deepcopy(dst), splits, device="cpu")
    assert len(h1["train_loss"]) == 1
    dst["NeuralNetwork"]["Training"]["startfrom"] = "no-such-run"
    with pytest.raises(ValueError, match="no-such-run"):
        run_training(copy.deepcopy(dst), splits, device="cpu")


def test_run_prediction_from_checkpoints(tmp_path, monkeypatch, splits):
    """run_prediction without weights reads the run's checkpoint: none
    raises FileNotFoundError, a BEST marker naming an uncommitted dir
    raises UncommittedCheckpointError naming it."""
    monkeypatch.chdir(tmp_path)
    cfg = _run_cfg(num_epoch=1)
    with pytest.raises(FileNotFoundError, match="no variables"):
        run_prediction(copy.deepcopy(cfg), splits, device="cpu")
    cfg["NeuralNetwork"]["Training"]["Checkpoint"] = True
    state, _, model, completed = run_training(copy.deepcopy(cfg), splits,
                                              device="cpu")
    _, mem = run_prediction(completed, splits, state=state, model=model,
                            device="cpu")
    _, got = run_prediction(completed, splits, device="cpu")
    assert np.array_equal(got[0], mem[0])
    d = ck._ckpt_dir(get_log_name_config(completed))
    os.makedirs(os.path.join(d, "step_999"))
    with open(os.path.join(d, "BEST"), "w") as f:
        f.write("step_999\n")
    with pytest.raises(ck.UncommittedCheckpointError, match="step_999"):
        run_prediction(completed, splits, device="cpu", checkpoint="best")
    # LATEST still restores the newest committed save
    _, got = run_prediction(completed, splits, device="cpu")
    assert np.array_equal(got[0], mem[0])
