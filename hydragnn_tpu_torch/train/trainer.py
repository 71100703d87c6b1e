"""Epoch loop (counterpart: hydragnn_tpu/train/trainer.py::
train_validate_test, its core): per-epoch reshuffle, the train pass, the
validation and test passes, keep-best, the LR plateau schedule, early
stopping, the best-validation checkpoint gate and the walltime guard.

History per epoch: train_loss is the mean of the epoch's step losses;
val_loss / test_loss the mean of the per-batch eval losses; lr the
learning rate after the plateau step; nonfinite_steps the count of steps
whose loss or gradients went non-finite; per-task losses under task_i,
val_task_i, test_task_i (energy_loss / force_loss on the energy-force
path). HYDRAGNN_MAX_NUM_BATCH caps the batches of an epoch and
HYDRAGNN_VALTEST=0 skips the eval passes, as in the JAX package.

Preemption (SIGTERM), periodic and asynchronous checkpoints, telemetry
and the device profiler are later work (ROADMAP A5, A8); `run_training`
refuses the knobs that ask for them.
"""
from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

from ..utils.envflags import env_flag, env_strict_int
from .optimizer import get_learning_rate, set_learning_rate


class EarlyStopping:
    """Stop after `patience` epochs without a validation loss below the
    best by more than `min_delta`."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.count = 0
            return False
        self.count += 1
        return self.count >= self.patience


class ReduceLROnPlateau:
    """Multiply the learning rate by `factor` (not below `min_lr`) after
    more than `patience` epochs without a new best validation loss."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-6):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.count = 0

    def step(self, val_loss: float, lr: float) -> float:
        if val_loss < self.best:
            self.best = val_loss
            self.count = 0
            return lr
        self.count += 1
        if self.count > self.patience:
            self.count = 0
            return max(lr * self.factor, self.min_lr)
        return lr


class CheckpointGate:
    """Best-validation gate of a checkpoint, after `warmup` epochs."""

    def __init__(self, warmup: int = 0):
        self.warmup = warmup
        self.best = float("inf")

    def should_save(self, epoch: int, val_loss: float) -> bool:
        if epoch < self.warmup:
            return False
        if val_loss < self.best:
            self.best = val_loss
            return True
        return False


def _timedelta_seconds(text: str) -> float:
    """squeue's remaining time, [d-]hh:mm:ss (or mm:ss), in seconds."""
    days = 0
    if "-" in text:
        d, text = text.split("-", 1)
        days = int(d)
    parts = [int(p) for p in text.split(":")]
    while len(parts) < 3:
        parts.insert(0, 0)
    h, m, s = parts[-3:]
    return float(((days * 24 + h) * 60 + m) * 60 + s)


def walltime_deadline(default: Optional[float] = None) -> Optional[float]:
    """Absolute stop time (epoch seconds) for the walltime guard:
    HYDRAGNN_WALLTIME_DEADLINE, else SLURM_JOB_END_TIME, else now plus
    `squeue -h -j $SLURM_JOB_ID -o %L`; `default` without any."""
    for name in ("HYDRAGNN_WALLTIME_DEADLINE", "SLURM_JOB_END_TIME"):
        val = os.getenv(name)
        if val:
            return float(val)
    jobid = os.getenv("SLURM_JOB_ID")
    if jobid:
        try:
            out = subprocess.run(["squeue", "-h", "-j", jobid, "-o", "%L"],
                                 stdout=subprocess.PIPE, timeout=30)
            return time.time() + _timedelta_seconds(out.stdout.decode()
                                                    .strip())
        except (OSError, ValueError, subprocess.SubprocessError):
            return default
    return default


def _accumulate(acc: Dict[str, float], metrics) -> None:
    for k, v in metrics.items():
        if (k == "loss" or k == "nonfinite_steps" or k.startswith("task_")
                or k.endswith("_loss")):
            acc[k] = acc.get(k, 0.0) + float(v)


def _eval_epoch(eval_step, state, loader, place_fn):
    """(mean loss, {metric: mean}) over the loader's batches."""
    if loader is None:
        return float("nan"), {}
    acc: Dict[str, float] = {}
    nb = 0
    for batch in loader:
        metrics, _ = eval_step(state, place_fn(batch))
        _accumulate(acc, metrics)
        nb += 1
    means = {k: v / max(nb, 1) for k, v in acc.items()}
    return means.pop("loss", float("nan")), means


def train_validate_test(
    train_step: Callable,
    eval_step: Callable,
    state,
    train_loader,
    val_loader,
    test_loader,
    num_epochs: int,
    patience: int = 10,
    use_early_stopping: bool = True,
    checkpoint_warmup: int = 0,
    checkpoint_fn: Optional[Callable] = None,
    plateau: Optional[ReduceLROnPlateau] = None,
    walltime_deadline: Optional[float] = None,
    keep_best: bool = True,
    place_fn: Optional[Callable] = None,
    verbosity: int = 0,
):
    """Returns (state, history). `place_fn(batch)` moves a loader batch to
    the model's device. With `keep_best` the returned state holds the
    values of the epoch with the lowest validation loss: a snapshot
    (`state.copy()`, copies, not references) put back into the live
    state at the end. `checkpoint_fn(state, epoch, val_loss)` is called
    when the CheckpointGate opens."""
    place_fn = place_fn or (lambda b: b)
    early = EarlyStopping(patience) if use_early_stopping else None
    gate = CheckpointGate(checkpoint_warmup)
    plateau = plateau or ReduceLROnPlateau()
    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                       "test_loss": [], "lr": [],
                                       "nonfinite_steps": []}
    best_state, best_val = None, float("inf")
    max_num_batch = env_strict_int("HYDRAGNN_MAX_NUM_BATCH")
    run_valtest = env_flag("HYDRAGNN_VALTEST", default=True)

    for epoch in range(num_epochs):
        train_loader.set_epoch(epoch)
        acc: Dict[str, float] = {}
        nb = 0
        for batch in train_loader:
            state, metrics = train_step(state, place_fn(batch))
            _accumulate(acc, metrics)
            nb += 1
            if max_num_batch is not None and nb >= max_num_batch:
                break
        train_loss = acc.pop("loss", 0.0) / max(nb, 1)
        nonfinite = acc.pop("nonfinite_steps", 0.0)
        if run_valtest:
            val_loss, val_tasks = _eval_epoch(eval_step, state, val_loader,
                                              place_fn)
            test_loss, test_tasks = _eval_epoch(eval_step, state,
                                                test_loader, place_fn)
        else:
            val_loss = test_loss = float("nan")
            val_tasks = test_tasks = {}

        if keep_best and val_loss == val_loss and val_loss < best_val:
            best_val = val_loss
            best_state = state.copy()

        lr = get_learning_rate(state.opt_state)
        if val_loss == val_loss:
            new_lr = plateau.step(val_loss, lr)
            if new_lr != lr:
                set_learning_rate(state.opt_state, new_lr)
                if verbosity >= 1:
                    print(f"reducing lr {lr:.2e} -> {new_lr:.2e}", flush=True)
            lr = new_lr

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["test_loss"].append(test_loss)
        history["lr"].append(lr)
        history["nonfinite_steps"].append(nonfinite)
        for k, v in acc.items():
            history.setdefault(k, []).append(v / max(nb, 1))
        for prefix, tasks in (("val", val_tasks), ("test", test_tasks)):
            for k, v in tasks.items():
                history.setdefault(f"{prefix}_{k}", []).append(v)
        if verbosity >= 1:
            extra = (f" NONFINITE_STEPS {int(nonfinite)}" if nonfinite
                     else "")
            print(f"epoch {epoch}: train {train_loss:.5f} val "
                  f"{val_loss:.5f} test {test_loss:.5f} lr {lr:.2e}" + extra,
                  flush=True)

        if (checkpoint_fn is not None and val_loss == val_loss
                and gate.should_save(epoch, val_loss)):
            checkpoint_fn(state, epoch, val_loss)
        if early is not None and val_loss == val_loss and early(val_loss):
            if verbosity >= 1:
                print(f"early stop at epoch {epoch}", flush=True)
            break
        if walltime_deadline is not None and time.time() >= walltime_deadline:
            if verbosity >= 1:
                print("walltime guard: stopping", flush=True)
            break

    if keep_best and best_state is not None:
        state = state.restore(best_state)
    return state, history
