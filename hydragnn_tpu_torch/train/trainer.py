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

Steps per call (JAX trainer.py:356-410, 769-840): with a multi step and
`steps_per_call` S > 1 the train pass runs the loader's batches in groups
of S, one multi-step call (one CUDA graph replay on the card) and one
host read of the metrics per full group; the remainder group, and a
group that HYDRAGNN_MAX_NUM_BATCH would cut, run as single steps. The
eval passes group likewise when the loader holds at least one full group.

Fault tolerance (JAX trainer.py:29-85, 247-340): SIGTERM only sets a
flag (`install_sigterm_handler`); the loop checks it at every step
boundary and makes ONE save through `preempt_save_fn`, then exits. A
preemption inside an epoch saves the state from that epoch's start with
next_epoch = the epoch, so the resumed run replays the whole epoch from
its deterministic order (the loader's order is a pure function of (seed,
epoch)) instead of applying its first batches twice. `start_epoch` and
`resume` (the saved metadata's "trainer" record) restore the history, the
plateau, early-stopping and gate state and the best validation loss, so
the resumed epochs repeat the uninterrupted run's bit for bit.

Telemetry (JAX trainer.py:522-663): with a `telemetry` session the train
pass runs under a HostStallMonitor (utils/profiling.py) and each epoch
reports the JAX package's registry metrics (train_loss, val_loss,
test_loss, train_input_bound_frac, train_nonfinite_steps_total,
train_padding_frac_{nodes,edges}, train_jit_recompiles_total,
train_achieved_flops_per_s, train_mfu) and one JSONL epoch event with
its `data` and `timing` keys. The achieved rate is the probe's FLOPs a
step (train_step.step_cost_flops, once a session, on the epoch's first
single-step batch) times the steps over the train pass's step time,
which includes the card's execution; `profiler` (an EpochDeviceTrace)
brackets each epoch's train pass. Without a session the loop is the
one above, with no timer and no probe.
"""
from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import get_comm_size_and_rank
from ..telemetry import spans as _spans
from ..utils.envflags import env_flag, env_strict_int
from ..utils.faults import fault_point
from ..utils.profiling import HostStallMonitor
from .optimizer import get_learning_rate, set_learning_rate

_log = logging.getLogger("hydragnn_tpu_torch")

# SLURM and cloud preemption deliver SIGTERM with a grace window; the
# handler only sets this flag (signal-safe)
_PREEMPT = threading.Event()
_PREV_SIGTERM: list = [None, False]  # (previous handler, installed?)


def install_sigterm_handler() -> bool:
    """Route SIGTERM to the preemption flag; False when not on the main
    thread, where no handler can be installed. The first install
    remembers the previous disposition for `restore_sigterm_handler`."""
    import signal

    def _handler(signum, frame):
        _PREEMPT.set()

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        return False
    if not _PREV_SIGTERM[1]:
        _PREV_SIGTERM[0], _PREV_SIGTERM[1] = prev, True
    return True


def restore_sigterm_handler() -> None:
    """Put back the SIGTERM disposition from before
    `install_sigterm_handler` (a flag-only handler left behind would make
    the process ignore SIGTERM for good); no-op when none was installed."""
    import signal
    if _PREV_SIGTERM[1]:
        try:
            signal.signal(signal.SIGTERM, _PREV_SIGTERM[0])
        except (ValueError, TypeError):
            pass
        _PREV_SIGTERM[0], _PREV_SIGTERM[1] = None, False


def request_preemption() -> None:
    _PREEMPT.set()


def preemption_requested() -> bool:
    return _PREEMPT.is_set()


def clear_preemption() -> None:
    _PREEMPT.clear()


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


def _group_batches(loader, size: int):
    """Lists of `size` consecutive loader batches; the last may be
    shorter."""
    buf = []
    for b in loader:
        buf.append(b)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


def _graph_count(step_fns) -> int:
    """CUDA graphs the given step callables (train_step.TrainStep and its
    kin, whose `steps` hold their graphs by key) have captured so far;
    a callable of another kind captures none."""
    return sum(len(getattr(getattr(f, "steps", None), "graphs", ()))
               for f in step_fns)


def _accumulate(acc: Dict[str, float], metrics, summed: bool = False
                ) -> None:
    """Add one step's metrics (or, `summed`, the [S] metrics of a group,
    summed in float32 as np.sum does) into `acc`: one host read for the
    whole dict."""
    keys = [k for k in metrics
            if (k == "loss" or k == "nonfinite_steps" or k.startswith("task_")
                or k.endswith("_loss"))]
    if not keys:
        return
    vals = torch.stack([metrics[k] for k in keys]).cpu().numpy()
    for k, v in zip(keys, vals):
        acc[k] = acc.get(k, 0.0) + (float(np.sum(v)) if summed
                                    else float(v))


def _eval_epoch(eval_step, state, loader, place_fn, multi_eval_step=None,
                steps_per_call: int = 1):
    """(mean loss, {metric: mean}) over the loader's batches, in groups
    of `steps_per_call` through `multi_eval_step` when the loader holds
    at least one full group (the remainder as single steps)."""
    if loader is None:
        return float("nan"), {}
    acc: Dict[str, float] = {}
    nb = 0
    grouped = (multi_eval_step is not None and steps_per_call > 1
               and len(loader) >= steps_per_call)
    groups = (_group_batches(loader, steps_per_call) if grouped
              else ([b] for b in loader))
    for group in groups:
        if grouped and len(group) == steps_per_call:
            _accumulate(acc, multi_eval_step(
                state, [place_fn(b) for b in group]), summed=True)
        else:
            for batch in group:
                metrics, _ = eval_step(state, place_fn(batch))
                _accumulate(acc, metrics)
        nb += len(group)
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
    start_epoch: int = 0,
    resume: Optional[Dict[str, Any]] = None,
    checkpoint_every_n_epochs: int = 0,
    periodic_checkpoint_fn: Optional[Callable] = None,
    preempt_save_fn: Optional[Callable] = None,
    initial_best_state=None,
    initial_best_val: Optional[float] = None,
    resume_meta_out: Optional[Dict[str, Any]] = None,
    multi_train_step: Optional[Callable] = None,
    multi_eval_step: Optional[Callable] = None,
    steps_per_call: int = 1,
    telemetry=None,
    profiler=None,
):
    """Returns (state, history). `place_fn(batch)` moves a loader batch to
    the model's device. With `keep_best` the returned state holds the
    values of the epoch with the lowest validation loss: a snapshot
    (`state.copy()`, copies, not references) put back into the live
    state at the end. `checkpoint_fn(state, epoch, val_loss, meta)` is
    called when the CheckpointGate opens.

    Resume: training runs epochs `start_epoch`..num_epochs - 1; `resume`
    restores the trainer state a checkpoint's metadata carries, and
    `initial_best_state` / `initial_best_val` the best-validation state
    (the BEST checkpoint) and its own loss. `periodic_checkpoint_fn(state,
    meta)` runs after every `checkpoint_every_n_epochs` completed epochs;
    `preempt_save_fn(state, meta)` at most once, on SIGTERM (or
    `request_preemption`), after which the loop returns. `meta` is the
    resume metadata (`next_epoch`, `step`, `loader_epoch`, `trainer`);
    `resume_meta_out` receives the run-complete one (next_epoch =
    num_epochs) for the caller's final save.

    `multi_train_step(state, batches) -> (state, metrics [S])` and
    `multi_eval_step(state, batches) -> metrics [S]` run groups of
    `steps_per_call` batches (train_step.make_multi_*_step); the
    preemption flag is then checked once a group.

    `telemetry` (a telemetry.session.TelemetrySession or None) reports
    the epoch's metrics and event; `profiler` (a
    telemetry.EpochDeviceTrace or None) traces its target epoch."""
    place_fn = place_fn or (lambda b: b)
    early = EarlyStopping(patience) if use_early_stopping else None
    gate = CheckpointGate(checkpoint_warmup)
    plateau = plateau or ReduceLROnPlateau()
    history: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                       "test_loss": [], "lr": [],
                                       "nonfinite_steps": []}
    best_state, best_val = initial_best_state, float("inf")
    if resume:
        for k, v in (resume.get("history") or {}).items():
            history[k] = list(v)
        p = resume.get("plateau") or {}
        plateau.best = float(p.get("best", plateau.best))
        plateau.count = int(p.get("count", plateau.count))
        e = resume.get("early") or {}
        if early is not None and e:
            early.best = float(e.get("best", early.best))
            early.count = int(e.get("count", early.count))
        gate.best = float(resume.get("gate_best", gate.best))
        if initial_best_state is not None:
            # the BEST checkpoint's own loss: the trainer's in-memory best
            # may belong to a save that never committed
            best_val = float(initial_best_val if initial_best_val is not None
                             else resume.get("best_val", best_val))
    max_num_batch = env_strict_int("HYDRAGNN_MAX_NUM_BATCH")
    run_valtest = env_flag("HYDRAGNN_VALTEST", default=True)

    def _resume_meta(next_epoch: int, state) -> Dict[str, Any]:
        """What a resumed run needs to go on bit for bit, the history
        copied now (an asynchronous save writes it later)."""
        return {
            "next_epoch": int(next_epoch),
            "step": int(state.step),
            "loader_epoch": int(next_epoch),
            # the world that wrote the save (informational: a checkpoint
            # holds whole tensors, so a restart at another world reads it)
            "world_size": int(get_comm_size_and_rank()[0]),
            "trainer": {
                "history": {k: list(v) for k, v in history.items()},
                "plateau": {"best": plateau.best, "count": plateau.count},
                "early": ({"best": early.best, "count": early.count}
                          if early is not None else None),
                "gate_best": gate.best,
                "best_val": best_val,
            },
        }

    preempt_saved = [False]

    def _preempt_save(next_epoch: int, snapshot) -> None:
        # exactly once: the step-boundary and epoch-boundary checks can
        # both see one SIGTERM
        if preempt_saved[0]:
            return
        preempt_saved[0] = True
        if preempt_save_fn is not None:
            preempt_save_fn(snapshot, _resume_meta(next_epoch, snapshot))
        if verbosity >= 1:
            print(f"preemption: checkpoint saved at epoch {next_epoch}; "
                  "exiting", flush=True)

    prev_boundary_committed = False
    step_fns = (train_step, multi_train_step, eval_step, multi_eval_step)
    captures0 = _graph_count(step_fns)
    # the host-stall timers run only under a session
    stall = HostStallMonitor() if telemetry is not None else None
    step_timer = (stall.step_timer if stall is not None
                  else contextlib.nullcontext)
    epoch_ctx = profiler if profiler is not None else contextlib.nullcontext()
    for epoch in range(start_epoch, num_epochs):
        train_loader.set_epoch(epoch)
        if profiler is not None:
            profiler.set_current_epoch(epoch)
        # the state before this epoch's updates, for a preemption inside
        # it; not needed when the last boundary's periodic save holds it
        epoch_start = (state.copy() if preempt_save_fn is not None
                       and not prev_boundary_committed else None)
        acc: Dict[str, float] = {}
        nb = 0
        preempted = False
        flops = None
        group = multi_train_step is not None and steps_per_call > 1
        source = (_group_batches(train_loader, steps_per_call) if group
                  else ([b] for b in train_loader))
        if stall is not None:
            stall.reset()
            source = stall.wrap(source)
        with _spans.span("train_epoch", cat="tracer"), epoch_ctx:
            for batches in source:
                if preemption_requested():
                    preempted = True
                    break
                # one forward-step index a train-loop dispatch (a group of
                # S steps counts once), on the host, outside any graph
                fault_point("forward-step")
                if group and len(batches) == steps_per_call and (
                        max_num_batch is None
                        or nb + steps_per_call <= max_num_batch):
                    with step_timer():
                        state, metrics = multi_train_step(
                            state, [place_fn(b) for b in batches])
                        _accumulate(acc, metrics, summed=True)
                    nb += steps_per_call
                else:
                    # single steps: no group, the remainder group, or a
                    # group the batch cap cuts
                    for batch in batches:
                        if max_num_batch is not None and nb >= max_num_batch:
                            break
                        with step_timer():
                            placed = place_fn(batch)
                            state, metrics = train_step(state, placed)
                            # the host read waits for the card: step time
                            # is dispatch and execution
                            _accumulate(acc, metrics)
                        if (telemetry is not None and not group
                                and not telemetry.flops_probed
                                and not telemetry.pipeline_info):
                            telemetry.step_flops_once(train_step, placed)
                        nb += 1
                if max_num_batch is not None and nb >= max_num_batch:
                    break
        if preempted:
            if epoch_start is None:
                # the previous boundary's periodic save is the resume point
                preempt_saved[0] = True
            else:
                _preempt_save(epoch, epoch_start)
            break
        train_loss = acc.pop("loss", 0.0) / max(nb, 1)
        nonfinite = acc.pop("nonfinite_steps", 0.0)
        if run_valtest:
            with _spans.span("validate", cat="tracer"):
                val_loss, val_tasks = _eval_epoch(
                    eval_step, state, val_loader, place_fn, multi_eval_step,
                    steps_per_call)
            with _spans.span("test", cat="tracer"):
                test_loss, test_tasks = _eval_epoch(
                    eval_step, state, test_loader, place_fn,
                    multi_eval_step, steps_per_call)
        else:
            val_loss = test_loss = float("nan")
            val_tasks = test_tasks = {}

        # padding: the fraction of the epoch's node and edge slots that
        # were padding (the waste batch packing cuts)
        pad = None
        if callable(getattr(train_loader, "padding_stats", None)):
            pad = train_loader.padding_stats()
            for k in ("padding_frac_nodes", "padding_frac_edges"):
                history.setdefault(k, []).append(float(pad[k]))
        # CUDA graphs this run's steps captured in this epoch (the JAX
        # package's jit_recompiles): nonzero after epoch 0 means a batch
        # shape left the pinned budgets
        captures = _graph_count(step_fns)
        recaptures = captures - captures0
        history.setdefault("graph_captures", []).append(recaptures)
        captures0 = captures

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
        achieved = mfu_val = None
        if telemetry is not None:
            achieved, mfu_val = _report_epoch(
                telemetry, stall, epoch, start_epoch, group, nb,
                train_loss, val_loss, test_loss, lr, nonfinite, pad,
                recaptures, train_step,
                next(iter(state.params.values())).device)
            if achieved is not None:
                history.setdefault("achieved_flops_per_s", []).append(
                    achieved)
            if mfu_val is not None:
                history.setdefault("mfu", []).append(mfu_val)
        if verbosity >= 1:
            extra = (f" NONFINITE_STEPS {int(nonfinite)}" if nonfinite
                     else "")
            if achieved is not None:
                extra += f" flops/s {achieved:.3e}"
            if mfu_val is not None:
                extra += f" mfu {mfu_val:.4f}"
            print(f"epoch {epoch}: train {train_loss:.5f} val "
                  f"{val_loss:.5f} test {test_loss:.5f} lr {lr:.2e}" + extra,
                  flush=True)

        if (checkpoint_fn is not None and val_loss == val_loss
                and gate.should_save(epoch, val_loss)):
            checkpoint_fn(state, epoch, val_loss,
                          meta=_resume_meta(epoch + 1, state))
        boundary_saved = False
        if (checkpoint_every_n_epochs and periodic_checkpoint_fn is not None
                and (epoch + 1) % checkpoint_every_n_epochs == 0):
            periodic_checkpoint_fn(state, _resume_meta(epoch + 1, state))
            boundary_saved = True
        if preemption_requested():
            if boundary_saved:
                # the periodic save above is this boundary's resume point
                preempt_saved[0] = True
            else:
                _preempt_save(epoch + 1, state)
            break
        prev_boundary_committed = boundary_saved
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
    if resume_meta_out is not None:
        resume_meta_out.update(_resume_meta(num_epochs, state))
    return state, history


def _report_epoch(telemetry, stall, epoch, start_epoch, group, nb,
                  train_loss, val_loss, test_loss, lr, nonfinite, pad,
                  recaptures, train_step, dev: torch.device):
    """One epoch's registry metrics and JSONL event, with the JAX
    package's names, help strings and keys; returns (achieved FLOP/s,
    mfu), each None where not measured. `train_jit_recompiles_total`
    counts the CUDA graphs the steps captured in the epoch, the port's
    counterpart of a compiled XLA program."""
    from ..telemetry.mfu import achieved_and_mfu
    flops = None
    pinfo = telemetry.pipeline_info
    if pinfo:
        if epoch == start_epoch:
            _log.info("telemetry: pipelined run — per-step MFU gauge "
                      "unavailable (the shard_map step's cost analysis "
                      "is per-partition; see BENCH_MFU for the "
                      "sequential-probe numerator)")
    elif telemetry.flops_probed:
        flops = telemetry.step_flops_once(train_step)
    elif group and epoch == start_epoch:
        # say why the gauge is absent instead of leaving it out
        _log.info("telemetry: steps_per_call > 1 — per-step MFU gauge "
                  "unavailable (the probe counts single steps; groups "
                  "run no single step to probe)")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    achieved, mfu_val = achieved_and_mfu(
        flops, nb, stall.step_s, backend=dev.type, device_kind=kind,
        compute_dtype=telemetry.compute_dtype)
    input_bound = stall.input_bound_frac()
    reg = telemetry.registry
    reg.gauge_set("train_loss", train_loss,
                  help="mean train loss this epoch")
    if val_loss == val_loss:
        reg.gauge_set("val_loss", val_loss,
                      help="mean validation loss this epoch")
        reg.gauge_set("test_loss", test_loss,
                      help="mean test loss this epoch")
    reg.gauge_set("train_input_bound_frac", input_bound,
                  help="fraction of the train pass blocked on "
                       "the input pipeline")
    reg.counter_inc("train_nonfinite_steps_total", float(nonfinite),
                    help="steps with non-finite loss/grads")
    if pad is not None:
        reg.gauge_set("train_padding_frac_nodes",
                      float(pad["padding_frac_nodes"]),
                      help="node-slot padding fraction")
        reg.gauge_set("train_padding_frac_edges",
                      float(pad["padding_frac_edges"]),
                      help="edge-slot padding fraction")
    reg.counter_inc("train_jit_recompiles_total", float(max(recaptures, 0)),
                    help="new compiled step programs")
    if achieved is not None:
        reg.gauge_set("train_achieved_flops_per_s", achieved,
                      help="XLA-cost-analysis FLOPs x steps over "
                           "dispatch+execute wall time")
    if mfu_val is not None:
        reg.gauge_set("train_mfu", mfu_val,
                      help="achieved over per-backend peak FLOPs")
    if pinfo:
        _pipeline_gauges(telemetry, pinfo, stall.step_s, epoch)
    # non-finite scalars are left out: json would write NaN
    data = {"nonfinite_steps": nonfinite, "batches": nb}
    for k, v in (("train_loss", train_loss), ("val_loss", val_loss),
                 ("test_loss", test_loss), ("lr", lr)):
        if np.isfinite(v):
            data[k] = v
    if pinfo:
        data["pipeline_schedule"] = pinfo["schedule"]
        data["pipeline_stages"] = int(pinfo["stages"])
        data["pipeline_microbatches"] = int(pinfo["microbatches"])
        data["pipeline_bubble_frac"] = float(pinfo["bubble_frac"])
        data["pipeline_train_bubble_frac"] = float(
            pinfo["train_bubble_frac"])
    if pad is not None:
        data["padding_frac_nodes"] = float(pad["padding_frac_nodes"])
        data["padding_frac_edges"] = float(pad["padding_frac_edges"])
    data["jit_recompiles"] = recaptures
    timing = {"input_bound_frac": input_bound,
              "epoch_wait_s": stall.wait_s, "epoch_step_s": stall.step_s}
    if achieved is not None:
        timing["achieved_flops_per_s"] = achieved
    if mfu_val is not None:
        timing["mfu"] = mfu_val
    telemetry.epoch_event(epoch, data=data, timing=timing)
    return achieved, mfu_val


def _pipeline_gauges(telemetry, pinfo, step_s: float, epoch: int) -> None:
    """A pipelined run's closed-form bubble gauges and one
    `pipe.stage_idle` span a stage (cat "pipeline-model"): each stage's
    fill and drain ticks scaled to the epoch's measured step time, a
    model of the schedule, not a device measurement (JAX
    trainer.py:603-647)."""
    reg = telemetry.registry
    reg.gauge_set("pipeline_bubble_frac", float(pinfo["bubble_frac"]),
                  help="closed-form per-pass schedule bubble "
                       "(S-1)/(M+S-1)")
    reg.gauge_set("pipeline_train_bubble_frac",
                  float(pinfo["train_bubble_frac"]),
                  help="closed-form fwd+bwd train-step bubble "
                       "for the active schedule")
    rec = _spans.current_recorder()
    if rec is None or step_s <= 0:
        return
    ticks = float(pinfo["train_ticks"])
    t_end = _spans.now()
    # every stage does 2 M useful ticks a step (each microbatch crosses
    # it once forward, once backward); the rest are fill and drain
    idle_ticks = max(ticks - 2 * int(pinfo["microbatches"]), 0)
    dur = step_s * idle_ticks / max(ticks, 1.0)
    for s in range(int(pinfo["stages"])):
        rec.add("pipe.stage_idle", t_end - dur, dur, "pipeline-model",
                {"stage": s, "epoch": epoch, "idle_ticks": idle_ticks,
                 "ticks_per_step": ticks, "schedule": pinfo["schedule"]})
