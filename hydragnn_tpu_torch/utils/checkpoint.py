"""Checkpoints with preemption-safe resume metadata (counterpart:
hydragnn_tpu/utils/checkpoint.py, whose on-disk layout this keeps).

Under `<path>/<log_name>/checkpoint/` (path "./logs" by default):

* `step_<N>/` holds one save: `state.pt`, a `torch.save` of tensors and
  plain numbers only (the parameters and buffers by state-dict name, the
  optimizer state, the step), read back with `torch.load(...,
  weights_only=True)`; `resume.json`, the trainer's resume metadata; and
  `COMMITTED`, written last: line 1 the dir's name, then one `<sha256>
  <size> <file>` line per payload file. A dir without `COMMITTED` is a save
  whose writer died and is never restored;
* `LATEST` names the newest committed save; `BEST` the best-validation
  one (line 2: its own validation loss); a save writes BEST before
  LATEST, so LATEST naming it means its markers are complete;
* `gc_checkpoints` keeps the newest k committed saves plus the `LATEST` and
  `BEST` targets and deletes by rename-then-rm, so a crash mid-delete
  leaves a `.gc-` dir no reader mistakes for a checkpoint;
* restore takes the saves at or before the step `LATEST` names
  (`restorable_steps`), newest first, re-hashes the payload against the
  manifest, and falls back to the next that verifies. A committed save
  past `LATEST` is one whose writer died before its last marker: a
  resume from it would miss that save's `BEST`, so it is skipped, and a
  run killed inside its first save restarts from scratch.

Best-validation saves made during training go through
`make_async_best_checkpoint_fn`: the state is copied to the host at the
call, and one writer thread writes the files and commits them in order;
`wait_for_checkpoints` drains it.

In a multi-process run (`parallel/`) every rank calls `save_model`: the
state is copied to the host on every rank (under ZeRO the optimizer
slots are gathered whole first, a collective), rank 0 alone writes the
files and markers, and a synchronous save ends with a barrier, so no
rank goes on to read a half-written save. A checkpoint holds whole
tensors whatever the world that wrote it; a ZeRO rank restores its rows
of them. The `checkpoint-write` fault site
(utils/faults.py) fires at the start of `save_model`, in the caller's
thread: a save it kills writes nothing, so no `COMMITTED` marker, and
resume skips it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..train.train_step import TrainState
from .faults import fault_point

COMMIT_MARKER = "COMMITTED"
RESUME_META = "resume.json"
PAYLOAD = "state.pt"
# resume.json keys a resume cannot proceed without; unknown keys pass
RESUME_REQUIRED_KEYS = ("next_epoch", "step")

_log = logging.getLogger("hydragnn_tpu_torch")


class UncommittedCheckpointError(RuntimeError):
    """A BEST/LATEST marker names a step dir that is not committed: a
    writer died mid-save, or is still writing."""


def _ckpt_dir(log_name: str, path: str = "./logs") -> str:
    return os.path.abspath(os.path.join(path, log_name, "checkpoint"))


def marker_target(log_name: str, path: str = "./logs",
                  which: str = "best") -> Optional[str]:
    """The step dir the BEST (or LATEST) marker names, or None; whether
    that dir is committed is not checked (`verify_checkpoint`)."""
    if which not in ("best", "latest"):
        raise ValueError(f"which={which!r}: 'best' or 'latest'")
    try:
        with open(os.path.join(_ckpt_dir(log_name, path),
                               which.upper())) as f:
            name = f.readline().strip()
    except OSError:
        return None
    return os.path.join(_ckpt_dir(log_name, path), name) if name else None


# ------------------------------------------------------------- payload --

def _host_payload(state: TrainState) -> Dict[str, Any]:
    """The state as tensors on the host and plain numbers, the only
    things `weights_only` loads accept; under ZeRO the slots whole (a
    collective: every rank calls this)."""
    def host(ts):
        return None if ts is None else [t.detach().cpu().clone() for t in ts]
    opt = state.opt_state
    slots = opt.slots
    if opt.zero is not None:
        slots = {k: opt.zero.gather(v) for k, v in slots.items()}
    return {
        "params": {k: v.detach().cpu().clone()
                   for k, v in state.params.items()},
        "batch_stats": {k: v.detach().cpu().clone()
                        for k, v in state.batch_stats.items()},
        "opt_state": {"learning_rate": float(opt.learning_rate),
                      "count": int(opt.count),
                      "slots": {k: host(v) for k, v in slots.items()},
                      "mini_step": int(opt.mini_step),
                      "gradient_step": int(opt.gradient_step),
                      "acc_grads": host(opt.acc_grads)},
        "step": int(state.step),
    }


def _state_from_payload(payload: Dict[str, Any], like: TrainState
                        ) -> TrainState:
    """A TrainState snapshot of `payload` on the devices of `like`; raises
    ValueError when the names, shapes or dtypes differ from `like`'s."""
    def match(saved, live, what):
        if set(saved) != set(live):
            raise ValueError(
                f"checkpoint {what} names differ from the model's: missing "
                f"{sorted(set(live) - set(saved))[:4]}, unexpected "
                f"{sorted(set(saved) - set(live))[:4]}")
        out = {}
        for k, t in live.items():
            s = saved[k]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"checkpoint {what} {k!r}: {s.dtype} "
                                 f"{tuple(s.shape)}, the model's {t.dtype} "
                                 f"{tuple(t.shape)}")
            out[k] = s.to(t.device)
        return out

    def tensors(saved, live, what):
        if live is None or saved is None:
            if (live is None) != (saved is None):
                raise ValueError(f"checkpoint optimizer {what} does not "
                                 "match this config's optimizer")
            return None
        if len(saved) != len(live):
            raise ValueError(f"checkpoint optimizer {what}: {len(saved)} "
                             f"tensors, this config's {len(live)}")
        return [s.to(t.device) for s, t in zip(saved, live)]

    o = payload["opt_state"]
    lo = like.opt_state
    if set(o["slots"]) != set(lo.slots):
        raise ValueError(f"checkpoint optimizer slots {sorted(o['slots'])} "
                         f"differ from this config's {sorted(lo.slots)}")
    saved_slots = o["slots"]
    if lo.zero is not None:
        # a ZeRO rank keeps its rows of the whole saved slots
        saved_slots = {k: lo.zero.local(v) for k, v in saved_slots.items()}
    opt = dataclasses.replace(
        lo, learning_rate=float(o["learning_rate"]), count=int(o["count"]),
        slots={k: tensors(saved_slots[k], lo.slots[k], k) for k in lo.slots},
        mini_step=int(o["mini_step"]),
        gradient_step=int(o["gradient_step"]),
        acc_grads=tensors(o["acc_grads"], lo.acc_grads, "accumulator"))
    return TrainState(params=match(payload["params"], like.params, "params"),
                      batch_stats=match(payload["batch_stats"],
                                        like.batch_stats, "buffers"),
                      opt_state=opt, step=int(payload["step"]))


# --------------------------------------------------------------- saving --

def _write_marker(d: str, name: str, content: str) -> None:
    tmp = os.path.join(d, f"{name}.tmp")
    with open(tmp, "w") as f:
        f.write(content)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, name))


def _file_digest(full: str) -> str:
    h = hashlib.sha256()
    with open(full, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_lines(target: str) -> List[str]:
    """`<sha256> <size> <relpath>` per payload file of a step dir (the
    marker itself excluded)."""
    lines = []
    for dirpath, dirnames, filenames in os.walk(target):
        dirnames.sort()
        for name in sorted(filenames):
            if name in (COMMIT_MARKER, COMMIT_MARKER + ".tmp"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, target).replace(os.sep, "/")
            lines.append(f"{_file_digest(full)} {os.path.getsize(full)} "
                         f"{rel}")
    return lines


def verify_manifest(target: str) -> Optional[str]:
    """None when every file the COMMITTED marker lists verifies, else a
    description of the first bad one."""
    try:
        with open(os.path.join(target, COMMIT_MARKER)) as f:
            lines = f.read().splitlines()
    except OSError as exc:
        return f"COMMITTED marker unreadable ({exc})"
    for line in lines[1:]:
        parts = line.split(" ", 2)
        if len(parts) != 3:
            continue  # unknown trailing marker content
        digest, size, rel = parts
        full = os.path.join(target, rel.replace("/", os.sep))
        try:
            if str(os.path.getsize(full)) != size:
                return (f"payload file {rel!r} has size "
                        f"{os.path.getsize(full)}, manifest says {size}")
            if _file_digest(full) != digest:
                return f"payload file {rel!r} fails its sha256 check"
        except OSError as exc:
            return f"payload file {rel!r} is missing or unreadable ({exc})"
    return None


def _finalize_commit(target: str, metadata: Optional[Dict[str, Any]],
                     mark_best: bool, keep_last_k: Optional[int],
                     best_val: Optional[float]) -> None:
    """resume.json, then COMMITTED with the manifest, then BEST, then
    LATEST, then GC: a dir is committed only once everything a restore
    needs is on disk, and the markers only name committed dirs. LATEST
    comes last (the JAX package writes it before BEST), so a save that
    LATEST covers has its BEST too, and restore takes only such saves
    (`restorable_steps`)."""
    d = os.path.dirname(target)
    if metadata is not None:
        _write_marker(target, RESUME_META, json.dumps(metadata))
    _write_marker(target, COMMIT_MARKER, "\n".join(
        [os.path.basename(target)] + _manifest_lines(target)))
    if mark_best:
        content = os.path.basename(target)
        if best_val is not None:
            content += f"\n{best_val!r}"
        _write_marker(d, "BEST", content)
    _write_marker(d, "LATEST", os.path.basename(target))
    if keep_last_k:
        gc_checkpoints(d, keep_last_k)


def _write_step(payload: Dict[str, Any], target: str,
                metadata: Optional[Dict[str, Any]], mark_best: bool,
                keep_last_k: Optional[int],
                best_val: Optional[float]) -> None:
    """Write the payload into a fresh dir beside `target`, move it in
    place (a save of the same step replaces the older dir), commit."""
    d = os.path.dirname(target)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{os.path.basename(target)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, PAYLOAD), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(target):
        trash = os.path.join(d, f".gc-{os.path.basename(target)}")
        shutil.rmtree(trash, ignore_errors=True)
        os.replace(target, trash)
        shutil.rmtree(trash, ignore_errors=True)
    os.replace(tmp, target)
    _finalize_commit(target, metadata, mark_best, keep_last_k, best_val)


def save_model(state: TrainState, log_name: str, path: str = "./logs",
               use_async: bool = False,
               metadata: Optional[Dict[str, Any]] = None,
               mark_best: bool = False, best_val: Optional[float] = None,
               keep_last_k: Optional[int] = None) -> str:
    """Save `state` as `step_<state.step>` and commit it; returns the
    dir. `metadata` becomes resume.json; `mark_best` points BEST at this
    save (`best_val`, its validation loss, on line 2); `keep_last_k` runs
    the GC after the commit. The state is copied to the host here;
    `use_async` leaves the writing and the commit to the writer thread
    (`wait_for_checkpoints` drains it). In a process group every rank
    calls this; rank 0 writes, and a synchronous save ends with a
    barrier."""
    from ..parallel.mesh import get_comm_size_and_rank
    fault_point("checkpoint-write")
    target = os.path.join(_ckpt_dir(log_name, path),
                          f"step_{int(state.step)}")
    job = (_host_payload(state), target, metadata, mark_best, keep_last_k,
           best_val)
    world, rank = get_comm_size_and_rank()
    if rank == 0:
        if use_async:
            _WRITER.submit(job)
        else:
            _write_step(*job)
    if world > 1 and not use_async:
        torch.distributed.barrier()
    return target


class _Writer:
    """One daemon thread that writes and commits queued saves in order.
    A failed save's error is raised by the next `submit` or `wait`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"an asynchronous checkpoint save failed: "
                               f"{type(err).__name__}: {err}") from err

    def submit(self, job) -> None:
        self._raise_pending()
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="checkpoint-writer", daemon=True)
                self._thread.start()
            self._queue.put(job)

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            try:
                _write_step(*job)
            except Exception as exc:  # noqa: BLE001 — reported by wait()
                with self._lock:
                    self._error = exc
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        self._queue.join()
        self._raise_pending()


_WRITER = _Writer()


def wait_for_checkpoints() -> None:
    """Block until every asynchronous save is written and committed;
    raises if one failed."""
    _WRITER.wait()


def make_async_best_checkpoint_fn(log_name: str, path: str = "./logs",
                                  keep_last_k: Optional[int] = None,
                                  max_consecutive_failures: int = 3):
    """The trainer's best-validation callback `fn(state, epoch, val_loss,
    meta=None)`: an asynchronous save marked BEST. A failed save (raised
    by the next call) is logged; `max_consecutive_failures` in a row
    raise, so a dead filesystem cannot yield a run without checkpoints."""
    failures = [0]

    def ckpt_fn(state, epoch, val_loss, meta=None):
        try:
            save_model(state, log_name, path=path, use_async=True,
                       metadata=meta, mark_best=True,
                       best_val=float(val_loss), keep_last_k=keep_last_k)
            failures[0] = 0
        except (OSError, RuntimeError) as exc:
            failures[0] += 1
            _log.warning("checkpoint save failed (%d/%d consecutive): %s",
                         failures[0], max_consecutive_failures, exc)
            if failures[0] >= max_consecutive_failures:
                raise RuntimeError(
                    f"checkpointing failed {failures[0]} times in a row "
                    f"(last: {exc}); fix the checkpoint filesystem or "
                    "disable Training.Checkpoint") from exc
    return ckpt_fn


# ------------------------------------------------------------ retention --

def _step_dirs(d: str) -> List[Tuple[int, str]]:
    """(step, path) of every step_<N> dir, newest first."""
    out = []
    for p in os.listdir(d):
        full = os.path.join(d, p)
        if (p.startswith("step_") and p[5:].isdigit()
                and os.path.isdir(full)):
            out.append((int(p[5:]), full))
    return sorted(out, reverse=True)


def gc_checkpoints(d: str, keep_last_k: int) -> int:
    """Keep the newest `keep_last_k` committed step dirs and the LATEST
    and BEST targets; delete the rest by rename-then-rm, with
    `.gc-` leftovers and uncommitted dirs older than the newest committed
    one (dead writers). Returns the number of dirs removed."""
    keep_last_k = max(int(keep_last_k), 1)
    for p in os.listdir(d):
        if p.startswith(".gc-"):
            shutil.rmtree(os.path.join(d, p), ignore_errors=True)
    protected = set()
    for marker in ("LATEST", "BEST"):
        try:
            with open(os.path.join(d, marker)) as f:
                protected.add(f.readline().strip())
        except OSError:
            pass
    all_steps = _step_dirs(d)
    committed = [(s, full) for s, full in all_steps
                 if os.path.exists(os.path.join(full, COMMIT_MARKER))]
    victims = list(committed[keep_last_k:])
    if committed:
        newest = committed[0][0]
        victims += [(s, full) for s, full in all_steps if s < newest
                    and not os.path.exists(os.path.join(full,
                                                        COMMIT_MARKER))]
    removed = 0
    for _, full in victims:
        if os.path.basename(full) in protected:
            continue
        trash = os.path.join(d, f".gc-{os.path.basename(full)}")
        try:
            os.replace(full, trash)
        except OSError:
            continue  # a racing reader or writer: the next GC retries
        shutil.rmtree(trash, ignore_errors=True)
        removed += 1
    return removed


# -------------------------------------------------------------- restore --

def verify_checkpoint(target: str, deep: bool = False) -> bool:
    """A step dir is restorable when it is committed and holds its
    payload; `deep` re-hashes every file against the manifest."""
    if not (os.path.isdir(target)
            and os.path.exists(os.path.join(target, COMMIT_MARKER))
            and os.path.exists(os.path.join(target, PAYLOAD))):
        return False
    if deep:
        bad = verify_manifest(target)
        if bad is not None:
            _log.warning("checkpoint %s fails its integrity manifest (%s); "
                         "treating it as corrupt", target, bad)
            return False
    return True


def load_checkpoint_metadata(target: str) -> Optional[Dict[str, Any]]:
    """The resume metadata saved with a checkpoint, or None."""
    try:
        with open(os.path.join(target, RESUME_META)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def validate_resume_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ValueError naming the first missing required key; unknown
    keys pass through (newer writers must not break older readers)."""
    for key in RESUME_REQUIRED_KEYS:
        if key not in meta:
            raise ValueError(
                f"resume.json is missing required key {key!r} (has "
                f"{sorted(meta)}): the resume metadata is incomplete or "
                "from an incompatible writer — delete the step dir's "
                "resume.json to restore the weights without the trainer "
                "state")
    return meta


# what a torn, foreign or mismatched payload raises on load
_LOAD_ERRORS = (OSError, RuntimeError, ValueError, KeyError, EOFError,
                pickle.UnpicklingError)


def _load(target: str, like: TrainState) -> TrainState:
    payload = torch.load(os.path.join(target, PAYLOAD), map_location="cpu",
                         weights_only=True)
    return _state_from_payload(payload, like)


def _latest_step(d: str) -> Optional[int]:
    """The step LATEST names, or None without a readable LATEST."""
    try:
        with open(os.path.join(d, "LATEST")) as f:
            name = f.readline().strip()
    except OSError:
        return None
    return int(name[5:]) if (name.startswith("step_")
                             and name[5:].isdigit()) else None


def restorable_steps(d: str) -> List[int]:
    """The committed steps under the checkpoint dir `d` that a restore
    may take, newest first: those at or before the step LATEST names,
    none without LATEST. A save writes LATEST last, so a committed dir
    past it belongs to a writer killed before its BEST or LATEST; the run
    that resumes retrains that stretch instead, as an uninterrupted run
    trained it."""
    latest = _latest_step(d) if os.path.isdir(d) else None
    if latest is None:
        return []
    return [s for s, full in _step_dirs(d) if s <= latest
            and os.path.exists(os.path.join(full, COMMIT_MARKER))]


def _restore_candidates(d: str) -> List[str]:
    """The restorable step dirs that verify, newest first (the LATEST
    target first)."""
    steps = set(restorable_steps(d))
    return [full for s, full in _step_dirs(d)
            if s in steps and verify_checkpoint(full)]


def load_existing_model(state_like: TrainState, log_name: str,
                        path: str = "./logs", with_metadata: bool = False):
    """A TrainState snapshot of the newest verified checkpoint, on the
    devices of `state_like` (whose names and shapes it must have), or None
    without one; with `with_metadata`, (state, resume metadata or None).
    An uncommitted, corrupt or mismatched dir is skipped with a warning
    and the next-newest verified one tried."""
    none = (None, None) if with_metadata else None
    d = _ckpt_dir(log_name, path)
    if not os.path.isdir(d):
        return none
    for target in _restore_candidates(d):
        if not verify_checkpoint(target, deep=True):
            continue
        try:
            restored = _load(target, state_like)
        except _LOAD_ERRORS as exc:
            _log.warning("checkpoint %s is unrestorable (%s: %s); falling "
                         "back to the previous verified step", target,
                         type(exc).__name__, exc)
            continue
        if with_metadata:
            return restored, load_checkpoint_metadata(target)
        return restored
    return none


def load_best_model(state_like: TrainState, log_name: str,
                    path: str = "./logs", with_val: bool = False):
    """A TrainState snapshot of the checkpoint BEST names, or None when
    there is none or it does not verify; with `with_val`, (state, the
    save's own validation loss or None)."""
    none = (None, None) if with_val else None
    d = _ckpt_dir(log_name, path)
    try:
        with open(os.path.join(d, "BEST")) as f:
            lines = f.read().splitlines()
    except OSError:
        return none
    target = os.path.join(d, lines[0].strip())
    val = float(lines[1]) if len(lines) > 1 else None
    if not verify_checkpoint(target, deep=True):
        return none
    try:
        restored = _load(target, state_like)
    except _LOAD_ERRORS as exc:
        _log.warning("BEST checkpoint %s is unrestorable (%s: %s)", target,
                     type(exc).__name__, exc)
        return none
    return (restored, val) if with_val else restored
