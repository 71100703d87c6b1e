"""Fault-tolerant HPO trial supervision (counterpart:
hydragnn_tpu/hpo/supervisor.py, whose state machine, ledger events,
fault-site order and counters this keeps).

``TrialSupervisor`` runs N concurrent trials as child jobs and drives
every trial to a terminal state however it dies:

* a per-trial state machine ``pending -> running -> {completed,
  resuming, pruned, failed}`` (``resuming`` loops back to ``running``
  through a bounded retry with exponential backoff);
* a heartbeat watchdog: a running trial whose progress token (its newest
  committed checkpoint step and its log's size, for process trials) does
  not change within ``heartbeat_s`` is killed and treated as preempted;
* resume from LATEST through the checkpoints' COMMITTED / resume.json
  contract (utils/checkpoint.py), so a trial killed anywhere retrains its
  uninterrupted trajectory bit for bit;
* deterministic chaos: the ``trial-spawn-fail`` / ``trial-hang`` /
  ``trial-kill`` fault sites (utils/faults.py) are consulted once per
  trial, at its first launch, in trial-id order.

Telemetry: the counters ``hpo.resumes_total``, ``hpo.preemptions_total``
and ``hpo.trials_total{outcome}`` and the gauge ``hpo.trials_per_hour``
on the process registry (telemetry/registry.py), and one span per trial
(``hpo.trial_<id>``, telemetry/spans.py) when a session is recording.

The supervisor does not know how a trial runs: ``launch_fn(spec,
attempt, resume, hang)`` returns a ``TrialHandle``
(``hpo.process.ProcessLauncher`` for child training processes, fakes in
the tests).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

from ..utils.faults import InjectedFault, fault_point
from .ledger import TrialLedger

# the trial state machine: transient states on the left,
# terminal states — every trial ends in exactly one — on the right
PENDING = "pending"
RUNNING = "running"
RESUMING = "resuming"
COMPLETED = "completed"
PRUNED = "pruned"
FAILED = "failed"
TERMINAL_STATES = (COMPLETED, PRUNED, FAILED)


@dataclasses.dataclass
class TrialSpec:
    """One trial: hyperparameters + the seed supervisor-side derived
    choices (the PBT perturbation) are drawn from — child training is
    deterministic in the params alone, so two trials with equal params
    train bit-identically regardless of seed. ``forked_from`` names the
    donor trial for a PBT exploit fork; the launcher is responsible for
    adopting the donor's BEST checkpoint (pbt.py)."""

    trial_id: int
    params: Dict[str, Any]
    seed: int = 0
    forked_from: Optional[int] = None
    fork_val: Optional[float] = None


class TrialHandle:
    """What the supervisor needs from a launched trial. Implementations:
    hpo.process.ProcessTrialHandle (subprocess); test fakes."""

    def poll(self) -> Optional[int]:
        """None while running, else the exit code."""
        raise NotImplementedError

    def kill(self) -> None:
        """Force-terminate (idempotent; must reap any process group)."""
        raise NotImplementedError

    def progress(self) -> Any:
        """Hashable progress token; any CHANGE counts as a heartbeat
        (process trials: newest committed checkpoint step + log size)."""
        return ()

    def checkpoint_step(self) -> Optional[int]:
        """Newest COMMITTED checkpoint step, or None before the first
        commit — the ``trial-kill`` site fires at this milestone so the
        injected preemption provably exercises restore, not restart."""
        return None

    def result(self) -> Optional[Dict[str, Any]]:
        """The trial's result payload once it completed, else None."""
        return None


class _Trial:
    """Mutable supervisor-side record (internal; snapshot() is the API)."""

    def __init__(self, spec: TrialSpec):
        self.spec = spec
        self.state = PENDING
        self.attempts = 0          # launches so far
        self.resumes = 0           # relaunches that restored a checkpoint
        self.preemptions = 0       # kills/hangs/crashes observed
        self.objective: Optional[float] = None
        self.outcome_reason = ""
        self.handle: Optional[TrialHandle] = None
        self.ran_once = False      # some attempt actually started
        self.kill_marked = False   # this launch dies at its first commit
        self.kill_missed = False   # trial finished before the kill landed
        self.last_progress: Any = None
        self.last_progress_t = 0.0
        self.next_launch_t = 0.0
        self.prune_requested = False
        self.started_t: Optional[float] = None
        self.finished_t: Optional[float] = None


@dataclasses.dataclass
class TrialRecord:
    """Immutable terminal-state summary returned by run()/snapshot()."""

    trial_id: int
    params: Dict[str, Any]
    state: str
    attempts: int
    resumes: int
    preemptions: int
    objective: Optional[float]
    outcome_reason: str
    kill_missed: bool
    duration_s: Optional[float]


class TrialSupervisor:
    """Runs trials to terminal states under chaos (module docstring).

    ``launch_fn(spec, attempt, resume, hang) -> TrialHandle`` launches
    one attempt; it may raise (a real scheduler rejection or the
    ``trial-spawn-fail`` site), which counts against the retry budget
    like any other preemption. The run loop is single-threaded; the lock
    exists because ``prune``/``shutdown``/``snapshot`` may be called
    from other threads."""

    def __init__(self, launch_fn: Callable[..., TrialHandle],
                 trials: Sequence[TrialSpec], *,
                 max_retries: int = 2, heartbeat_s: float = 120.0,
                 backoff_s: float = 1.0, concurrency: int = 1,
                 poll_interval_s: float = 0.05,
                 ledger: Optional[TrialLedger] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        ids = [int(t.trial_id) for t in trials]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate trial ids: {sorted(ids)}")
        self._launch_fn = launch_fn
        self._max_retries = max(int(max_retries), 0)
        self._heartbeat_s = max(float(heartbeat_s), 0.05)
        self._backoff_s = max(float(backoff_s), 0.0)
        self._concurrency = max(int(concurrency), 1)
        self._poll_interval_s = max(float(poll_interval_s), 0.001)
        self._time = time_fn
        self.ledger = ledger if ledger is not None else TrialLedger()
        self._lock = threading.Lock()
        self._trials: Dict[int, _Trial] = {  # guarded-by: _lock
            int(t.trial_id): _Trial(t) for t in trials}
        self._closed = False  # guarded-by: _lock
        self._run_started_t: Optional[float] = None

    # ------------------------------------------------------------- queries

    def snapshot(self) -> Dict[int, TrialRecord]:
        """Point-in-time public view of every trial."""
        with self._lock:
            return {tid: self._record(t)
                    for tid, t in sorted(self._trials.items())}

    # holds-lock: _lock
    def _record(self, t: _Trial) -> TrialRecord:
        dur = None
        if t.started_t is not None:
            dur = (t.finished_t if t.finished_t is not None
                   else self._time()) - t.started_t
        return TrialRecord(
            trial_id=t.spec.trial_id, params=dict(t.spec.params),
            state=t.state, attempts=t.attempts, resumes=t.resumes,
            preemptions=t.preemptions, objective=t.objective,
            outcome_reason=t.outcome_reason, kill_missed=t.kill_missed,
            duration_s=dur)

    # -------------------------------------------------------- control API

    def add_trial(self, spec: TrialSpec) -> None:
        """Register a new trial (PBT forks arrive mid-run)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("supervisor is shut down")
            if int(spec.trial_id) in self._trials:
                raise ValueError(f"trial {spec.trial_id} already exists")
            self._trials[int(spec.trial_id)] = _Trial(spec)

    def fork_trial(self, donor_id: int, trial_id: int,
                   space: Dict[str, Any], *, donor_val: Optional[float]
                   = None) -> TrialSpec:
        """PBT exploit/explore: register a new trial whose params are the
        donor's, perturbed deterministically from the NEW trial's seed
        (= trial_id, so the fork is a pure function of the pair). The
        launcher adopts the donor's BEST checkpoint (pbt.fork_checkpoint)
        when it sees ``forked_from``."""
        from .pbt import perturb_params
        with self._lock:
            donor = self._trials.get(int(donor_id))
            if donor is None:
                raise ValueError(f"unknown donor trial {donor_id}")
            params = perturb_params(donor.spec.params, space, int(trial_id))
        spec = TrialSpec(trial_id=int(trial_id), params=params,
                         seed=int(trial_id), forked_from=int(donor_id),
                         fork_val=donor_val)
        self.add_trial(spec)
        return spec

    def prune(self, trial_id: int) -> None:
        """Request a trial be pruned: killed if running, terminal state
        ``pruned``. Safe from any thread; the run loop applies it."""
        with self._lock:
            t = self._trials.get(int(trial_id))
            if t is None:
                raise ValueError(f"unknown trial {trial_id}")
            if t.state not in TERMINAL_STATES:
                t.prune_requested = True

    def shutdown(self) -> None:
        """Kill every running trial and stop the run loop; any trial not
        yet terminal goes FAILED (reason ``shutdown``) so the
        every-trial-terminal contract holds on this path too. Idempotent
        (a completed run's finally-shutdown is a no-op); zero child
        processes survive it."""
        with self._lock:
            self._closed = True
            handles = [t.handle for t in self._trials.values()
                       if t.state == RUNNING and t.handle is not None]
        for h in handles:  # kill() may block on process reaping: not
            # under the lock
            try:
                h.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        now = self._time()
        with self._lock:
            for _, t in sorted(self._trials.items()):
                if t.state not in TERMINAL_STATES:
                    self._terminal_locked(t, FAILED, now,
                                          reason="shutdown")

    # ----------------------------------------------------------- run loop

    def run(self, deadline_s: Optional[float] = None
            ) -> Dict[int, TrialRecord]:
        """Drive every trial to a terminal state; returns the records.
        ``deadline_s`` bounds the whole run: on expiry, running trials
        are killed and non-terminal trials marked failed (reason
        ``deadline``) — the supervisor itself must terminate even when a
        launcher misbehaves."""
        self._run_started_t = self._time()
        try:
            while True:
                now = self._time()
                if deadline_s is not None and \
                        now - self._run_started_t > deadline_s:
                    self._expire_deadline()
                    break
                if not self._tick(now):
                    break
                time.sleep(self._poll_interval_s)
        finally:
            self.shutdown()
            self._report_summary()
        return self.snapshot()

    def _tick(self, now: float) -> bool:
        """One scheduling pass; False when every trial is terminal or
        shutdown was requested."""
        with self._lock:
            if self._closed:
                return False
            pending = [t for _, t in sorted(self._trials.items())
                       if t.state in (PENDING, RESUMING)
                       and t.next_launch_t <= now]
            running = [t for _, t in sorted(self._trials.items())
                       if t.state == RUNNING]
            slots = self._concurrency - len(running)
            open_states = any(t.state not in TERMINAL_STATES
                              for t in self._trials.values())
        for t in pending[:max(slots, 0)]:
            self._launch(t, now)
        with self._lock:
            running = [t for _, t in sorted(self._trials.items())
                       if t.state == RUNNING]
        for t in running:
            self._poll_trial(t, now)
        return open_states

    def _launch(self, t: _Trial, now: float) -> None:
        """One launch attempt. The three trial fault sites are consulted
        only at a trial's FIRST launch, in fixed order: first launches
        happen in trial-id order (the scheduler fills slots from the
        sorted pending list and retries never consult again), so site
        index k deterministically names the k-th registered trial no
        matter how retries of earlier trials interleave — the
        ledger-determinism contract.
        Any launch failure — injected or real — consumes retry budget
        exactly like a crash."""
        attempt = t.attempts
        with self._lock:
            # a shutdown racing the launch phase: the trial was already
            # marked terminal — launching now would spawn a child nobody
            # owns and fire a duplicate terminal event
            if self._closed or t.state in TERMINAL_STATES:
                return
            prune = t.prune_requested
        if prune:
            if attempt == 0:
                # a pruned trial never launches, but its one-shot
                # consultations are still consumed (results discarded)
                # so every LATER trial's site index stays aligned with
                # registration order — the "index k names the k-th
                # registered trial" contract
                self._consult("trial-spawn-fail")
                self._consult("trial-hang")
                self._consult("trial-kill")
            with self._lock:
                if t.state not in TERMINAL_STATES:
                    self._terminal_locked(t, PRUNED, now, reason="pruned")
            return
        if attempt == 0:
            spawn_fail = self._consult("trial-spawn-fail")
            hang = self._consult("trial-hang")
            kill = self._consult("trial-kill")
        else:
            spawn_fail = hang = kill = False
        # resume only when a previous attempt actually ran: after a
        # spawn failure there is nothing on disk to continue from
        resume = t.ran_once
        handle = None
        error = ""
        if spawn_fail:
            error = "injected: trial-spawn-fail"
        else:
            try:
                handle = self._launch_fn(t.spec, attempt, resume, hang)
            except Exception as exc:  # noqa: BLE001 — scheduler rejection
                error = f"{type(exc).__name__}: {exc}"
        orphan = None
        with self._lock:
            # the stillborn re-check and the state mutation share ONE
            # critical section: a shutdown() completing between two
            # separate acquisitions could mark the trial terminal and
            # then watch this launch resurrect it to RUNNING (duplicate
            # terminal events)
            if self._closed or t.state in TERMINAL_STATES:
                orphan = handle
            elif handle is None:
                t.attempts += 1
                if t.started_t is None:
                    t.started_t = now
                self.ledger.event(
                    t.spec.trial_id, "spawn-failed",
                    data={"attempt": attempt, "error": error})
                self._preempted_locked(t, now, reason="spawn-fail")
            else:
                t.attempts += 1
                if t.started_t is None:
                    t.started_t = now
                t.handle = handle
                t.ran_once = True
                t.kill_marked = kill
                t.last_progress = None
                t.last_progress_t = now
                if resume:
                    t.resumes += 1
                    self._counter(
                        "hpo.resumes_total",
                        help="trial relaunches resuming from LATEST")
                t.state = RUNNING
                self.ledger.event(
                    t.spec.trial_id, "launched",
                    data={"attempt": attempt, "resume": resume,
                          "injected_hang": hang, "injected_kill": kill,
                          "params": dict(t.spec.params),
                          "forked_from": t.spec.forked_from})
        if orphan is not None:
            try:
                orphan.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def _poll_trial(self, t: _Trial, now: float) -> None:
        with self._lock:
            if t.state != RUNNING or t.handle is None:
                return
            handle = t.handle
        rc = handle.poll()
        if rc is not None:
            self._handle_exit(t, handle, rc, now)
            return
        # prune: terminal, no retry
        with self._lock:
            prune = t.prune_requested
        if prune:
            handle.kill()
            with self._lock:
                self._terminal_locked(t, PRUNED, now, reason="pruned")
            return
        # injected preemption: SIGKILL at the first committed checkpoint
        # so the recovery provably restores rather than restarts
        with self._lock:
            kill_marked = t.kill_marked
        if kill_marked and handle.checkpoint_step() is not None:
            handle.kill()
            with self._lock:
                t.kill_marked = False
                self.ledger.event(
                    t.spec.trial_id, "killed",
                    data={"attempt": t.attempts - 1,
                          "reason": "injected-kill"})
                self._preempted_locked(t, now, reason="injected-kill")
            return
        # heartbeat watchdog: no checkpoint/log progress within the
        # deadline -> the trial is hung; kill and treat as preempted
        token = handle.progress()
        with self._lock:
            if token != t.last_progress:
                t.last_progress = token
                t.last_progress_t = now
                return
            hung = now - t.last_progress_t > self._heartbeat_s
        if hung:
            handle.kill()
            with self._lock:
                self.ledger.event(
                    t.spec.trial_id, "hung",
                    data={"attempt": t.attempts - 1},
                    timing={"stalled_s": round(now - t.last_progress_t,
                                               3)})
                self._preempted_locked(t, now, reason="hang")

    def _handle_exit(self, t: _Trial, handle: TrialHandle, rc: int,
                     now: float) -> None:
        result = handle.result() if rc == 0 else None
        # reap the whole group on EVERY exit (result already read): a
        # crash-exited leader can leave grandchildren holding devices
        # that would otherwise survive relaunch after relaunch
        try:
            handle.kill()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        with self._lock:
            if t.state != RUNNING:
                return
            if t.prune_requested:
                self._terminal_locked(t, PRUNED, now, reason="pruned")
                return
            if rc == 0 and result is not None:
                if t.kill_marked:
                    # the injected kill never landed (the trial finished
                    # first) — record it; determinism of the ledger's
                    # data bucket rests on sizing trials so this is rare
                    t.kill_missed = True
                obj = result.get("objective")
                t.objective = None if obj is None else float(obj)
                self._terminal_locked(t, COMPLETED, now,
                                      reason="completed")
                return
            reason = ("exit-0-without-result" if rc == 0
                      else f"exit-{rc}")
            self._preempted_locked(t, now, reason=reason)

    # holds-lock: _lock
    def _preempted_locked(self, t: _Trial, now: float,
                          reason: str) -> None:
        """Crash/kill/hang/spawn-failure: bounded retry with exponential
        backoff, else terminal ``failed``. A pending prune wins over the
        retry — a pruned trial must never relaunch (nor exhaust its
        budget into FAILED)."""
        t.handle = None
        t.kill_marked = False
        t.preemptions += 1
        if t.prune_requested:
            self._terminal_locked(t, PRUNED, now, reason="pruned")
            return
        self._counter("hpo.preemptions_total",
                      help="trial deaths observed (kill/hang/crash/"
                           "spawn-fail)")
        retries_used = t.attempts - 1
        if retries_used >= self._max_retries:
            self._terminal_locked(
                t, FAILED, now,
                reason=f"{reason} (retries exhausted)")
            return
        t.state = RESUMING
        t.next_launch_t = now + self._backoff_s * (2 ** retries_used)
        self.ledger.event(t.spec.trial_id, "state",
                          data={"to": RESUMING, "reason": reason,
                                "attempt": t.attempts - 1})

    # holds-lock: _lock
    def _terminal_locked(self, t: _Trial, state: str, now: float,
                         reason: str) -> None:
        t.state = state
        t.outcome_reason = reason
        t.handle = None
        t.finished_t = now
        self._counter("hpo.trials_total", outcome=state,
                      help="trials by terminal outcome")
        self.ledger.event(
            t.spec.trial_id, "terminal",
            data={"state": state, "reason": reason,
                  "attempts": t.attempts, "resumes": t.resumes,
                  "preemptions": t.preemptions,
                  "objective": t.objective,
                  "kill_missed": t.kill_missed},
            timing={"duration_s": None if t.started_t is None
                    else round(now - t.started_t, 3)})
        self._span(t, now)

    def _expire_deadline(self) -> None:
        """Deadline expiry: kill running trials, fail the non-terminal."""
        with self._lock:
            live = [t for _, t in sorted(self._trials.items())
                    if t.state not in TERMINAL_STATES]
            handles = [t.handle for t in live if t.handle is not None]
        for h in handles:
            try:
                h.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        now = self._time()
        with self._lock:
            for t in live:
                self._terminal_locked(t, FAILED, now, reason="deadline")

    # --------------------------------------------------------- telemetry

    def _counter(self, name: str, *, help: str = "", **labels) -> None:
        from ..telemetry.registry import get_registry
        get_registry().counter_inc(name, help=help, **labels)

    def _span(self, t: _Trial, now: float) -> None:
        """Per-trial span into a live telemetry session."""
        from ..telemetry import spans
        if not spans.enabled() or t.started_t is None:
            return
        dur = max(now - t.started_t, 0.0)
        # translate onto the span clock: the supervisor times with its
        # own time_fn, which need not share the recorder's clock base
        spans.record(f"hpo.trial_{t.spec.trial_id}", spans.now() - dur,
                     dur, cat="hpo", state=t.state, attempts=t.attempts,
                     resumes=t.resumes)

    def _report_summary(self) -> None:
        """trials/hour gauge over the whole run (completed trials)."""
        if self._run_started_t is None:
            return
        elapsed = max(self._time() - self._run_started_t, 1e-9)
        with self._lock:
            done = sum(1 for t in self._trials.values()
                       if t.state == COMPLETED)
        from ..telemetry.registry import get_registry
        get_registry().gauge_set("hpo.trials_per_hour",
                                 done / elapsed * 3600.0,
                                 help="completed trials per hour")

    @staticmethod
    def _consult(site: str) -> bool:
        """One fault-site check -> did it fire for this invocation."""
        try:
            fault_point(site)
        except InjectedFault:
            return True
        return False
