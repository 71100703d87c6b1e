"""Elastic multi-process training supervision (counterpart:
hydragnn_tpu/elastic/supervisor.py, whose state machine, ledger events,
fault-site order and counters this keeps).

One dead or wedged rank leaves every survivor blocked inside a
collective. ``JobSupervisor`` launches the W ranks of one data-parallel
training job, watches each rank's progress token (the newest committed
checkpoint step and the rank's log size), and on any rank's death, hang
or spawn failure makes a *coordinated abort*: it kills every rank of the
generation, because a hung collective cannot be recovered in place, and
restarts the whole job from LATEST through the checkpoints' resume
contract (utils/checkpoint.py).

A restart generation may run at another world size W'
(``world_schedule``). The data is one global pack plan, computed from the
global sample order before it is sliced per (rank, shard), and a
checkpoint holds whole tensors whatever the world that wrote it (a ZeRO
rank restores its rows); so a W' restart re-slices the same plan and
restores the same state. With the same total shard count the step
counts and each step's global batch are equal at any W'.

Deterministic chaos: the ``rank-spawn-fail`` / ``rank-hang`` /
``rank-kill`` fault sites (utils/faults.py) are consulted once per rank
launch; generations launch one after another, ranks in rank order.

Telemetry: the counters ``elastic.rank_failures_total{reason}``,
``elastic.restarts_total`` and ``elastic.jobs_total{outcome}`` and the
gauges ``elastic.world_size`` and ``elastic.generations_total`` on the
process registry (telemetry/registry.py).

The supervisor does not know how a rank runs: ``launch_fn(generation,
world_size, rank, resume, hang)`` returns a ``RankHandle``
(``elastic.process.RankProcessLauncher`` for child rank processes, fakes
in the tests).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils.faults import InjectedFault, fault_point
from .ledger import JOB, JobLedger

# the job state machine: transient states on the
# left, terminal states — every job ends in exactly one — on the right
PENDING = "pending"
RUNNING = "running"
RESTARTING = "restarting"
COMPLETED = "completed"
FAILED = "failed"
TERMINAL_STATES = (COMPLETED, FAILED)


class RankHandle:
    """What the supervisor needs from one launched rank. Implementations:
    elastic.process.RankProcessHandle (subprocess); test fakes."""

    def poll(self) -> Optional[int]:
        """None while running, else the exit code."""
        raise NotImplementedError

    def kill(self) -> None:
        """Force-terminate (idempotent; must reap any process group)."""
        raise NotImplementedError

    def progress(self) -> Any:
        """Hashable progress token; any CHANGE counts as a heartbeat
        (process ranks: newest committed checkpoint step + log size).
        A rank wedged in a collective stops producing BOTH signals, so
        a single hung peer surfaces on every rank — the watchdog needs
        only one of them to go stale."""
        return ()

    def checkpoint_step(self) -> Optional[int]:
        """Newest COMMITTED checkpoint step of the JOB (the checkpoint
        dir is shared across ranks), or None before the first commit —
        the ``rank-kill`` site fires at the first commit of the
        generation so the injected preemption provably exercises
        restore, not restart."""
        return None

    def result(self) -> Optional[Dict[str, Any]]:
        """The job's result payload once this rank completed (rank 0
        writes it), else None."""
        return None


class _Rank:
    """Mutable per-rank record of the CURRENT generation (internal)."""

    def __init__(self, rank: int, handle: RankHandle, now: float,
                 kill_marked: bool):
        self.rank = rank
        self.handle = handle
        self.exited: Optional[int] = None
        self.kill_marked = kill_marked
        self.last_progress: Any = None
        self.last_progress_t = now


@dataclasses.dataclass
class JobRecord:
    """Immutable job summary returned by run()/snapshot()."""

    state: str
    generations: int
    restarts: int
    rank_failures: int
    world_sizes: List[int]
    outcome_reason: str
    result: Optional[Dict[str, Any]]
    duration_s: Optional[float]


class JobSupervisor:
    """Runs one multi-process training job to a terminal state under
    chaos (module docstring).

    ``launch_fn(generation, world_size, rank, resume, hang)`` launches
    one rank; it may raise (a real scheduler rejection or the
    ``rank-spawn-fail`` site), which aborts the generation and counts
    against the restart budget like any other rank failure. The run
    loop is single-threaded; the lock exists because ``shutdown`` /
    ``snapshot`` may be called from other threads."""

    def __init__(self, launch_fn: Callable[..., RankHandle], *,
                 world_size: int,
                 world_schedule: Optional[Sequence[int]] = None,
                 max_restarts: int = 2, heartbeat_s: float = 120.0,
                 backoff_s: float = 1.0, poll_interval_s: float = 0.2,
                 ledger: Optional[JobLedger] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        # poll default is coarser than the TrialSupervisor's 0.05 s:
        # every rank's progress token re-globs the SHARED checkpoint
        # dir, so one tick costs W directory sweeps — and every
        # detection latency here is heartbeat-scale anyway
        schedule = [int(w) for w in (world_schedule or [world_size])]
        if not schedule or any(w < 1 for w in schedule):
            raise ValueError(
                f"world_schedule must list world sizes >= 1 per "
                f"generation, got {schedule}")
        if int(world_size) != schedule[0]:
            raise ValueError(
                f"world_schedule[0] ({schedule[0]}) must equal "
                f"world_size ({world_size}) — generation 0 runs at the "
                "requested world size")
        self._launch_fn = launch_fn
        self._schedule = schedule
        self._max_restarts = max(int(max_restarts), 0)
        self._heartbeat_s = max(float(heartbeat_s), 0.05)
        self._backoff_s = max(float(backoff_s), 0.0)
        self._poll_interval_s = max(float(poll_interval_s), 0.001)
        self._time = time_fn
        self.ledger = ledger if ledger is not None else JobLedger()
        self._lock = threading.Lock()
        self._state = PENDING          # guarded-by: _lock
        self._ranks: List[_Rank] = []  # guarded-by: _lock
        self._closed = False           # guarded-by: _lock
        self._generation = 0           # guarded-by: _lock
        self._restarts = 0             # guarded-by: _lock
        self._rank_failures = 0        # guarded-by: _lock
        self._world_sizes: List[int] = []  # guarded-by: _lock
        self._ran_once = False         # guarded-by: _lock
        self._outcome_reason = ""      # guarded-by: _lock
        self._result: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        self._next_launch_t = 0.0      # guarded-by: _lock
        self._gen_start_step: Optional[int] = None  # guarded-by: _lock
        self._started_t: Optional[float] = None
        self._finished_t: Optional[float] = None  # guarded-by: _lock

    # ------------------------------------------------------------- queries

    def snapshot(self) -> JobRecord:
        """Point-in-time public view of the job."""
        with self._lock:
            return self._record()

    # holds-lock: _lock
    def _record(self) -> JobRecord:
        dur = None
        if self._started_t is not None:
            end = (self._finished_t if self._finished_t is not None
                   else self._time())
            dur = end - self._started_t
        return JobRecord(
            state=self._state, generations=self._generation,
            restarts=self._restarts, rank_failures=self._rank_failures,
            world_sizes=list(self._world_sizes),
            outcome_reason=self._outcome_reason,
            result=self._result, duration_s=dur)

    def _world_for(self, generation: int) -> int:
        """World size of a generation: the schedule entry, last repeats
        (a schedule shorter than the restart budget keeps restarting at
        its final world size)."""
        return self._schedule[min(generation, len(self._schedule) - 1)]

    # -------------------------------------------------------- control API

    def shutdown(self) -> None:
        """Kill every rank and stop the run loop; a non-terminal job
        goes FAILED (reason ``shutdown``) so the every-job-terminal
        contract holds on this path too. Idempotent; zero child process
        groups survive it."""
        with self._lock:
            self._closed = True
            handles = [r.handle for r in self._ranks
                       if r.handle is not None]
        for h in handles:  # kill() may block on process reaping: not
            # under the lock
            try:
                h.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        now = self._time()
        with self._lock:
            if self._state not in TERMINAL_STATES:
                self._terminal_locked(FAILED, now, reason="shutdown")
            self._ranks = []

    # ----------------------------------------------------------- run loop

    def run(self, deadline_s: Optional[float] = None) -> JobRecord:
        """Drive the job to a terminal state; returns the record.
        ``deadline_s`` bounds the whole run: on expiry every rank is
        killed and the job marked failed (reason ``deadline``) — the
        supervisor itself must terminate even when a launcher
        misbehaves."""
        self._started_t = self._time()
        try:
            while True:
                now = self._time()
                if deadline_s is not None and \
                        now - self._started_t > deadline_s:
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
        """One scheduling pass; False when the job is terminal or
        shutdown was requested."""
        with self._lock:
            if self._closed or self._state in TERMINAL_STATES:
                return False
            state = self._state
            launch_due = self._next_launch_t <= now
        if state in (PENDING, RESTARTING) and launch_due:
            self._launch_generation(now)
        elif state == RUNNING:
            self._poll_generation(now)
        with self._lock:
            return self._state not in TERMINAL_STATES

    def _launch_generation(self, now: float) -> None:
        """Launch every rank of the next generation, in rank order.

        The three rank fault sites are consulted once per rank launch:
        generations launch sequentially from the single-threaded run
        loop and ranks within a generation in rank order, so site index
        k deterministically names the k-th rank launch of the job — the
        ledger-determinism contract. Any launch failure — injected or
        real — aborts the generation (already-launched ranks are
        killed; a partial world would wedge at rendezvous) and counts
        against the restart budget exactly like a rank death."""
        with self._lock:
            if self._closed or self._state in TERMINAL_STATES:
                return
            gen = self._generation
            resume = self._ran_once
        world = self._world_for(gen)
        # ledger writes are serialized under _lock everywhere (shutdown
        # may append the terminal event from another thread and the
        # ledger itself is single-writer by design)
        with self._lock:
            self.ledger.event(JOB, "generation",
                              data={"generation": gen,
                                    "world_size": world,
                                    "resume": resume})
        handles: List[RankHandle] = []
        fail_reason = fail_rank = None
        injected: List[Dict[str, bool]] = []
        for rank in range(world):
            spawn_fail = self._consult("rank-spawn-fail")
            hang = self._consult("rank-hang")
            kill = self._consult("rank-kill")
            injected.append({"hang": hang, "kill": kill})
            if spawn_fail:
                error = "injected: rank-spawn-fail"
            else:
                error = None
                try:
                    handle = self._launch_fn(gen, world, rank, resume,
                                             hang)
                except Exception as exc:  # noqa: BLE001 — scheduler
                    # rejection
                    error = f"{type(exc).__name__}: {exc}"
            if error is not None:
                with self._lock:
                    self.ledger.event(rank, "spawn-failed",
                                      data={"generation": gen,
                                            "error": error})
                fail_reason, fail_rank = "spawn-fail", rank
                break
            handles.append(handle)
            with self._lock:
                self.ledger.event(rank, "launched",
                                  data={"generation": gen,
                                        "world_size": world,
                                        "resume": resume,
                                        "injected_hang": hang,
                                        "injected_kill": kill})
        if fail_reason is not None:
            # a partial world must not be left rendezvousing forever
            for h in handles:
                try:
                    h.kill()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            with self._lock:
                if self._closed or self._state in TERMINAL_STATES:
                    return
                self._generation = gen + 1
                self._world_sizes.append(world)
                self._ran_once = self._ran_once or bool(handles)
                self._failed_generation_locked(now, fail_reason,
                                               fail_rank)
            return
        # the generation's starting commit point: an injected rank-kill
        # fires only at a NEW commit, so a kill in a resume generation
        # provably lands after fresh work (restore, not instant re-kill)
        gen_start = None
        if handles:
            try:
                gen_start = handles[0].checkpoint_step()
            except Exception:  # noqa: BLE001 — probe is best-effort
                pass
        orphans: List[RankHandle] = []
        with self._lock:
            # the stillborn re-check and the state mutation share ONE
            # critical section: a shutdown() completing between two
            # separate acquisitions could mark the job terminal and then
            # watch this launch resurrect it to RUNNING)
            if self._closed or self._state in TERMINAL_STATES:
                orphans = handles
            else:
                self._ranks = [
                    _Rank(rank, h, now, injected[rank]["kill"])
                    for rank, h in enumerate(handles)]
                self._gen_start_step = (None if gen_start is None
                                        else int(gen_start))
                self._generation = gen + 1
                self._world_sizes.append(world)
                self._ran_once = True
                self._state = RUNNING
                self._gauge("elastic.world_size", float(world),
                            help="current generation's world size")
        for h in orphans:
            try:
                h.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def _poll_generation(self, now: float) -> None:
        with self._lock:
            if self._state != RUNNING:
                return
            ranks = list(self._ranks)
            gen = self._generation - 1
            gen_start = self._gen_start_step
        # 1) exits — a non-zero exit is a rank death; all ranks exiting
        # zero completes the job once rank 0's result payload is real
        for r in ranks:
            if r.exited is not None:
                continue
            rc = r.handle.poll()
            if rc is None:
                continue
            with self._lock:
                r.exited = rc
                self.ledger.event(r.rank, "exited",
                                  data={"generation": gen,
                                        "rc": int(rc)})
            if rc != 0:
                self._abort_generation(now, f"exit-{rc}", r.rank)
                return
        if all(r.exited == 0 for r in ranks):
            result = ranks[0].handle.result() if ranks else None
            if result is None:
                # every rank exited 0 but no payload: a crash, never a
                # success (the TrialSupervisor contract)
                self._abort_generation(now, "exit-0-without-result", 0)
                return
            with self._lock:
                if self._state == RUNNING:
                    self._result = result
                    self._terminal_locked(COMPLETED, now,
                                          reason="completed")
            return
        # 2) injected preemption: SIGKILL the marked rank at the
        # generation's first committed checkpoint, so the recovery
        # provably restores rather than restarts
        for r in ranks:
            if r.exited is not None or not r.kill_marked:
                continue
            step = r.handle.checkpoint_step()
            if step is None or step == gen_start:
                continue
            with self._lock:
                r.kill_marked = False
            try:
                r.handle.kill()
            except Exception:  # noqa: BLE001 — the abort sweep retries
                pass
            with self._lock:
                self.ledger.event(r.rank, "killed",
                                  data={"generation": gen,
                                        "reason": "injected-kill",
                                        "committed_step": int(step)})
            self._abort_generation(now, "injected-kill", r.rank)
            return
        # 3) heartbeat watchdog: ANY rank with no checkpoint/log
        # progress within the deadline means the generation is wedged
        # (one hung rank blocks every peer inside the next collective) —
        # only a coordinated abort recovers it
        stale: List[int] = []
        for r in ranks:
            if r.exited is not None:
                continue
            token = r.handle.progress()
            with self._lock:
                if token != r.last_progress:
                    r.last_progress = token
                    r.last_progress_t = now
                elif now - r.last_progress_t > self._heartbeat_s:
                    stale.append(r.rank)
        if stale:
            # the injected hang wedges ONE rank but every peer goes
            # stale with it (they block in the collective) — which ranks
            # appear stale first is a wall-clock race, so the abort's
            # deterministic data bucket carries only the reason; the
            # observed stale set is timing
            with self._lock:
                self.ledger.event(JOB, "hang-detected",
                                  data={"generation": gen},
                                  timing={"stale_ranks": sorted(stale)})
            self._abort_generation(now, "hang", None)

    def _abort_generation(self, now: float, reason: str,
                          rank: Optional[int]) -> None:
        """Coordinated abort: kill EVERY rank of the generation — a hung
        collective cannot be recovered in place, and survivors of a dead
        peer are already wedged — then restart the whole job from
        LATEST (or go FAILED when the restart budget is exhausted)."""
        with self._lock:
            if self._state != RUNNING:
                return
            ranks = list(self._ranks)
            gen = self._generation - 1
        # newest committed step survives the abort — it is the restart
        # point (probe BEFORE killing; the probe is on-disk state)
        committed = None
        for r in ranks:
            try:
                committed = r.handle.checkpoint_step()
                break
            except Exception:  # noqa: BLE001 — probe is best-effort
                continue
        for r in ranks:
            try:
                r.handle.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        with self._lock:
            if self._state != RUNNING:
                return
            self._ranks = []
            self._failed_generation_locked(
                now, reason, rank, gen=gen,
                committed_step=(None if committed is None
                                else int(committed)))

    # holds-lock: _lock
    def _failed_generation_locked(self, now: float, reason: str,
                                  rank: Optional[int],
                                  gen: Optional[int] = None,
                                  committed_step: Optional[int] = None
                                  ) -> None:
        self._rank_failures += 1
        self._counter("elastic.rank_failures_total",
                      reason=("hang" if reason == "hang" else
                              "spawn-fail" if reason == "spawn-fail" else
                              "death"),
                      help="generation aborts by failure class")
        self.ledger.event(
            JOB, "abort",
            data={"generation": (self._generation - 1 if gen is None
                                 else gen),
                  "reason": reason, "rank": rank,
                  "committed_step": committed_step})
        if self._restarts >= self._max_restarts:
            self._terminal_locked(FAILED, now,
                                  reason=f"{reason} (restarts exhausted)")
            return
        self._restarts += 1
        self._counter("elastic.restarts_total",
                      help="coordinated whole-job restarts")
        self._state = RESTARTING
        self._next_launch_t = now + self._backoff_s * \
            (2 ** (self._restarts - 1))
        self.ledger.event(
            JOB, "restart",
            data={"restarts": self._restarts,
                  "next_world_size": self._world_for(self._generation)})

    # holds-lock: _lock
    def _terminal_locked(self, state: str, now: float,
                         reason: str) -> None:
        self._state = state
        self._outcome_reason = reason
        self._finished_t = now
        self._counter("elastic.jobs_total", outcome=state,
                      help="elastic jobs by terminal outcome")
        self.ledger.event(
            JOB, "terminal",
            data={"state": state, "reason": reason,
                  "generations": self._generation,
                  "restarts": self._restarts,
                  "rank_failures": self._rank_failures,
                  "world_sizes": list(self._world_sizes)},
            timing={"duration_s": None if self._started_t is None
                    else round(now - self._started_t, 3)})

    def _expire_deadline(self) -> None:
        """Deadline expiry: kill every rank, fail the job."""
        with self._lock:
            handles = [r.handle for r in self._ranks
                       if r.handle is not None]
        for h in handles:
            try:
                h.kill()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        now = self._time()
        with self._lock:
            self._ranks = []
            if self._state not in TERMINAL_STATES:
                self._terminal_locked(FAILED, now, reason="deadline")

    # --------------------------------------------------------- telemetry

    def _counter(self, name: str, *, help: str = "", **labels) -> None:
        from ..telemetry.registry import get_registry
        get_registry().counter_inc(name, help=help, **labels)

    def _gauge(self, name: str, value: float, *, help: str = "") -> None:
        from ..telemetry.registry import get_registry
        get_registry().gauge_set(name, value, help=help)

    def _report_summary(self) -> None:
        """Generations-per-restart telemetry over the whole run."""
        with self._lock:
            gens = self._generation
        self._gauge("elastic.generations_total", float(gens),
                    help="generations launched over the job's lifetime")

    @staticmethod
    def _consult(site: str) -> bool:
        """One fault-site check -> did it fire for this invocation."""
        try:
            fault_point(site)
        except InjectedFault:
            return True
        return False
