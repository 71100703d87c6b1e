"""The subprocess trial launcher (counterpart: hydragnn_tpu/hpo/process.py).

Each launch runs ``python -m hydragnn_tpu_torch.hpo.runner`` in the
trial's own directory and its own process group, so a kill (the
watchdog, the ``trial-kill`` site, shutdown) takes the whole tree down
with one ``killpg`` and no grandchild outlives its trial holding a card.
Progress is probed from outside: the newest committed checkpoint step
under the trial's run dirs and the byte size of the child's log.

`committed_steps` is the one definition of "this trial (or job) has
committed work": the supervisors' progress probes, the chaos points (the
`trial-kill` / `rank-kill` trigger, the runners' hang watcher) and the
drivers' final step read it, as in the JAX package. `restorable_steps`
is what a resume would restore (`utils.checkpoint.restorable_steps`):
the runners' and the examples' `--resume` (examples/gfm.py,
examples/ogbn.py) continue only when it is non-empty, and otherwise
restart from scratch.
"""
from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..utils import checkpoint as ck
from .supervisor import TrialHandle, TrialSpec

# run-dir name of the checkpoint a PBT fork adopts; "_"-prefixed so the
# progress probe (which skips such run dirs) never reads the donor's copy
# as the child's progress
FORK_DONOR_NAME = "_fork_donor"
FORK_META = "FORK.json"


def _repo_root() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def _child_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A child trial's environment: the parent's, with the package
    importable from the trial's cwd and the parent's fault plan masked
    (set but empty: explicitly none). The trial sites are the
    supervisor's; a child must never inherit a plan meant for the
    scheduler above it."""
    env = dict(os.environ)
    root = _repo_root()
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = root + (os.pathsep + prev if prev else "")
    env["HYDRAGNN_FAULT_PLAN"] = ""
    if extra:
        env.update(extra)
    return env


def _own_ckpt_dirs(trial_dir: str) -> List[str]:
    """The checkpoint dirs of every run under `<trial_dir>/logs` but
    those whose name starts with "_" (a fork donor's copy is not the
    trial's progress)."""
    return [d for d in sorted(glob.glob(
                os.path.join(trial_dir, "logs", "*", "checkpoint")))
            if not os.path.basename(os.path.dirname(d)).startswith("_")]


def committed_steps(trial_dir: str) -> List[int]:
    """The sorted committed checkpoint steps over the trial's own run
    dirs."""
    steps: List[int] = []
    for ckpt_dir in _own_ckpt_dirs(trial_dir):
        for p in sorted(os.listdir(ckpt_dir)):
            if (p.startswith("step_") and p.split("_")[-1].isdigit()
                    and os.path.exists(os.path.join(ckpt_dir, p,
                                                    ck.COMMIT_MARKER))):
                steps.append(int(p.split("_")[-1]))
    return sorted(steps)


def restorable_steps(trial_dir: str) -> List[int]:
    """The sorted steps a resume could restore over the trial's own run
    dirs: committed and covered by their dir's LATEST. Empty after a
    kill inside the first save, which a resume restarts from scratch."""
    return sorted(s for d in _own_ckpt_dirs(trial_dir)
                  for s in ck.restorable_steps(d))


def _committed_step_under(trial_dir: str) -> Optional[int]:
    """The newest committed checkpoint step, or None before the first."""
    steps = committed_steps(trial_dir)
    return steps[-1] if steps else None


class ProcessTrialHandle(TrialHandle):
    """One child training process (group) and its progress on disk."""

    def __init__(self, proc: subprocess.Popen, trial_dir: str,
                 log_path: str):
        self.proc = proc
        self.trial_dir = trial_dir
        self.log_path = log_path

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        """SIGKILL the whole process group, then reap (idempotent). The
        group is killed even when its leader has exited: it lives on
        while any member does, and a crashed trial's stragglers must not
        leak into the next launch."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            if self.proc.poll() is None:
                self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL
            # cannot be blocked
            pass

    def progress(self) -> Tuple[int, int]:
        try:
            log_size = os.path.getsize(self.log_path)
        except OSError:
            log_size = 0
        step = _committed_step_under(self.trial_dir)
        return (-1 if step is None else step, log_size)

    def checkpoint_step(self) -> Optional[int]:
        return _committed_step_under(self.trial_dir)

    def result(self) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.trial_dir, "result.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def group_alive(self) -> bool:
        """True while any process of the trial's group survives."""
        try:
            os.killpg(self.proc.pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False


class ProcessLauncher:
    """The TrialSupervisor's launch_fn: child training processes.

    ``work_dir/trial_<id>/`` is each trial's cwd (its ./logs run dirs,
    trial.log, result.json). The knobs mirror the runner's command line;
    ``device`` is the children's (cuda unless the caller asks for the
    CPU); ``extra_env`` pins a trial's cards (CUDA_VISIBLE_DEVICES) the
    way utils/hpo.create_launch_command does. `child_argv` is the command
    a launch runs."""

    module = "hydragnn_tpu_torch.hpo.runner"

    def __init__(self, work_dir: str, *, num_epochs: int = 4,
                 num_configs: int = 24, data_seed: int = 0,
                 hang_after_epoch: int = 1, device: str = "cuda",
                 python: str = sys.executable,
                 extra_env: Optional[Dict[str, str]] = None):
        self.work_dir = os.path.abspath(work_dir)
        self.num_epochs = int(num_epochs)
        self.num_configs = int(num_configs)
        self.data_seed = int(data_seed)
        self.hang_after_epoch = int(hang_after_epoch)
        self.device = str(device)
        self.python = python
        self.extra_env = dict(extra_env or {})
        self.handles: List[ProcessTrialHandle] = []

    def trial_dir(self, trial_id: int) -> str:
        return os.path.join(self.work_dir, f"trial_{int(trial_id):04d}")

    def _prepare_fork(self, spec: TrialSpec, trial_dir: str) -> None:
        """Adopt the donor's BEST checkpoint (pbt.fork_checkpoint) under
        the ``_fork_donor`` run name; the runner turns FORK.json into
        ``continue=1, startfrom=_fork_donor``: the donor's weights, epoch
        0 (the reference's transfer semantics)."""
        from .pbt import fork_checkpoint
        donor_dir = self.trial_dir(spec.forked_from)
        candidates = sorted(glob.glob(
            os.path.join(donor_dir, "logs", "*", "checkpoint")))
        candidates = [c for c in candidates
                      if not os.path.basename(
                          os.path.dirname(c)).startswith("_")]
        if not candidates:
            raise FileNotFoundError(
                f"fork donor trial {spec.forked_from} has no run dir "
                f"under {donor_dir}")
        dst = os.path.join(trial_dir, "logs", FORK_DONOR_NAME,
                           "checkpoint")
        step, val = fork_checkpoint(candidates[-1], dst)
        meta = {"startfrom": FORK_DONOR_NAME, "donor_step": step,
                "donor_val": val,
                "donor_trial": int(spec.forked_from)}
        with open(os.path.join(trial_dir, FORK_META), "w") as f:
            json.dump(meta, f)

    def child_argv(self, spec: TrialSpec, resume: bool,
                   hang: bool) -> List[str]:
        cmd = [self.python, "-m", self.module,
               "--params", json.dumps(spec.params, sort_keys=True),
               "--num-epochs", str(self.num_epochs),
               "--num-configs", str(self.num_configs),
               "--data-seed", str(self.data_seed),
               "--device", self.device]
        if resume:
            cmd.append("--resume")
        if hang:
            cmd += ["--hang-after-epoch", str(self.hang_after_epoch)]
        return cmd

    def __call__(self, spec: TrialSpec, attempt: int, resume: bool,
                 hang: bool) -> ProcessTrialHandle:
        trial_dir = self.trial_dir(spec.trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        if spec.forked_from is not None and not resume and \
                not os.path.exists(os.path.join(trial_dir, FORK_META)):
            self._prepare_fork(spec, trial_dir)
        log_path = os.path.join(trial_dir, "trial.log")
        # appended: the log's size is the heartbeat token and must grow
        # monotonically across relaunches
        with open(log_path, "ab") as out:
            proc = subprocess.Popen(
                self.child_argv(spec, resume, hang), cwd=trial_dir,
                stdout=out, stderr=subprocess.STDOUT,
                env=_child_env(self.extra_env), start_new_session=True)
        handle = ProcessTrialHandle(proc, trial_dir, log_path)
        self.handles.append(handle)
        return handle

    def live_process_groups(self) -> List[int]:
        """pids of trial process groups still alive: [] after the
        supervisor's shutdown."""
        return [h.proc.pid for h in self.handles if h.group_alive()]
