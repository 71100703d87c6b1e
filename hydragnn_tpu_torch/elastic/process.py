"""The subprocess rank launcher of the elastic JobSupervisor (counterpart:
hydragnn_tpu/elastic/process.py).

Each launch runs one rank of a data-parallel training job as ``python -m
hydragnn_tpu_torch.elastic.runner`` in the shared job directory, in its
own process group, so one ``killpg`` (the watchdog, the ``rank-kill``
site, shutdown) takes the rank's whole tree down. Every rank of a job
shares one cwd: the checkpoint dir is the job's (rank 0 writes it), so
the progress probe and the resume detection read one layout.

Rendezvous: every generation gets a fresh port, so a restarted world
never meets a half-dead predecessor. A restart generation's world size
W' may differ from W; `total_shards` is fixed, and each rank trains
``total_shards / W`` data shards stacked on its own device
(run_training's `data_devices`), so the global pack plan and its slicing
are the same at every world size.

The child environment differs from the JAX package's in two keys, which
it does not set: JAX_PLATFORMS and XLA's virtual device count. The
device comes through the runner's ``--device`` (default cuda); ranks
that share one card meet over gloo (parallel/mesh.py).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

from ..hpo.process import ProcessTrialHandle, _repo_root
from .supervisor import RankHandle


def free_port() -> int:
    """A free TCP port the OS assigns, for a generation's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(rank: int, world_size: int, coord_port: int,
               rendezvous_timeout_s: float,
               extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A child rank's environment: the parent's, with the package
    importable from the job's cwd, the localhost rendezvous, the bounded
    rendezvous timeout, and the parent's fault plan masked (set but
    empty: explicitly none; the rank sites are the supervisor's)."""
    env = dict(os.environ)
    root = _repo_root()
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = root + (os.pathsep + prev if prev else "")
    env["HYDRAGNN_FAULT_PLAN"] = ""
    if int(world_size) > 1:
        env["HYDRAGNN_MASTER_ADDR"] = "127.0.0.1"
        env["HYDRAGNN_MASTER_PORT"] = str(int(coord_port))
        env["SLURM_NPROCS"] = str(int(world_size))
        env["SLURM_PROCID"] = str(int(rank))
    else:
        # a W' = 1 generation is one process: it must not rendezvous with
        # (or inherit) a dead world's coordinates
        for key in ("HYDRAGNN_MASTER_ADDR", "HYDRAGNN_MASTER_PORT",
                    "SLURM_NPROCS", "SLURM_PROCID"):
            env.pop(key, None)
    # a rank whose peers never arrive dies with an actionable error
    # instead of outliving the supervisor's patience in the handshake
    env["HYDRAGNN_RENDEZVOUS_TIMEOUT_S"] = f"{rendezvous_timeout_s:g}"
    if extra:
        env.update(extra)
    return env


class RankProcessHandle(ProcessTrialHandle, RankHandle):
    """One child rank process (group) and the job's progress on disk: the
    trial handle's kill, progress token, result reader and group probe,
    over the job dir every rank shares (``job_dir`` is the inherited
    ``trial_dir``). A rank wedged in a collective stops its own log even
    while a healthy peer's grows."""

    def __init__(self, proc: subprocess.Popen, job_dir: str,
                 log_path: str):
        super().__init__(proc, job_dir, log_path)

    @property
    def job_dir(self) -> str:
        return self.trial_dir


class RankProcessLauncher:
    """The JobSupervisor's launch_fn: child rank processes.

    ``job_dir`` is every rank's cwd (its ./logs run dirs, rank_<r>.log,
    result.json). ``total_shards`` is the global data-shard count, the
    same at every world size. ``device`` is the ranks' (cuda unless the
    caller asks for the CPU). The other knobs mirror the runner's command
    line; ``extra_env`` is added to each child's environment. `child_argv`
    is the command a launch runs."""

    module = "hydragnn_tpu_torch.elastic.runner"

    def __init__(self, job_dir: str, *, total_shards: int = 4,
                 num_epochs: int = 4, num_configs: int = 24,
                 data_seed: int = 0, batch_size: int = 8,
                 hang_after_epoch: int = 1,
                 rendezvous_timeout_s: float = 240.0,
                 device: str = "cuda", python: str = sys.executable,
                 extra_env: Optional[Dict[str, str]] = None):
        self.job_dir = os.path.abspath(job_dir)
        self.total_shards = int(total_shards)
        self.num_epochs = int(num_epochs)
        self.num_configs = int(num_configs)
        self.data_seed = int(data_seed)
        self.batch_size = int(batch_size)
        self.hang_after_epoch = int(hang_after_epoch)
        self.rendezvous_timeout_s = float(rendezvous_timeout_s)
        self.device = str(device)
        self.python = python
        self.extra_env = dict(extra_env or {})
        self.handles: List[RankProcessHandle] = []
        self._gen_ports: Dict[int, int] = {}

    def _port_for(self, generation: int) -> int:
        """One fresh port per generation (rank 0 launches first)."""
        port = self._gen_ports.get(int(generation))
        if port is None:
            port = free_port()
            self._gen_ports[int(generation)] = port
        return port

    def child_argv(self, world_size: int, rank: int, resume: bool,
                   hang: bool) -> List[str]:
        cmd = [self.python, "-m", self.module,
               "--rank", str(int(rank)),
               "--world", str(int(world_size)),
               "--total-shards", str(self.total_shards),
               "--num-epochs", str(self.num_epochs),
               "--num-configs", str(self.num_configs),
               "--data-seed", str(self.data_seed),
               "--batch-size", str(self.batch_size),
               "--device", self.device]
        if resume:
            cmd.append("--resume")
        if hang:
            cmd += ["--hang-after-epoch", str(self.hang_after_epoch)]
        return cmd

    def __call__(self, generation: int, world_size: int, rank: int,
                 resume: bool, hang: bool) -> RankProcessHandle:
        if self.total_shards % int(world_size):
            raise ValueError(
                f"total_shards={self.total_shards} must divide evenly "
                f"over world_size={world_size}: the global mesh (and the "
                "pack-plan slicing geometry) must be identical at every "
                "world size for the elastic resume contract")
        os.makedirs(self.job_dir, exist_ok=True)
        log_path = os.path.join(self.job_dir, f"rank_{int(rank)}.log")
        # appended: the log's size is the heartbeat token and must grow
        # monotonically across generations
        with open(log_path, "ab") as out:
            proc = subprocess.Popen(
                self.child_argv(world_size, rank, resume, hang),
                cwd=self.job_dir, stdout=out, stderr=subprocess.STDOUT,
                env=_child_env(rank, world_size,
                               self._port_for(generation),
                               self.rendezvous_timeout_s, self.extra_env),
                start_new_session=True)
        handle = RankProcessHandle(proc, self.job_dir, log_path)
        self.handles.append(handle)
        return handle

    def live_process_groups(self) -> List[int]:
        """pids of rank process groups still alive: [] after the
        supervisor's shutdown."""
        return [h.proc.pid for h in self.handles if h.group_alive()]
