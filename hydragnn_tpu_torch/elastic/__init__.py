"""Elastic multi-process training (counterpart: hydragnn_tpu/elastic/).

``JobSupervisor`` runs the W ranks of one data-parallel training job and
drives the job to a terminal state whichever rank dies, hangs or fails
to spawn: any rank failure makes a coordinated abort (every rank is
killed) and a whole-job restart from LATEST, at another world size W'
where ``world_schedule`` asks. ``RankProcessLauncher`` launches child
rank processes with a fresh rendezvous port per generation, each in its
own process group.
"""
from .ledger import JOB, JobLedger
from .process import RankProcessHandle, RankProcessLauncher, free_port
from .supervisor import (COMPLETED, FAILED, PENDING, RESTARTING, RUNNING,
                         TERMINAL_STATES, JobRecord, JobSupervisor,
                         RankHandle)

__all__ = [
    "JOB", "JobLedger", "RankProcessHandle", "RankProcessLauncher",
    "free_port", "JobRecord", "JobSupervisor", "RankHandle",
    "PENDING", "RUNNING", "RESTARTING", "COMPLETED", "FAILED",
    "TERMINAL_STATES",
]
