"""Fault-tolerant HPO (counterpart: hydragnn_tpu/hpo/).

``TrialSupervisor`` runs N concurrent trials as preemptible child jobs
on the checkpoints' resume contract: kill a trial anywhere and it
resumes bit for bit; PBT forks a BEST checkpoint (pbt.py). The launch
command functions and the in-process search loops live in
``hydragnn_tpu_torch.utils.hpo``; this package is the supervision layer
that keeps those trials alive under preemption, hangs and node loss.
"""
from .ledger import TrialLedger
from .pbt import fork_checkpoint, perturb_params, select_fork_source
from .process import ProcessLauncher, ProcessTrialHandle, committed_steps
from .supervisor import (COMPLETED, FAILED, PENDING, PRUNED, RESUMING,
                         RUNNING, TERMINAL_STATES, TrialHandle,
                         TrialRecord, TrialSpec, TrialSupervisor)

__all__ = [
    "TrialLedger", "fork_checkpoint", "perturb_params",
    "select_fork_source", "ProcessLauncher", "ProcessTrialHandle",
    "committed_steps", "TrialHandle", "TrialRecord", "TrialSpec",
    "TrialSupervisor", "PENDING", "RUNNING", "RESUMING", "COMPLETED",
    "PRUNED", "FAILED", "TERMINAL_STATES",
]
