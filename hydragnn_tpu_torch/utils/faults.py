"""Deterministic fault injection (counterpart: hydragnn_tpu/utils/faults.py,
whose grammar, precedence, per-site counters and raise this copy keeps).

Named failure sites fire at exact invocation indices, so a recovery path
runs in the tests deterministically. The serving engine consults the
`serving-dispatch` site once per executed batch and the `swap-fail` site
once per `swap_variables`; training consults `forward-step` once per
train-loop dispatch (train/trainer.py), `checkpoint-write` at the start
of each save (utils/checkpoint.save_model) and `loader-fetch` once per
sample fetch attempt (datasets/loader.fetch_samples). `run_training`
installs the plan that resolves for its run.

Plan grammar (HYDRAGNN_FAULT_PLAN env / Training.fault_plan)::

    plan  := entry (';' entry)*
    entry := site '@' index (',' index)*

with `site` one of `SITES` and `index` a non-negative integer, the 0-based
invocation count of that site. Each site keeps its own counter per
installed plan, so a plan is a pure function of the call sequence.
Faults raise `InjectedFault`; `loader-fetch` raises
`InjectedTransientIOError`, an OSError.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from .envflags import env_str

SITES = ("checkpoint-write", "loader-fetch", "forward-step",
         "serving-dispatch", "replica-kill", "swap-fail",
         "trial-kill", "trial-hang", "trial-spawn-fail",
         "rank-kill", "rank-hang", "rank-spawn-fail")


class InjectedFault(RuntimeError):
    """A deterministic failure fired by the active FaultPlan."""


class InjectedTransientIOError(InjectedFault, OSError):
    """Injected at the loader-fetch site: transient I/O to a retry layer."""


@dataclasses.dataclass
class FaultPlan:
    """Named failure sites firing at fixed invocation indices.

    `fault_point(site)` increments the site's counter and raises when the
    current index is listed. Counters are per plan (installing a plan
    resets them) and thread-safe: serving-dispatch fires on the
    dispatcher thread."""

    injections: Dict[str, FrozenSet[int]]

    def __post_init__(self):
        self._counts: Dict[str, int] = {s: 0 for s in self.injections}
        self._fired: List[Tuple[str, int]] = []
        self._lock = threading.Lock()

    def fault_point(self, site: str) -> None:
        hits = self.injections.get(site)
        if hits is None:
            return
        with self._lock:
            idx = self._counts[site]
            self._counts[site] = idx + 1
            fire = idx in hits
            if fire:
                self._fired.append((site, idx))
        if fire:
            if site == "loader-fetch":
                raise InjectedTransientIOError(
                    f"injected fault: {site}@{idx}")
            raise InjectedFault(f"injected fault: {site}@{idx}")

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def fired(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._fired)


def parse_fault_plan(spec: str) -> FaultPlan:
    """The plan of `spec`; ValueError on a malformed entry, an unknown
    site or an empty plan."""
    injections: Dict[str, FrozenSet[int]] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(f"fault-plan entry {entry!r} has no '@' "
                             "(grammar: site@idx[,idx...])")
        site, _, idx_part = entry.partition("@")
        site = site.strip()
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: "
                             f"{', '.join(SITES)})")
        idxs = []
        for tok in idx_part.split(","):
            tok = tok.strip()
            if not tok.isdigit():
                raise ValueError(f"fault-plan index {tok!r} for site "
                                 f"{site!r} is not a non-negative integer")
            idxs.append(int(tok))
        if not idxs:
            raise ValueError(f"fault-plan entry {entry!r} lists no indices")
        injections[site] = injections.get(site, frozenset()) | \
            frozenset(idxs)
    if not injections:
        raise ValueError("fault plan is empty")
    return FaultPlan(injections)


def resolve_fault_plan(train_cfg=None) -> Optional[FaultPlan]:
    """HYDRAGNN_FAULT_PLAN over Training.fault_plan; None when neither
    sets a plan. The env set but empty masks the config's plan. A
    malformed spec warns and gives None: a typo injects nothing."""
    spec = env_str("HYDRAGNN_FAULT_PLAN")
    origin = "HYDRAGNN_FAULT_PLAN"
    if spec is None and os.getenv("HYDRAGNN_FAULT_PLAN") is None \
            and train_cfg:
        spec = train_cfg.get("fault_plan")
        origin = "Training.fault_plan"
    if spec is None or not str(spec).strip():
        return None
    try:
        return parse_fault_plan(str(spec))
    except ValueError as exc:
        logging.getLogger("hydragnn_tpu_torch").warning(
            "%s=%r is not a valid fault plan (%s); injecting nothing",
            origin, spec, exc)
        return None


_ACTIVE: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set (or clear, with None) the process-wide active plan; returns it.
    Its counters start fresh."""
    global _ACTIVE
    if plan is not None:
        plan.__post_init__()
    _ACTIVE = plan
    return plan


def active_fault_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def fault_point(site: str) -> None:
    """The hook at a site: a no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fault_point(site)
