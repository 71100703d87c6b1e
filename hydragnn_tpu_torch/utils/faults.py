"""The fault plan's resolution (counterpart: hydragnn_tpu/utils/faults.py,
`parse_fault_plan` and `resolve_fault_plan`, whose grammar and precedence
this copy keeps). The port injects no faults yet (ROADMAP A8):
`run_training` refuses a run for which a plan resolves, and only then.

Plan grammar (HYDRAGNN_FAULT_PLAN env / Training.fault_plan)::

    plan  := entry (';' entry)*
    entry := site '@' index (',' index)*

with `site` one of `SITES` and `index` a non-negative integer.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, FrozenSet, Optional

from .envflags import env_str

SITES = ("checkpoint-write", "loader-fetch", "forward-step",
         "serving-dispatch", "replica-kill", "swap-fail",
         "trial-kill", "trial-hang", "trial-spawn-fail",
         "rank-kill", "rank-hang", "rank-spawn-fail")


def parse_fault_plan(spec: str) -> Dict[str, FrozenSet[int]]:
    """{site: invocation indices} of a plan; ValueError on a malformed
    entry, an unknown site or an empty plan."""
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
    return injections


def resolve_fault_plan(train_cfg=None) -> Optional[Dict[str, FrozenSet[int]]]:
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
