"""PBT exploit and explore (counterpart: hydragnn_tpu/hpo/pbt.py), over
the port's checkpoint layout (utils/checkpoint.py: step dirs with a
COMMITTED marker and its manifest, BEST, LATEST, resume.json).

Exploit forks a new trial from another trial's BEST checkpoint; explore
perturbs the donor's hyperparameters deterministically from the forked
trial's seed. The fork adopts the (state, val) pair `load_best_model`
defines: the step dir BEST names and the validation loss on BEST's line
2. A BEST that is malformed, uncommitted or names a missing dir falls
back to the newest committed step dir with a warning; nothing to fork
raises FileNotFoundError.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils import checkpoint as ck

_log = logging.getLogger("hydragnn_tpu_torch")


def _committed_steps(ckpt_dir: str):
    """(step, path) for every VERIFIED step dir, newest first."""
    out = []
    for p in sorted(os.listdir(ckpt_dir)):
        full = os.path.join(ckpt_dir, p)
        if (p.startswith("step_") and p.split("_")[-1].isdigit()
                and ck.verify_checkpoint(full)):
            out.append((int(p.split("_")[-1]), full))
    return sorted(out, reverse=True)


def select_fork_source(ckpt_dir: str) -> Tuple[str, Optional[float]]:
    """The step dir a fork adopts: the BEST marker's target when verified
    (returning the marker's own recorded val loss, the load_best_model
    (state, val) adoption semantics), else the newest verified step dir
    with a warning (val unknown -> None), else FileNotFoundError."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(
            f"fork source {ckpt_dir!r} is not a checkpoint directory")
    best = os.path.join(ckpt_dir, "BEST")
    if os.path.exists(best):
        # ANY malformed marker (truncated/empty file, garbled val line)
        # takes the same fallback as an unverifiable target — the
        # supervisor must never crash on a half-written BEST
        target = val = None
        try:
            with open(best) as f:
                lines = f.read().splitlines()
            target = os.path.join(ckpt_dir, lines[0].strip())
            val = float(lines[1]) if len(lines) > 1 else None
        except (OSError, IndexError, ValueError):
            pass
        if target is not None and ck.verify_checkpoint(target):
            return target, val
        _log.warning(
            "fork source BEST %s is missing/uncommitted/corrupt; falling "
            "back to the newest verified checkpoint", target or best)
    committed = _committed_steps(ckpt_dir)
    if not committed:
        raise FileNotFoundError(
            f"no verified checkpoint to fork from under {ckpt_dir!r}")
    return committed[0][1], None


def fork_checkpoint(src_ckpt_dir: str,
                    dst_ckpt_dir: str) -> Tuple[int, Optional[float]]:
    """Copy the fork source step dir into a fresh checkpoint dir whose
    LATEST names it, dropping the donor's resume.json (the forked trial
    trains from epoch 0 on the adopted weights — PBT exploit, the
    reference's startfrom transfer semantics). Returns (step, donor_val).
    """
    target, val = select_fork_source(src_ckpt_dir)
    step = int(os.path.basename(target).split("_")[-1])
    os.makedirs(dst_ckpt_dir, exist_ok=True)
    dst = os.path.join(dst_ckpt_dir, os.path.basename(target))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(target, dst)
    stale_meta = os.path.join(dst, ck.RESUME_META)
    if os.path.exists(stale_meta):
        os.remove(stale_meta)
        # the copied COMMITTED marker's manifest still lists the dropped
        # resume.json: re-commit the copy so the marker describes the
        # files present, or the restore's deep verification would reject
        # the fork as corrupt
        ck._write_marker(dst, ck.COMMIT_MARKER, "\n".join(
            [os.path.basename(dst)] + ck._manifest_lines(dst)))
    ck._write_marker(dst_ckpt_dir, "LATEST", os.path.basename(dst))
    return step, val


def perturb_params(params: Dict[str, Any], space: Dict[str, Any],
                   seed: int, *, factors=(0.8, 1.25),
                   resample_prob: float = 0.25) -> Dict[str, Any]:
    """Explore: deterministic perturbation of `params` within `space`
    (the SearchSpace grammar: list = categorical, 2-tuple = range, other
    = fixed). Continuous/int ranges multiply by an rng-chosen factor and
    clip to the range; categoricals resample with `resample_prob`. A
    pure function of (params, space, seed) — the same seed produces the
    same forked trial start state bitwise, iterating sorted(space) so
    dict insertion order can't change rng consumption.
    """
    rng = np.random.RandomState(int(seed))
    out = dict(params)
    for key in sorted(space):
        sv = space[key]
        if key not in params:
            continue
        if isinstance(sv, list):
            if rng.uniform() < resample_prob:
                out[key] = sv[rng.randint(len(sv))]
        elif isinstance(sv, tuple) and len(sv) == 2:
            lo, hi = sv
            factor = factors[rng.randint(len(factors))]
            scaled = params[key] * factor
            if isinstance(lo, int) and isinstance(hi, int):
                out[key] = int(min(max(int(round(scaled)), lo), hi))
            else:
                out[key] = float(min(max(scaled, lo), hi))
        # fixed values pass through unchanged
    return out
