"""HPO orchestration helpers (counterpart: hydragnn_tpu/utils/hpo.py).

SLURM nodelist expansion, the per-trial launch command, the
in-process `search` loop (optuna TPE when importable, else the in-tree
CBO of utils/bayes_opt.py, or random search under HYDRAGNN_HPO_RANDOM=1)
and `orchestrate`, the standing subprocess-per-trial loop.

The one departure from the JAX package: a trial is pinned to its cards
with CUDA_VISIBLE_DEVICES, where JAX pins TPU chips with
TPU_VISIBLE_CHIPS (`create_launch_command`'s `chips`, `orchestrate`'s
`chips_per_trial`). Everything else, the command line included, is the
JAX package's.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _split_groups(nodelist: str) -> List[str]:
    """Split a SLURM nodelist on the commas OUTSIDE brackets:
    'frontier[001-002],borg[005]' -> ['frontier[001-002]', 'borg[005]'].
    A naive str.split(',') also cuts inside '[001-002,007]'."""
    groups, depth, start = [], 0, 0
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(depth - 1, 0)
        elif ch == "," and depth == 0:
            groups.append(nodelist[start:i])
            start = i + 1
    groups.append(nodelist[start:])
    return [g.strip() for g in groups if g.strip()]


def parse_slurm_nodelist(nodelist: str) -> List[str]:
    """Expand 'frontier[00001-00003,00007]' style lists, including
    comma-separated multiple bracketed groups as SLURM emits for
    heterogeneous allocations — 'frontier[001-002],borg[005]' ->
    ['frontier001', 'frontier002', 'borg005']. (The pre-fix single
    trailing-bracket regex treated that whole string as one group and
    silently returned a wrong node list.)
    (reference: distributed.py:52-83 / deephyper.py:13-46)."""
    out: List[str] = []
    for group in _split_groups(nodelist.strip()):
        m = re.match(r"^([^\[]+)\[([^\]]+)\]$", group)
        if not m:
            out.append(group)
            continue
        prefix, body = m.groups()
        for part in body.split(","):
            if "-" in part:
                lo, hi = part.split("-")
                width = len(lo)
                out += [f"{prefix}{str(i).zfill(width)}"
                        for i in range(int(lo), int(hi) + 1)]
            else:
                out.append(f"{prefix}{part}")
    return out


def read_node_list() -> List[str]:
    """reference: deephyper.py:13 — nodes of the current allocation."""
    from .envflags import env_str
    nl = env_str("SLURM_NODELIST") or env_str("SLURM_JOB_NODELIST")
    return parse_slurm_nodelist(nl) if nl else []


def create_launch_command(script: str, trial_args: Dict[str, Any],
                          chips: Optional[Sequence[int]] = None,
                          coordinator: Optional[str] = None,
                          python: str = "python") -> List[str]:
    """Build a per-trial launch command (reference: create_launch_command,
    deephyper.py:94-177 builds srun lines; here: a KEY=VALUE env prefix
    pinning the trial's cards with CUDA_VISIBLE_DEVICES, then the argv)."""
    cmd = []
    env = {}
    if chips is not None:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(c) for c in chips)
    if coordinator:
        env["HYDRAGNN_MASTER_ADDR"] = coordinator
    for k, v in env.items():
        cmd += [f"{k}={v}"]
    cmd += [python, script]
    for k, v in trial_args.items():
        if v == "":
            cmd.append(f"--{k}")  # boolean flag (store_true)
        else:
            cmd += [f"--{k}", str(v)]
    return cmd


def split_env_prefix(cmd: Sequence[str]) -> Tuple[Dict[str, str], List[str]]:
    """Split create_launch_command's KEY=VALUE env prefixes from the argv
    (one shared splitter — every subprocess consumer needs this)."""
    env: Dict[str, str] = {}
    rest = list(cmd)
    while rest and "=" in rest[0] and not rest[0].startswith("-"):
        k, _, v = rest.pop(0).partition("=")
        env[k] = v
    return env, rest


class SearchSpace:
    """Dict of name -> list of choices or (low, high) float/int ranges."""

    def __init__(self, space: Dict[str, Any]):
        self.space = space

    def sample(self, rng: np.random.RandomState) -> Dict[str, Any]:
        out = {}
        for k, v in self.space.items():
            if isinstance(v, list):
                out[k] = v[rng.randint(len(v))]
            elif isinstance(v, tuple) and len(v) == 2:
                lo, hi = v
                if isinstance(lo, int) and isinstance(hi, int):
                    out[k] = int(rng.randint(lo, hi + 1))
                else:
                    # log-uniform for float ranges, matching the optuna
                    # backend's suggest_float(log=True)
                    out[k] = float(10 ** rng.uniform(np.log10(lo),
                                                     np.log10(hi)))
            else:
                out[k] = v
        return out


def search(objective: Callable[[Dict[str, Any]], float],
           space: Dict[str, Any], num_trials: int = 20, seed: int = 0,
           log_path: Optional[str] = None,
           maximize: bool = False) -> Tuple[Dict[str, Any], List[Dict]]:
    """Random search with optuna TPE when available
    (reference HPO budget shape: 200 trials, 10 epochs each,
    gfm_deephyper_multi.py:89,164-177). Returns (best_params, history)."""
    history: List[Dict] = []
    try:
        import optuna
        optuna.logging.set_verbosity(optuna.logging.WARNING)

        def obj(trial):
            params = {}
            for k, v in space.items():
                if isinstance(v, list):
                    params[k] = trial.suggest_categorical(k, v)
                elif isinstance(v, tuple) and all(isinstance(x, int) for x in v):
                    params[k] = trial.suggest_int(k, v[0], v[1])
                elif isinstance(v, tuple):
                    params[k] = trial.suggest_float(k, v[0], v[1], log=True)
                else:
                    params[k] = v
            val = objective(params)
            history.append({"params": params, "value": val})
            return val
        study = optuna.create_study(
            direction="maximize" if maximize else "minimize",
            sampler=optuna.samplers.TPESampler(seed=seed))
        study.optimize(obj, n_trials=num_trials)
        best = study.best_params
    except ImportError:
        # in-tree Bayesian optimization (GP + UCB + constant liar) — the
        # CBO equivalent (reference: deephyper CBO at
        # gfm_deephyper_multi.py:164-177); random search only as the
        # explicit HYDRAGNN_HPO_RANDOM=1 opt-out
        from .envflags import env_flag
        if env_flag("HYDRAGNN_HPO_RANDOM"):
            rng = np.random.RandomState(seed)
            ss = SearchSpace(space)
            best, best_val = None, np.inf if not maximize else -np.inf
            for _ in range(num_trials):
                params = ss.sample(rng)
                val = objective(params)
                history.append({"params": params, "value": val})
                better = val > best_val if maximize else val < best_val
                if better:
                    best, best_val = params, val
        else:
            from .bayes_opt import CBO
            opt = CBO(space, seed=seed, maximize=maximize)
            for _ in range(num_trials):
                params = opt.ask()
                val = objective(params)
                opt.tell(params, val)
                history.append({"params": params, "value": val})
            best = opt.best[0] if opt.best else None
    if log_path:
        with open(log_path, "w") as f:
            json.dump({"best": best, "history": history}, f, indent=2,
                      default=str)
    return best, history


def orchestrate(script: str, space: Dict[str, Any], num_trials: int = 20,
                concurrent: int = 1, seed: int = 42,
                objective_pattern: str = r"final_val_loss\"?[:=]\s*([-\d.eE+]+)",
                log_dir: str = "./logs/hpo",
                extra_args: Optional[Dict[str, Any]] = None,
                chips_per_trial: Optional[int] = None,
                maximize: bool = False,
                timeout_s: float = 3600.0) -> Dict[str, Any]:
    """Standing multi-trial orchestration loop — the DeepHyper
    ProcessPoolEvaluator + CBO loop as one function (reference:
    gfm_deephyper_multi.py:47-180: queued evaluator pops node subsets,
    launches a trial script per suggestion, parses the objective from the
    trial's output with a regex, feeds it back to the search).

    Trials run as subprocesses of `script` with --key value args from the
    suggested params (+ extra_args). With `chips_per_trial`, trial i is
    pinned to a disjoint slice of cards via CUDA_VISIBLE_DEVICES. Results
    stream to {log_dir}/trials.jsonl (one JSON line per finished trial —
    crash-resumable: already-logged trials are told to the optimizer on
    restart). Failed/unparseable trials score worst-case, like the
    reference's "F" objective. Returns {"best": ..., "history": [...]}.
    """
    import sys as _sys
    import time

    from .bayes_opt import CBO

    os.makedirs(log_dir, exist_ok=True)
    trials_path = os.path.join(log_dir, "trials.jsonl")
    opt = CBO(space, seed=seed, maximize=maximize)
    history: List[Dict] = []
    worst = -np.inf if maximize else np.inf
    if os.path.exists(trials_path):  # resume a prior loop
        with open(trials_path) as f:
            for line in f:
                rec = json.loads(line)
                # failed trials persist as value=null (strict JSON);
                # tell() maps the non-finite stand-in to worst-finite
                val = rec["value"] if rec.get("value") is not None else worst
                opt.tell(rec["params"], val)
                history.append(rec)

    running: List[Tuple[subprocess.Popen, Dict, float, Any, int]] = []
    launched = len(history)
    pattern = re.compile(objective_pattern)
    # card slices are leased from a free-slot pool, NOT idx % concurrent:
    # out-of-order completions would otherwise pin two live trials to the
    # same CUDA_VISIBLE_DEVICES slice
    free_slots = list(range(max(1, concurrent)))

    def _launch(idx: int):
        params = opt.ask()
        args = dict(params)
        args.update(extra_args or {})
        slot = free_slots.pop(0)
        chips = None
        if chips_per_trial:
            chips = list(range(slot * chips_per_trial,
                               (slot + 1) * chips_per_trial))
        cmd = create_launch_command(script, args, chips=chips,
                                    python=_sys.executable)
        env_over, cmd = split_env_prefix(cmd)
        env = dict(os.environ, **env_over)
        out = open(os.path.join(log_dir, f"trial_{idx:04d}.log"), "w")
        # own session: a timed-out trial is killed as a PROCESS GROUP so
        # grandchildren (run_one wrappers spawn the actual training) can't
        # outlive it still holding the card slice we're about to re-lease
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=env, start_new_session=True)
        running.append((proc, params, time.time(), out, slot))

    def _reap(block: bool):
        while running:
            for i, (proc, params, t0, out, slot) in enumerate(running):
                rc = proc.poll()
                timed_out = False
                if rc is None and time.time() - t0 > timeout_s:
                    import signal
                    timed_out = True
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        proc.kill()
                    # real wait() status (not a hardcoded -9): diagnostics
                    # can tell a SIGKILLed group from one that beat the
                    # kill to a clean exit
                    rc = proc.wait()
                if rc is not None:
                    out.close()
                    val = worst
                    logf = out.name
                    try:
                        with open(out.name) as f:
                            matches = pattern.findall(f.read())
                        if rc == 0 and matches:
                            val = float(matches[-1])
                    except (OSError, ValueError):
                        pass
                    # tell() maps non-finite scores to worst-finite so a
                    # failed trial can't poison the GP surrogate
                    opt.tell(params, val)
                    # strict JSON: a failed trial records null + failed
                    # (json.dumps would emit bare Infinity otherwise,
                    # breaking jq/strict parsers on trials.jsonl)
                    rec = {"params": params,
                           "value": val if np.isfinite(val) else None,
                           "failed": not np.isfinite(val),
                           "timed_out": timed_out, "rc": rc, "log": logf}
                    history.append(rec)
                    with open(trials_path, "a") as f:
                        f.write(json.dumps(rec, default=str) + "\n")
                    free_slots.append(slot)
                    del running[i]
                    return
            if not block:
                return
            time.sleep(1.0)

    while launched < num_trials:
        while len(running) < concurrent and launched < num_trials:
            _launch(launched)
            launched += 1
        _reap(block=True)
    while running:
        _reap(block=True)

    best = opt.best
    result = {"best": {"params": best[0], "value": best[1]} if best else None,
              "history": history}
    with open(os.path.join(log_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2, default=str)
    return result
