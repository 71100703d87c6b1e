"""A child trial: ``python -m hydragnn_tpu_torch.hpo.runner`` (counterpart:
hydragnn_tpu/hpo/runner.py, whose config, data and result this keeps).

One HPO trial as one training process: it builds a small deterministic
config from the suggested hyperparameters, trains it through the port's
`run_training` with a committed checkpoint every epoch, and writes
``result.json`` atomically on success. Killed anywhere and relaunched
with ``--resume``, it restores from LATEST and retrains its
uninterrupted trajectory bit for bit. The run is on the card unless
``--device cpu``. Beside JAX's keys, result.json carries the port's
`param_digest` and `param_norm` (elastic/runner.py) of the returned
state, so a resumed trial's weights can be held against its twin's.

``--hang-after-epoch N`` stands in for a wedged trial (a dead
filesystem, a stuck collective): once N checkpoints are committed the
process stops itself, so the supervisor's heartbeat watchdog must kill
and resume it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List

import numpy as np

# hyperparameter name -> config path; anything else must be an explicit
# dotted config path (actionable error otherwise, never silent)
PARAM_PATHS = {
    "learning_rate": ("NeuralNetwork", "Training", "Optimizer",
                      "learning_rate"),
    "batch_size": ("NeuralNetwork", "Training", "batch_size"),
    "hidden_dim": ("NeuralNetwork", "Architecture", "hidden_dim"),
    "num_conv_layers": ("NeuralNetwork", "Architecture",
                        "num_conv_layers"),
    "model_type": ("NeuralNetwork", "Architecture", "model_type"),
}


def base_trial_config(num_epochs: int) -> Dict[str, Any]:
    """A small GIN graph-head config (the JAX package's) with the
    checkpoint block the resume contract needs."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "hpo_synth",
            "format": "unit_test",
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                              "column_index": [0, 6, 7]},
            "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1],
                               "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": "GIN",
                "radius": 1.0,
                "max_neighbours": 100,
                "hidden_dim": 8,
                "num_conv_layers": 2,
                "output_heads": {
                    "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 4,
                              "num_headlayers": 2,
                              "dim_headlayers": [10, 10]},
                },
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["sum_x_x2_x3"],
                "output_index": [0],
                "type": ["graph"],
                "denormalize_output": False,
            },
            "Training": {
                "num_epoch": int(num_epochs),
                "perc_train": 0.7,
                "EarlyStopping": False,
                "patience": 10,
                "loss_function_type": "mse",
                "batch_size": 8,
                "Checkpoint": True,
                "checkpoint_every_n_epochs": 1,
                "keep_best": True,
                "Optimizer": {"type": "AdamW", "learning_rate": 0.005},
            },
        },
    }


def apply_params(config: Dict[str, Any],
                 params: Dict[str, Any]) -> Dict[str, Any]:
    """Set each suggested hyperparameter at its config path (sorted for
    a deterministic application order)."""
    for key in sorted(params):
        path = PARAM_PATHS.get(key)
        if path is None:
            if "." not in key:
                raise ValueError(
                    f"unknown hyperparameter {key!r} (known: "
                    f"{', '.join(sorted(PARAM_PATHS))}; or use a dotted "
                    "config path like NeuralNetwork.Training.batch_size)")
            path = tuple(key.split("."))
        node = config
        for part in path[:-1]:
            node = node[part]
        node[path[-1]] = params[key]
    return config


def _wedge_after_commits(trial_dir: str, n_commits: int) -> None:
    """The chaos watcher (``--hang-after-epoch``): once `n_commits`
    checkpoints are committed, SIGSTOP this process, wedged mid-epoch
    (or mid-save) with its work on disk."""
    import signal

    from .process import committed_steps
    while len(committed_steps(trial_dir)) < int(n_commits):
        time.sleep(0.001)
    os.kill(os.getpid(), signal.SIGSTOP)


def _has_own_checkpoint(trial_dir: str) -> bool:
    """Anything a resume would restore under this trial's own run dirs
    (hpo.process.restorable_steps)."""
    from .process import restorable_steps
    return bool(restorable_steps(trial_dir))


def synthetic_dataset(num_configs: int, seed: int = 0) -> List:
    """A deterministic BCC-lattice graph-head dataset, bitwise the JAX
    package's (its edges from the port's `graphs.radius.radius_graph`):
    node feature type / num_types, graph target sum(x + x^2 + x^3)."""
    from ..graphs import GraphSample
    from ..graphs.radius import radius_graph
    rng = np.random.RandomState(int(seed))
    samples = []
    for _ in range(int(num_configs)):
        ucx, ucy = rng.randint(1, 4), rng.randint(1, 4)
        ucz = rng.randint(1, 3)
        pos = []
        for x in range(ucx):
            for y in range(ucy):
                for z in range(ucz):
                    pos.append([x, y, z])
                    pos.append([x + 0.5, y + 0.5, z + 0.5])
        pos = np.asarray(pos, dtype=np.float32)
        types = np.arange(pos.shape[0]) % 3
        x = (types.astype(np.float32) + 1.0) / 3.0
        send, recv = radius_graph(pos, 1.0, 100)
        y_graph = np.asarray([(x + x ** 2 + x ** 3).sum()], np.float32)
        samples.append(GraphSample(
            x=x[:, None], pos=pos, senders=send, receivers=recv,
            y_graph=y_graph))
    return samples


def run_trial(params: Dict[str, Any], *, num_epochs: int,
              num_configs: int, data_seed: int, resume: bool,
              hang_after_epoch: int = 0, trial_dir: str = ".",
              device: str = "cuda") -> Dict[str, Any]:
    """Train one trial in ``trial_dir`` (the cwd contract: run dirs land
    under ./logs) on `device`. Returns the result payload (also written
    to result.json unless the hang phase is active)."""
    from ..elastic.runner import param_digest
    from ..preprocess.load_data import split_dataset
    from ..run_training import run_training

    hang = int(hang_after_epoch) > 0 and not resume
    config = apply_params(base_trial_config(num_epochs), params)
    train_cfg = config["NeuralNetwork"]["Training"]
    if hang:
        # wedge mid-training once N checkpoints are committed: SIGSTOP
        # from a watcher thread freezes the process anywhere in the epoch
        # loop; the log and the checkpoints stop, the watchdog kills the
        # group, and the relaunch resumes from LATEST mid-trajectory
        import threading
        threading.Thread(target=_wedge_after_commits,
                         args=(trial_dir, int(hang_after_epoch)),
                         daemon=True).start()
    fork_meta_path = os.path.join(trial_dir, "FORK.json")
    if resume and _has_own_checkpoint(trial_dir):
        train_cfg["continue"] = 1
    elif os.path.exists(fork_meta_path):
        # first launch of a fork, or a fork killed before its own first
        # commit: (re-)adopt the donor checkpoint
        with open(fork_meta_path) as f:
            fork = json.load(f)
        train_cfg["continue"] = 1
        train_cfg["startfrom"] = fork["startfrom"]
    # else: resume with nothing to restore (killed before or inside the
    # first save) restarts from scratch; deterministic training makes the
    # restarted trajectory identical to the lost one

    samples = synthetic_dataset(num_configs, seed=data_seed)
    splits = split_dataset(samples, train_cfg.get("perc_train", 0.7))
    state, history, _, _ = run_training(config, datasets=splits,
                                        device=device, num_shards=1)

    if hang:
        # if training outran the watcher, still never report success
        # from a hang-injected launch: wedge here, so the watchdog path
        # runs whatever the timing
        while True:
            time.sleep(3600)

    result = {
        "objective": float(min(history["val_loss"])),
        "history": {k: history[k] for k in ("train_loss", "val_loss",
                                            "test_loss", "lr")},
        "step": int(state.step),
        "params": dict(params),
        **param_digest(state),
    }
    tmp = os.path.join(trial_dir, "result.json.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(trial_dir, "result.json"))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--params", default="{}",
                   help="JSON dict of hyperparameters")
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-configs", type=int, default=24)
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from this trial dir's LATEST")
    p.add_argument("--hang-after-epoch", type=int, default=0,
                   help="chaos: train N epochs then stop progressing")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    # the first heartbeat before any heavy import: the progress token
    # includes the log's size, and the torch import and the card's
    # context are otherwise a silent window the watchdog must not take
    # for a hang
    print(f"hpo-runner: starting (params={args.params} "
          f"resume={args.resume})", flush=True)
    run_trial(json.loads(args.params), num_epochs=args.num_epochs,
              num_configs=args.num_configs, data_seed=args.data_seed,
              resume=args.resume,
              hang_after_epoch=args.hang_after_epoch, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
