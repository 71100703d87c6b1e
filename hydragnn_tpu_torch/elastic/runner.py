"""A child rank: ``python -m hydragnn_tpu_torch.elastic.runner``
(counterpart: hydragnn_tpu/elastic/runner.py, whose config, data and
result this keeps).

One rank of a data-parallel training job: it joins the group over the
launcher's rendezvous, trains the HPO trial's GIN config packed, with
ZeRO and a committed checkpoint every epoch (`base_job_config`), and
rank 0 writes ``result.json`` atomically: the history, the final step
and the port's `param_digest`. Killed anywhere and relaunched with
``--resume`` at any world size W' that divides ``--total-shards``, every
rank restores from LATEST, re-slices the same global pack plan, and the
job ends with equal step counts: bit for bit at the same W, within a
bound across W -> W' (the gradient's summation order changes).

A rank trains ``total_shards / W`` data shards stacked on its own device
(run_training's `data_devices`). The device is ``--device`` (default
cuda); ranks meet over gloo on the CPU and where they outnumber the
visible cards (two ranks on one card), else over NCCL.

``--hang-after-epoch N`` stands in for a wedged rank (a dead NIC, a stuck
collective): once N new checkpoints are committed the rank stops
itself, its peers block in the next collective, and only the
supervisor's coordinated abort recovers the job.

`param_digest` and `start_alive_ticker` serve the other rank children
too (examples/gfm.py, examples/ogbn.py).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from typing import Any, Dict

import numpy as np


def base_job_config(num_epochs: int, batch_size: int) -> Dict[str, Any]:
    """The HPO trial config (hpo/runner.base_trial_config) with the
    elastic job's extras: budget-packed batching (the one global pack
    plan every world size re-slices) and ZeRO's split of the optimizer
    state (so a W -> W' restore restores each rank's rows)."""
    from ..hpo.runner import base_trial_config
    config = base_trial_config(num_epochs)
    config["Dataset"]["name"] = "elastic_synth"
    tcfg = config["NeuralNetwork"]["Training"]
    tcfg["batch_size"] = int(batch_size)
    tcfg["batch_packing"] = True
    tcfg["Optimizer"]["use_zero_redundancy"] = True
    # the small model's leaves are below the default 2^14-element floor:
    # without this every leaf stays whole and the split restore is
    # never exercised
    tcfg["Optimizer"]["zero_min_shard_size"] = 8
    return config


def _wedge_after_commits(job_dir: str, n_commits: int,
                         base_commits: int = 0) -> None:
    """The chaos watcher (``--hang-after-epoch``): once `n_commits` new
    checkpoints are committed past `base_commits` (the count when this
    launch started), SIGSTOP this rank."""
    import signal
    while len(_committed(job_dir)) < int(base_commits) + int(n_commits):
        time.sleep(0.001)
    os.kill(os.getpid(), signal.SIGSTOP)


def _committed(job_dir: str):
    from ..hpo.process import committed_steps
    return committed_steps(job_dir)


def start_alive_ticker(label: str = "elastic-runner",
                       period_s: float = 5.0) -> None:
    """A daemon thread printing one line a period. A rank logs nothing
    between its first line and its first epoch (the torch import, the
    card's context, the kernel libraries, the first captures), and its
    log's size is its heartbeat token; the ticker keeps it growing. A
    SIGSTOP (the injected hang) freezes this thread too, so a wedged
    rank still goes stale."""
    import threading

    def _tick():
        n = 0
        while True:
            time.sleep(period_s)
            n += 1
            print(f"{label}: alive t+{n * period_s:g}s", flush=True)

    threading.Thread(target=_tick, daemon=True).start()


def param_digest(state) -> Dict[str, object]:
    """sha256 over the state's parameters and buffers in sorted key
    order (each key's bytes, then its tensor's), plus their float64 norm
    (the bound across world sizes). The port's own digest: the JAX
    package's hashes the Flax parameter tree by its paths."""
    h = hashlib.sha256()
    sq = 0.0
    for name, t in sorted(state.state_dict().items()):
        arr = t.detach().cpu().contiguous().numpy()
        h.update(name.encode())
        h.update(arr.tobytes())
        sq += float((arr.astype(np.float64) ** 2).sum())
    return {"param_digest": h.hexdigest(), "param_norm": float(np.sqrt(sq))}


def _backend(device, world: int) -> str:
    """gloo on the CPU and for ranks sharing a card, else NCCL."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def run_rank(*, rank: int, world: int, total_shards: int,
             num_epochs: int, num_configs: int, data_seed: int,
             batch_size: int, resume: bool, hang_after_epoch: int = 0,
             job_dir: str = ".", device: str = "cuda") -> int:
    """Train this rank in ``job_dir`` (the shared cwd: run dirs land under
    ./logs, rank 0 writes ./result.json) on `device`."""
    from ..hpo.process import restorable_steps
    from ..hpo.runner import synthetic_dataset
    from ..parallel.mesh import init_distributed
    from ..preprocess.load_data import split_dataset
    from ..run_training import run_training
    from ..utils.devices import resolve_device

    # unlike the trial sites (first launch only), the rank sites are
    # consulted on every launch: a hang injected into a resume
    # generation counts new commits from this launch's start
    hang = int(hang_after_epoch) > 0
    config = base_job_config(num_epochs, batch_size)
    train_cfg = config["NeuralNetwork"]["Training"]
    if hang:
        import threading
        threading.Thread(target=_wedge_after_commits,
                         args=(job_dir, int(hang_after_epoch),
                               len(_committed(job_dir))),
                         daemon=True).start()
    if resume and restorable_steps(job_dir):
        train_cfg["continue"] = 1
    # else: resume with nothing to restore (the whole generation died
    # before or inside the first save) restarts from scratch;
    # deterministic training makes the restarted trajectory the lost one

    dev = resolve_device(device)
    if world > 1:
        # the group from the launcher's HYDRAGNN_MASTER_* / SLURM_* env;
        # run_training joins it
        init_distributed(device=dev, backend=_backend(dev, world))
    samples = synthetic_dataset(num_configs, seed=data_seed)
    splits = split_dataset(samples, train_cfg.get("perc_train", 0.7))
    state, history, _, _ = run_training(
        config, datasets=splits, device=dev, num_shards=int(total_shards),
        data_devices=[dev] * (int(total_shards) // int(world)))

    if hang:
        # never report success from a hang-injected launch: SIGSTOP (a
        # sleep would leave the alive ticker beating), so the watchdog
        # path runs whatever the timing
        import signal
        os.kill(os.getpid(), signal.SIGSTOP)
        while True:  # pragma: no cover — unreachable past the STOP
            time.sleep(3600)

    if rank == 0:
        committed = _committed(job_dir)
        result = {
            "objective": float(min(history["val_loss"])),
            "history": {k: history[k] for k in ("train_loss", "val_loss",
                                                "test_loss", "lr")},
            # keep_best returns the best state, whose step is the best
            # epoch's; final_step is the run's last committed step
            "step": int(state.step),
            "final_step": int(committed[-1]) if committed
            else int(state.step),
            "world_size": int(world),
            "total_shards": int(total_shards),
            **param_digest(state),
        }
        tmp = os.path.join(job_dir, "result.json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(job_dir, "result.json"))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--total-shards", type=int, default=4,
                   help="the global data-shard count, the same at every "
                        "world size (each rank trains total/world)")
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-configs", type=int, default=24)
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="continue from this job dir's LATEST")
    p.add_argument("--hang-after-epoch", type=int, default=0,
                   help="chaos: train N epochs then SIGSTOP this rank")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.total_shards % args.world:
        p.error(f"--total-shards {args.total_shards} must divide evenly "
                f"over --world {args.world}")
    # the first heartbeat before any heavy import: the progress token
    # includes the log's size
    print(f"elastic-runner: starting (rank={args.rank} "
          f"world={args.world} total_shards={args.total_shards} "
          f"resume={args.resume})", flush=True)
    start_alive_ticker()
    return run_rank(rank=args.rank, world=args.world,
                    total_shards=args.total_shards,
                    num_epochs=args.num_epochs,
                    num_configs=args.num_configs,
                    data_seed=args.data_seed,
                    batch_size=args.batch_size,
                    resume=args.resume,
                    hang_after_epoch=args.hang_after_epoch,
                    device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
