"""Multi-dataset GFM mixture training, the port's counterpart of
examples/gfm/train_gfm.py, with its command line:

    python -m hydragnn_tpu_torch.examples.gfm --job-dir DIR
        [--inputfile examples/gfm/gfm_mixture.json] [--num-epochs N]
        [--batch-size B] [--sizes 48,32,40] [--data-seed 0] [--seed 0]
        [--rank r --world W] [--log-name gfm] [--resume] [--device cuda]

It trains the synthetic three-member mixture (graphs/synthetic.py
`build_members`) through the global mixture pack plan
(parallel/multidataset.GfmMixtureLoader: one captured train step for the
run) and the head-masked multi-task step (train/gfm.py), the knobs
resolved once (utils/envflags.resolve_gfm: HYDRAGNN_GFM_* over
Training.Gfm). Per epoch: the count-weighted per-head losses
(`GfmEpochAccumulator`), the registry's gauges (`record_gfm_epoch`),
the telemetry session's epoch event when one is on, an epoch line and a
committed checkpoint under <job-dir>/logs whose metadata holds the
history; `--resume` restarts from the newest committed one. It prints
`plan_fp=` (the plan's fingerprint, the JAX package's for the same
inputs) and writes <job-dir>/result.json atomically (rank 0).

As the JAX driver does, it trains with Adam at
`Optimizer.learning_rate`, not the config's AdamW (ROADMAP, reference
quirks). `--rank r --world W` trains rank r's slice of the plan, with no
collective between the ranks. The config is read from the file, never
imported; the run is on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
import types
from typing import Dict

import numpy as np

from ..config import build_model_config, update_config
from ..graphs.synthetic import build_members, split_members
from ..models.create import create_model
from ..parallel.multidataset import GfmMixtureLoader
from ..telemetry import record_gfm_epoch, start_session
from ..train.gfm import (GfmEpochAccumulator, make_gfm_eval_step,
                         make_gfm_train_step)
from ..train.optimizer import Optimizer
from ..train.train_step import TrainState
from ..utils.checkpoint import (committed_steps, load_existing_model,
                                save_model)
from ..utils.devices import resolve_device
from ..utils.envflags import resolve_gfm, resolve_telemetry

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "gfm", "gfm_mixture.json")


def load_gfm_config(path: str = DEFAULT_CONFIG, num_epochs=None,
                    batch_size=None) -> dict:
    """The mixture's JSON config, with the command line's overrides."""
    with open(path) as f:
        config = json.load(f)
    train_cfg = config["NeuralNetwork"]["Training"]
    if num_epochs is not None:
        train_cfg["num_epoch"] = num_epochs
    if batch_size is not None:
        train_cfg["batch_size"] = batch_size
    return config


def param_digest(state) -> Dict[str, object]:
    """sha256 over the state's parameters and buffers in sorted key
    order (each key's bytes, then its tensor's), plus their float64 norm.
    The port's own digest: it is not the JAX package's, which hashes the
    Flax parameter tree by its paths."""
    h = hashlib.sha256()
    sq = 0.0
    for name, t in sorted(state.state_dict().items()):
        arr = t.detach().cpu().contiguous().numpy()
        h.update(name.encode())
        h.update(arr.tobytes())
        sq += float((arr.astype(np.float64) ** 2).sum())
    return {"param_digest": h.hexdigest(), "param_norm": float(np.sqrt(sq))}


def run(args, optimizer=None) -> "tuple[dict, types.SimpleNamespace]":
    """(result, run): result is what result.json holds; run holds the
    state, the train step, the train loader, the model config, the first
    step's metrics, each epoch's wall time and per-head train and val
    losses, and the train step's captures, for callers that look
    inside. `optimizer`, given, trains in place of the driver's Adam."""
    device = resolve_device(args.device)
    config = load_gfm_config(args.inputfile, args.num_epochs,
                             args.batch_size)
    train_cfg = config["NeuralNetwork"]["Training"]
    mixture, head_weights = resolve_gfm(train_cfg)

    members = build_members(
        sizes=[int(v) for v in args.sizes.split(",")],
        seed=args.data_seed)
    train_members, val_members = split_members(members)
    all_train = [s for v in train_members.values() for s in v]
    config = update_config(config, all_train)
    mcfg = build_model_config(config)

    B = int(train_cfg["batch_size"])
    loader = GfmMixtureLoader(
        train_members, B, cfg=mcfg, weights=mixture, seed=args.seed,
        pack_rank=args.rank, pack_nproc=args.world)
    # validation replays the whole mixture at epoch 0's order each epoch
    val_loader = GfmMixtureLoader(val_members, B, cfg=mcfg, seed=args.seed)
    plan_fp = loader.global_plan_fingerprint()
    print(f"plan_fp={plan_fp}", flush=True)

    model = create_model(mcfg, device=device, seed=args.seed)
    lr = float(train_cfg["Optimizer"].get("learning_rate", 3e-3))
    tx = optimizer or Optimizer("Adam", learning_rate=lr)
    names = loader.member_names
    step = make_gfm_train_step(model, mcfg, tx, head_weights=head_weights,
                               num_datasets=len(names))
    eval_step = make_gfm_eval_step(model, mcfg, head_weights=head_weights,
                                   num_datasets=len(names))
    state = TrainState.create(model, tx)

    session = start_session(resolve_telemetry(train_cfg), args.job_dir)
    ckpt_path = os.path.join(args.job_dir, "logs")
    history: Dict[str, list] = {"train_loss": [], "val_loss": []}
    for n in names:
        history[f"val_loss_{n}"] = []
    start_epoch = 0
    if args.resume and committed_steps(args.job_dir):
        restored, meta = load_existing_model(
            state, args.log_name, path=ckpt_path, with_metadata=True)
        if restored is not None:
            state.restore(restored)
            if meta and "history" in meta:
                history = {k: list(v) for k, v in meta["history"].items()}
            start_epoch = len(history["train_loss"])
            print(f"gfm-runner: resumed at step {int(state.step)} "
                  f"(epoch {start_epoch})", flush=True)

    num_epochs = int(train_cfg["num_epoch"])
    info = types.SimpleNamespace(
        state=state, step=step, loader=loader, mcfg=mcfg, config=config,
        first_metrics=None, epoch_s=[], train_head_losses=[],
        val_head_losses=[])
    t_train = time.perf_counter()
    graphs_done = 0
    for epoch in range(start_epoch, num_epochs):
        t_epoch = time.perf_counter()
        loader.set_epoch(epoch)
        acc = GfmEpochAccumulator(names)
        losses = []
        for batch in loader:
            state, metrics = step(state, batch.to(device))
            if info.first_metrics is None:
                info.first_metrics = {k: float(v)
                                      for k, v in metrics.items()}
            acc.update(batch, metrics)
            losses.append(float(metrics["loss"]))
        train_sum = acc.summary()
        graphs_done += acc.total_graphs
        val_loader.set_epoch(0)
        vacc = GfmEpochAccumulator(names)
        vl = []
        for batch in val_loader:
            m, _ = eval_step(state, batch.to(device))
            vacc.update(batch, m)
            vl.append(float(m["loss"]))
        val_sum = vacc.summary()
        history["train_loss"].append(float(np.mean(losses)))
        history["val_loss"].append(float(np.mean(vl)))
        for n in names:
            history[f"val_loss_{n}"].append(
                float(val_sum["head_losses"][n]))
        info.train_head_losses.append(dict(train_sum["head_losses"]))
        info.val_head_losses.append(dict(val_sum["head_losses"]))
        record_gfm_epoch(train_sum["head_losses"],
                         val_losses=val_sum["head_losses"],
                         mixture_frac=train_sum["mixture_frac"])
        if session is not None:
            data = {"train_loss": history["train_loss"][-1],
                    "val_loss": history["val_loss"][-1]}
            for n in names:
                data[f"gfm_head_loss_{n}"] = float(
                    train_sum["head_losses"][n])
                data[f"gfm_val_head_loss_{n}"] = float(
                    val_sum["head_losses"][n])
                data[f"gfm_mixture_frac_{n}"] = float(
                    train_sum["mixture_frac"][n])
            session.epoch_event(epoch, data=data)
        frac = " ".join(f"{n}={train_sum['mixture_frac'][n]:.2f}"
                        for n in names)
        print(f"epoch {epoch}: train_loss={history['train_loss'][-1]:.4f}"
              f" val_loss={history['val_loss'][-1]:.4f} mix[{frac}]",
              flush=True)
        save_model(state, args.log_name, path=ckpt_path,
                   metadata={"history": history, "epoch": epoch})
        info.epoch_s.append(time.perf_counter() - t_epoch)
    train_s = time.perf_counter() - t_train
    if session is not None:
        session.finalize()
    info.train_captures = len(step.steps.graphs)

    committed = committed_steps(args.job_dir)
    result = {
        "objective": float(history["val_loss"][-1]),
        "history": history,
        "per_head_val": {n: history[f"val_loss_{n}"][-1] for n in names},
        "mixture_frac": dict(loader.mixture_fractions()),
        "step": int(state.step),
        "final_step": int(committed[-1]) if committed
        else int(state.step),
        "world_size": int(args.world),
        "plan_fp": plan_fp,
        "graphs_per_s": graphs_done / max(train_s, 1e-9),
        **param_digest(state),
    }
    if args.rank == 0:
        tmp = os.path.join(args.job_dir, "result.json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(args.job_dir, "result.json"))
    print(json.dumps({"final_train_loss": history["train_loss"][-1],
                      "final_val_loss": history["val_loss"][-1]}),
          flush=True)
    return result, info


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Multi-dataset GFM mixture training (hydragnn_tpu_torch)")
    p.add_argument("--inputfile", default=DEFAULT_CONFIG,
                   help="the mixture's JSON config (default "
                        "examples/gfm/gfm_mixture.json)")
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--sizes", default="48,32,40",
                   help="per-member sample counts (alpha,beta,gamma)")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rank", type=int, default=0,
                   help="pack_rank: this process's slice of the global "
                        "mixture plan")
    p.add_argument("--world", type=int, default=1,
                   help="pack_nproc: the plan is computed globally and "
                        "sliced, so step counts are world-size-invariant")
    p.add_argument("--job-dir", default=".",
                   help="checkpoints land under <job-dir>/logs; rank 0 "
                        "writes <job-dir>/result.json")
    p.add_argument("--log-name", default="gfm")
    p.add_argument("--resume", action="store_true",
                   help="continue from this job dir's newest committed "
                        "checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    print(f"gfm-runner: starting (rank={args.rank} world={args.world} "
          f"resume={args.resume})", flush=True)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
