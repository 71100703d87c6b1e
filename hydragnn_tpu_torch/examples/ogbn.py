"""Sampled training on one giant graph, the port's counterpart of
examples/ogbn/train_ogbn.py, with its command line:

    python -m hydragnn_tpu_torch.examples.ogbn --job-dir DIR
        [--inputfile examples/ogbn/ogbn_arxiv.json] [--num-epochs N]
        [--batch-size B] [--num-nodes 2000] [--data-dir D] [--data-seed 0]
        [--seed 0] [--staleness-k K] [--async-workers W]
        [--rank r --world W] [--log-name ogbn] [--resume] [--device cuda]

It trains the config's SAGE on the ogbn-style graph (the example's
``ogbn_graph.npz`` under --data-dir, else `graphs.synthetic.
synthetic_arxiv`) through fixed-shape fanout minibatches
(preprocess/sampling.NeighborSamplingLoader; the knobs resolved once by
utils/envflags.resolve_sampling: HYDRAGNN_SAMPLE_* over
Training.Sampling), one captured train step for the run on the card, and
at --staleness-k > 0 the historical-embedding cache (its tables on the
card, refreshed inside the step every K steps; `record_hist_refresh`
after each step). Validation samples exactly (K = 0, no shuffle) over the
val ids. Per epoch: an epoch line with the train and val losses and the
val accuracy, and a committed checkpoint under <job-dir>/logs whose
metadata holds the history; `--resume` restarts from the newest one. It
prints `plan_fp=` (the plan's fingerprint, the JAX package's for the same
inputs) and writes <job-dir>/result.json atomically (rank 0) with the
port's `param_digest` (elastic/runner.py).

As the JAX driver does, it trains with Adam at `Optimizer.learning_rate`,
not the config's AdamW (ROADMAP, reference quirks), and draws the first
batch of epoch 0 once before training (JAX initialises its weights from
it), so the fetch accounting matches. The historical tables are not
checkpointed (neither are JAX's): a resumed run at K > 0 restarts them.
The run is on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import types
from typing import Dict

import numpy as np

from ..config import build_model_config
from ..graphs.synthetic import load_ogbn
from ..models.create import create_model
from ..preprocess.sampling import NeighborSamplingLoader, init_hist_tables
from ..telemetry import record_hist_refresh
from ..train.optimizer import Optimizer
from ..train.train_step import (TrainState, make_sampled_eval_step,
                                make_sampled_train_step)
from ..elastic.runner import param_digest, start_alive_ticker
from ..hpo.process import committed_steps
from ..utils.checkpoint import load_existing_model, save_model
from ..utils.devices import resolve_device
from ..utils.envflags import resolve_sampling
from ..utils.weights import load_jax_variables

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "examples", "ogbn", "ogbn_arxiv.json")


def load_ogbn_config(path: str = DEFAULT_CONFIG, num_epochs=None,
                     batch_size=None) -> dict:
    """The example's JSON config, with the command line's overrides."""
    with open(path) as f:
        config = json.load(f)
    train_cfg = config["NeuralNetwork"]["Training"]
    if num_epochs is not None:
        train_cfg["num_epoch"] = num_epochs
    if batch_size is not None:
        train_cfg["batch_size"] = batch_size
    return config


def complete_config(config: dict, data):
    """The model config: the keys `update_config` derives from datasets
    (input width, the node head's classes) taken from the graph itself,
    as the JAX driver does."""
    arch = config["NeuralNetwork"]["Architecture"]
    arch["input_dim"] = int(data.x.shape[1])
    arch["output_dim"] = [int(data.num_classes)]
    arch["output_type"] = ["node"]
    arch.setdefault("num_nodes", 0)
    return build_model_config(config)


def run(args, variables=None) -> "tuple[dict, types.SimpleNamespace]":
    """(result, run): result is what result.json holds; run holds the
    state, the train step, the train loader, the model config, the first
    step's metrics, each epoch's wall time, the train step's captures and
    the seeds a second, for callers that look inside. `variables` (a Flax
    {"params", "batch_stats"} tree) are loaded in place of the seeded
    initial weights."""
    device = resolve_device(args.device)
    config = load_ogbn_config(args.inputfile, args.num_epochs,
                              args.batch_size)
    train_cfg = config["NeuralNetwork"]["Training"]
    fanouts, staleness_k, partitions, partition_mode = \
        resolve_sampling(train_cfg)
    if args.staleness_k is not None:
        staleness_k = int(args.staleness_k)

    data = load_ogbn(args.data_dir, num_nodes=args.num_nodes,
                     seed=args.data_seed)
    B = int(train_cfg["batch_size"])
    y = data.y_onehot
    num_layers = int(config["NeuralNetwork"]["Architecture"]
                     ["num_conv_layers"])
    common = dict(senders=data.senders, receivers=data.receivers,
                  batch_size=B, fanouts=fanouts, seed=args.seed,
                  num_partitions=partitions, partition_mode=partition_mode,
                  num_layers=num_layers, async_workers=args.async_workers)
    loader = NeighborSamplingLoader(
        x=data.x, y_node=y, train_nodes=data.train_idx, rank=args.rank,
        world=args.world, staleness_k=staleness_k, **common)
    val_nodes = data.val_idx[:max(len(data.val_idx) // B, 1) * B]
    val_loader = NeighborSamplingLoader(
        x=data.x, y_node=y, train_nodes=val_nodes, shuffle=False, rank=0,
        world=1, staleness_k=0, **common)
    plan_fp = loader.plan_fingerprint()
    print(f"plan_fp={plan_fp}", flush=True)

    mcfg = complete_config(config, data)
    model = create_model(mcfg, device=device, seed=args.seed)
    if variables is not None:
        model.load_state_dict(load_jax_variables(variables))
    lr = float(train_cfg["Optimizer"].get("learning_rate", 1e-3))
    tx = Optimizer("Adam", learning_rate=lr)
    loss_name = train_cfg.get("loss_function_type", "ce")
    step = make_sampled_train_step(model, mcfg, tx, loss_name=loss_name,
                                   staleness_k=staleness_k)
    # eval samples exactly, so accuracy is never confounded by staleness
    eval_step = make_sampled_eval_step(model, mcfg, loss_name=loss_name,
                                       staleness_k=0)
    hist = staleness_k > 0
    tables = (init_hist_tables(data.x, mcfg.hidden_dim,
                               mcfg.num_conv_layers, device=device)
              if hist else None)
    state = TrainState.create(model, tx)

    # JAX's driver draws this batch to initialise its weights: drawn here
    # too, the fetch accounting and the sampler's metrics match
    loader.set_epoch(0)
    next(iter(loader))

    ckpt_path = os.path.join(args.job_dir, "logs")
    history: Dict[str, list] = {"train_loss": [], "val_loss": [],
                                "val_acc": []}
    start_epoch = 0
    if args.resume and committed_steps(args.job_dir):
        restored, meta = load_existing_model(
            state, args.log_name, path=ckpt_path, with_metadata=True)
        if restored is not None:
            state.restore(restored)
            if meta and "history" in meta:
                history = {k: list(v) for k, v in meta["history"].items()}
            start_epoch = len(history["train_loss"])
            print(f"ogbn-runner: resumed at step {int(state.step)} "
                  f"(epoch {start_epoch})", flush=True)

    num_epochs = int(train_cfg["num_epoch"])
    steps_per_epoch = len(loader)
    info = types.SimpleNamespace(state=state, step=step, loader=loader,
                                 mcfg=mcfg, first_metrics=None, epoch_s=[])
    t_train = time.perf_counter()
    for epoch in range(start_epoch, num_epochs):
        t_epoch = time.perf_counter()
        loader.set_epoch(epoch)
        losses = []
        for i, batch in enumerate(loader):
            batch = batch.to(device)
            if hist:
                gstep = epoch * steps_per_epoch + i
                state, tables, metrics = step(
                    state, batch, tables, gstep % staleness_k == 0)
                record_hist_refresh(float(metrics["hist_staleness"]),
                                    float(metrics["hist_frac"]))
            else:
                state, metrics = step(state, batch)
            if info.first_metrics is None:
                info.first_metrics = {k: float(v)
                                      for k, v in metrics.items()}
            losses.append(float(metrics["loss"]))
        vl, corr, cnt = [], 0.0, 0.0
        for batch in val_loader:
            m, _ = eval_step(state, batch.to(device))
            vl.append(float(m["loss"]))
            corr += float(m["correct"])
            cnt += float(m["count"])
        history["train_loss"].append(float(np.mean(losses)))
        history["val_loss"].append(float(np.mean(vl)))
        history["val_acc"].append(corr / max(cnt, 1.0))
        print(f"epoch {epoch}: train_loss={history['train_loss'][-1]:.4f}"
              f" val_loss={history['val_loss'][-1]:.4f}"
              f" val_acc={history['val_acc'][-1]:.4f}", flush=True)
        save_model(state, args.log_name, path=ckpt_path,
                   metadata={"history": history, "epoch": epoch})
        info.epoch_s.append(time.perf_counter() - t_epoch)
    train_s = time.perf_counter() - t_train
    info.train_captures = len(step.steps.graphs)
    info.seeds_per_s = ((num_epochs - start_epoch) * steps_per_epoch * B
                        / max(train_s, 1e-9))

    committed = committed_steps(args.job_dir)
    result = {
        "objective": float(history["val_loss"][-1]),
        "history": history,
        "step": int(state.step),
        "final_step": int(committed[-1]) if committed
        else int(state.step),
        "world_size": int(args.world),
        "plan_fp": plan_fp,
        "staleness_k": int(staleness_k),
        "graphs_per_s": info.seeds_per_s,
        "fetch_stats": loader.fetch_stats(),
        **param_digest(state),
    }
    if args.rank == 0:
        tmp = os.path.join(args.job_dir, "result.json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(args.job_dir, "result.json"))
    print(json.dumps({"final_train_loss": history["train_loss"][-1],
                      "final_val_acc": history["val_acc"][-1]}), flush=True)
    return result, info


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Sampled giant-graph training (hydragnn_tpu_torch)")
    p.add_argument("--inputfile", default=DEFAULT_CONFIG,
                   help="the JSON config (default "
                        "examples/ogbn/ogbn_arxiv.json)")
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-nodes", type=int, default=2000,
                   help="synthetic graph size (ignored with real data)")
    p.add_argument("--data-dir", default=None,
                   help="directory holding ogbn_graph.npz (synthetic "
                        "when absent)")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--staleness-k", type=int, default=None,
                   help="historical-embedding refresh period "
                        "(overrides config/env; 0 = exact)")
    p.add_argument("--async-workers", type=int, default=None,
                   help="background sampling depth (None = env default)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--job-dir", default=".",
                   help="checkpoints land under <job-dir>/logs; rank 0 "
                        "writes <job-dir>/result.json")
    p.add_argument("--log-name", default="ogbn")
    p.add_argument("--resume", action="store_true",
                   help="continue from this job dir's newest committed "
                        "checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # the first heartbeat before any heavy work (the supervisor's
    # watchdog), then one line a period
    print(f"ogbn-runner: starting (rank={args.rank} world={args.world} "
          f"resume={args.resume})", flush=True)
    start_alive_ticker("ogbn-runner")
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
