"""One rank of the port's multi-process CPU tests (tests/
test_torch_parallel*.py): `python tests/torch_parallel_worker.py JOB RANK
WORLD RDZV OUT`.

The rank joins a gloo group of WORLD ranks through a file rendezvous at
RDZV (one torch thread), runs `JOB`'s function (a pickle of {"fn": name,
"kwargs": {...}}) with (rank, world, **kwargs), and pickles its return
value to OUT. It imports the port only, never JAX: the parent test holds
the results against the JAX package. `spawn_ranks` is the parent's side:
it starts the ranks, joins each with a time bound, kills them all and
fails on a timeout or a rank that fails.
"""
from __future__ import annotations

import copy
import hashlib
import os
import pickle
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# ----------------------------------------------------------- parent side

def spawn_ranks(tmp_path, fn: str, world: int, timeout: float = 120.0,
                env=None, **kwargs):
    """Run `fn(rank, world, **kwargs)` in `world` ranks; returns their
    results in rank order. Fails (AssertionError with each rank's
    output) when a rank exits non-zero or the ranks outlast `timeout`."""
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    job = os.path.join(tmp_path, f"job_{fn}.pkl")
    with open(job, "wb") as f:
        pickle.dump({"fn": fn, "kwargs": kwargs}, f)
    rdzv = os.path.join(tmp_path, f"rdzv_{fn}_{time.monotonic_ns()}")
    child_env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(tmp_path, f"out_{fn}_{rank}.pkl")
        log = open(os.path.join(tmp_path, f"log_{fn}_{rank}.txt"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(rank),
             str(world), rdzv, out], stdout=log, stderr=subprocess.STDOUT,
            cwd=tmp_path, env=child_env), log))
        outs.append(out)
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} outlasted {timeout} s")
                break
            if proc.returncode != 0:
                failed.append(f"rank {rank} exit {proc.returncode}")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        logs = []
        for rank, (proc, log) in enumerate(procs):
            log.seek(0)
            logs.append(f"--- rank {rank}\n{log.read()[-4000:]}")
            log.close()
    assert not failed, "; ".join(failed) + "\n" + "\n".join(logs)
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


# ------------------------------------------------------------ rank side

def _init(rank, world, rdzv):
    import torch
    torch.set_num_threads(1)
    from hydragnn_tpu_torch.parallel.mesh import init_distributed
    got = init_distributed(coordinator=f"file://{rdzv}",
                           num_processes=world, process_id=rank,
                           timeout_s=60, device="cpu")
    assert got == (world, rank), got
    import torch.distributed as dist
    assert dist.get_backend() == "gloo"


def _model(config, variables, samples):
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import (create_model,
                                                  data_input_dim)
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    mcfg = data_input_dim(tcfg.build_model_config(config), samples)
    model = create_model(mcfg, device="cpu")
    if variables is not None:
        model.load_state_dict(load_jax_variables(variables))
    return model, mcfg


def _numpy_state(state):
    """{"params": {name: array}, "batch_stats": {...}} of a TrainState."""
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in state.params.items()},
            "batch_stats": {k: v.detach().numpy().copy()
                            for k, v in state.batch_stats.items()}}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def spmd_steps(rank, world, cases):
    """Each case: a model at `variables`, SpmdTrainStep over
    `batches[step][rank]`, then SpmdEvalStep on `eval_batches[rank]`.
    Returns per case the per-step metrics, the final variables (flax
    tree), the eval metrics, and the captured-route-free eager metrics
    of a second copy run through `eager` (equal on the CPU)."""
    from hydragnn_tpu_torch.parallel.spmd import (SpmdEvalStep,
                                                  SpmdTrainStep)
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_eval_step)
    from hydragnn_tpu_torch.utils.weights import export_jax_variables
    out = {}
    for case in cases:
        cfg = case["config"]
        tr = cfg["NeuralNetwork"]["Training"]
        model, mcfg = _model(cfg, case["variables"], case["samples"])
        tx = select_optimizer(tr)
        state = TrainState.create(model, tx)
        kw = dict(compute_grad_energy=case.get("cge", False))
        step = SpmdTrainStep(model, mcfg, tx, tr.get("loss_function_type",
                                                     "mse"), **kw)
        per_step = []
        for batches in case["batches"]:
            state, m = step(state, batches[rank])
            per_step.append(_floats(m))
        ev = None
        if case.get("eval_batches") is not None:
            evs = SpmdEvalStep(make_eval_step(model, mcfg, "mse", **kw))
            ev, _ = evs(state, case["eval_batches"][rank])
            ev = _floats(ev)
        out[case["name"]] = {"metrics": per_step,
                             "variables": export_jax_variables(model),
                             "eval": ev}
    return out


def zero_steps(rank, world, cases, steps):
    """Each case: the same model and batches through the replicated SPMD
    step and the ZeRO one (`zero_min_shard_size` 0); returns both
    states, the ZeRO rank's optimizer-slot bytes, the replicated slot
    bytes and the sharded leaves' flags."""
    from hydragnn_tpu_torch.parallel.spmd import (SpmdTrainStep,
                                                  make_zero_partition)
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    out = {}
    for case in cases:
        cfg = case["config"]
        tr = cfg["NeuralNetwork"]["Training"]
        res = {}
        for zero_on in (False, True):
            model, mcfg = _model(cfg, case["variables"], case["samples"])
            tx = select_optimizer(tr)
            zero = (make_zero_partition(list(model.parameters()), 0)
                    if zero_on else None)
            state = TrainState.create(model, tx, zero=zero)
            step = SpmdTrainStep(model, mcfg, tx)
            metrics = []
            for i in range(steps):
                state, m = step(state, case["batches"][i][rank])
                metrics.append(_floats(m))
            slots_bytes = sum(t.numel() * t.element_size()
                              for ts in state.opt_state.slots.values()
                              for t in ts)
            full = state.opt_state.slots
            if zero is not None:
                full = {k: zero.gather(v) for k, v in full.items()}
            res["zero" if zero_on else "replicated"] = dict(
                state=_numpy_state(state), metrics=metrics,
                slot_bytes=slots_bytes,
                slots={k: [t.numpy().copy() for t in v]
                       for k, v in full.items()},
                sharded=None if zero is None else list(zero.sharded))
        out[case["name"]] = res
    return out


def _digest(model) -> str:
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_run(rank, world, config, splits, variables, num_shards,
              runs=1, resume_config=None):
    """run_training in the group with the model loaded from `variables`;
    returns the history, a digest of the model after each epoch (read at
    the plateau step, after the epoch's eval passes), the final
    variables, and with `resume_config` a second run_training of it (a
    `continue` of the first) with its history and variables."""
    import importlib
    # the package exports a function named like the module
    rt = importlib.import_module("hydragnn_tpu_torch.run_training")
    from hydragnn_tpu_torch.train import trainer
    from hydragnn_tpu_torch.utils.weights import (export_jax_variables,
                                                  load_jax_variables)
    made = []
    create = rt.create_model

    def create_model(mcfg, device="cpu"):
        model = create(mcfg, device=device)
        if variables is not None:
            model.load_state_dict(load_jax_variables(variables))
        made.append(model)
        return model

    digests = []
    plateau_step = trainer.ReduceLROnPlateau.step

    def step(self, val_loss, lr):
        digests.append(_digest(made[-1]))
        return plateau_step(self, val_loss, lr)

    rt.create_model = create_model
    trainer.ReduceLROnPlateau.step = step
    out = {}
    from hydragnn_tpu_torch.utils.faults import InjectedFault
    for i, cfg in enumerate([config] + ([resume_config]
                                        if resume_config else [])):
        digests.clear()
        key = "first" if i == 0 else "resumed"
        try:
            _, hist, model, completed = rt.run_training(
                copy.deepcopy(cfg), datasets=splits, device="cpu",
                num_shards=num_shards)
        except InjectedFault as exc:
            # a fault plan's kill: the next run resumes from the saves
            out[key] = {"fault": f"InjectedFault: {exc}"}
            continue
        out[key] = dict(history=hist, digests=list(digests),
                        variables=export_jax_variables(model),
                        log_name=rt.get_log_name_config(completed))
    return out


def train_error(rank, world, config, splits):
    """The ValueError run_training raises, as text."""
    from hydragnn_tpu_torch import run_training
    try:
        run_training(copy.deepcopy(config), datasets=splits, device="cpu",
                     num_shards=world)
    except ValueError as exc:
        return str(exc)
    return None


def predict_run(rank, world, config, splits, variables, num_shards):
    from hydragnn_tpu_torch import run_prediction
    return run_prediction(copy.deepcopy(config), datasets=splits,
                          variables=variables, serve=False, device="cpu",
                          num_shards=num_shards)


def collectives(rank, world, stats_configs, values):
    """allreduce_max_int, sync_config_stats and a failing
    assert_equal_across_processes on each rank's own inputs."""
    from hydragnn_tpu_torch.parallel import multiprocess as mp
    out = {"max": mp.allreduce_max_int(*values[rank]),
           "stats": mp.sync_config_stats(stats_configs[rank])}
    mp.assert_equal_across_processes(7, "equal")
    try:
        mp.assert_equal_across_processes(rank, "rank")
        out["unequal"] = None
    except ValueError as exc:
        out["unequal"] = str(exc)
    return out


def multidataset_driver(rank, world, limit, job_dir, inputfile=None,
                        variables=None):
    """hydragnn_tpu_torch.examples.multidataset in this rank of the group
    (the driver joins it as it is), its model loaded from `variables` (a
    Flax tree) when given: the first step's metrics from a fresh setup,
    then one epoch through the driver from another (the history), and the
    member of this rank's shard."""
    from hydragnn_tpu_torch.examples import multidataset as md
    from hydragnn_tpu_torch.utils.weights import load_jax_variables
    argv = ["--job-dir", job_dir, "--device", "cpu", "--limit", str(limit),
            "--num_epoch", "1"]
    if inputfile is not None:
        argv += ["--inputfile", inputfile]
    args = md.parse_args(argv)

    def prepared():
        r = md.setup(args)
        if variables is not None:
            r.model.load_state_dict(load_jax_variables(variables))
        return r
    r = prepared()
    _, m = r.train_step(r.state, next(iter(r.loader)))
    _, history, run = md.train(prepared())
    keys = [k for k in history if not k.startswith("padding_frac")]
    return {"history": {k: list(history[k]) for k in keys},
            "first": _floats(m),
            "member": run.loader.assignment[rank]}


def main(argv):
    job, rank, world, rdzv, out = argv[1:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.dirname(HERE))
    with open(job, "rb") as f:
        spec = pickle.load(f)
    _init(rank, world, rdzv)
    result = globals()[spec["fn"]](rank, world, **spec["kwargs"])
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
