"""Top-level training entry point (counterpart:
hydragnn_tpu/run_training.py, its single-process, single-device path).

`run_training(config, datasets=(train, val, test), device="cuda")`
completes the config from the data (`update_config`), builds the loaders
(`create_dataloaders`, the dense neighbor layout unless
`Architecture.neighbor_format` is false; budget-packed when
`Training.batch_packing` or HYDRAGNN_PACKING asks, with
`Training.pack_lookahead` or HYDRAGNN_PACK_LOOKAHEAD its planner's
window; DimeNet falls back to fixed-shape batches, whose triplet tables
the loaders add with one budget over the three splits), the model on the
device
(the card unless the caller passes device="cpu"; `create_model`'s seeded
initialization), the optimizer (`select_optimizer`) and the train/eval
steps (the energy-force ones with `Training.compute_grad_energy`), and
runs `train_validate_test`. With `datasets=None` the data comes from
the config's own files (`Dataset.format` "LSMS", "unit_test" or "CFG",
`Dataset.path`; a relative path is taken from the working directory);
the splits complete the config as plain lists, as in the JAX package, so
a reader's min-max does not reach it and `denormalize_output` turns off
with a warning.
Returns (state, history, model, completed_config);
`run_prediction(completed_config, datasets, state=state, model=model)`
predicts from the trained state.

Steps: on the card each train and eval step is a CUDA graph replay
(train/step_graphs.py); `Training.steps_per_call` (or
HYDRAGNN_STEPS_PER_CALL) S > 1 trains S steps a call, one replay of a
graph of S steps, as the JAX package scans S steps in one dispatch.

Precision: the steps compute in the resolved precision
(train/precision.py: HYDRAGNN_PRECISION, then Architecture.dtype, float32
or bfloat16) on float32 master parameters.

Checkpoints (JAX run_training.py:405-450, 584-612, 714-776), under
./logs/<run name>/checkpoint/ (utils/checkpoint.py): `Training.Checkpoint`
saves every best-validation epoch asynchronously (BEST) and the final
state; `checkpoint_every_n_epochs` saves synchronously with resume
metadata every n epochs; either installs the SIGTERM handler, so a
preempted run saves once and returns; `checkpoint_keep_last_k` (3) bounds
the saves kept. `Training.continue` resumes the run from its newest
verified save (history, schedules, best state) bit for bit, or from the
run `Training.startfrom` names, whose weights and optimizer state then
seed a fresh epoch 0.

Telemetry (JAX run_training.py:201-211, 672-791): `Training.Telemetry`
and the HYDRAGNN_TELEMETRY* knobs (utils/envflags.resolve_telemetry)
start a session (telemetry/session.py) next to the epoch loop and
finalize it on every exit path: telemetry.jsonl, trace.json and
metrics.prom under <run dir>/telemetry (or the `dir` knob), with the
per-epoch MFU (telemetry/mfu.py). The `Profile` section ({"enable": 1,
"target_epoch": n}) traces epoch n's train pass with torch.profiler
under ./logs/<run name>/profile; without it, `device_trace` traces
`device_trace_epoch` under <telemetry dir>/profile, with or without the
session.

Faults (utils/faults.py): the plan that HYDRAGNN_FAULT_PLAN or
`Training.fault_plan` resolves to is installed for the run; the training
sites are `forward-step` (once a train-loop dispatch), `checkpoint-write`
(at the start of each save) and `loader-fetch` (once a sample fetch
attempt, under the loader's bounded retry). `Training.conv_checkpointing`
recomputes each encoder conv in the backward (models/base.py).

Data parallelism (JAX run_training.py:156-199, 270-379; parallel/):
`run_training` joins the process group that `parallel.mesh.
init_distributed` makes from HYDRAGNN_MASTER_ADDR / _PORT, SLURM_NPROCS
and SLURM_PROCID (or one the caller made). In a group of W ranks,
`num_shards` (default: W) resolves as the JAX package resolves it over W
devices, one a rank; a single process asked for more falls back to 1
with JAX's warning. With W > 1 each rank keeps its contiguous slice of
the replicated splits (HYDRAGNN_MP_DATA=replicated, the default; the
val/test splits are kept whole when too small to slice) or, packed,
its bins of the one global pack plan; with HYDRAGNN_MP_DATA=local the
splits are the rank's own and the data-derived config statistics are
reduced over the group. The padded batch shape and neighbour K are
max-reduced over the ranks, every rank must have as many batches, and
`steps_per_call` is 1. In a group (W = 1 included) the steps are
`parallel.spmd`'s: the rank's shard, then the gradients, BatchNorm
running statistics and metrics averaged over the group;
`Optimizer.use_zero_redundancy` splits the optimizer state over the
ranks (`zero_min_shard_size`, default 2^14 elements). Rank 0 alone writes
./logs/<run name>/history.json (in one process too, as in JAX), the
checkpoint files and the telemetry; every rank calls each save, which
ends with a barrier. DimeNet's triplet budget is not reduced over the
ranks, so DimeNet trains in one process, as in JAX.

Pipeline parallelism (JAX run_training.py:224-268, 393-400, 477-508,
641-644; parallel/pipeline_trainer.py): `Training.pipeline_stages` S > 1
trains the pipelined LayerNorm stack (the config must set
`Training.pipeline_norm: "layernorm"`), its conv layers split into S
stages on the stage devices: `pipeline_devices` (a list of S devices;
several stages may share one card), or without it the visible cards
cuda:0 .. S-1 (fewer raises JAX's "exceeds device count"). The knobs
(`pipeline_microbatches` M, `pipeline_schedule` gpipe or 1f1b,
`pipeline_remat` off, full or dots; the HYDRAGNN_PIPE_* env over them)
resolve once (`utils.envflags.resolve_pipeline`); the loaders yield
stacked [M, ...] batches of batch_size / M graphs (num_shards = M,
fixed-shape: `batch_packing` falls back); steps_per_call is 1; the
returned model is None (the state holds the pipelined model's
tensors). `pipeline_data_shards` D > 1 runs D pipe rings on the same
stage devices (`pipeline_devices` lists the S x D devices of the pipe x
data mesh, ring d's stage s at s * D + d; every ring's must be ring 0's,
e.g. one card's streams, or NotImplementedError names A9): the loaders
stack D x M microbatches ([d * M + m]), and `use_zero_redundancy` splits
the optimizer update over the D data slots.

Graph parallelism (JAX run_training.py:213-222, 306-321, 510-523;
parallel/composite.py): `Architecture.graph_shards` G > 1 splits each
data shard's edge list over G graph slots. The slot devices are
`graph_devices` (several may be one card: a CUDA stream a slot; the CPU
tests pass ["cpu"] * k), or the visible cards; G must divide their count
(JAX's ValueError), the data axis gets `num_shards` over the count / G
left (`resolve_num_shards`), the dense neighbour layout and packing turn
off with JAX's log lines, and steps_per_call is 1. GIN, PNA and SchNet
split (PNA on its unfused accumulators: a fused kernel's finished
statistics do not combine); other model types raise NotImplementedError
naming A9 before any work; pipeline_stages with graph_shards raises JAX's
ValueError; so does a multi-process run with either.

Knobs off this path raise NotImplementedError naming the ROADMAP item
that brings them; none is ignored. `Visualization.create_plots` raises
(A10) where JAX builds its Visualizer; a pipelined run skips the plots
with JAX's log line, as JAX does.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

import torch.distributed as dist

from .config import (build_model_config, get_log_name_config, load_config,
                     update_config)
from .graphs.triplets import maybe_triplet_transform
from .models.create import create_model, data_input_dim
from .parallel.composite import (ComposedGrid, check_graph_shard_model,
                                 make_composed_eval_step,
                                 make_composed_train_step,
                                 place_composed_batch)
from .parallel.mesh import (ZERO_MIN_SHARD_SIZE, init_distributed,
                            resolve_num_shards)
from .parallel.multiprocess import (allreduce_max_int,
                                    assert_equal_across_processes,
                                    packing_process_coords, slice_by_process,
                                    sync_config_stats,
                                    validate_multiprocess_spmd)
from .parallel.pipeline import (bubble_fraction, stage_device,
                                train_bubble_fraction, train_step_ticks)
from .parallel.pipeline_trainer import (create_pipeline_model,
                                        make_pipeline_ef_eval_step,
                                        make_pipeline_ef_train_step,
                                        make_pipeline_eval_step,
                                        make_pipeline_train_step,
                                        require_pipeline_norm_optin,
                                        validate_pipeline_config)
from .parallel.spmd import SpmdEvalStep, SpmdTrainStep, make_zero_partition
from .preprocess.load_data import (create_dataloaders, loader_budgets,
                                   load_datasets_from_config)
from .train import trainer
from .train.optimizer import select_optimizer
from .train.precision import check_ported_precision, resolve_precision
from .train.train_step import (TrainState, make_eval_step,
                               make_multi_eval_step, make_multi_train_step,
                               make_train_step)
from .utils import checkpoint as ckpt
from .utils.devices import resolve_device
from .utils.faults import install_fault_plan, resolve_fault_plan
from .telemetry import EpochDeviceTrace, start_session
from .utils.envflags import (env_flag, env_str, resolve_pack_lookahead,
                             resolve_packing, resolve_pipeline,
                             resolve_steps_per_call, resolve_telemetry)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to hydragnn_tpu_torch yet (ROADMAP {item})")


def check_training_knobs(config) -> None:
    """Raise NotImplementedError for every config key or HYDRAGNN_* knob
    that asks for a part of training the port does not have yet. Runs
    before any work; the unported `Dataset.format`s and preprocessing
    knobs raise in `load_datasets_from_config`, before any file is
    read."""
    nn = config["NeuralNetwork"]
    tr = nn["Training"]
    arch = nn["Architecture"]
    if (int(tr.get("pipeline_stages", 1) or 1) > 1
            and int(arch.get("graph_shards", 1) or 1) > 1):
        raise ValueError("pipeline_stages and graph_shards cannot be "
                         "combined yet")
    if int(arch.get("graph_shards", 1) or 1) > 1:
        # the stacks whose convs split their edge stage over graph slots
        check_graph_shard_model(arch.get("model_type"))
    create_plots = bool((config.get("Visualization") or {}).get(
        "create_plots", False))
    if create_plots and int(tr.get("pipeline_stages", 1) or 1) > 1:
        # JAX builds no Visualizer on the pipelined path (its model is
        # None there) and trains (run_training.py:617-622)
        print("pipeline_stages > 1: prediction-based plots are not wired "
              "for the pipelined parameter layout; skipping", flush=True)
        create_plots = False
    checks = [
        (create_plots, "Visualization.create_plots", "A10: postprocess"),
        (tr.get("async_loader_workers") or tr.get("batch_cache_mb"),
         "async_loader_workers / batch_cache_mb",
         "A10: datasets/async_loader.py"),
        (env_flag("HYDRAGNN_USE_ddstore"), "HYDRAGNN_USE_ddstore",
         "A10: datasets"),
    ]
    for on, what, item in checks:
        if on:
            _not_ported(what, item)


def multiprocess_path_check(world: int, pipeline_stages: int,
                            graph_shards: int, num_shards: int) -> None:
    """A multi-process run takes the plain data-parallel path only (JAX
    run_training.py:278-287, its message)."""
    if world > 1 and (num_shards == 1 or pipeline_stages > 1
                      or graph_shards > 1):
        raise ValueError(
            "multi-process runs support the plain SPMD data-parallel "
            "path only: pipeline_stages and graph_shards must be 1 and "
            f"num_shards > 1 (got pipeline_stages={pipeline_stages}, "
            f"graph_shards={graph_shards}, num_shards={num_shards})")


def _graph_device_list(graph_devices, graph_shards: int) -> list:
    """The graph slots' devices: `graph_devices`, or the visible cards;
    their count must divide by graph_shards (JAX's ValueError)."""
    import torch
    if graph_devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [stage_device(d) for d in graph_devices]
    ndev = len(devs)
    if ndev == 0 or ndev % graph_shards != 0:
        raise ValueError(
            f"Architecture.graph_shards={graph_shards} does not divide the "
            f"device count {ndev}")
    return devs


def run_training(config_or_path, datasets: Optional[Sequence] = None,
                 device="cuda", num_shards: Optional[int] = None,
                 pipeline_devices: Optional[Sequence] = None,
                 graph_devices: Optional[Sequence] = None):
    config = load_config(config_or_path)
    check_training_knobs(config)
    # the fault plan (HYDRAGNN_FAULT_PLAN over Training.fault_plan) is
    # installed per run, so the sites' counters start fresh, and a stale
    # preemption flag of an earlier run in this process is cleared, as in
    # the JAX package (run_training.py:101-109)
    install_fault_plan(resolve_fault_plan(
        config["NeuralNetwork"].get("Training", {})))
    trainer.clear_preemption()
    dev = resolve_device(device)
    world, rank = init_distributed(device=dev)
    in_group = dist.is_initialized()
    if datasets is None:
        datasets = load_datasets_from_config(config)
    trainset, valset, testset = (list(d) for d in datasets)
    # the splits as plain lists, as the JAX package completes the config:
    # a reader's min-max (datasets.lsmsdataset.Split) does not reach
    # `denormalize_output`, which turns off with JAX's warning
    config = update_config(config, trainset, valset, testset)
    nn = config["NeuralNetwork"]
    train_cfg = nn["Training"]
    batch_size = int(train_cfg["batch_size"])
    verbosity = int(config.get("Verbosity", {}).get("level", 0) or 0)

    nbr_fmt = env_flag("HYDRAGNN_NEIGHBOR_FORMAT",
                       bool(nn["Architecture"].get("neighbor_format", True)))
    pipeline_stages = int(train_cfg.get("pipeline_stages", 1) or 1)
    graph_shards = int(nn["Architecture"].get("graph_shards", 1) or 1)
    gdevs = None
    if graph_shards > 1:
        # the graph axis claims its devices first; the data axis gets the
        # rest (JAX run_training.py:213-222)
        gdevs = _graph_device_list(graph_devices, graph_shards)
    packing = resolve_packing(train_cfg)
    if packing and nn["Architecture"]["model_type"] == "DimeNet":
        print("batch_packing: DimeNet's static triplet budget is not "
              "pack-aware yet; falling back to fixed-shape batching",
              flush=True)
        packing = False
    if packing and (pipeline_stages > 1 or graph_shards > 1):
        print("batch_packing: not composed with graph_shards/pipeline_stages "
              "meshes yet; falling back to fixed-shape batching", flush=True)
        packing = False
    (trainset, valset, testset), config, (pack_rank, pack_nproc) = \
        _multiprocess_data(config, (trainset, valset, testset), packing,
                           world)
    nn = config["NeuralNetwork"]
    mcfg = data_input_dim(build_model_config(config), trainset)

    pipe = None
    if pipeline_stages > 1:
        pipe = _pipeline_setup(train_cfg, mcfg, pipeline_stages, batch_size,
                               pipeline_devices, verbosity)
        # the loader's stacked shards are the microbatches, d-major over
        # the data axis's pipe rings ([d * M + m])
        num_shards = pipe["microbatches"] * pipe["data_shards"]
    elif graph_shards > 1:
        # the data axis over the devices the graph axis leaves (JAX
        # run_training.py:306-311)
        num_shards = resolve_num_shards(
            num_shards, batch_size, device_budget=len(gdevs) // graph_shards)
    else:
        # the shard count over one device a rank (JAX
        # run_training.py:270-292)
        num_shards = resolve_num_shards(num_shards, batch_size)
    multiprocess_path_check(world, pipeline_stages, graph_shards, num_shards)
    if graph_shards > 1 and nbr_fmt:
        # the dense [N, K] layout is node-major: edge sharding needs the
        # edge list (JAX run_training.py:315-321)
        print("graph_shards > 1: disabling the dense neighbor-list layout "
              "(edge-sharded aggregation uses the segment path)", flush=True)
        nbr_fmt = False
    local_batch = batch_size
    if world > 1:
        _, local_batch = validate_multiprocess_spmd(num_shards, batch_size)
    # DimeNet's triplets, one budget over the three splits
    batch_transform = maybe_triplet_transform(
        mcfg.model_type, trainset + valset + testset, max(local_batch, 1))
    budgets = {}
    if world > 1:
        if batch_transform is not None:
            raise ValueError(
                "multi-process SPMD does not support triplet-transform "
                "models yet (the static triplet budget is not globally "
                "reduced; train DimeNet single-process)")
        if not packing:
            # one batch shape and K on every rank (packed ranks plan the
            # same replicated splits, so their budget agrees already)
            n_node, n_edge, k = loader_budgets(
                trainset + valset + testset, max(local_batch, 1), nbr_fmt,
                reduce_fn=allreduce_max_int)
            budgets = dict(n_node=n_node, n_edge=n_edge, neighbor_k=k)
    train_loader, val_loader, test_loader = create_dataloaders(
        trainset, valset, testset, local_batch, neighbor_format=nbr_fmt,
        packing=packing, pack_lookahead=resolve_pack_lookahead(train_cfg),
        batch_transform=batch_transform, pack_rank=pack_rank,
        pack_nproc=pack_nproc,
        num_shards=num_shards if (pipe or graph_shards > 1) else 1,
        **budgets)
    if world > 1:
        # unequal step counts would deadlock the collectives
        for name, ld in (("train", train_loader), ("validate", val_loader),
                         ("test", test_loader)):
            assert_equal_across_processes(len(ld), f"{name} batches/epoch")
    if packing and verbosity >= 1:
        b = train_loader.pack_budget
        print(f"batch_packing: budget n_node={b.n_node} n_edge={b.n_edge} "
              f"n_graph={b.n_graph} lookahead={b.lookahead} "
              f"plan_fp={train_loader.global_plan_fingerprint()} "
              "(fixed-shape batching would pad every batch to the worst "
              "case)", flush=True)

    tx = select_optimizer(train_cfg)
    loss_name = train_cfg.get("loss_function_type", "mse")
    cge = bool(train_cfg.get("compute_grad_energy", False))
    e_w = float(train_cfg.get("energy_loss_weight", 1.0))
    f_w = train_cfg.get("force_loss_weight", 1.0)
    f_w = f_w if f_w == "auto" else float(f_w)
    compute_dtype = check_ported_precision(resolve_precision(mcfg.dtype))
    grid = None
    if pipe is not None:
        model = create_pipeline_model(mcfg, pipe["devices"])
        state = TrainState.create(model, tx)
        train_step, eval_step = _pipeline_steps(
            model, tx, loss_name, cge, e_w, f_w, compute_dtype, pipe)
    elif graph_shards > 1:
        # the (data x graph) grid of slots (parallel/composite.py)
        grid = ComposedGrid(gdevs, num_shards, graph_shards)
        if grid.home != stage_device(dev):
            raise ValueError(f"graph devices {[str(d) for d in gdevs]} "
                             f"are not the run's device {dev}")
        model = create_model(mcfg, device=dev)
        state = TrainState.create(model, tx)
        opt_cfg = train_cfg.get("Optimizer", {}) or {}
        step_kw = dict(compute_grad_energy=cge, energy_weight=e_w,
                       force_weight=f_w, compute_dtype=compute_dtype)
        train_step = make_composed_train_step(
            model, mcfg, tx, grid, loss_name,
            zero_opt=bool(opt_cfg.get("use_zero_redundancy", False)),
            zero_min_size=int(opt_cfg.get("zero_min_shard_size",
                                          ZERO_MIN_SHARD_SIZE)), **step_kw)
        eval_step = make_composed_eval_step(model, mcfg, grid, loss_name,
                                            **step_kw)
    else:
        model = create_model(mcfg, device=dev)
        opt_cfg = train_cfg.get("Optimizer", {}) or {}
        zero = None
        if in_group and opt_cfg.get("use_zero_redundancy"):
            zero = make_zero_partition(
                list(model.parameters()),
                int(opt_cfg.get("zero_min_shard_size",
                                ZERO_MIN_SHARD_SIZE)))
        state = TrainState.create(model, tx, zero=zero)
        step_kw = dict(compute_grad_energy=cge, energy_weight=e_w,
                       force_weight=f_w, compute_dtype=compute_dtype)
        eval_step = make_eval_step(model, mcfg, loss_name, **step_kw)
        if in_group:
            train_step = SpmdTrainStep(model, mcfg, tx, loss_name, **step_kw)
            eval_step = SpmdEvalStep(eval_step)
        else:
            train_step = make_train_step(model, mcfg, tx, loss_name,
                                         **step_kw)
    # steps-per-call dispatch batching (Training.steps_per_call /
    # HYDRAGNN_STEPS_PER_CALL): S steps a call, one CUDA graph replay on
    # the card; the same steps as the single-step loop. A group's steps
    # take one batch a call, as JAX's multi-process SPMD steps do, and a
    # pipelined step is one a call, as in JAX
    multi_step = multi_eval = None
    steps_per_call = (1 if in_group or pipe is not None or grid is not None
                      else resolve_steps_per_call(train_cfg))
    if steps_per_call > 1:
        kw = dict(loss_name=loss_name, compute_grad_energy=cge,
                  energy_weight=e_w, force_weight=f_w,
                  compute_dtype=compute_dtype)
        multi_step = make_multi_train_step(model, mcfg, tx, **kw)
        multi_eval = make_multi_eval_step(model, mcfg, **kw)
    log_name = get_log_name_config(config)
    start_epoch, resume, best0, best_val0 = _resume(train_cfg, state,
                                                    log_name, verbosity)
    # the telemetry knobs, resolved once; the session starts next to the
    # epoch loop's try, whose finally finalizes it
    run_dir = os.path.join("./logs", log_name)
    tel_cfg = resolve_telemetry(train_cfg)
    if rank != 0:
        # one rank writes the run's telemetry and traces
        tel_cfg = dataclasses.replace(tel_cfg, enabled=False,
                                      device_trace=False)
    profiler = None
    if "Profile" in config and rank == 0:
        profiler = EpochDeviceTrace(run_dir)
        profiler.setup(config["Profile"])
    elif tel_cfg.device_trace:
        # honoured without the session: the bracket needs no registry
        profiler = EpochDeviceTrace(
            tel_cfg.resolve_out_dir(run_dir), enable=True,
            target_epoch=tel_cfg.device_trace_epoch)

    plateau = None
    if "ReduceLROnPlateau" in train_cfg:
        pcfg = train_cfg["ReduceLROnPlateau"] or {}
        plateau = trainer.ReduceLROnPlateau(
            factor=float(pcfg.get("factor", 0.5)),
            patience=int(pcfg.get("patience", 5)),
            min_lr=float(pcfg.get("min_lr", 1e-6)))
    deadline = (trainer.walltime_deadline()
                if train_cfg.get("CheckRemainingTime") else None)

    keep_last_k = int(train_cfg.get("checkpoint_keep_last_k", 3) or 3)
    every = int(train_cfg.get("checkpoint_every_n_epochs", 0) or 0)
    use_ckpt = bool(train_cfg.get("Checkpoint", False))
    best_fn = (ckpt.make_async_best_checkpoint_fn(log_name,
                                                  keep_last_k=keep_last_k)
               if use_ckpt else None)

    def sync_save(snapshot, meta):
        # drain the asynchronous best-validation saves first: they can
        # name the same step dir
        try:
            ckpt.wait_for_checkpoints()
        except RuntimeError as exc:
            logging.getLogger("hydragnn_tpu_torch").warning(
                "best-validation checkpoint failed: %s", exc)
        ckpt.save_model(snapshot, log_name, metadata=meta,
                        keep_last_k=keep_last_k)

    save_fn = sync_save if (every or use_ckpt) else None
    final_meta: dict = {}
    # installed next to the try whose finally restores it
    if save_fn is not None:
        trainer.install_sigterm_handler()
    telemetry = start_session(tel_cfg, run_dir)
    try:
        if telemetry is not None:
            telemetry.compute_dtype = compute_dtype
            if pipe is not None:
                telemetry.pipeline_info = pipeline_info(pipe)
            if verbosity >= 1:
                print(f"telemetry: on -> {telemetry.out_dir}", flush=True)
        state, history = trainer.train_validate_test(
            train_step, eval_step, state, train_loader, val_loader,
            test_loader, num_epochs=int(train_cfg["num_epoch"]),
            patience=int(train_cfg.get("patience", 10)),
            use_early_stopping=bool(train_cfg.get("EarlyStopping", False)),
            checkpoint_warmup=int(train_cfg.get("checkpoint_warmup", 0)),
            checkpoint_fn=best_fn, plateau=plateau,
            walltime_deadline=deadline,
            keep_best=bool(train_cfg.get("keep_best", True)),
            verbosity=verbosity,
            start_epoch=start_epoch, resume=resume,
            checkpoint_every_n_epochs=every, periodic_checkpoint_fn=save_fn,
            preempt_save_fn=save_fn, initial_best_state=best0,
            initial_best_val=best_val0, resume_meta_out=final_meta,
            multi_train_step=multi_step, multi_eval_step=multi_eval,
            steps_per_call=steps_per_call, telemetry=telemetry,
            profiler=profiler,
            place_fn=(lambda b: b.to(pipe["devices"][0])) if pipe
            else (lambda b: place_composed_batch(b, grid)) if grid
            else (lambda b: b.to(dev)))
    finally:
        if save_fn is not None:
            trainer.restore_sigterm_handler()
        # written on every exit path: a crashed run's timeline is the
        # one worth reading
        if telemetry is not None:
            paths = telemetry.finalize()
            if paths and verbosity >= 1:
                print(f"telemetry artifacts: {paths['jsonl']} "
                      f"{paths['chrome_trace']}", flush=True)
    if pipe is not None:
        model = None    # the pipelined model's tensors are the state's
    else:
        model.eval()
    if rank == 0:
        _write_history(run_dir, history)
    if trainer.preemption_requested():
        # the trainer saved the resume point; a final save would point
        # LATEST at a completed run
        if use_ckpt:
            ckpt.wait_for_checkpoints()
            if world > 1:
                dist.barrier()
        return state, history, model, config
    if use_ckpt:
        # the run-complete save: a later `continue` with a raised num_epoch
        # goes on from here with the trainer's counters
        sync_save(state, final_meta)
    return state, history, model, config


def _pipeline_setup(train_cfg, mcfg, stages: int, batch_size: int,
                    pipeline_devices, verbosity: int) -> dict:
    """The pipeline's knobs, resolved once, its config checks (JAX
    run_training.py:224-268) and its stage devices: `pipeline_devices`,
    or the visible cards cuda:0 .. S-1."""
    import torch
    micro, schedule, remat, data_shards = resolve_pipeline(train_cfg,
                                                           stages)
    require_pipeline_norm_optin(train_cfg)
    need = stages * data_shards
    if pipeline_devices is None:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(min(need, count))]
    else:
        devices = [stage_device(d) for d in pipeline_devices]
        count = len(devices)
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"pipeline_devices mixes device types: "
                             f"{[str(d) for d in devices]}")
    validate_pipeline_config(mcfg, stages, batch_size, micro,
                             schedule=schedule, data_shards=data_shards,
                             device_count=count)
    if len(devices) != need:
        raise ValueError(f"pipeline_devices names {len(devices)} devices "
                         f"for pipeline_stages={stages}"
                         + (f" x pipeline_data_shards={data_shards}"
                            if data_shards > 1 else ""))
    # the (pipe x data) mesh's device order: ring d's stage s is device
    # s * D + d; every ring runs on ring 0's stage devices (its streams)
    rings = [[devices[s * data_shards + d] for s in range(stages)]
             for d in range(data_shards)]
    if any(r != rings[0] for r in rings[1:]):
        _not_ported("pipe rings of a data axis on other devices than "
                    "ring 0's (the parameters live on ring 0's stage "
                    "devices; list each stage device once a ring)",
                    "A9: multi-GPU training")
    devices = rings[0]
    zero = bool((train_cfg.get("Optimizer") or {}).get(
        "use_zero_redundancy"))
    if zero and data_shards == 1:
        # ZeRO shards the optimizer state over the data axis, which one
        # data shard does not have: say so instead of doing nothing
        logging.getLogger("hydragnn_tpu_torch").warning(
            "Optimizer.use_zero_redundancy has no effect on a "
            "pipeline run with pipeline_data_shards=1: opt state "
            "shards over the data mesh axis. Set "
            "Training.pipeline_data_shards > 1 to shard it.")
    if verbosity >= 1:
        print(f"pipeline: stages={stages} microbatches={micro} "
              f"schedule={schedule} remat={remat or 'off'} "
              f"data_shards={data_shards} devices="
              f"{[str(d) for d in devices]}", flush=True)
    opt_cfg = train_cfg.get("Optimizer") or {}
    return dict(stages=stages, microbatches=micro, schedule=schedule,
                remat=remat, data_shards=data_shards, devices=devices,
                zero_opt=zero and data_shards > 1,
                zero_min_size=int(opt_cfg.get("zero_min_shard_size",
                                              ZERO_MIN_SHARD_SIZE)))


def _pipeline_steps(model, tx, loss_name, cge, e_w, f_w, compute_dtype,
                    pipe):
    """The pipelined train and eval steps (JAX run_training.py:477-508)."""
    kw = dict(schedule=pipe["schedule"], remat=pipe["remat"] is not None,
              remat_policy=pipe["remat"], compute_dtype=compute_dtype,
              data_shards=pipe["data_shards"], zero_opt=pipe["zero_opt"],
              zero_min_size=pipe["zero_min_size"])
    if cge:
        return (make_pipeline_ef_train_step(model, tx, loss_name,
                                            energy_weight=e_w,
                                            force_weight=f_w, **kw),
                make_pipeline_ef_eval_step(model, loss_name,
                                           energy_weight=e_w,
                                           force_weight=f_w))
    return (make_pipeline_train_step(model, tx, loss_name, **kw),
            make_pipeline_eval_step(model, loss_name))


def pipeline_info(pipe: dict) -> dict:
    """The schedule's closed forms the trainer reports (JAX
    run_training.py:734-753)."""
    S, M, sched = pipe["stages"], pipe["microbatches"], pipe["schedule"]
    return {"stages": S, "microbatches": M,
            "data_shards": pipe["data_shards"], "schedule": sched,
            "remat": pipe["remat"] or "off",
            "bubble_frac": bubble_fraction(S, M),
            "train_bubble_frac": train_bubble_fraction(S, M, sched),
            "train_ticks": train_step_ticks(S, M, sched)}


def _multiprocess_data(config, splits, packing: bool, world: int):
    """The multi-process data wiring (JAX run_training.py:156-199):
    ((train, val, test), config, (pack_rank, pack_nproc)). Replicated
    inputs (HYDRAGNN_MP_DATA=replicated, the default) are sliced per rank,
    or, packed, kept whole for the global plan; local inputs keep the
    rank's splits and reduce the config's data statistics. One process:
    as given."""
    if world <= 1:
        return splits, config, (0, 1)
    # (JAX defaults to "local" under GraphStore shard dirs, a format the
    # port does not read)
    mp_data = env_str("HYDRAGNN_MP_DATA") or "replicated"
    if packing:
        return splits, config, packing_process_coords(mp_data)
    trainset, valset, testset = splits
    if mp_data == "replicated":
        # too few train samples to slice is fatal; val/test are kept
        # whole instead, so no rank evaluates an empty split
        return ((slice_by_process(trainset, what="train split"),
                 slice_by_process(valset, what="validate split",
                                  underflow="replicate"),
                 slice_by_process(testset, what="test split",
                                  underflow="replicate")),
                config, (0, 1))
    return splits, sync_config_stats(config), (0, 1)


def _write_history(run_dir: str, history) -> None:
    """history.json under the run's directory, written whole (a temporary
    file renamed into place)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "history.json")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(history, f)
    os.replace(tmp, path)


def _resume(train_cfg, state, log_name: str, verbosity: int):
    """`Training.continue`: restore the state in place from the newest
    verified checkpoint of the run (or of `Training.startfrom`'s run).
    Returns (start epoch, the trainer's resume record, best state, its
    validation loss); the last three are None for a transfer from another
    run, which trains from epoch 0."""
    if not train_cfg.get("continue"):
        return 0, None, None, None
    start_name = train_cfg.get("startfrom") or log_name
    restored, meta = ckpt.load_existing_model(state, start_name,
                                              with_metadata=True)
    if restored is None:
        raise ValueError(
            f"Training.continue is set but run '{start_name}' has no "
            "verified checkpoint under ./logs (or its state does not match "
            "this config's model and optimizer)")
    state.restore(restored)
    start_epoch, resume, best, best_val = 0, None, None, None
    if meta and start_name == log_name:
        ckpt.validate_resume_meta(meta)
        start_epoch = int(meta.get("next_epoch", 0))
        resume = meta.get("trainer")
        if bool(train_cfg.get("keep_best", True)):
            best, best_val = ckpt.load_best_model(state, start_name,
                                                  with_val=True)
    if verbosity >= 1:
        print(f"resumed from '{start_name}' at step {state.step}"
              + (f" (epoch {start_epoch})" if start_epoch else ""),
              flush=True)
    return start_epoch, resume, best, best_val
