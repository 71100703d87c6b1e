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

Knobs off this path raise NotImplementedError naming the ROADMAP item
that brings them; none is ignored. A fault plan is refused only where
the JAX package's resolution yields one (utils/faults.py).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

from .config import (build_model_config, get_log_name_config, load_config,
                     update_config)
from .graphs.triplets import maybe_triplet_transform
from .models.create import create_model, data_input_dim
from .preprocess.load_data import (create_dataloaders,
                                   load_datasets_from_config)
from .train import trainer
from .train.optimizer import select_optimizer
from .train.precision import resolve_precision
from .train.train_step import (TrainState, make_eval_step,
                               make_multi_eval_step, make_multi_train_step,
                               make_train_step)
from .utils import checkpoint as ckpt
from .utils.devices import resolve_device
from .utils.faults import resolve_fault_plan
from .utils.envflags import (env_flag, env_strict_flag,
                             resolve_pack_lookahead, resolve_packing,
                             resolve_steps_per_call)


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
    opt = tr.get("Optimizer", {}) or {}
    checks = [
        (int(arch.get("graph_shards", 1) or 1) > 1,
         "Architecture.graph_shards", "A9: multi-GPU training"),
        (int(tr.get("pipeline_stages", 1) or 1) > 1,
         "Training.pipeline_stages", "A9: multi-GPU training"),
        (opt.get("use_zero_redundancy"),
         "Optimizer.use_zero_redundancy", "A9: multi-GPU training"),
        ("Profile" in config, "the Profile section", "A8: telemetry"),
        ((tr.get("Telemetry") or {}).get("enabled")
         or env_strict_flag("HYDRAGNN_TELEMETRY")
         or env_strict_flag("HYDRAGNN_DEVICE_TRACE"),
         "Telemetry", "A8: telemetry"),
        ((config.get("Visualization") or {}).get("create_plots"),
         "Visualization.create_plots", "A10: postprocess"),
        (tr.get("async_loader_workers") or tr.get("batch_cache_mb"),
         "async_loader_workers / batch_cache_mb",
         "A10: datasets/async_loader.py"),
        (env_flag("HYDRAGNN_USE_ddstore"), "HYDRAGNN_USE_ddstore",
         "A10: datasets"),
        (tr.get("conv_checkpointing"), "Training.conv_checkpointing",
         "A4: BaseStack remat"),
        (resolve_fault_plan(tr) is not None,
         "a fault plan (HYDRAGNN_FAULT_PLAN / Training.fault_plan)",
         "A5.6: the training fault sites"),
    ]
    for on, what, item in checks:
        if on:
            _not_ported(what, item)


def run_training(config_or_path, datasets: Optional[Sequence] = None,
                 device="cuda", num_shards: Optional[int] = None):
    config = load_config(config_or_path)
    if num_shards not in (None, 1):
        _not_ported(f"num_shards={num_shards}", "A9: multi-GPU training")
    check_training_knobs(config)
    dev = resolve_device(device)
    if datasets is None:
        datasets = load_datasets_from_config(config)
    trainset, valset, testset = (list(d) for d in datasets)
    # the splits as plain lists, as the JAX package completes the config:
    # a reader's min-max (datasets.lsmsdataset.Split) does not reach
    # `denormalize_output`, which turns off with JAX's warning
    config = update_config(config, trainset, valset, testset)
    nn = config["NeuralNetwork"]
    train_cfg = nn["Training"]
    mcfg = data_input_dim(build_model_config(config), trainset)
    batch_size = int(train_cfg["batch_size"])
    verbosity = int(config.get("Verbosity", {}).get("level", 0) or 0)

    nbr_fmt = env_flag("HYDRAGNN_NEIGHBOR_FORMAT",
                       bool(nn["Architecture"].get("neighbor_format", True)))
    packing = resolve_packing(train_cfg)
    if packing and mcfg.model_type == "DimeNet":
        print("batch_packing: DimeNet's static triplet budget is not "
              "pack-aware yet; falling back to fixed-shape batching",
              flush=True)
        packing = False
    # DimeNet's triplets, one budget over the three splits
    batch_transform = maybe_triplet_transform(
        mcfg.model_type, trainset + valset + testset, max(batch_size, 1))
    train_loader, val_loader, test_loader = create_dataloaders(
        trainset, valset, testset, batch_size, neighbor_format=nbr_fmt,
        packing=packing, pack_lookahead=resolve_pack_lookahead(train_cfg),
        batch_transform=batch_transform)
    if packing and verbosity >= 1:
        b = train_loader.pack_budget
        print(f"batch_packing: budget n_node={b.n_node} n_edge={b.n_edge} "
              f"n_graph={b.n_graph} lookahead={b.lookahead} "
              f"plan_fp={train_loader.global_plan_fingerprint()} "
              "(fixed-shape batching would pad every batch to the worst "
              "case)", flush=True)

    model = create_model(mcfg, device=dev)
    tx = select_optimizer(train_cfg)
    state = TrainState.create(model, tx)

    loss_name = train_cfg.get("loss_function_type", "mse")
    cge = bool(train_cfg.get("compute_grad_energy", False))
    e_w = float(train_cfg.get("energy_loss_weight", 1.0))
    f_w = train_cfg.get("force_loss_weight", 1.0)
    f_w = f_w if f_w == "auto" else float(f_w)
    compute_dtype = resolve_precision(mcfg.dtype)
    train_step = make_train_step(model, mcfg, tx, loss_name,
                                 compute_grad_energy=cge, energy_weight=e_w,
                                 force_weight=f_w, compute_dtype=compute_dtype)
    eval_step = make_eval_step(model, mcfg, loss_name,
                               compute_grad_energy=cge, energy_weight=e_w,
                               force_weight=f_w, compute_dtype=compute_dtype)
    # steps-per-call dispatch batching (Training.steps_per_call /
    # HYDRAGNN_STEPS_PER_CALL): S steps a call, one CUDA graph replay on
    # the card; the same steps as the single-step loop
    multi_step = multi_eval = None
    steps_per_call = resolve_steps_per_call(train_cfg)
    if steps_per_call > 1:
        kw = dict(loss_name=loss_name, compute_grad_energy=cge,
                  energy_weight=e_w, force_weight=f_w,
                  compute_dtype=compute_dtype)
        multi_step = make_multi_train_step(model, mcfg, tx, **kw)
        multi_eval = make_multi_eval_step(model, mcfg, **kw)
    log_name = get_log_name_config(config)
    start_epoch, resume, best0, best_val0 = _resume(train_cfg, state,
                                                    log_name, verbosity)

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
    try:
        state, history = trainer.train_validate_test(
            train_step, eval_step, state, train_loader, val_loader,
            test_loader, num_epochs=int(train_cfg["num_epoch"]),
            patience=int(train_cfg.get("patience", 10)),
            use_early_stopping=bool(train_cfg.get("EarlyStopping", False)),
            checkpoint_warmup=int(train_cfg.get("checkpoint_warmup", 0)),
            checkpoint_fn=best_fn, plateau=plateau,
            walltime_deadline=deadline,
            keep_best=bool(train_cfg.get("keep_best", True)),
            place_fn=lambda b: b.to(dev), verbosity=verbosity,
            start_epoch=start_epoch, resume=resume,
            checkpoint_every_n_epochs=every, periodic_checkpoint_fn=save_fn,
            preempt_save_fn=save_fn, initial_best_state=best0,
            initial_best_val=best_val0, resume_meta_out=final_meta,
            multi_train_step=multi_step, multi_eval_step=multi_eval,
            steps_per_call=steps_per_call)
    finally:
        if save_fn is not None:
            trainer.restore_sigterm_handler()
    model.eval()
    if trainer.preemption_requested():
        # the trainer saved the resume point; a final save would point
        # LATEST at a completed run
        if use_ckpt:
            ckpt.wait_for_checkpoints()
        return state, history, model, config
    if use_ckpt:
        # the run-complete save: a later `continue` with a raised num_epoch
        # goes on from here with the trainer's counters
        sync_save(state, final_meta)
    return state, history, model, config


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
