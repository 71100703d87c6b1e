"""Top-level training entry point (counterpart:
hydragnn_tpu/run_training.py, its single-process, single-device,
fixed-shape path).

`run_training(config, datasets=(train, val, test), device="cuda")`
completes the config from the data (`update_config`), builds the
fixed-shape loaders (`create_dataloaders`, the dense neighbor layout
unless `Architecture.neighbor_format` is false), the model on the device
(the card unless the caller passes device="cpu"; `create_model`'s seeded
initialization), the optimizer (`select_optimizer`) and the train/eval
steps (the energy-force ones with `Training.compute_grad_energy`), and
runs `train_validate_test`. Returns (state, history, model,
completed_config); `run_prediction(completed_config, datasets,
state=state, model=model)` predicts from the trained state.

Knobs off this path raise NotImplementedError naming the ROADMAP item
that brings them; none is ignored.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .config import build_model_config, load_config, update_config
from .models.create import create_model
from .preprocess.load_data import create_dataloaders
from .train.optimizer import select_optimizer
from .train.train_step import TrainState, make_eval_step, make_train_step
from .train.trainer import (ReduceLROnPlateau, train_validate_test,
                            walltime_deadline)
from .utils.devices import resolve_device
from .utils.envflags import env_flag, env_str, env_strict_flag


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to hydragnn_tpu_torch yet (ROADMAP {item})")


def check_training_knobs(config) -> None:
    """Raise NotImplementedError for every config key or HYDRAGNN_* knob
    that asks for a part of training the port does not have yet."""
    nn = config["NeuralNetwork"]
    tr = nn["Training"]
    arch = nn["Architecture"]
    opt = tr.get("Optimizer", {}) or {}
    checks = [
        (tr.get("Checkpoint"), "Training.Checkpoint", "A5: checkpoints"),
        (tr.get("continue"), "Training.continue", "A5: resume"),
        (tr.get("startfrom"), "Training.startfrom", "A5: resume"),
        (tr.get("checkpoint_every_n_epochs"),
         "Training.checkpoint_every_n_epochs", "A5: checkpoints"),
        (tr.get("batch_packing") or env_strict_flag("HYDRAGNN_PACKING"),
         "batch packing", "A2/A5: packing"),
        (int(env_str("HYDRAGNN_STEPS_PER_CALL",
                     tr.get("steps_per_call", 1)) or 1) > 1,
         "steps_per_call > 1", "A5: steps_per_call"),
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
        (tr.get("fault_plan"), "Training.fault_plan", "A8: utils/faults.py"),
    ]
    for on, what, item in checks:
        if on:
            _not_ported(what, item)


def run_training(config_or_path, datasets: Optional[Sequence] = None,
                 device="cuda", num_shards: Optional[int] = None):
    config = load_config(config_or_path)
    if num_shards not in (None, 1):
        _not_ported(f"num_shards={num_shards}", "A9: multi-GPU training")
    if datasets is None:
        _not_ported("config-driven dataset loading (Dataset.format)",
                    "A2: the raw/LSMS dataset path; pass datasets=")
    dev = resolve_device(device)
    trainset, valset, testset = (list(d) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    check_training_knobs(config)
    nn = config["NeuralNetwork"]
    train_cfg = nn["Training"]
    mcfg = build_model_config(config)
    batch_size = int(train_cfg["batch_size"])

    nbr_fmt = env_flag("HYDRAGNN_NEIGHBOR_FORMAT",
                       bool(nn["Architecture"].get("neighbor_format", True)))
    train_loader, val_loader, test_loader = create_dataloaders(
        trainset, valset, testset, batch_size, neighbor_format=nbr_fmt)

    model = create_model(mcfg, device=dev)
    tx = select_optimizer(train_cfg)
    state = TrainState.create(model, tx)

    loss_name = train_cfg.get("loss_function_type", "mse")
    cge = bool(train_cfg.get("compute_grad_energy", False))
    e_w = float(train_cfg.get("energy_loss_weight", 1.0))
    f_w = train_cfg.get("force_loss_weight", 1.0)
    f_w = f_w if f_w == "auto" else float(f_w)
    train_step = make_train_step(model, mcfg, tx, loss_name,
                                 compute_grad_energy=cge, energy_weight=e_w,
                                 force_weight=f_w)
    eval_step = make_eval_step(model, mcfg, loss_name,
                               compute_grad_energy=cge, energy_weight=e_w,
                               force_weight=f_w)

    plateau = None
    if "ReduceLROnPlateau" in train_cfg:
        pcfg = train_cfg["ReduceLROnPlateau"] or {}
        plateau = ReduceLROnPlateau(
            factor=float(pcfg.get("factor", 0.5)),
            patience=int(pcfg.get("patience", 5)),
            min_lr=float(pcfg.get("min_lr", 1e-6)))
    deadline = (walltime_deadline() if train_cfg.get("CheckRemainingTime")
                else None)
    verbosity = int(config.get("Verbosity", {}).get("level", 0) or 0)

    state, history = train_validate_test(
        train_step, eval_step, state, train_loader, val_loader, test_loader,
        num_epochs=int(train_cfg["num_epoch"]),
        patience=int(train_cfg.get("patience", 10)),
        use_early_stopping=bool(train_cfg.get("EarlyStopping", False)),
        checkpoint_warmup=int(train_cfg.get("checkpoint_warmup", 0)),
        plateau=plateau, walltime_deadline=deadline,
        keep_best=bool(train_cfg.get("keep_best", True)),
        place_fn=lambda b: b.to(dev), verbosity=verbosity)
    model.eval()
    return state, history, model, config
