"""Top-level inference entry point (counterpart:
hydragnn_tpu/run_prediction.py).

`run_prediction(config, datasets, variables)` completes the config from
the data (`datasets=None`: the config's own files, as `run_training`
reads them; the splits as plain lists, as in the JAX package),
builds the model on the device (the card unless the caller passes
device="cpu"), loads the weights — the Flax variable tree given as
nested numpy dicts (utils/weights.py), or `state=` (and `model=`) as
`run_training` returns them, or else the run's checkpoint
(utils/checkpoint.py; `checkpoint="latest"`, the newest verified save, or
"best") — and predicts the test split through the
batched `InferenceEngine` when serving is on (`serve`, else the `Serving`
block / HYDRAGNN_SERVE), or through a `ReplicaRouter` of
`Serving.fleet.replicas` engines (HYDRAGNN_FLEET_REPLICAS) when that is
above 1, else with a plain loop over `batch_size` batches padded to one
shape. The engines compute in the serving precision (`Serving.precision`,
else the train-side policy); the loop, as the JAX package's eval-step
loop, always at the train-side policy (HYDRAGNN_PRECISION, else
Architecture.dtype, else float32), so `Serving.precision` "int8" acts
only where an engine is built: the int8 tier, calibrated once on the
first `quant_calib_samples` test samples and the scales shared by every
replica. Engines are tagged
`step_<n>` from the TrainState or checkpoint the weights came from
(`variables=` and `model=` carry no step: "v0"). DimeNet, whose batches
carry triplet tables the engine does not
build, takes the loop with the JAX package's warning. Returns (trues, preds), one array per head,
over real graphs (graph heads) or real nodes (node heads). With
HYDRAGNN_DUMP_TESTDATA set, they are also pickled to
./logs/<log name>/test_data.pk as {output name: {"true", "pred"}}.

`num_shards` > 1 (JAX run_prediction.py:131-146) predicts through the
loop over the ranks of the process group (`parallel.mesh.
init_distributed`): each global batch of `batch_size` test samples splits
into `num_shards` contiguous shards, rank r forwards shard r, and the
padded outputs are gathered in the JAX package's device-major order, so
every rank returns the whole lists. `num_shards` resolves over the world
as in run_training (one process: back to 1 with JAX's warning), before
any work and before DimeNet leaves the engine route; a resolved count
above 1 on the engine route is not ported (A8) and raises there.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from .config import (build_model_config, get_log_name_config, load_config,
                     update_config)
from .graphs.batch import BucketSpec, collate, neighbor_budget_for_dataset, \
    padding_batch, with_neighbor_format
from .graphs.triplets import maybe_triplet_transform
from .models.create import create_model, data_input_dim
from .parallel.mesh import get_comm_size_and_rank, resolve_num_shards
from .parallel.spmd import predict_rows
from .postprocess.postprocess import output_denormalize
from .preprocess.load_data import load_datasets_from_config
from .quant.calibrate import calibrate
from .serving.config import (check_unported_serving_knobs, resolve_fleet,
                             resolve_serving)
from .serving.engine import InferenceEngine
from .train.optimizer import select_optimizer
from .train.train_step import TrainState, make_forward_fn
from .utils import checkpoint as ckpt
from .utils.devices import CompileStore, resolve_device
from .utils.envflags import env_flag
from .utils.weights import load_jax_variables


def run_prediction(config_or_path, datasets: Optional[Sequence] = None,
                   variables=None, serve: Optional[bool] = None,
                   device="cuda", state=None, model=None,
                   checkpoint: str = "latest",
                   num_shards: Optional[int] = None):
    """The weights come from `state` (a TrainState), else `variables` (a
    Flax tree), else `model` (a trained model), else the run's
    `checkpoint` ("latest" or "best") under ./logs; they are loaded into a
    fresh model on `device`, so a trained model is left as it is.
    `num_shards` > 1 shards the loop's batches over the process group's
    ranks; on the engine route it is not ported and raises naming A8."""
    config = load_config(config_or_path)
    serving = resolve_serving(config)
    use_engine = serving.enabled if serve is None else bool(serve)
    batch_size = int(config["NeuralNetwork"]["Training"]["batch_size"])
    # the shard count as JAX resolves it (run_prediction.py:55-56): over
    # the world, back to 1 with its warning where it does not fit
    num_shards = resolve_num_shards(num_shards or 1, batch_size)
    triplets = (config["NeuralNetwork"]["Architecture"].get("model_type")
                == "DimeNet")
    if use_engine and triplets:
        # the engine builds no triplet tables for its buckets: the same
        # fallback as the JAX package's
        logging.getLogger("hydragnn_tpu_torch").warning(
            "serving engine does not support triplet batch transforms "
            "(DimeNet); falling back to the legacy prediction loop")
        use_engine = False
    if use_engine:
        # refused on the resolved count, where the engine would use it
        check_unported_serving_knobs(num_shards)
    dev = resolve_device(device)
    if datasets is None:
        datasets = load_datasets_from_config(config)
    trainset, valset, testset = (list(d) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    mcfg = data_input_dim(build_model_config(config),
                          trainset + valset + testset)
    version = "v0"
    if state is not None:
        weights = {k: v.detach() for k, v in state.state_dict().items()}
        version = f"step_{int(state.step)}"
    elif variables is not None:
        weights = load_jax_variables(variables)
    elif model is not None:
        weights = model.state_dict()
    else:
        weights = None
    model = create_model(mcfg, device=dev)
    if weights is None:
        restored = _checkpoint_state(config, model, checkpoint)
        weights = restored.state_dict()
        version = f"step_{int(restored.step)}"
    model.load_state_dict(weights)

    arch = config["NeuralNetwork"]["Architecture"]
    nbr_fmt = env_flag("HYDRAGNN_NEIGHBOR_FORMAT",
                       bool(arch.get("neighbor_format", True)))
    all_samples = trainset + valset + testset
    # one K for every split, as the JAX loaders share one program
    neighbor_k = neighbor_budget_for_dataset(all_samples) if nbr_fmt else None

    # DimeNet's triplets, with run_training's budget
    batch_transform = maybe_triplet_transform(
        mcfg.model_type, all_samples, max(batch_size // num_shards, 1))
    if use_engine:
        trues, preds = _predict_with_engine(model, mcfg, testset, serving,
                                            neighbor_k, dev, config,
                                            version)
    else:
        forward = make_forward_fn(model, mcfg, None, frozen=True)
        trues, preds = _predict_with_loader(forward, mcfg, testset,
                                            all_samples, batch_size,
                                            neighbor_k, dev, batch_transform,
                                            num_shards)
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    if voi.get("denormalize_output") and "y_minmax" in voi:
        trues, preds = output_denormalize(voi["y_minmax"], trues, preds)
    if env_flag("HYDRAGNN_DUMP_TESTDATA"):
        dump_test_data(config, trues, preds)
    return trues, preds


def dump_test_data(config, trues, preds):
    """./logs/<log name>/test_data.pk: {output name: {"true", "pred"}}
    per head (head_<i> where the config names no outputs)."""
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    dump_dir = os.path.join("./logs", get_log_name_config(config))
    os.makedirs(dump_dir, exist_ok=True)
    names = voi.get("output_names",
                    [f"head_{i}" for i in range(len(trues))])
    with open(os.path.join(dump_dir, "test_data.pk"), "wb") as f:
        pickle.dump({name: {"true": t, "pred": p}
                     for name, t, p in zip(names, trues, preds)}, f)


def _checkpoint_state(config, model, which: str):
    """The TrainState of the run's newest verified checkpoint ("latest")
    or of the one BEST names ("best")."""
    log_name = get_log_name_config(config)
    like = TrainState.create(model, select_optimizer(
        config["NeuralNetwork"]["Training"]))
    if which == "best":
        target = ckpt.marker_target(log_name, which="best")
        if target is not None and not ckpt.verify_checkpoint(target):
            raise ckpt.UncommittedCheckpointError(
                f"BEST names {target}, which is not committed (a save in "
                "flight, or one whose writer died)")
        restored = ckpt.load_best_model(like, log_name)
    elif which == "latest":
        restored = ckpt.load_existing_model(like, log_name)
    else:
        raise ValueError(f"checkpoint={which!r}: 'latest' or 'best'")
    if restored is None:
        raise FileNotFoundError(
            f"run_prediction: no variables=, state= or model= given and run "
            f"'{log_name}' has no verified {which} checkpoint under ./logs")
    return restored


def _sample_targets(mcfg, sample):
    """Per-head targets of one sample (graph head: [1, D]; node head:
    [num_nodes, D])."""
    targets = []
    for head in mcfg.heads:
        y = sample.y_graph if head.head_type == "graph" else sample.y_node
        end = head.offset + head.output_dim
        have = 0 if y is None else y.shape[-1]
        if have < end:
            raise ValueError(
                f"{head.head_type} head needs packed label columns "
                f"[{head.offset}:{end}) but the sample carries {have}")
        if head.head_type == "graph":
            targets.append(np.asarray(y[head.offset:end], np.float32)[None])
        else:
            targets.append(np.asarray(y[:, head.offset:end], np.float32))
    return targets


def _predict_with_loader(forward, mcfg, testset, all_samples, batch_size,
                         neighbor_k, device, batch_transform=None,
                         num_shards: int = 1):
    """One padded forward per `batch_size` test samples, every batch on
    the shape the JAX loaders use: nodes and edges for `batch_size`
    largest graphs, rounded by BucketSpec(64); `batch_transform(batch,
    samples)` (DimeNet's triplets) rewrites each batch first. With
    `num_shards` > 1 (one a rank of the group) rank r forwards shard r of
    each batch, on the shape of `batch_size // num_shards` graphs (an
    empty shard is all padding), and the outputs of every rank are
    gathered in rank order."""
    graphs = max(batch_size // num_shards, 1)
    rank = get_comm_size_and_rank()[1] if num_shards > 1 else 0
    bucket = BucketSpec(multiple=64)
    n_node = bucket.bucket(max(s.num_nodes for s in all_samples)
                           * graphs + 1)
    n_edge = bucket.bucket(max(s.num_edges for s in all_samples)
                           * graphs + 1)
    trues = [[] for _ in mcfg.heads]
    preds = [[] for _ in mcfg.heads]
    for i in range(0, len(testset), batch_size):
        chunk = testset[i:i + batch_size]
        shard = chunk[rank * graphs:(rank + 1) * graphs]
        if shard:
            batch = collate(shard, n_node=n_node, n_edge=n_edge,
                            n_graph=graphs + 1)
        else:
            batch = padding_batch(testset[0], n_node, n_edge, graphs + 1)
        if batch_transform is not None:
            batch = batch_transform(batch, shard)
        if neighbor_k is not None:
            batch = with_neighbor_format(batch, k=neighbor_k)
        with torch.inference_mode():
            outputs, _ = forward(batch.to(device))
        outputs = [o.cpu() for o in outputs]
        masks = [batch.graph_mask, batch.node_mask]
        if num_shards > 1:
            rows = predict_rows(outputs + [m.to(torch.uint8) for m in masks])
            outputs, masks = rows[:-2], [m.bool() for m in rows[-2:]]
        else:
            outputs = [o[None] for o in outputs]
            masks = [m[None] for m in masks]
        for r in range(masks[0].shape[0]):
            gm, nm = masks[0][r].numpy(), masks[1][r].numpy()
            for ih, head in enumerate(mcfg.heads):
                out = outputs[ih][r].numpy()
                preds[ih].append(out[gm if head.head_type == "graph"
                                     else nm])
        for s in chunk:
            for ih, t in enumerate(_sample_targets(mcfg, s)):
                trues[ih].append(t)
    return ([np.concatenate(t) for t in trues],
            [np.concatenate(p) for p in preds])


def _predict_with_engine(model, mcfg, testset, serving, neighbor_k, device,
                         config, version="v0"):
    """Every test sample becomes one serving request; the dispatcher
    coalesces them into bucketed padded batches. The failure knobs
    (max_queue, deadline_ms, breaker_*) stay at their permissive defaults,
    as in the JAX package's offline run: the whole test split is
    submitted at once, and a deployment's admission bound or deadline
    would refuse a good prediction run. With `Serving.structure` the
    engine gets the full config, so raw-structure clients could share it;
    the test split's prediction is the same. `Serving.metrics_port` > 0
    (HYDRAGNN_SERVE_METRICS_PORT) serves /healthz and /metrics on that
    loopback port for the run (telemetry/http.py).

    With `Serving.fleet.replicas` > 1 the requests go through a
    ReplicaRouter of that many engines on `device`, each with its own
    copy of the model, sharing a CompileStore when
    `Serving.fleet.compile_store` names one (a single engine uses it
    too), and a TierPolicy when `tier_priority_min` > 0 (the test split
    is submitted at priority 0). Every replica serves the same weights
    on the same bucket ladder, tagged `version`. At `Serving.precision`
    "int8" the model is calibrated once, on the edge list as the JAX
    package's run_prediction calibrates, and every replica serves those
    scales, so they share their compile-store keys."""
    from .serving.fleet import ReplicaRouter, TierPolicy
    fleet = resolve_fleet(config)
    store = (CompileStore(fleet.compile_store) if fleet.compile_store
             else None)
    quant_calibration = None
    if serving.precision == "int8":
        quant_calibration = calibrate(
            model, None, mcfg, testset,
            num_samples=serving.quant_calib_samples, batch_transform=None)

    def make_engine(replica_idx=0):
        return InferenceEngine(
            copy.deepcopy(model) if fleet.replicas > 1 else model, mcfg,
            reference_samples=testset,
            max_batch_size=serving.max_batch_size,
            max_wait_ms=serving.max_wait_ms,
            num_buckets=serving.num_buckets,
            bucket_multiple=serving.bucket_multiple,
            neighbor_format=neighbor_k is not None, neighbor_k=neighbor_k,
            compute_dtype=serving.precision, breaker_threshold=0,
            quant_calibration=quant_calibration,
            quant_calib_samples=serving.quant_calib_samples,
            structure_config=config if serving.structure else None,
            md_skin=serving.md_skin, compile_store=store,
            model_version=version, device=device)

    if fleet.replicas > 1:
        tier_policy = None
        if fleet.tier_priority_min > 0:
            tier_policy = TierPolicy(
                fast=fleet.tier_fast, accurate=fleet.tier_accurate,
                priority_min=fleet.tier_priority_min,
                quota=fleet.tier_quota)
        server = ReplicaRouter(
            make_engine, fleet.replicas,
            max_redispatch=fleet.redispatch_max or None,
            drain_timeout_s=fleet.drain_timeout_s, tier_policy=tier_policy)
    else:
        server = make_engine()
    try:
        if serving.metrics_port:
            http = server.start_metrics_server(port=serving.metrics_port)
            logging.getLogger("hydragnn_tpu_torch").info(
                "serving metrics endpoint at %s/metrics", http.url)
        server.warmup()
        results = server.predict(testset)
    finally:
        server.shutdown()
    trues = [[] for _ in mcfg.heads]
    preds = [[] for _ in mcfg.heads]
    for sample, res in zip(testset, results):
        for ih, (head, t) in enumerate(zip(mcfg.heads,
                                           _sample_targets(mcfg, sample))):
            trues[ih].append(t)
            preds[ih].append(res[ih][None, :]
                             if head.head_type == "graph" else res[ih])
    return ([np.concatenate(t) for t in trues],
            [np.concatenate(p) for p in preds])
