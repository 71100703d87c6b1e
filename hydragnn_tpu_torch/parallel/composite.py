"""Composed (data x graph) training: `Architecture.graph_shards`
(counterpart: hydragnn_tpu/parallel/composite.py).

Each data shard's graph has its EDGE list split over a graph axis of G
slots (parallel/graph_parallel.py's edge-sharded mode): the node features
stay on the data shard's home device, each graph slot forms the messages
of its contiguous edge chunk and their partial aggregate, and the
partials come back and are combined in slot order. The JAX package gets
this from GSPMD (edge-leading leaves placed P("data", "graph"), XLA
inserting the partial aggregate and its all-reduce); PyTorch has no
partitioner, so each conv states the split at its edge stage
(`ops.segment.slot_edge_stage`): GIN's sum and SchNet's filter-scatter
(with its coordinate mean) add the slots' partial sums; PNA adds the
slots' accumulators (sum, sum of squares, count) and reduces their
extremes with the single-device gradient rule (`cross_slot_extreme`), then
takes the statistics once. BatchNorm, pooling and the heads stay
node-side and run once, on the home device: GSPMD's replicated node
compute. The models that split are `GRAPH_SHARD_TYPES`; the others
raise NotImplementedError naming A9.

The step (`make_composed_train_step`) is one autograd graph over the
grid: the loss is the mean of the D data shards' losses, each shard's
forward normalizing with its own batch statistics, the BatchNorm running
statistics and the metrics the mean over the shards (JAX
`composite.py:91-98`); the gradients are exact because the whole step is
differentiated. On the card the slots of a grid are streams of one card
and each step is one CUDA graph across them (train/step_graphs.py), the
slot streams forked from the capture stream and joined back to it. A grid
that spans several devices raises NotImplementedError (ROADMAP A9): the
parameters live on one device.

ZeRO over the data axis (`zero_opt`): the JAX package places the
optimizer state's rows over the data axis, a sharding that leaves the
update's values as they are. The slots of a grid share one device,
whose memory a split would not divide, so the update is the replicated
`tx.update`, as `parallel.spmd`'s ZeRO is in a world of one; the split
waits for slots on several devices (ROADMAP A9).

The eval step weights the data shards' metrics by their real graphs
(JAX `composite.py:122-153`).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..config.config import ModelConfig
from ..datasets.loader import unstack_batch
from ..graphs.batch import GraphBatch
from ..train.train_step import (EvalStep, TrainStep, _nonfinite_watchdog,
                                eval_metrics_and_outputs, freeze_conv_grads,
                                make_forward_fn, make_loss_fn)
from .graph_parallel import EDGE_FIELDS, Slots, composed
from .mesh import ZERO_MIN_SHARD_SIZE
from .pipeline import stage_device

__all__ = ["EDGE_FIELDS", "GRAPH_SHARD_TYPES", "ComposedGrid",
           "place_composed_batch", "make_composed_train_step",
           "make_composed_eval_step"]

# the model types whose edge stage splits over a graph axis
GRAPH_SHARD_TYPES = ("GIN", "PNA", "SchNet")


def check_graph_shard_model(model_type: str) -> None:
    """NotImplementedError naming A9 for a model type whose convs do not
    split their edge stage."""
    if model_type not in GRAPH_SHARD_TYPES:
        raise NotImplementedError(
            f"Architecture.graph_shards > 1 with model_type {model_type} is "
            f"not ported to hydragnn_tpu_torch yet (graph parallelism "
            f"covers {list(GRAPH_SHARD_TYPES)}; ROADMAP A9: multi-GPU "
            f"training)")


class ComposedGrid:
    """The (data x graph) grid of slots: data shard d's graph slots are
    `devices[d * G : (d + 1) * G]` (the JAX mesh's device order), slot 0
    of each its home; `slots[d]` their `graph_parallel.Slots`, whose
    streams are keyed ("graph", d * G + g)."""

    def __init__(self, devices: Sequence, data_shards: int,
                 graph_shards: int):
        D, G = int(data_shards), int(graph_shards)
        devs = [stage_device(d) for d in devices]
        if len(devs) < D * G:
            raise ValueError(f"{len(devs)} graph devices for a {D} x {G} "
                             f"(data x graph) grid")
        devs = devs[:D * G]
        if len(set(devs)) > 1:
            raise NotImplementedError(
                "graph slots on several devices are not ported to "
                "hydragnn_tpu_torch yet (the parameters live on one device; "
                "list one device's slots, a CUDA stream each; ROADMAP A9: "
                "multi-GPU training)")
        self.data, self.graph = D, G
        self.devices = devs
        self.home = devs[0]
        self.slots = [Slots(devs[d * G:(d + 1) * G], base=d * G)
                      for d in range(D)]

    def join(self) -> None:
        for s in self.slots:
            s.join()


def place_composed_batch(batch: GraphBatch, grid: ComposedGrid
                         ) -> GraphBatch:
    """The loader's batch (stacked [D, ...] for D data shards, unstacked
    for one) on the grid's home device; the graph slots take their edge
    chunks inside the step (`graph_parallel.ShardedEdges`)."""
    return batch.to(grid.home)


def _data_shards(batch: GraphBatch, grid: ComposedGrid) -> List[GraphBatch]:
    shards = unstack_batch(batch)
    if len(shards) != grid.data:
        raise ValueError(f"a batch of {len(shards)} data shards for a grid "
                         f"of {grid.data}")
    return shards


def _float_buffers(model) -> List[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


def make_composed_train_step(model, cfg: ModelConfig, tx, grid: ComposedGrid,
                             loss_name: str = "mse",
                             compute_grad_energy: bool = False,
                             energy_weight: float = 1.0, force_weight=1.0,
                             compute_dtype=None, zero_opt: bool = False,
                             zero_min_size: int = ZERO_MIN_SHARD_SIZE
                             ) -> TrainStep:
    """train_step(state, batch) -> (state, metrics) over the grid; the
    batch is the loader's (stacked [D, ...] for D data shards), placed by
    `place_composed_batch`. Metrics: loss, task_i (or energy_loss /
    force_loss), nonfinite_steps. `zero_opt` and `zero_min_size` are JAX's
    ZeRO knobs; the update is the replicated one (the module's
    docstring). A step is a `train_step.TrainStep` (a CUDA graph on the
    card)."""
    check_graph_shard_model(cfg.model_type)
    loss_fn = make_loss_fn(model, cfg, loss_name, compute_grad_energy,
                           energy_weight, force_weight, compute_dtype)
    D = grid.data

    def body(state, batch: GraphBatch, scalars=None):
        model.train()
        names = list(state.params)
        params = list(state.params.values())
        shards = _data_shards(batch, grid)
        bufs = _float_buffers(model)
        saved = [b.detach().clone() for b in bufs] if D > 1 else None
        losses, rows, new_bufs = [], [], []
        for d, b in enumerate(shards):
            if d:
                # every shard normalizes from the step's running statistics
                with torch.no_grad():
                    for buf, s in zip(bufs, saved):
                        buf.copy_(s)
            with composed(grid.slots[d]):
                total, metrics = loss_fn(b)
            losses.append(total)
            rows.append(metrics)
            if D > 1:
                new_bufs.append([buf.detach().clone() for buf in bufs])
        if D > 1:
            with torch.no_grad():
                for i, buf in enumerate(bufs):
                    buf.copy_(torch.mean(torch.stack(
                        [nb[i] for nb in new_bufs]), dim=0))
        total = torch.mean(torch.stack(losses))
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        # the backward ran on the slot streams: join them back before the
        # update reads the gradients (and before a capture ends)
        grid.join()
        metrics = {k: torch.mean(torch.stack([r[k].detach() for r in rows]))
                   for k in rows[0]}
        metrics["nonfinite_steps"] = _nonfinite_watchdog(total, grads)
        grads = freeze_conv_grads(names, list(grads), cfg)
        updates, state.opt_state = tx.update(grads, state.opt_state,
                                             params, scalars)
        updates = freeze_conv_grads(names, updates, cfg)
        if updates is not None:
            with torch.no_grad():
                torch._foreach_add_(params, updates)
        state.step += 1
        return metrics, None

    body.loss_fn = loss_fn
    return TrainStep(model, body, tx)


def make_composed_eval_step(model, cfg: ModelConfig, grid: ComposedGrid,
                            loss_name: str = "mse",
                            compute_grad_energy: bool = False,
                            energy_weight: float = 1.0, force_weight=1.0,
                            compute_dtype=None) -> EvalStep:
    """eval_step(state, batch) -> (metrics, None): each data shard's eval
    metrics over the graph slots, weighted by its real graphs,
    sum(m * w) / max(sum(w), 1)."""
    check_graph_shard_model(cfg.model_type)
    forward = make_forward_fn(model, cfg, compute_dtype)

    def body(state, batch: GraphBatch, scalars=None):
        shards = _data_shards(batch, grid)
        rows, ws = [], []
        for d, b in enumerate(shards):
            with composed(grid.slots[d]):
                metrics, _ = eval_metrics_and_outputs(
                    model, cfg, loss_name, b, compute_grad_energy,
                    energy_weight, force_weight, forward)
            rows.append(metrics)
            ws.append(b.graph_mask.to(torch.float32).sum())
        grid.join()
        w = torch.stack(ws)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        return {k: torch.sum(torch.stack([r[k].detach().float()
                                          for r in rows]) * w) / wsum
                for k in rows[0]}, None

    return EvalStep(model, body)
