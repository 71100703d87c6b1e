"""The steps of one rank of a data-parallel run (counterpart:
hydragnn_tpu/parallel/spmd.py).

The JAX package's SPMD step maps a per-device body over a data mesh
(`spmd.py:72-95`); here each rank runs that body on its own shard and
meets the others at explicit collectives, in a fixed order:

1. the loss on the rank's shard (the single-device `make_loss_fn`), its
   gradients, and the non-finite watchdog flag, taken BEFORE the
   gradients are reduced;
2. one all-reduce of a flat float32 buffer [gradients | BatchNorm running
   statistics | train metrics], divided by the world (JAX's pmean), and
   one MAX all-reduce of the flag. Each rank normalized with its own batch
   statistics; only the running statistics are averaged, after the step
   (not `torch.nn.SyncBatchNorm`, which normalizes with the global
   batch's statistics);
3. `freeze_conv_grads`, the optimizer's update and its addition to the
   parameters.

On the card, 1 and 3 are CUDA graphs (one per batch signature, one per
gradient-accumulation phase) and 2 runs between them: gloo cannot be
captured, and NCCL would need a warm-up of its own. On the CPU the same
parts run eagerly. `eager()` runs them eagerly on any device.

ZeRO (`Optimizer.use_zero_redundancy`, JAX `spmd.py:97-121`): a
`ZeroPartition` splits every optimizer-state leaf that `mesh.zero_sharded`
admits by its leading dim over the ranks. Each rank keeps and updates
only its rows; the gradient stays whole on every rank (the all-reduce
above), so the update of a row is bitwise the replicated one, and the
updated parameters are then gathered by one broadcast from each owner
(gloo on CUDA tensors offers broadcast and all-reduce only).

The eval step (`spmd.py:163-196`) reduces its metrics as a
sample-weighted mean: each rank's masked mean times its real-graph
count, summed, over the summed count; the train metrics are an
unweighted mean, on purpose, as in JAX. `predict_rows` gathers a rank's
padded outputs for run_prediction in device-major order (JAX
`make_spmd_forward`).
"""
from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..graphs.batch import GraphBatch
from ..train import step_graphs
from ..train.train_step import (_nonfinite_watchdog, freeze_conv_grads,
                                make_loss_fn)
from .mesh import ZERO_MIN_SHARD_SIZE, get_comm_size_and_rank, zero_sharded


class ZeroPartition:
    """Which optimizer-state leaves are split over the ranks (by their
    leading dim) and how: leaf i's rows `rows(i, r)` belong to rank r.
    `local` takes this rank's rows, `gather` assembles whole leaves from
    every rank's rows, `broadcast_owned` sends each owner's rows of whole
    tensors to the other ranks. Made for a world above 1."""

    def __init__(self, shapes: Sequence[Sequence[int]], world: int,
                 rank: int, min_size: int = ZERO_MIN_SHARD_SIZE):
        self.world, self.rank = int(world), int(rank)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sharded = [zero_sharded(s, world, min_size)
                        for s in self.shapes]

    def rows(self, i: int, r: Optional[int] = None) -> slice:
        per = self.shapes[i][0] // self.world
        r = self.rank if r is None else r
        return slice(r * per, (r + 1) * per)

    def local(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's rows of each split leaf (views); others whole."""
        return [t[self.rows(i)] if self.sharded[i] else t
                for i, t in enumerate(tensors)]

    def gather(self, local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves from every rank's rows (a collective): new
        tensors for the split leaves, the whole ones as they are."""
        out = []
        for i, t in enumerate(local):
            if self.sharded[i]:
                full = t.new_empty(self.shapes[i])
                full[self.rows(i)] = t
                t = full
            out.append(t)
        self.broadcast_owned(out)
        return out

    def broadcast_owned(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: each rank's rows of the split leaves of `tensors`
        (whole leaves, on every rank) reach the other ranks, one
        broadcast of a flat buffer from each owner."""
        idx = [i for i, s in enumerate(self.sharded) if s]
        if not idx:
            return
        for r in range(self.world):
            parts = [tensors[i][self.rows(i, r)] for i in idx]
            if r == self.rank:
                buf = torch.cat([p.reshape(-1) for p in parts])
            else:
                buf = parts[0].new_empty(sum(p.numel() for p in parts))
            dist.broadcast(buf, src=r)
            if r != self.rank:
                at = 0
                with torch.no_grad():
                    for p in parts:
                        p.copy_(buf[at:at + p.numel()].view_as(p))
                        at += p.numel()


def make_zero_partition(params: Sequence[torch.Tensor],
                        min_size: int = ZERO_MIN_SHARD_SIZE):
    """The ZeRO partition of `params` over the process group, or None in
    a world of 1 (nothing to split)."""
    world, rank = get_comm_size_and_rank()
    if world <= 1:
        return None
    return ZeroPartition([tuple(p.shape) for p in params], world, rank,
                         min_size)


def _float_buffers(state) -> List[torch.Tensor]:
    """The BatchNorm running statistics (the model's float buffers)."""
    return [b for b in state.batch_stats.values() if b.is_floating_point()]


class SpmdTrainStep:
    """step(state, batch) -> (state, metrics): one optimizer step of this
    rank on its shard, with the gradients, BatchNorm running statistics
    and metrics averaged over the group (see the module's docstring);
    metrics as the single-device TrainStep's (nonfinite_steps the MAX
    over the ranks). `collective_ms` sums the wall time of the reductions
    and the parameter gather since the last `reset_timing()` (on the card
    the work before each is waited for, then the collective itself, so
    the time holds the transfer and nothing else)."""

    def __init__(self, model, cfg, tx, loss_name: str = "mse",
                 compute_grad_energy: bool = False,
                 energy_weight: float = 1.0, force_weight=1.0,
                 compute_dtype=None):
        self.model, self.cfg, self.tx = model, cfg, tx
        self.world = get_comm_size_and_rank()[0]
        loss_fn = make_loss_fn(model, cfg, loss_name, compute_grad_energy,
                               energy_weight, force_weight, compute_dtype)
        self._loss_fn = loss_fn
        # the trainer reads `steps.graphs` (captures) and the telemetry
        # probe `steps.model` / `steps.body.loss_fn`, as of a TrainStep
        self.steps = self
        self.body = types.SimpleNamespace(loss_fn=loss_fn)
        # ("grad", batch signature) and ("update", accumulation phase)
        self.graphs: Dict[tuple, step_graphs.Captured] = {}
        self.keys: Optional[List[str]] = None
        self.rbuf: Optional[torch.Tensor] = None   # [grads | BN | metrics]
        self.flag: Optional[torch.Tensor] = None   # the watchdog flag
        self.scalars: Optional[torch.Tensor] = None
        self.collective_ms = 0.0

    def reset_timing(self) -> None:
        self.collective_ms = 0.0

    # ----------------------------------------------------------- parts --
    def _grad_part(self, state, batch: GraphBatch):
        """Forward and backward on the rank's shard into `rbuf` and
        `flag` (static buffers, made at the first call)."""
        self.model.train()
        params = list(state.params.values())
        total, metrics = self._loss_fn(batch)
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        flag = _nonfinite_watchdog(total, grads)
        keys = list(metrics)
        parts = ([g.reshape(-1) for g in grads]
                 + [b.reshape(-1).float() for b in _float_buffers(state)]
                 + [torch.stack([metrics[k].detach().float()
                                 for k in keys])])
        if self.rbuf is None:
            self.keys = keys
            self.rbuf = torch.empty(sum(p.numel() for p in parts),
                                    dtype=torch.float32,
                                    device=params[0].device)
            self.flag = torch.empty((), dtype=torch.float32,
                                    device=params[0].device)
        torch.cat(parts, out=self.rbuf)
        self.flag.copy_(flag)

    def _reduce(self, state) -> None:
        """The step's collectives: the mean of `rbuf` and the MAX of the
        flag over the group; the averaged running statistics back into
        the model's buffers. On the card the parts before are waited for
        first, so `collective_ms` holds the collectives alone."""
        if self.rbuf.is_cuda:
            torch.cuda.synchronize(self.rbuf.device)
        t0 = time.perf_counter()
        dist.all_reduce(self.rbuf)
        self.rbuf.div_(self.world)
        dist.all_reduce(self.flag, op=dist.ReduceOp.MAX)
        at = sum(p.numel() for p in state.params.values())
        with torch.no_grad():
            for b in _float_buffers(state):
                b.copy_(self.rbuf[at:at + b.numel()].view_as(b))
                at += b.numel()
        if self.rbuf.is_cuda:
            torch.cuda.synchronize(self.rbuf.device)
        self.collective_ms += (time.perf_counter() - t0) * 1e3

    def _update_part(self, state, scalars=None) -> bool:
        """freeze_conv_grads, the optimizer's update from the reduced
        gradients, its addition to the parameters (this rank's rows of
        the split leaves under ZeRO); True when it updated them."""
        names = list(state.params)
        params = list(state.params.values())
        grads, at = [], 0
        for p in params:
            grads.append(self.rbuf[at:at + p.numel()].view_as(p))
            at += p.numel()
        grads = freeze_conv_grads(names, grads, self.cfg)
        updates, state.opt_state = self.tx.update(grads, state.opt_state,
                                                  params, scalars)
        updates = freeze_conv_grads(names, updates, self.cfg)
        if updates is None:
            return False
        zero = state.opt_state.zero
        with torch.no_grad():
            torch._foreach_add_(params if zero is None
                                else zero.local(params), updates)
        return True

    def _gather_params(self, state, applied: bool) -> None:
        zero = state.opt_state.zero
        if zero is None or not applied:
            return
        cuda = next(iter(state.params.values())).is_cuda
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero.broadcast_owned(list(state.params.values()))
        if cuda:
            torch.cuda.synchronize()
        self.collective_ms += (time.perf_counter() - t0) * 1e3

    def _metrics(self) -> Dict[str, torch.Tensor]:
        vals = self.rbuf[self.rbuf.numel() - len(self.keys):].clone()
        out = {k: vals[i] for i, k in enumerate(self.keys)}
        out["nonfinite_steps"] = self.flag.clone()
        return out

    # ----------------------------------------------------------- route --
    def eager(self, state, batch: GraphBatch):
        """The step with every part run eagerly, on any device."""
        self._grad_part(state, batch)
        self._reduce(state)
        applied = self._update_part(state)
        self._gather_params(state, applied)
        state.step += 1
        return state, self._metrics()

    def __call__(self, state, batch: GraphBatch):
        dev = batch.x.device
        if dev.type == "cpu":
            return self.eager(state, batch)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        ctx = step_graphs.context_for(self.model, dev)
        (slot,) = ctx.slots(batch, 1)
        step_graphs.fill(slot, batch)
        key = ("grad", step_graphs.batch_signature(batch))
        grad = self.graphs.get(key)
        if grad is None:
            grad = self.graphs[key] = self._capture_grad(ctx, state, slot)
        grad.replay()
        self._reduce(state)
        tx, opt = self.tx, state.opt_state
        if tx.update_has_collective(opt):
            applied = self._update_part(state)
        else:
            key = ("update", opt.mini_step if tx.accumulate > 1 else 0)
            upd = self.graphs.get(key)
            if upd is None:
                upd = self.graphs[key] = self._capture_update(ctx, state)
            applied = tx.applies(opt)
            rows = step_graphs._advance_rows(tx, opt, 1)
            self.scalars.copy_(rows.pin_memory(), non_blocking=True)
            upd.replay()
        self._gather_params(state, applied)
        state.step += 1
        return state, self._metrics()

    def _capture_grad(self, ctx, state, slot) -> step_graphs.Captured:
        saved = [b.detach().clone() for b in _float_buffers(state)]

        def restore(device: bool):
            if device:
                with torch.no_grad():
                    for b, s in zip(_float_buffers(state), saved):
                        b.copy_(s)

        return step_graphs.capture(ctx, lambda: self._grad_part(state, slot),
                                   restore)

    def _capture_update(self, ctx, state) -> step_graphs.Captured:
        if self.scalars is None:
            self.scalars = torch.zeros((1, 4), dtype=torch.float32,
                                       device=ctx.device)
        snapshot = state.copy()
        self.scalars.copy_(step_graphs._advance_rows(
            self.tx, dataclasses.replace(snapshot.opt_state), 1))

        def restore(device: bool):
            if device:
                state.restore(snapshot)
            else:
                state.restore_host(snapshot)

        return step_graphs.capture(
            ctx, lambda: self._update_part(state, self.scalars[0]), restore)


class SpmdEvalStep:
    """eval_step(state, batch) -> (metrics, outputs): the single-device
    eval step (`local`, a captured graph on the card) on this rank's
    shard, its metrics the sample-weighted mean over the group (in a
    world of 1, the rank's own); outputs are this rank's."""

    def __init__(self, local):
        self.local = local
        self.steps = local.steps
        self.world = get_comm_size_and_rank()[0]

    def __call__(self, state, batch: GraphBatch):
        metrics, outputs = self.local(state, batch)
        if self.world == 1:
            # the weighted mean over one rank is its own mean (exactly;
            # m * w / w would round)
            return metrics, outputs
        keys = list(metrics)
        w = batch.graph_mask.to(torch.float32).sum()
        buf = torch.stack([metrics[k].float() * w for k in keys] + [w])
        dist.all_reduce(buf)
        vals = buf[:-1] / torch.clamp(buf[-1], min=1.0)
        return {k: vals[i] for i, k in enumerate(keys)}, outputs


def predict_rows(local: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's `local` tensors (equal shapes on every rank), stacked
    rank-major on the CPU: [world, *shape] each; the device-major order of
    JAX's `make_spmd_forward`. Gathered on the collective device (the
    card under NCCL, the CPU under gloo)."""
    from .multiprocess import collective_device
    dev = collective_device()
    world = get_comm_size_and_rank()[0]
    out = []
    for t in local:
        t = t.to(dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out.append(torch.stack(parts).cpu())
    return out
