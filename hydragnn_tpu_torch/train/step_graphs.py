"""CUDA graphs of the train and eval steps (counterpart: the JAX package's
compiled step, `make_train_step`'s `jax.jit` and `make_multi_train_step`'s
`lax.scan` of S steps in one dispatch, hydragnn_tpu/train/train_step.py:
426-460 and 545-558).

On the card a step, or a group of S steps, is one CUDA graph replay. A
graph is captured at the first call with a new key (kind, S, the batch
signature, the gradient-accumulation phase at the group's start) and
replayed from then on; the eager step functions are the capture's body.
On the CPU the same entry points run those eager bodies, S of them for a
group. There is no switch between the two routes: the batch's device
decides, and a capture or replay that fails on the card raises.

What a captured step needs, and where it comes from:

* static inputs: one `GraphBatch` slot per step of a group, refilled with
  `copy_` before each replay (a model's graphs share the slots of one
  batch signature), and for a train step a float32 [S, 4] tensor of the
  optimizer's per-step scalars (`Optimizer.step_scalars`: -lr, the bias
  corrections, the micro-step divisor), which the host computes from its
  counters and copies in before each replay, so the plateau schedule's
  `set_learning_rate` and the growing `count` reach every replay;
* state the graph updates in place: parameters, BatchNorm buffers,
  optimizer slots and the accumulator keep their tensors from capture to
  replay (`TrainState.restore` and the checkpoint resume copy into them);
  a replay whose state holds other tensors raises;
* static outputs: the group's metrics as one [K, S] float32 tensor
  (one host read a group), cloned at each replay, and for the single eval
  step its outputs;
* warm-up: `WARMUP_ITERS` eager runs of the body on the capture stream
  before the capture (PyTorch's whole-network recipe), with the state
  snapshot before them and put back in place after each, so that the
  first replay sees what the first eager step would have seen;
* one memory pool and one side stream per model (`context_for`);
* the launch counters of `kernels/`: a capture's count is taken back and
  added again at each replay, so the counters keep counting the kernels
  the card runs;
* one capture at a time on a device (`capture_lock`): the warm-up and
  the capture hold the device's lock, and so does whoever frees a set of
  graphs (`serving/engine.py`), so that engines of one process (a
  fleet's replicas) never capture, or free a pool, next to another
  capture. Replays need no lock.

A kernel launched inside a graph reports a bad launch at capture
(`cudaGetLastError()` in its C entry point); a fault while a replay runs
surfaces at the next synchronising read, the metrics' host read.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import kernels
from ..graphs.batch import GraphBatch

# eager runs of a body on the capture stream before its capture
WARMUP_ITERS = 2

class GraphContext:
    """What one model's graphs share: a memory pool, the side stream of
    warm-up and capture, and static batch slots by signature. Graphs that
    share the pool replay one at a time on one stream, and each keeps its
    own outputs alive, so one graph's temporaries may reuse another's."""

    def __init__(self, device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device) if stream is None else stream
        self._slots: Dict[tuple, List[GraphBatch]] = {}

    def slots(self, batch: GraphBatch, n: int) -> List[GraphBatch]:
        """n static batches shaped like `batch`, on the card."""
        have = self._slots.setdefault(batch_signature(batch), [])
        while len(have) < n:
            have.append(GraphBatch(**{
                f.name: (None if getattr(batch, f.name) is None else
                         torch.empty_like(getattr(batch, f.name),
                                          device=self.device))
                for f in dataclasses.fields(batch)}))
        return have[:n]


_CONTEXTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def context_for(owner, device: torch.device) -> GraphContext:
    """The graph context of `owner` (a model) on `device`, made once."""
    ctxs = _CONTEXTS.setdefault(owner, {})
    if device not in ctxs:
        ctxs[device] = GraphContext(device)
    return ctxs[device]


def batch_signature(batch: GraphBatch) -> tuple:
    return tuple((f.name, None) if getattr(batch, f.name) is None else
                 (f.name, tuple(getattr(batch, f.name).shape),
                  getattr(batch, f.name).dtype)
                 for f in dataclasses.fields(batch))


def fill(slot: GraphBatch, batch: GraphBatch) -> None:
    """Copy a batch (on the card or the host) into a static slot."""
    for f in dataclasses.fields(slot):
        dst = getattr(slot, f.name)
        if dst is not None:
            dst.copy_(getattr(batch, f.name), non_blocking=True)


_CAPTURE_LOCKS: Dict[int, threading.Lock] = {}
_CAPTURE_LOCKS_GUARD = threading.Lock()


def capture_lock(device: torch.device) -> threading.Lock:
    """The lock every capture on `device`, and every release of captured
    graphs there, holds (one per card in the process)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _CAPTURE_LOCKS_GUARD:
        return _CAPTURE_LOCKS.setdefault(index, threading.Lock())


@dataclasses.dataclass
class Captured:
    """One captured graph, what it reads and writes besides the state,
    and the launches of the port's kernels one replay makes."""
    graph: "torch.cuda.CUDAGraph"
    outputs: object
    launches: Dict[str, int]
    capture_ms: float
    inputs: object = None

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launch_counts(self.launches)


def capture(ctx: GraphContext, body: Callable, restore: Optional[Callable]
            = None, error_mode: str = "global") -> Captured:
    """Warm `body()` up on the context's stream, then capture one call
    into a CUDA graph from the context's pool. `restore(device)` puts the
    state back after each warm-up run (device=True: tensors and host
    counters) and after the capture (device=False: the host counters the
    capture's run of the body moved; the capture itself computes
    nothing). `error_mode` is `torch.cuda.graph`'s capture_error_mode
    ("thread_local" where another thread may use the card meanwhile).
    Holds the device's `capture_lock` throughout."""
    t0 = time.perf_counter()
    with capture_lock(ctx.device):
        s = ctx.stream
        s.wait_stream(torch.cuda.current_stream(ctx.device))
        with torch.cuda.stream(s):
            for _ in range(WARMUP_ITERS):
                body()
                if restore is not None:
                    restore(True)
        torch.cuda.current_stream(ctx.device).wait_stream(s)
        mark = kernels.counts_mark()
        # the captured graph is kept beside its executable, so its nodes
        # can be read (`raw_cuda_graph`)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=ctx.pool, stream=s,
                              capture_error_mode=error_mode):
            outputs = body()
        graph.instantiate()
        launches = kernels.take_back_since(mark)
    if restore is not None:
        restore(False)
    return Captured(graph, outputs, launches,
                    (time.perf_counter() - t0) * 1e3)


def _stack_metrics(per_step: Sequence[Dict[str, torch.Tensor]]):
    """(keys, [K, S] float32) of S steps' metric dicts."""
    keys = list(per_step[0])
    return keys, torch.stack([torch.stack([m[k].float() for m in per_step])
                              for k in keys])


def _as_dict(keys, values) -> Dict[str, torch.Tensor]:
    return {k: values[i] for i, k in enumerate(keys)}


def _state_tensors(state) -> List[torch.Tensor]:
    opt = state.opt_state
    return (list(state.params.values()) + list(state.batch_stats.values())
            + [t for ts in opt.slots.values() for t in ts]
            + list(opt.acc_grads or ()))


class GraphedSteps:
    """S steps of `body(state, batch, scalars) -> (metrics, outputs)` on S
    batches: on the card one replay of the graph of their key, on the CPU
    S eager calls. A train step passes its optimizer `tx` (the body
    updates the state; `scalars` is the step's row of the optimizer's
    scalars, None for the body to make its own) and `mode` "train"; an
    eval step none and "eval". `keep_outputs` keeps the last step's
    outputs (the single eval step's predictions)."""

    def __init__(self, model, body: Callable, tx=None, mode: str = "train",
                 keep_outputs: bool = False,
                 extra_state: Optional[Callable] = None):
        self.model = model
        self.body = body
        self.tx = tx
        self.mode = mode
        self.keep_outputs = keep_outputs
        # state the body reads, or updates in place, beside the TrainState
        # (the sampled step's historical tables): `extra_state()` returns
        # an object with `tensors()`, `copy()` and `restore(snapshot)`, or
        # None; a replay checks its tensors as it checks the state's, and
        # the warm-up puts them back after each run
        self.extra_state = extra_state
        self.graphs: Dict[tuple, Captured] = {}

    def _extra(self):
        return None if self.extra_state is None else self.extra_state()

    def _bound_tensors(self, state) -> List[torch.Tensor]:
        extra = self._extra()
        return _state_tensors(state) + (
            [] if extra is None else list(extra.tensors()))

    # ------------------------------------------------------------ eager --
    def eager(self, state, batches: Sequence[GraphBatch]):
        """The S eager steps: (stacked metrics {k: [S]}, per-step metric
        dicts, the last step's outputs)."""
        per_step, outputs = [], None
        for batch in batches:
            metrics, outputs = self.body(state, batch, None)
            per_step.append(metrics)
        keys, values = _stack_metrics(per_step)
        return _as_dict(keys, values), per_step, outputs

    # ------------------------------------------------------------ route --
    def __call__(self, state, batches: Sequence[GraphBatch]):
        """(stacked metrics {k: [S]}, per-step metric dicts or None, the
        last step's outputs or None)."""
        dev = batches[0].x.device
        if dev.type == "cpu":
            return self.eager(state, batches)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        return self._replay(state, batches, dev)

    def _key(self, state, batches):
        phase = (state.opt_state.mini_step if self.tx is not None
                 and self.tx.accumulate > 1 else 0)
        return (len(batches), batch_signature(batches[0]), phase)

    def _replay(self, state, batches, dev):
        ctx = context_for(self.model, dev)
        key = self._key(state, batches)
        slots = ctx.slots(batches[0], len(batches))
        for slot, batch in zip(slots, batches):
            fill(slot, batch)
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(ctx, state, slots)
        ptrs, scalars, keys = cap.inputs
        if [t.data_ptr() for t in self._bound_tensors(state)] != ptrs:
            raise RuntimeError(
                "a captured step's state tensors were replaced since its "
                "capture: restore a state in place (TrainState.restore)")
        if self.tx is not None:
            rows = _advance_rows(self.tx, state.opt_state, len(batches))
            scalars.copy_(rows.pin_memory(), non_blocking=True)
            state.step += len(batches)
        if self.model.training != (self.mode == "train"):
            self.model.train(self.mode == "train")    # as the body leaves it
        cap.replay()
        metrics, outputs = cap.outputs
        values = metrics.clone()
        outputs = (None if outputs is None
                   else [o.clone() for o in outputs])
        return _as_dict(keys, values), None, outputs

    def _capture(self, ctx, state, slots) -> Captured:
        scalars = None
        restore = None
        if self.tx is not None:
            n = len(slots)
            scalars = torch.zeros((n, 4), dtype=torch.float32,
                                  device=ctx.device)
            snapshot = state.copy()
            extra = self._extra()
            extra_snapshot = None if extra is None else extra.copy()
            # the rows a replay would fill: the warm-up computes with them
            scalars.copy_(_advance_rows(
                self.tx, dataclasses.replace(snapshot.opt_state), n))

            def restore(device: bool):
                if device:
                    state.restore(snapshot)
                    if extra is not None:
                        extra.restore(extra_snapshot)
                else:
                    state.restore_host(snapshot)
        keys: List[str] = []

        def run():
            per_step, outputs = [], None
            for i, slot in enumerate(slots):
                metrics, outputs = self.body(
                    state, slot, None if scalars is None else scalars[i])
                per_step.append(metrics)
            k, values = _stack_metrics(per_step)
            keys[:] = k
            return values, (outputs if self.keep_outputs else None)

        cap = capture(ctx, run, restore)
        cap.inputs = ([t.data_ptr() for t in self._bound_tensors(state)],
                      scalars, list(keys))
        return cap


def _advance_rows(tx, opt_state, n: int) -> torch.Tensor:
    """The scalar rows of the next n updates as a float32 [n, 4] host
    tensor, moving `opt_state`'s counters over them."""
    rows = []
    for _ in range(n):
        rows.append(tx.step_scalars(opt_state))
        tx.advance(opt_state)
    return torch.tensor(rows, dtype=torch.float32)
