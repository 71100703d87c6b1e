"""Pipeline (layer) parallelism for a deep stack of homogeneous layers
(counterpart: hydragnn_tpu/parallel/pipeline.py).

The stack's L layers split into S contiguous stages, stage s holding
layers [s L/S, (s + 1) L/S) on `stage_devices[s]`; a batch is M
microbatches; the schedule takes M + S - 1 ticks, and at tick t stage s
works on microbatch t - s. The JAX package runs the ticks as a
`lax.scan` over a `pipe` mesh axis, the hop as a `ppermute`; here one
process drives every stage, so the forward, the backward through it, and
for energy-force training the double backward, stay in one autograd
graph, as the whole step is one differentiable program in JAX.

* **Devices and streams.** Stage s computes on `stage_devices[s]`; on a
  card each stage has a CUDA stream of its own (one per stage index and
  device), which forks from the caller's stream at the start of the
  pass and joins back at its end, so several stages on one card overlap
  as far as their data lets them. The backward of each op runs on its
  forward's stream (autograd's stream semantics), so it overlaps the
  same way. `stage_streams=False` computes every tick on the caller's
  stream, in the same order.
* **The hop** is the previous tick's stage output, issued at the top of
  the tick (JAX's double-buffered carry): a copy to the next stage's
  device, or on the same device a wait of the next stage's stream on the
  producer's. A tensor read on a stream other than the one it was made
  on is recorded on the reader (`record_stream`), so the allocator does
  not hand its memory out before the reader is done.
* **Banked outputs**: finished microbatches are kept from the last stage.
* **Remat** (`remat=True`) wraps each tick's stage compute in
  `torch.utils.checkpoint` (non-reentrant, no RNG state, as
  `models/base.remat_call`): the backward keeps only the stage's input
  and recomputes the rest. `remat_policy="dots"` keeps the matrix
  products' outputs (aten mm, addmm, bmm) and recomputes the rest:
  torch's selective activation checkpointing, JAX's `checkpoint_dots`.
  The hand-written kernels launch through ctypes inside autograd
  Functions, which the policy does not see: they are recomputed, with
  the same bits.

The closed forms (`forward_ticks`, `bubble_fraction`, `train_step_ticks`,
`train_bubble_fraction`) and the checks are the JAX package's, messages
included.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Sequence

import torch

PIPELINE_SCHEDULES = ("gpipe", "1f1b")

# remat policies: "full" keeps nothing, "dots" the matrix products
_REMAT_POLICIES = ("full", "dots")


def check_stage_divisibility(num_layers: int, num_stages: int) -> int:
    """Layers a stage, or a ValueError naming the knob to change."""
    num_stages = int(num_stages)
    if num_stages < 1:
        raise ValueError(
            f"pipeline_stages must be >= 1 (got {num_stages})")
    if num_layers % num_stages:
        raise ValueError(
            f"num_conv_layers={num_layers} does not split into "
            f"{num_stages} pipeline stages: set Training.pipeline_stages "
            f"to a divisor of the conv-layer count (remainder "
            f"{num_layers % num_stages})")
    return num_layers // num_stages


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: Optional[str]):
    """The checkpoint `context_fn` of a remat-policy name: None for None
    or "full" (save nothing), torch's selective checkpoint contexts with
    the matrix-product policy for "dots"; another name raises."""
    if name is None or name == "full":
        return None
    if name == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    raise ValueError(
        f"unknown pipeline remat policy {name!r} (use one of "
        f"{_REMAT_POLICIES})")


def forward_ticks(num_stages: int, microbatches: int) -> int:
    """Ticks one pipelined forward pass takes: M + S - 1."""
    return microbatches + num_stages - 1


def bubble_fraction(num_stages: int, microbatches: int) -> float:
    """The bubble of one pipelined pass (forward or backward):
    (S - 1) / (M + S - 1), the share of stage-ticks spent filling and
    draining."""
    return (num_stages - 1) / forward_ticks(num_stages, microbatches)


def train_step_ticks(num_stages: int, microbatches: int,
                     schedule: str = "gpipe") -> int:
    """Stage-ticks of one train step: gpipe 2 (M + S - 1); 1f1b
    ceil(M / W) windows of W = min(S, M) microbatches, each 2 (W + S - 1)
    ticks."""
    S, M = int(num_stages), int(microbatches)
    if schedule == "gpipe":
        return 2 * (M + S - 1)
    if schedule == "1f1b":
        W = min(S, M)
        windows = -(-M // W)
        return windows * 2 * (W + S - 1)
    raise ValueError(f"unknown pipeline schedule {schedule!r} "
                     f"(use one of {PIPELINE_SCHEDULES})")


def train_bubble_fraction(num_stages: int, microbatches: int,
                          schedule: str = "gpipe") -> float:
    """1 - 2M / train_step_ticks: every microbatch crosses every stage
    once forward and once backward."""
    total = train_step_ticks(num_stages, microbatches, schedule)
    return 1.0 - (2 * int(microbatches)) / total


_STREAMS: dict = {}


def stage_device(device) -> torch.device:
    """A stage's device with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stage_stream(device: torch.device, stage: int):
    """The CUDA stream of stage `stage` on `device`, made once (a fresh
    stream a step would grow cuBLAS's per-stream workspaces)."""
    key = (device, stage)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


def _used_on(tensors, stream) -> None:
    """Record every tensor of `tensors` (any nesting of lists, tuples and
    dicts) as used on `stream`."""
    if isinstance(tensors, torch.Tensor):
        if tensors.is_cuda:
            tensors.record_stream(stream)
    elif isinstance(tensors, dict):
        for t in tensors.values():
            _used_on(t, stream)
    elif isinstance(tensors, (list, tuple)):
        for t in tensors:
            _used_on(t, stream)
    elif hasattr(tensors, "__dataclass_fields__"):
        for name in tensors.__dataclass_fields__:
            _used_on(getattr(tensors, name), stream)


def make_pipeline_apply(stage_devices: Sequence, layer_fn: Callable,
                        num_layers: int, remat: bool = False,
                        remat_policy: Optional[str] = None,
                        stage_streams: bool = True, stream_base: int = 0):
    """apply(stage_layers, x_micro, structure) -> y_micro.

    `layer_fn(layer, h, structure) -> h'` applies one layer; the
    activation keeps one shape across layers. `stage_layers[s]` is the
    list of stage s's layers (on `stage_devices[s]`); `x_micro` the M
    microbatches' inputs (a list of tensors); `structure[s][m]` what
    microbatch m's layers read on stage s's device. Returns the M outputs
    of the last stage, on its device. With `remat` each tick's stage
    compute is checkpointed (the same values and gradients, bit for
    bit). Stage s computes on stream `stage_stream(device, stream_base +
    s)`: a pipe ring of a data axis takes its own streams."""
    devices = [stage_device(d) for d in stage_devices]
    S = len(devices)
    check_stage_divisibility(num_layers, S)

    def stage_apply(layers, h, structure_t):
        for layer in layers:
            h = layer_fn(layer, h, structure_t)
        return h

    run = stage_apply
    if remat:
        from torch.utils.checkpoint import checkpoint
        context_fn = resolve_remat_policy(remat_policy)
        kw = {} if context_fn is None else {"context_fn": context_fn}

        def run(layers, h, structure_t):
            if not torch.is_grad_enabled():
                return stage_apply(layers, h, structure_t)
            return checkpoint(stage_apply, layers, h, structure_t,
                              use_reentrant=False, preserve_rng_state=False,
                              **kw)

    def apply(stage_layers, x_micro: List[torch.Tensor], structure):
        M = len(x_micro)
        cuda = devices[0].type == "cuda" and stage_streams
        streams = ([stage_stream(d, stream_base + s)
                    for s, d in enumerate(devices)] if cuda else [None] * S)
        callers = ([torch.cuda.current_stream(d) for d in devices]
                   if cuda else [None] * S)

        def on(s):
            return (torch.cuda.stream(streams[s]) if cuda
                    else contextlib.nullcontext())
        if cuda:
            # fork: every stage stream starts after what the caller queued
            # (the embed, the microbatch structure)
            for s in range(S):
                streams[s].wait_stream(callers[s])
                _used_on(structure[s], streams[s])
        outputs: List[Optional[torch.Tensor]] = [None] * M
        h_prev: List[Optional[torch.Tensor]] = [None] * S
        for t in range(M + S - 1):
            # the hops of tick t - 1's outputs, at the top of tick t
            inflight: List[Optional[torch.Tensor]] = [None] * S
            for s in range(1, S):
                h = h_prev[s - 1]
                if h is None or not 0 <= t - s < M:
                    continue
                if devices[s] != devices[s - 1]:
                    with on(s):
                        if cuda:
                            streams[s].wait_stream(streams[s - 1])
                        h = h.to(devices[s], non_blocking=cuda)
                elif cuda:
                    streams[s].wait_stream(streams[s - 1])
                    h.record_stream(streams[s])
                inflight[s] = h
            h_prev = [None] * S
            for s in range(S):
                mb = t - s
                if not 0 <= mb < M:
                    continue
                if s == 0:
                    h = x_micro[mb]
                    if h.device != devices[0]:
                        h = h.to(devices[0])
                    if cuda:
                        h.record_stream(streams[0])
                else:
                    h = inflight[s]
                with on(s):
                    h_out = run(stage_layers[s], h, structure[s][mb])
                h_prev[s] = h_out
                if s == S - 1:
                    outputs[mb] = h_out
        if cuda:
            # join: the caller's stream goes on after every stage
            last = devices[-1]
            for s in range(S):
                callers[s].wait_stream(streams[s])
            for y in outputs:
                y.record_stream(torch.cuda.current_stream(last))
        return outputs

    return apply


def join_stage_streams(devices: Sequence) -> None:
    """Make each stage device's current stream wait on its stage's
    stream: after a backward through the stages (whose ops ran on the
    stage streams), before the caller reads the gradients or a CUDA
    graph's capture ends. A no-op off the card."""
    for s, dev in enumerate(stage_device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_stream(stage_stream(dev, s))
