"""Graph parallelism: message passing for graphs too large for one device
(counterpart: hydragnn_tpu/parallel/graph_parallel.py).

The JAX package spreads a graph's edges over a ``graph`` mesh axis and
lets XLA insert the collectives. Here one process drives a list of
*slots*: each slot computes on its device, and on a card on a CUDA stream
of its own (one per slot key and device, `pipeline.stage_stream`), so
several slots on one card overlap as far as their data lets them. A slot
list forks from the caller's stream before its work and joins back after
it; a backward through slot work runs on the slots' streams (autograd's
stream semantics) and is joined back by `Slots.join` before the caller
reads its gradients or a CUDA graph's capture ends.

- **Edge-sharded mode** (`edge_sharded_aggregate`): x lives on the home
  slot (slot 0); the edges split into contiguous chunks, one a slot. Each
  slot gathers its chunk's rows, computes the messages and their partial
  segment sum (the segment-sum kernel on the card, over a CSR layout of
  the chunk's receivers); the partials come back to the home slot and are
  added in slot order, so the result is the same on every run.
- **Ring mode** (`ring_aggregate`): slot d owns node block d and the
  edges whose receiver lies in it, bucketed by the sender's block
  (`build_ring_buckets`). The sender blocks rotate one hop a step (slot d
  hands its block to slot d + 1: a copy onto the next device, or on one
  card the next stream waiting on this one); at step k slot d holds block
  (d - k) mod D and adds the segment sum of bucket [d, k] into its own
  aggregate. Nothing is replicated and no final reduction is needed.

Both are differentiable through autograd: the backward of a hop or a
copy moves the gradient back to the slot it came from. The host helpers
(`partition_nodes`, `build_ring_buckets`, `shard_node_array`,
`shard_edge_arrays`) are the JAX package's, bit for bit.

`Slots` also carries the composed (data x graph) training of
parallel/composite.py: `composed(slots)` makes a slot list the active
graph axis, and while it is active the edge-list stacks that support it
(GIN, PNA, SchNet) build `ShardedEdges` in their `conv_args` and route
each conv's edge stage through `ops.segment.slot_edge_stage`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..graphs.batch import GraphBatch
from ..kernels import segment as kseg
from ..ops import segment as seg
from .pipeline import stage_device, stage_stream

# the GraphBatch fields whose leading dim is the edge axis: the fields a
# graph slot takes a contiguous chunk of (JAX composite.EDGE_FIELDS)
EDGE_FIELDS = ("senders", "receivers", "edge_mask", "edge_attr",
               "edge_shifts")


class RingEdgeBuckets(NamedTuple):
    """Host-built edge partition for ring mode. All arrays lead with
    [D, D, Eb]: slot, ring step, padded per-bucket edge count.
    ``send_local``/``recv_local`` are block-local indices; ``mask`` marks
    real edges."""
    send_local: np.ndarray   # [D, D, Eb] int32 index into the rotating block
    recv_local: np.ndarray   # [D, D, Eb] int32 index into the local block
    edge_id: np.ndarray      # [D, D, Eb] int32 index into the original edge
    mask: np.ndarray         # [D, D, Eb] bool
    block: int               # node block size (padded N / D)


def partition_nodes(num_nodes: int, n_shards: int) -> int:
    """Block size of the contiguous node partition (last block padded)."""
    return -(-num_nodes // n_shards)


def build_ring_buckets(senders: np.ndarray, receivers: np.ndarray,
                       num_nodes: int, n_shards: int,
                       edge_mask: Optional[np.ndarray] = None,
                       pad_multiple: int = 8) -> RingEdgeBuckets:
    """Bucket edges for ring mode: bucket[d, k] holds the edges whose
    receiver is in node block d and whose sender is in block (d - k) mod
    D, the block slot d holds after k ring rotations."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    block = partition_nodes(num_nodes, n_shards)
    if edge_mask is None:
        edge_mask = np.ones(senders.shape, bool)
    real = np.asarray(edge_mask, bool)
    sb = senders // block
    rb = receivers // block
    step = (rb - sb) % n_shards

    buckets = [[None] * n_shards for _ in range(n_shards)]
    eb = 0
    for d in range(n_shards):
        for k in range(n_shards):
            sel = np.nonzero(real & (rb == d) & (step == k))[0]
            buckets[d][k] = sel
            eb = max(eb, len(sel))
    eb = max(pad_multiple, -(-eb // pad_multiple) * pad_multiple)

    shape = (n_shards, n_shards, eb)
    send_local = np.zeros(shape, np.int32)
    recv_local = np.zeros(shape, np.int32)
    edge_id = np.zeros(shape, np.int32)
    mask = np.zeros(shape, bool)
    for d in range(n_shards):
        for k in range(n_shards):
            sel = buckets[d][k]
            n = len(sel)
            send_local[d, k, :n] = senders[sel] % block
            recv_local[d, k, :n] = receivers[sel] % block
            edge_id[d, k, :n] = sel
            mask[d, k, :n] = True
    return RingEdgeBuckets(send_local, recv_local, edge_id, mask, block)


def shard_node_array(arr, n_shards: int):
    """[N, ...] -> [D, block, ...] with zero padding (a numpy array or a
    tensor, returned as the same kind)."""
    block = partition_nodes(arr.shape[0], n_shards)
    pad = block * n_shards - arr.shape[0]
    if isinstance(arr, torch.Tensor):
        if pad:
            arr = torch.cat([arr, arr.new_zeros((pad,)
                                                + tuple(arr.shape[1:]))])
        return arr.reshape((n_shards, block) + tuple(arr.shape[1:]))
    arr = np.asarray(arr)
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:],
                                            arr.dtype)])
    return arr.reshape((n_shards, block) + arr.shape[1:])


def shard_edge_arrays(n_shards: int, *arrays, pad_multiple: int = 8):
    """Split edge arrays evenly into [D, Eb, ...] shards (edge-sharded
    mode). Returns (mask, *shards): mask marks real edges after
    padding."""
    e = arrays[0].shape[0]
    eb = partition_nodes(e, n_shards)
    eb = -(-eb // pad_multiple) * pad_multiple
    pad = eb * n_shards - e
    mask = np.ones((e,), bool)
    out = []
    for a in (mask,) + arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        out.append(a.reshape((n_shards, eb) + a.shape[1:]))
    return tuple(out)


def _record(obj, stream) -> None:
    """Record every CUDA tensor in `obj` (nested lists, tuples, dicts,
    GraphBatches) as used on `stream`."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, dict):
        for v in obj.values():
            _record(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _record(v, stream)
    elif isinstance(obj, GraphBatch):
        for v in vars(obj).values():
            _record(v, stream)


def _move(obj, device):
    """`obj` (a tensor or nested tuple / list of tensors) on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == device else obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, device) for v in obj)
    return obj


class Slots:
    """A list of slot devices. Slot i computes on `devices[i]`; on a card
    on the CUDA stream `stage_stream(devices[i], ("graph", base + i))`. The
    home slot is slot 0 (the caller's device)."""

    def __init__(self, devices: Sequence, base: int = 0):
        self.devices = [stage_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a slot list needs at least one device")
        types = {d.type for d in self.devices}
        if len(types) > 1:
            raise ValueError(f"slot devices mix device types: "
                             f"{[str(d) for d in self.devices]}")
        self.home = self.devices[0]
        self.cuda = self.home.type == "cuda"
        self.keys = [("graph", base + i) for i in range(len(self.devices))]

    def __len__(self) -> int:
        return len(self.devices)

    def stream(self, i: int):
        return stage_stream(self.devices[i], self.keys[i]) if self.cuda \
            else None

    def on(self, i: int):
        """The context that computes on slot i (its stream on a card)."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream(i))

    def fork(self) -> None:
        """Every slot stream starts after what its device's (and the home
        device's) current stream queued."""
        if not self.cuda:
            return
        for i, dev in enumerate(self.devices):
            s = self.stream(i)
            s.wait_stream(torch.cuda.current_stream(self.home))
            if dev != self.home:
                s.wait_stream(torch.cuda.current_stream(dev))

    def join(self) -> None:
        """Each slot device's (and the home device's) current stream goes
        on after its slot's stream: after slot work or a backward through
        it, before the caller reads the results or a capture ends."""
        if not self.cuda:
            return
        for i, dev in enumerate(self.devices):
            s = self.stream(i)
            torch.cuda.current_stream(dev).wait_stream(s)
            if dev != self.home:
                torch.cuda.current_stream(self.home).wait_stream(s)

    def to_slot(self, obj, i: int):
        """`obj` on slot i, recorded as used on its stream (call inside
        `on(i)`: a copy to another device is issued there)."""
        obj = _move(obj, self.devices[i])
        if self.cuda:
            _record(obj, self.stream(i))
        return obj

    def to_home(self, obj):
        """`obj` on the home device, recorded as used on its current
        stream (call after `join`)."""
        obj = _move(obj, self.home)
        if self.cuda:
            _record(obj, torch.cuda.current_stream(self.home))
        return obj

    def map(self, fn: Callable, *inputs) -> list:
        """[fn(i, *inputs on slot i) for each slot i], each on its slot,
        forked from and joined back to the caller; the results on the home
        device."""
        self.fork()
        out = []
        for i in range(len(self)):
            with self.on(i):
                out.append(fn(i, *[self.to_slot(t, i) for t in inputs]))
        self.join()
        return [self.to_home(o) for o in out]


def edge_chunks(num_edges: int, n_slots: int) -> List[slice]:
    """The contiguous edge chunk of each slot: ceil(E / G) edges a slot,
    the last ones shorter (the padding edges, which lie at the end of a
    loader batch, fall in the last chunks), as P("graph") splits the edge
    axis."""
    per = partition_nodes(num_edges, n_slots)
    return [slice(min(g * per, num_edges), min((g + 1) * per, num_edges))
            for g in range(n_slots)]


def shard_batch(batch: GraphBatch, chunk: slice, device) -> GraphBatch:
    """The batch with its edge fields cut to `chunk`, on `device` (the
    node fields replicated there)."""
    kw = {}
    for name, val in vars(batch).items():
        if val is None:
            continue
        if name in EDGE_FIELDS:
            val = val[chunk]
        kw[name] = _move(val, device)
    return GraphBatch(**kw)


class ShardedEdges:
    """A batch's edges split over the active graph slots: `batches[g]` is
    slot g's `shard_batch` and `cargs[g]` what its convs read there (the
    stack's per-batch arguments of that chunk). `map(fn, *node_inputs)`
    runs `fn(shard batch, shard cargs, *inputs on the slot)` on every
    slot (the edge stage `ops.segment.slot_edge_stage` reduces)."""

    def __init__(self, slots: Slots, batch: GraphBatch,
                 cargs_fn: Callable[[GraphBatch], dict]):
        if batch.nbr is not None:
            raise ValueError(
                "graph_shards splits the edge list: the dense neighbor "
                "layout is node-major (run_training turns it off)")
        self.slots = slots
        self.num_nodes = batch.num_nodes
        chunks = edge_chunks(batch.num_edges, len(slots))

        def build(i):
            sb = shard_batch(batch, chunks[i], slots.devices[i])
            return sb, cargs_fn(sb)
        built = slots.map(build)
        self.batches = [b for b, _ in built]
        self.cargs = [c for _, c in built]
        if slots.cuda:
            # built on the slot streams, read there by every layer
            for i, (b, c) in enumerate(built):
                _record((b, c), slots.stream(i))

    def map(self, fn: Callable, *inputs) -> list:
        return self.slots.map(
            lambda i, *xs: fn(self.batches[i], self.cargs[i], *xs), *inputs)


_ACTIVE = threading.local()


@contextlib.contextmanager
def composed(slots: Optional[Slots]):
    """Make `slots` the graph axis of the forwards run inside (None: no
    graph axis); the previous one is put back after."""
    prev = getattr(_ACTIVE, "slots", None)
    _ACTIVE.slots = slots
    try:
        yield
    finally:
        _ACTIVE.slots = prev


def active_slots() -> Optional[Slots]:
    """The graph slots of the composed forward running on this thread, or
    None."""
    return getattr(_ACTIVE, "slots", None)


def sharded_conv_args(batch: GraphBatch, cargs_fn: Callable) -> dict:
    """A stack's `conv_args` under the active graph axis: {"graph_slots":
    ShardedEdges of the batch, each chunk's arguments `cargs_fn(chunk)`},
    or None when no graph axis is active."""
    slots = active_slots()
    if slots is None:
        return None
    return {"graph_slots": ShardedEdges(slots, batch, cargs_fn)}


# --------------------------------------------------------------- layers --
def _as_tensor(a, device, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def _masked(m, mask):
    return torch.where(mask[:, None], m, torch.zeros_like(m))


def edge_sharded_aggregate(message_fn: Callable, x: torch.Tensor,
                           send_shards: Sequence, recv_shards: Sequence,
                           mask_shards: Sequence, num_nodes: int,
                           slots: Slots,
                           edge_attr_shards: Optional[Sequence] = None
                           ) -> torch.Tensor:
    """x [N, F] on the home slot, slot g's edges `send_shards[g]`,
    `recv_shards[g]`, `mask_shards[g]` [Eb] (and `edge_attr_shards[g]`).
    `message_fn(x_i, x_j, edge_attr) -> [Eb, Fm]`. Returns the full
    [N, Fm] aggregation on the home device: slot g's masked messages
    summed by receivers (over a CSR layout of its receivers), the
    partials added in slot order."""

    def part(i, xs):
        dev = slots.devices[i]
        send = _as_tensor(send_shards[i], dev, torch.int32)
        recv = _as_tensor(recv_shards[i], dev, torch.int32)
        mask = _as_tensor(mask_shards[i], dev, torch.bool)
        ea = (None if edge_attr_shards is None
              else _as_tensor(edge_attr_shards[i], dev))
        layout = None if dev.type == "cpu" else kseg.segment_layout(
            recv, num_nodes, mask)
        send_layout = None if dev.type == "cpu" else kseg.segment_layout(
            send, num_nodes, mask)
        xi = kseg.gather_rows(xs, recv, layout)
        xj = kseg.gather_rows(xs, send, send_layout)
        m = _masked(message_fn(xi, xj, ea), mask)
        return seg.segment_sum(m.contiguous(), recv, num_nodes,
                               layout=layout)

    return seg.add_in_order(slots.map(part, x))


def ring_aggregate(message_fn: Callable, x_blocks: Sequence[torch.Tensor],
                   buckets, slots: Slots,
                   edge_attr_buckets: Optional[Sequence] = None
                   ) -> List[torch.Tensor]:
    """Slot d holds `x_blocks[d]` [block, F] (on its device) and the
    buckets [d, k] of `buckets` (a `RingEdgeBuckets`, or any object with
    `send_local`, `recv_local`, `mask` of [D, D, Eb]). D ring steps: at
    step k slot d adds the segment sum of bucket [d, k]'s messages
    against the block it holds, (d - k) mod D, then hands that block to
    slot d + 1. Returns each slot's [block, Fm] aggregation, on its
    device (receiver-partitioned: no final reduction)."""
    D = len(slots)
    if len(x_blocks) != D:
        raise ValueError(f"{len(x_blocks)} node blocks for {D} slots")
    block = x_blocks[0].shape[0]
    send = [_as_tensor(buckets.send_local[d], slots.devices[d], torch.int32)
            for d in range(D)]
    recv = [_as_tensor(buckets.recv_local[d], slots.devices[d], torch.int32)
            for d in range(D)]
    mask = [_as_tensor(buckets.mask[d], slots.devices[d], torch.bool)
            for d in range(D)]
    slots.fork()
    own = []
    for d in range(D):
        with slots.on(d):
            own.append(slots.to_slot(x_blocks[d], d))
    held = list(own)
    agg: List[Optional[torch.Tensor]] = [None] * D
    for k in range(D):
        for d in range(D):
            with slots.on(d):
                r, s, m = recv[d][k], send[d][k], mask[d][k]
                layout = send_layout = None
                if slots.cuda:
                    layout = kseg.segment_layout(r, block, m)
                    send_layout = kseg.segment_layout(s, block, m)
                ea = (None if edge_attr_buckets is None
                      else _as_tensor(edge_attr_buckets[d][k],
                                      slots.devices[d]))
                xj = kseg.gather_rows(held[d], s, send_layout)
                xi = kseg.gather_rows(own[d], r, layout)
                msg = _masked(message_fn(xi, xj, ea), m)
                part = seg.segment_sum(msg.contiguous(), r, block,
                                       layout=layout)
                agg[d] = part if agg[d] is None else agg[d] + part
        if k == D - 1:
            break
        # the hop: slot d's block to slot d + 1 (the last step's is unused)
        nxt: List[Optional[torch.Tensor]] = [None] * D
        for d in range(D):
            t = (d + 1) % D
            with slots.on(t):
                if slots.cuda:
                    slots.stream(t).wait_stream(slots.stream(d))
                nxt[t] = slots.to_slot(held[d], t)
        held = nxt
    slots.join()
    return agg


def make_edge_sharded_layer(slot_devices: Sequence, message_fn: Callable,
                            num_nodes: int,
                            update_fn: Optional[Callable] = None):
    """layer(x [N, F], send [D, Eb], recv [D, Eb], mask [D, Eb]) ->
    update_fn(x, agg) (the aggregation when None): edge-sharded message
    passing over the slot devices (several may be one card: a stream a
    slot)."""
    slots = Slots(slot_devices)
    upd = update_fn or (lambda x, agg: agg)

    def layer(x, send, recv, mask):
        x = _as_tensor(x, slots.home)
        agg = edge_sharded_aggregate(message_fn, x, send, recv, mask,
                                     num_nodes, slots)
        return upd(x, agg)

    layer.slots = slots
    return layer


def make_ring_layer(slot_devices: Sequence, message_fn: Callable,
                    update_fn: Optional[Callable] = None):
    """layer(x_sharded [D, block, F], send_local, recv_local, mask [D, D,
    Eb]) -> [D, block, F]: ring message passing over the slot devices,
    each slot's block updated by `update_fn(x_block, agg_block)` (the
    aggregation when None); the blocks come back stacked on the home
    device."""
    slots = Slots(slot_devices)
    upd = update_fn or (lambda x, agg: agg)

    def layer(x_sh, send_l, recv_l, mask):
        x_sh = _as_tensor(x_sh, slots.home)
        D = len(slots)
        blocks = [x_sh[d] for d in range(D)]
        b = RingEdgeBuckets(send_l, recv_l, None, mask, x_sh.shape[1])
        agg = ring_aggregate(message_fn, blocks, b, slots)
        return torch.stack([upd(blocks[d], slots.to_home(agg[d]))
                            for d in range(D)])

    layer.slots = slots
    return layer
