"""Batched inference serving engine, core (counterpart:
hydragnn_tpu/serving/engine.py).

* ``bucket_ladder`` — a small deterministic set of padded shapes, one per
  graph-count capacity in {1, 2, 4, ..., max_batch_size}, each sized by
  ``graphs.packing.choose_budget`` over a reference size histogram.
* ``InferenceEngine.submit(sample) -> Future`` — requests enter a queue; a
  dispatcher thread coalesces them in arrival order into one padded batch
  (while the next request fits the largest bucket) up to
  ``max_batch_size`` requests or ``max_wait_ms`` after the first dequeued
  request, runs one forward on the smallest fitting bucket on the engine's
  device, and resolves each caller's future to its own unpadded rows.

Batched outputs equal the single-request forward on the same bucket bit
for bit: every per-node op is row-independent, the matmul shapes are the
bucket's, and the pooling and aggregation kernels sum each graph's rows
in the same relative order wherever the graph sits (CSR walks, no
atomics).

``ef_forward=True`` serves energies and forces from a node-level energy
head (head 0): each response is [energy [1], forces [num_nodes, 3]] with
forces = -d(energy)/d pos (train/loss.py). That forward runs under
``torch.enable_grad()``, not ``torch.inference_mode()``, and its backward
goes through the kernels' autograd Functions: the filter-scatter's dh is
the same CSR kernel on the sender-sorted layout, the pooling's gradient a
gather, and the position gathers' gradient the segment-sum kernel, so the
batched = single contract holds for forces too.

Precision. ``compute_dtype`` (the serve-side override, else
HYDRAGNN_PRECISION, else Architecture.dtype; train/precision.py) is
resolved once. A float32 engine runs the model as it is and promises the
bitwise contract above (``parity`` "bitwise"). A bfloat16 engine runs
train_step.make_forward_fn's casting policy on weights cast once at
construction; its batched outputs still equal the single-request forward
bit for bit on the same bucket, and against a float32 forward they obey
|bf16 - f32| <= SERVE_REDUCED_ATOL + SERVE_REDUCED_RTOL |f32| (2^-5 each,
the JAX package's bound): every future carries ``parity`` "tolerance"
and the two tolerances, and ``stats()`` reports ``compute_dtype`` and
``parity``.

CUDA graphs (counterpart: the JAX engine's AOT executable per bucket,
hydragnn_tpu/serving/engine.py:1123-1150, compiled at warm-up,
:898-912). On the card each bucket's forward (EF: forward and the
forces' backward) is one CUDA graph: `warmup()` captures every bucket, a
bucket not captured yet is captured at its first use, and a forward
collates on the host, copies into the bucket's static batch, replays and
copies the outputs to the host before the next replay. Forwards hold one
lock, so captures and replays never overlap (captures run in
thread-local mode). `forward_single` replays the same bucket's graph, so
batched = single holds as above; `capture_ms` holds each bucket's
capture time (its warm-up included). On the CPU the forward runs eagerly.

A failed batch resolves only its own futures with the error and the
dispatcher keeps serving. Admission bounds, deadlines, the circuit
breaker, raw-structure serving, multi-device shards and the fleet hooks
come with ROADMAP item A8.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs.batch import (GraphBatch, GraphSample, collate,
                            neighbor_budget_for_dataset, with_neighbor_format)
from ..graphs.packing import (MAX_GRAPH_SLOTS, PackBudget, choose_budget,
                              sample_sizes)
from ..train.loss import energy_forces_from_node_head
from ..train.precision import resolve_precision
from ..train.step_graphs import GraphContext, capture, fill
from ..train.train_step import make_forward_fn
from ..utils.devices import resolve_device
from .config import check_serving_precision

_SHUTDOWN = object()

# the reduced-precision serving bound (JAX serving/engine.py:108-128):
# 2^-5 is 8 bf16 ulps at unit scale, the budget of the <= 8 rounding-
# dominated stages of a stack with float32 sums
SERVE_REDUCED_RTOL = 2.0 ** -5
SERVE_REDUCED_ATOL = 2.0 ** -5


def bucket_ladder(nodes, edges, max_batch_size: int, num_buckets: int = 0,
                  multiple: int = 64) -> Tuple[PackBudget, ...]:
    """The engine's deterministic bucket set, smallest first: one
    `choose_budget` shape per capacity in {1, 2, 4, ..., max_batch_size}
    (`num_buckets` > 0 keeps only the largest that many), duplicates
    merged into the roomier capacity."""
    caps: List[int] = []
    g = max(int(max_batch_size), 1)
    while g >= 1:
        caps.append(g)
        g //= 2
    caps = sorted(set(caps))
    if num_buckets and num_buckets > 0:
        caps = caps[-int(num_buckets):]
    ladder: List[PackBudget] = []
    for cap in caps:
        b = choose_budget(nodes, edges, cap, multiple=multiple)
        b = dataclasses.replace(b, n_graph=min(cap, MAX_GRAPH_SLOTS) + 1)
        if not ladder or (b.n_node, b.n_edge) != (ladder[-1].n_node,
                                                  ladder[-1].n_edge):
            ladder.append(b)
        else:
            ladder[-1] = b
    return tuple(ladder)


def select_bucket(buckets: Sequence[PackBudget], count: int, tot_n: int,
                  tot_e: int) -> Optional[PackBudget]:
    """Smallest bucket (ladder order) that fits `count` graphs with
    `tot_n` nodes and `tot_e` edges; None when nothing fits."""
    for b in buckets:
        if (count <= b.cap_graphs and tot_n <= b.cap_nodes
                and tot_e <= b.cap_edges):
            return b
    return None


class _Request:
    __slots__ = ("sample", "future", "n", "e", "t_submit")

    def __init__(self, sample: GraphSample, future: Future):
        self.sample = sample
        self.future = future
        self.n = sample.num_nodes
        self.e = sample.num_edges
        self.t_submit = time.perf_counter()


class InferenceEngine:
    """submit(sample) -> Future resolving to per-head unpadded numpy
    outputs (graph heads: [output_dim]; node heads: [num_nodes,
    output_dim]).

    `model` is the port's stack with its weights loaded; it is moved to
    `device` (the card unless the caller passes device="cpu") and put in
    eval mode. Bucket shapes and the request schema come from
    `reference_samples`. Label fields are stripped before the forward.
    `neighbor_format` serves on the dense neighbor layout with width
    `neighbor_k` (default: the reference samples' budget). `ef_forward`
    serves [energy [1], forces [num_nodes, 3]] from a node-level head 0.
    `compute_dtype` overrides the train-side precision policy."""

    def __init__(self, model, mcfg, *,
                 reference_samples: Sequence[GraphSample],
                 max_batch_size: int = 32, max_wait_ms: float = 5.0,
                 num_buckets: int = 0, bucket_multiple: int = 64,
                 neighbor_format: bool = False,
                 neighbor_k: Optional[int] = None,
                 ef_forward: bool = False,
                 compute_dtype: Optional[str] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if not reference_samples:
            raise ValueError("InferenceEngine needs reference_samples (bucket "
                             "shapes + request schema)")
        self.compute_dtype = resolve_precision(getattr(mcfg, "dtype", None),
                                               compute_dtype)
        check_serving_precision(self.compute_dtype)
        if self.compute_dtype == "float32":
            self.parity, self.parity_rtol, self.parity_atol = \
                "bitwise", 0.0, 0.0
        else:
            self.parity = "tolerance"
            self.parity_rtol = SERVE_REDUCED_RTOL
            self.parity_atol = SERVE_REDUCED_ATOL
        self.model = model.to(self.device).eval()
        self._model_fn = make_forward_fn(self.model, mcfg, self.compute_dtype,
                                         frozen=True)
        self.mcfg = mcfg
        self.max_batch_size = max(int(max_batch_size), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        nodes, edges = sample_sizes(reference_samples)
        self.buckets: Tuple[PackBudget, ...] = bucket_ladder(
            nodes, edges, self.max_batch_size, num_buckets, bucket_multiple)
        self._fill_cap = min(self.max_batch_size,
                             self.buckets[-1].cap_graphs)
        self._proto = reference_samples[0]
        self.neighbor_k = None
        if neighbor_format:
            self.neighbor_k = int(
                neighbor_budget_for_dataset(reference_samples)
                if neighbor_k is None else neighbor_k)
        self.ef_forward = bool(ef_forward)
        if self.ef_forward:
            if mcfg.heads[0].head_type != "node":
                raise ValueError(
                    "ef_forward=True needs head 0 to be a node-level "
                    "energy head (the energy_force_loss convention); got "
                    f"a {mcfg.heads[0].head_type!r} head")
            self._response_heads = ["graph", "node"]
        else:
            self._response_heads = [h.head_type for h in mcfg.heads]

        self._lock = threading.Lock()
        # one forward at a time: a bucket's static batch and outputs are
        # shared, and a capture needs the card to itself
        self._forward_lock = threading.Lock()
        self._graphs = {}          # guarded-by: _forward_lock
        self.capture_ms = {}       # bucket -> capture ms
        self._graph_ctx = None
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False  # guarded-by: _lock
        self.requests_done = 0  # guarded-by: _lock
        self.batches_run = 0  # guarded-by: _lock
        self._latencies: List[float] = []  # guarded-by: _lock
        self._dispatcher = threading.Thread(target=self._loop,
                                            name="serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------- client API

    def submit(self, sample: GraphSample) -> Future:
        """Enqueue one request; returns a Future resolving to the per-head
        outputs (or raising the request's failure). Thread-safe."""
        fut: Future = Future()
        err = self._validate(sample)
        if err is not None:
            fut.set_exception(err)
            return fut
        # the closed check and the put share the lock that shutdown()
        # flips _closed under, so no request lands behind the sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("InferenceEngine is shut down")
            self._queue.put(_Request(sample, fut))
        return fut

    def predict(self, samples: Sequence[GraphSample], timeout=None):
        """Submit all samples, wait, return the results in order."""
        futs = [self.submit(s) for s in samples]
        return [f.result(timeout=timeout) for f in futs]

    def forward_single(self, sample: GraphSample,
                       bucket: Optional[PackBudget] = None):
        """One sample padded alone into the smallest bucket that fits it
        (or `bucket`): the per-request reference path."""
        err = self._validate(sample)
        if err is not None:
            raise err
        if bucket is None:
            bucket = select_bucket(self.buckets, 1, sample.num_nodes,
                                   sample.num_edges)
        req = _Request(sample, Future())
        return self._unpad([req], bucket, self._forward([req], bucket))[0]

    def warmup(self) -> int:
        """Run one forward per bucket (on the card: build the kernels and
        capture the bucket's graph); returns the number of buckets run."""
        for bucket in self.buckets:
            self._forward([_Request(self._proto, Future())], bucket)
        return len(self.buckets)

    def shutdown(self, wait: bool = True):
        """Stop accepting submissions; the dispatcher drains every queued
        request and exits. Idempotent."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._queue.put(_SHUTDOWN)
        if wait:
            self._dispatcher.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(wait=True)
        return False

    def reset_stats(self):
        with self._lock:
            self.requests_done = 0
            self.batches_run = 0
            self._latencies = []

    def stats(self) -> dict:
        """Requests and batches served, the request-latency percentiles
        (submit to result, milliseconds), the compute dtype and the parity
        contract."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            out = {"requests": self.requests_done,
                   "batches": self.batches_run,
                   "compute_dtype": self.compute_dtype,
                   "parity": self.parity}
        for q in (50, 95, 99):
            out[f"p{q}_ms"] = (float(np.percentile(lat, q) * 1e3)
                               if lat.size else 0.0)
        out["mean_ms"] = float(lat.mean() * 1e3) if lat.size else 0.0
        out["count"] = int(lat.size)
        return out

    # --------------------------------------------------------------- plumbing

    def _validate(self, sample: GraphSample) -> Optional[Exception]:
        big = self.buckets[-1]
        if sample.num_nodes > big.cap_nodes or sample.num_edges > big.cap_edges:
            return ValueError(
                f"request ({sample.num_nodes} nodes, {sample.num_edges} "
                f"edges) exceeds the largest serving bucket (capacity "
                f"{big.cap_nodes} nodes / {big.cap_edges} edges)")
        p = self._proto
        for name in ("edge_attr", "edge_shifts", "cell"):
            if (getattr(sample, name) is None) != (getattr(p, name) is None):
                return ValueError(
                    f"request field '{name}' does not match the engine's "
                    "reference sample schema")
        if sample.x.shape[1] != p.x.shape[1]:
            return ValueError(
                f"request feature width {sample.x.shape[1]} != engine "
                f"schema width {p.x.shape[1]}")
        return None

    def _collate_bucket(self, samples: List[GraphSample],
                        bucket: PackBudget) -> GraphBatch:
        """The bucket's padded batch, on the host."""
        b = collate(samples, n_node=bucket.n_node, n_edge=bucket.n_edge,
                    n_graph=bucket.n_graph)
        b = b.replace(y_graph=None, y_node=None, energy=None, forces=None)
        if self.neighbor_k is not None:
            b = with_neighbor_format(b, k=self.neighbor_k)
        return b

    def _run(self, batch: GraphBatch) -> List[torch.Tensor]:
        """The eager forward: the CPU's route and the graphs' capture
        body."""
        if self.ef_forward:
            return list(energy_forces_from_node_head(self._model_fn, batch))
        with torch.inference_mode():
            outputs, _ = self._model_fn(batch)
        return list(outputs)

    def _forward(self, reqs: List[_Request],
                 bucket: PackBudget) -> List[np.ndarray]:
        batch = self._collate_bucket([r.sample for r in reqs], bucket)
        if self.device.type == "cpu":
            return [o.numpy() for o in self._run(batch)]
        with self._forward_lock:
            cap = self._graphs.get(bucket)
            if cap is None:
                cap = self._graphs[bucket] = self._capture(bucket, batch)
            else:
                fill(cap.inputs, batch)
            cap.replay()
            return [o.cpu().numpy() for o in cap.outputs]

    def _capture(self, bucket: PackBudget, batch: GraphBatch):
        """The bucket's graph, captured from a forward of `batch` (the
        warm-up runs and the captured call compute on it)."""
        if self._graph_ctx is None:
            self._graph_ctx = GraphContext(self.device)
        slot = self._graph_ctx.slots(batch, 1)[0]
        fill(slot, batch)
        cap = capture(self._graph_ctx, lambda: self._run(slot),
                      error_mode="thread_local")
        cap.inputs = slot
        self.capture_ms[bucket] = cap.capture_ms
        return cap

    def _unpad(self, reqs: List[_Request], bucket: PackBudget,
               outs: List[np.ndarray]) -> List[List[np.ndarray]]:
        """Request i sits at graph slot i, its nodes at the running node
        offset."""
        results: List[List[np.ndarray]] = []
        no = 0
        for i, req in enumerate(reqs):
            per_head = []
            for ih, kind in enumerate(self._response_heads):
                if kind == "graph":
                    per_head.append(outs[ih][i])
                else:
                    per_head.append(outs[ih][no:no + req.n])
            results.append(per_head)
            no += req.n
        return results

    def _execute(self, reqs: List[_Request]):
        try:
            bucket = select_bucket(self.buckets, len(reqs),
                                   sum(r.n for r in reqs),
                                   sum(r.e for r in reqs))
            if bucket is None:
                raise RuntimeError(
                    f"internal error: a coalesced batch of {len(reqs)} "
                    "requests fits no bucket")
            results = self._unpad(reqs, bucket, self._forward(reqs, bucket))
            done = time.perf_counter()
            with self._lock:
                self.batches_run += 1
                self.requests_done += len(reqs)
                self._latencies.extend(done - r.t_submit for r in reqs)
            for req, res in zip(reqs, results):
                req.future.bucket = bucket
                req.future.parity = self.parity
                req.future.parity_rtol = self.parity_rtol
                req.future.parity_atol = self.parity_atol
                req.future.set_result(res)
        except Exception as e:  # noqa: BLE001 — must reach the callers
            # a failed batch resolves only its own futures; the
            # dispatcher keeps serving
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(e)

    def _coalesce(self, first: _Request, wait: bool = True):
        """Greedy arrival-order coalescing: grow the batch while the next
        request fits the largest bucket's node/edge budget and graph
        capacity; flush at max_batch_size requests or max_wait_ms after
        `first` was dequeued. Returns (requests, leftover_or_sentinel)."""
        big = self.buckets[-1]
        reqs = [first]
        rem_n = big.cap_nodes - first.n
        rem_e = big.cap_edges - first.e
        deadline = time.perf_counter() + (self.max_wait_s if wait else 0.0)
        leftover = None
        while len(reqs) < self._fill_cap:
            timeout = deadline - time.perf_counter()
            try:
                nxt = (self._queue.get_nowait() if timeout <= 0
                       else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if nxt is _SHUTDOWN or nxt.n > rem_n or nxt.e > rem_e:
                leftover = nxt
                break
            reqs.append(nxt)
            rem_n -= nxt.n
            rem_e -= nxt.e
        return reqs, leftover

    def _loop(self):
        pending = None
        while True:
            if pending is None:
                req = self._queue.get()
            else:
                req, pending = pending, None
            if req is _SHUTDOWN:
                break
            reqs, pending = self._coalesce(req)
            self._execute(reqs)
        # drain what is still queued: a shutdown never leaves a caller's
        # future hanging
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _SHUTDOWN:
                continue
            reqs, leftover = self._coalesce(req, wait=False)
            self._execute(reqs)
            if leftover is not None and leftover is not _SHUTDOWN:
                self._queue.put(leftover)
