"""Batched inference serving engine (counterpart:
hydragnn_tpu/serving/engine.py).

* ``bucket_ladder`` — a small deterministic set of padded shapes, one per
  graph-count capacity in {1, 2, 4, ..., max_batch_size}, each sized by
  ``graphs.packing.choose_budget`` over a reference size histogram; or an
  explicit ladder (``buckets=`` with a ``proto_sample`` for the schema).
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
``parity``. An int8 engine (``compute_dtype="int8"``, quant/) routes the
encoder convs' Dense layers through calibrated int8 products
(quant/ptq.py) and keeps everything else at float32: the scales come
from ``quant_calibration`` or, without one, from calibrating on the
first ``quant_calib_samples`` reference samples; batched = single holds
bitwise within a bucket, and against float32 the JAX package's bound
|int8 - f32| <= SERVE_INT8_ATOL + SERVE_INT8_RTOL |f32| (2^-3 each) is
the contract futures carry. Both packages miss it where a real atom has
no neighbours: PNA's attenuation scaler then sets the calibrated scales
(ROADMAP C). The weights are quantized inside each bucket's
graph, so a hot swap re-quantizes at the next replay. int8 serves
neither ``ef_forward`` (the rounding's gradient is zero almost
everywhere) nor ``num_shards`` > 1, as in the JAX package.

CUDA graphs (counterpart: the JAX engine's AOT executable per bucket).
On the card each bucket's forward (EF: forward and the forces' backward)
is one CUDA graph: `warmup()` captures every bucket, a bucket not
captured yet is captured at its first use, and a forward collates on the
host, copies into the bucket's static batch, replays and copies the
outputs to the host before the next replay, all on the engine's own
non-default stream. Forwards hold one lock, so an engine's captures,
replays and hot swaps never overlap; captures run in thread-local mode
under the device's capture lock (train/step_graphs.capture_lock), so
engines sharing a card (a fleet's replicas, serving/fleet.py) capture
one at a time while the others replay. When the dispatcher exits after
`shutdown()` the engine drops its graphs and their pool, under the same
lock, and hands its stream to the next engine built on the card: PyTorch
keeps a cuBLAS workspace per thread handle and stream for the life of
the process, so a restarted replica on a fresh stream would add one at
every restart. `forward_single` replays the same bucket's graph, so
batched = single holds as above; `capture_ms` holds each bucket's capture
time (its warm-up included) and `stats()["captures"]` counts them. On the
CPU the forward runs eagerly.

Compile store (counterpart: the JAX engine's `compile_store`). A bucket's
first use "compiles" it: with a `compile_store`
(utils/devices.CompileStore) the engine looks up the bucket's key
(`_store_key`: the model config, the bucket, the schema, the precision,
the device's kind and compute capability and the kernel sources'
digest) and, on a hit, installs the stored kernel libraries where
`kernels/_build.py` finds them (no `nvcc`); on a miss it builds them and
saves them under the key. `stats()` reports `compile_count`,
`compile_fresh` and `compile_store_hits` as the JAX engine does; the
bucket's graph is captured in every process and counted apart
(`captures`, `capture_ms`). `tier` (default: the compute dtype) tags the
engine for a fleet's tier routing and is echoed on every future.

Failure semantics: every accepted future resolves, with a result or an
error, under any single-batch failure.

* ``max_queue`` > 0 bounds the admission queue: ``submit`` fast-fails
  with ``QueueFullError`` instead of queueing without bound;
* ``deadline_ms`` (per submit, or ``default_deadline_ms``) resolves an
  expired request with ``DeadlineExceededError``, at dequeue and again
  just before the forward: an expired request never takes a slot;
* a failed batch resolves only its own futures; ``breaker_threshold``
  consecutive failures open a circuit breaker that fast-fails
  (``CircuitOpenError``) for ``breaker_reset_s``, then admits one probe
  whose outcome closes or re-opens it. ``health()`` reports the state,
  queue depth and counters. A sticky CUDA error (the device no longer
  synchronises after a failed batch) ends the dispatcher:
  ``health()["dispatcher_alive"]`` turns false and every queued and later
  request fails with it;
* the ``serving-dispatch`` fault site (utils/faults.py) fires once per
  executed batch, before collation, so all of this runs deterministically
  in the tests.

Hot swap. ``swap_variables(variables, version)`` takes a Flax-shaped tree
(as ``utils/weights.load_jax_variables`` does), refuses a shape or dtype
mismatch before touching anything, and copies the new values into the
model's own tensors (and, at bf16, re-casts them into the frozen bf16
copies) under the forward lock, between replays (at the dispatcher's
next forward when it holds that lock first): the captured graphs read
those addresses, so nothing is recaptured. Each batch reads
``model_version`` under the same lock and every future carries it.

Raw structures. With a ``structure_config`` the engine also takes raw
positions: ``submit_structure(positions, node_features[, cell])`` builds
the radius graph and the sample (``build_graph_sample``) on the caller's
thread and submits it; a trajectory client holds a
``structure_session()`` whose Verlet-skin neighbour list
(graphs/neighborlist.py) re-filters step t's candidates at step t+1. The
edges are bitwise a fresh build's. Futures carry ``.rebuilt`` and
``.graph_build_ms``; the engine counts ``structure_requests``,
``nbr_updates`` and ``nbr_rebuilds`` (``health()``, ``stats()``).
``trajectory_farm(dt=...)`` returns the device-resident MD farm
(md/farm.py) over this engine's model, bucket and precision.

Telemetry (telemetry/). Each `submit_structure` reports
``serve.nbr_updates_total``, ``serve.nbr_rebuilds_total`` and the
``serve.nbr_rebuild_fraction`` gauge into the process registry and, with
a span recorder installed, a ``serve.graph_build`` span; each batch the
``serve.queue_wait`` (a request's), ``serve.forward`` and ``serve.unpad``
spans. ``start_metrics_server()`` serves /healthz and /metrics until
``shutdown()``.

Not ported yet: multi-device shards (``num_shards`` > 1 raises naming
ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphs.batch import (GraphBatch, GraphSample, collate,
                            neighbor_budget_for_dataset, with_neighbor_format)
from ..graphs.neighborlist import NeighborList
from ..graphs.packing import (MAX_GRAPH_SLOTS, PackBudget, choose_budget,
                              sample_sizes)
from ..preprocess.transforms import build_graph_sample
from ..telemetry import spans as _spans
from ..telemetry.registry import get_registry
from ..train.loss import energy_forces_from_node_head
from ..train.precision import check_ported_precision, resolve_precision
from ..kernels import _build
from ..train.step_graphs import GraphContext, capture, capture_lock, fill
from ..train.train_step import make_forward_fn
from ..utils.devices import CompileStore, resolve_device
from ..utils.faults import fault_point
from ..utils.profiling import latency_percentiles
from ..utils.weights import (export_jax_variables, load_jax_variables,
                             variables_signature)
from ..quant.calibrate import calibrate
from ..quant.ptq import make_quantized_forward
from .config import Structure

_SHUTDOWN = object()
_log = logging.getLogger("hydragnn_tpu_torch")

# the side streams of engines whose graphs were released, by device, for
# the next engine's graph context
_FREE_STREAMS: dict = {}
_FREE_STREAMS_LOCK = threading.Lock()


def _take_stream(device: torch.device):
    with _FREE_STREAMS_LOCK:
        free = _FREE_STREAMS.get(device)
        return free.pop() if free else None

# the reduced-precision serving bound (JAX serving/engine.py:108-128):
# 2^-5 is 8 bf16 ulps at unit scale, the budget of the <= 8 rounding-
# dominated stages of a stack with float32 sums
SERVE_REDUCED_RTOL = 2.0 ** -5
SERVE_REDUCED_ATOL = 2.0 ** -5
# the int8 serving bound (JAX serving/engine.py:130-151): one quantized
# product's error is the input's and the folded weight's rounding (2^-8
# of the calibrated range each, the int32 sum exact), through the <= 8
# rounding-dominated stages of the deepest conv stacks
SERVE_INT8_RTOL = 2.0 ** -3
SERVE_INT8_ATOL = 2.0 ** -3


class ServingError(RuntimeError):
    """Base of the engine's failure-semantics errors."""


class QueueFullError(ServingError):
    """submit() fast-fail: the bounded admission queue is at max_queue."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before a batch could serve it."""


class CircuitOpenError(ServingError):
    """The circuit breaker is open (consecutive batch failures); requests
    fast-fail until the probe window."""


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
    __slots__ = ("sample", "future", "n", "e", "t_submit", "deadline")

    def __init__(self, sample: GraphSample, future: Future,
                 deadline_ms: Optional[float] = None):
        self.sample = sample
        self.future = future
        self.n = sample.num_nodes
        self.e = sample.num_edges
        self.t_submit = time.perf_counter()
        # absolute expiry on t_submit's clock; None or 0: none
        self.deadline = (self.t_submit + float(deadline_ms) / 1e3
                         if deadline_ms else None)


class InferenceEngine:
    """submit(sample) -> Future resolving to per-head unpadded numpy
    outputs (graph heads: [output_dim]; node heads: [num_nodes,
    output_dim]).

    `model` is the port's stack with its weights loaded; it is moved to
    `device` (the card unless the caller passes device="cpu") and put in
    eval mode. Bucket shapes and the request schema come from
    `reference_samples`, or from an explicit `buckets` ladder and a
    `proto_sample`. Label fields are stripped before the forward.
    `neighbor_format` serves on the dense neighbor layout with width
    `neighbor_k` (default: the reference samples' budget). `ef_forward`
    serves [energy [1], forces [num_nodes, 3]] from a node-level head 0.
    `compute_dtype` overrides the train-side precision policy.
    `max_queue`, `default_deadline_ms` and `breaker_threshold` (0 each:
    off) with `breaker_reset_s` set the failure semantics;
    `structure_config` (the full config) turns on raw-structure serving,
    whose sessions use the Verlet skin `md_skin`; `model_version` tags the
    served weights. `compile_store` (a utils/devices.CompileStore) keeps
    the kernel libraries each bucket needs; `tier` tags the engine for a
    fleet's tier routing (default: the compute dtype). At int8,
    `quant_calibration` (quant.calibrate's result, shared by a fleet's
    replicas) gives the activation scales; without it the engine
    calibrates on the first `quant_calib_samples` reference samples.
    `num_shards` > 1 is not ported (ROADMAP A8)."""

    def __init__(self, model, mcfg, *,
                 reference_samples: Optional[Sequence[GraphSample]] = None,
                 buckets: Optional[Sequence[PackBudget]] = None,
                 proto_sample: Optional[GraphSample] = None,
                 max_batch_size: int = 32, max_wait_ms: float = 5.0,
                 num_buckets: int = 0, bucket_multiple: int = 64,
                 neighbor_format: bool = False,
                 neighbor_k: Optional[int] = None,
                 ef_forward: bool = False,
                 compute_dtype: Optional[str] = None,
                 max_queue: int = 0,
                 default_deadline_ms: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 30.0,
                 structure_config: Optional[dict] = None,
                 md_skin: float = 0.3,
                 model_version: str = "v0",
                 compile_store: Optional[CompileStore] = None,
                 tier: Optional[str] = None,
                 quant_calibration=None,
                 quant_calib_samples: int = 32,
                 num_shards: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.compute_dtype = check_ported_precision(resolve_precision(
            getattr(mcfg, "dtype", None), compute_dtype))
        quantized = self.compute_dtype == "int8"
        if quantized and int(num_shards) > 1:
            raise ValueError(
                "int8 serving is single-shard for now — run one int8 "
                "engine per device (a fleet tier of them, "
                "serving/fleet.py) instead of num_shards > 1")
        if quantized and ef_forward:
            raise ValueError(
                "ef_forward needs exact gradients (forces = -dE/dpos) "
                "and the int8 round/clip has a zero gradient almost "
                "everywhere — serve EF from the fp32/bf16 tier and keep "
                "int8 for the plain forward tiers")
        if int(num_shards) > 1:
            raise NotImplementedError(
                f"num_shards={num_shards} (serving sharded over devices) is "
                "not ported to hydragnn_tpu_torch yet (ROADMAP A8: "
                "multi-device shards); run a fleet of replicas instead")
        if self.compute_dtype == "float32":
            self.parity, self.parity_rtol, self.parity_atol = \
                "bitwise", 0.0, 0.0
        elif quantized:
            self.parity = "tolerance"
            self.parity_rtol = SERVE_INT8_RTOL
            self.parity_atol = SERVE_INT8_ATOL
        else:
            self.parity = "tolerance"
            self.parity_rtol = SERVE_REDUCED_RTOL
            self.parity_atol = SERVE_REDUCED_ATOL
        self.tier = str(tier) if tier is not None else self.compute_dtype
        self.max_batch_size = max(int(max_batch_size), 1)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue = max(int(max_queue), 0)
        self.default_deadline_ms = (float(default_deadline_ms)
                                    if default_deadline_ms else None)
        self.breaker_threshold = max(int(breaker_threshold), 0)
        self.breaker_reset_s = max(float(breaker_reset_s), 0.0)
        if buckets is None:
            if not reference_samples:
                raise ValueError(
                    "InferenceEngine needs reference_samples (bucket "
                    "shapes + request schema) or an explicit buckets "
                    "ladder with a proto_sample")
            nodes, edges = sample_sizes(reference_samples)
            buckets = bucket_ladder(nodes, edges, self.max_batch_size,
                                    num_buckets, bucket_multiple)
        self.buckets: Tuple[PackBudget, ...] = tuple(buckets)
        if not self.buckets:
            raise ValueError("InferenceEngine: empty bucket ladder")
        if any(b.n_graph < 2 for b in self.buckets):
            raise ValueError(
                "InferenceEngine: every bucket needs n_graph >= 2 (one "
                "real graph slot + the padding slot, the collate "
                "convention)")
        # an explicit ladder may hold fewer graph slots than
        # max_batch_size: the coalescer never builds a batch that
        # select_bucket cannot place
        self._fill_cap = min(self.max_batch_size,
                             self.buckets[-1].cap_graphs)
        if proto_sample is None and not reference_samples:
            raise ValueError("InferenceEngine: an explicit buckets ladder "
                             "needs a proto_sample (the request schema)")
        self._proto = (proto_sample if proto_sample is not None
                       else reference_samples[0])
        self.neighbor_k = None
        if neighbor_format:
            if neighbor_k is None:
                if not reference_samples:
                    raise ValueError(
                        "neighbor_format=True needs an explicit "
                        "neighbor_k when no reference_samples are given")
                neighbor_k = neighbor_budget_for_dataset(reference_samples)
            self.neighbor_k = int(neighbor_k)

        self._structure_cfg = structure_config
        self.md_skin = float(md_skin)
        if structure_config is not None:
            s_arch = structure_config["NeuralNetwork"]["Architecture"]
            self._structure_pbc = bool(
                s_arch.get("periodic_boundary_conditions", False))
            self._structure_radius = float(s_arch.get("radius") or 5.0)
            self._structure_max_nb = s_arch.get("max_neighbours")
            self._structure_rot = bool(structure_config["Dataset"].get(
                "rotational_invariance", False))

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
        self.mcfg = mcfg
        self.model = model.to(self.device).eval()
        # the int8 tier's scales: given (run_prediction calibrates once
        # for every replica) or calibrated here from the reference samples;
        # their digest keys the compile store
        self.quant_calibration = None
        self._quant_digest = None
        if quantized:
            if quant_calibration is None:
                if not reference_samples:
                    raise ValueError(
                        "int8 serving needs calibration: pass "
                        "quant_calibration (quant.calibrate) or "
                        "reference_samples for the engine to calibrate "
                        "from")
                quant_calibration = calibrate(
                    self.model, None, mcfg, reference_samples,
                    num_samples=quant_calib_samples)
            self.quant_calibration = quant_calibration
            self._quant_digest = quant_calibration.digest
            self._model_fn = make_quantized_forward(self.model, mcfg,
                                                    quant_calibration)
        else:
            self._model_fn = make_forward_fn(self.model, mcfg,
                                             self.compute_dtype, frozen=True)
        # what swap_variables must keep
        self._signature = variables_signature(export_jax_variables(model))

        self._lock = threading.Lock()
        # one forward at a time: a bucket's static batch and outputs are
        # shared, a capture needs the card to itself, and a hot swap
        # lands between two forwards
        self._forward_lock = threading.Lock()
        self._graphs = {}          # guarded-by: _forward_lock
        self.capture_ms = {}       # bucket -> capture ms (written under
        # _forward_lock)
        self._graph_ctx = None
        # written under both locks, so a forward (_forward_lock) and a
        # monitor (_lock) each read it whole
        self.model_version = str(model_version)
        self.swap_count = 0  # guarded-by: _lock
        self._pending_swap = None  # guarded-by: _lock
        self._swap_lock = threading.Lock()  # one swap at a time
        self._started_at = time.monotonic()
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False  # guarded-by: _lock
        self._fatal: Optional[BaseException] = None  # guarded-by: _lock
        self.requests_done = 0  # guarded-by: _lock
        self.batches_run = 0  # guarded-by: _lock
        self._occupancy_sum = 0.0  # guarded-by: _lock
        self._real_node_slots = 0  # guarded-by: _lock
        self._total_node_slots = 0  # guarded-by: _lock
        self._real_edge_slots = 0  # guarded-by: _lock
        self._total_edge_slots = 0  # guarded-by: _lock
        self.max_queue_depth = 0  # guarded-by: _lock
        self._latencies: List[float] = []  # guarded-by: _lock
        # submit_structure's neighbour-list builds; a session-less submit
        # is a rebuild
        self.structure_requests = 0  # guarded-by: _lock
        self.nbr_updates = 0  # guarded-by: _lock
        self.nbr_rebuilds = 0  # guarded-by: _lock
        # the breaker: closed | open | half_open
        self._breaker_state = "closed"  # guarded-by: _lock
        self._consec_failures = 0  # guarded-by: _lock
        self._open_until = 0.0  # guarded-by: _lock, monotonic probe point
        self.trip_count = 0  # guarded-by: _lock
        self.probe_count = 0  # guarded-by: _lock, open -> half_open moves
        self.batch_failures = 0  # guarded-by: _lock
        self.deadline_expired = 0  # guarded-by: _lock
        self.queue_rejections = 0  # guarded-by: _lock
        self.circuit_rejections = 0  # guarded-by: _lock
        # buckets made ready, split as the JAX engine's compile accounting
        # (from the store, or fresh)
        self._compile_store = compile_store
        self._compiled = set()  # guarded-by: _forward_lock
        self.compile_count = 0  # guarded-by: _lock
        self.compile_store_hits = 0  # guarded-by: _lock
        self.compile_fresh = 0  # guarded-by: _lock
        self._metrics_server = None
        self._dispatcher = threading.Thread(target=self._loop,
                                            name="serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------- client API

    def submit(self, sample: GraphSample,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the per-head
        outputs (or raising the request's failure). Thread-safe.

        Raises here, creating no future: `QueueFullError` when the bounded
        queue is at max_queue, `CircuitOpenError` while the breaker is
        open or its probe is in flight, RuntimeError after shutdown or
        the dispatcher's death. `deadline_ms` (default: the engine's
        default_deadline_ms) bounds the wait; an expired request resolves
        with `DeadlineExceededError`."""
        fut: Future = Future()
        err = self._validate(sample)
        if err is not None:
            fut.set_exception(err)
            return fut
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        # the admission checks and the put share the lock that shutdown()
        # flips _closed under, so no request lands behind the sentinel
        with self._lock:
            self._admission_check()
            if self._breaker_state == "open":
                # the window has elapsed (the check passed): this request
                # is the probe
                self._breaker_state = "half_open"
                self.probe_count += 1
            self._queue.put(_Request(sample, fut, deadline_ms=deadline_ms))
            depth = self._queue.qsize()
            if depth > self.max_queue_depth:
                self.max_queue_depth = depth
        return fut

    # holds-lock: _lock. Read-only but for the rejection counters: the
    # open -> half_open move stays with submit(), so the structure
    # precheck cannot take the probe its own submit would then refuse.
    def _admission_check(self) -> None:
        if self._closed:
            raise RuntimeError("InferenceEngine is shut down")
        if self._fatal is not None:
            raise RuntimeError(
                "InferenceEngine dispatcher died") from self._fatal
        if self._breaker_state == "half_open":
            self.circuit_rejections += 1
            raise CircuitOpenError(
                "circuit half-open: probe in flight; retry shortly")
        if self._breaker_state == "open":
            now = time.monotonic()
            if now < self._open_until:
                self.circuit_rejections += 1
                raise CircuitOpenError(
                    f"circuit open after {self.trip_count} trip(s) "
                    f"({self._consec_failures} consecutive batch "
                    f"failures); probing in {self._open_until - now:.2f}s")
        if self.max_queue and self._queue.qsize() >= self.max_queue:
            self.queue_rejections += 1
            raise QueueFullError(
                f"admission queue full ({self.max_queue} pending); "
                "retry with backoff or raise Serving.max_queue")

    def _require_structure(self):
        if self._structure_cfg is None:
            raise RuntimeError(
                "raw-structure serving is off — construct the "
                "InferenceEngine with structure_config=<config dict> "
                "(Serving.structure / HYDRAGNN_SERVE_STRUCTURE wires it "
                "through run_prediction)")

    def structure_session(self, skin: Optional[float] = None
                          ) -> "StructureSession":
        """A trajectory client's handle: submit_structure calls carrying
        it share one Verlet-skin NeighborList (cutoff, max_neighbours and
        PBC from the structure config, skin from `md_skin` unless given).
        One session per sequential client: it is not thread-safe."""
        self._require_structure()
        if self._structure_rot:
            raise ValueError(
                "trajectory sessions need Dataset.rotational_invariance "
                "off — the incremental neighbor list tracks displacements "
                "in the raw frame, per-step rotation normalization would "
                "invalidate them")
        return StructureSession(NeighborList(
            self._structure_radius,
            self.md_skin if skin is None else float(skin),
            max_neighbours=self._structure_max_nb,
            pbc=(True, True, True) if self._structure_pbc else None))

    def trajectory_farm(self, *, dt: float, skin: Optional[float] = None,
                        mass: float = 1.0, force_scale: float = 1.0,
                        steps_per_dispatch: Optional[int] = None,
                        cand_headroom: Optional[float] = None,
                        scorer=None):
        """The device-resident MD farm over this engine's model (md/farm.py):
        T trajectories advance `steps_per_dispatch` velocity-Verlet steps
        a dispatch (on the card one CUDA graph replay), each bitwise the
        single-session `submit_structure` loop (`md/loop.run_md`) from
        the same initial conditions. Needs the raw-structure and
        `ef_forward` configuration and a one-bucket ladder (every farm
        step runs the session's bucket shape, T times over). The knobs
        default to `serving.config.resolve_md_farm` (Serving.md_farm,
        HYDRAGNN_MD_FARM_*). The farm copies the weights it is built with:
        a later `swap_variables` of the engine leaves it as it is."""
        self._require_structure()
        if not self.ef_forward:
            raise ValueError(
                "trajectory_farm needs ef_forward=True — the farm "
                "integrates forces served as -dE/dpos")
        if self._structure_rot:
            raise ValueError(
                "trajectory farms need Dataset.rotational_invariance off "
                "— the incremental neighbor list tracks displacements in "
                "the raw frame")
        if len(self.buckets) != 1:
            raise ValueError(
                "trajectory_farm needs a single-bucket ladder (e.g. "
                "md.loop.md_buckets) so every step of the farm and of the "
                "session reference runs the same bucket shape")
        from ..md.farm import TrajectoryFarm
        from .config import resolve_md_farm
        knobs = resolve_md_farm(self._structure_cfg)
        # a consistent snapshot of the served weights: a swap lands
        # between forwards, under the forward lock
        with self._forward_lock:
            self._apply_swap()
            variables = export_jax_variables(self.model)
        return TrajectoryFarm(
            self.model, variables, self.mcfg, self._structure_cfg,
            bucket=self.buckets[0], dt=dt,
            skin=self.md_skin if skin is None else float(skin),
            mass=mass, force_scale=force_scale,
            steps_per_dispatch=(knobs.steps_per_dispatch
                                if steps_per_dispatch is None
                                else int(steps_per_dispatch)),
            cand_headroom=(knobs.cand_headroom if cand_headroom is None
                           else float(cand_headroom)),
            compute_dtype=self.compute_dtype, scorer=scorer,
            device=self.device)

    def submit_structure(self, positions, node_features=None, cell=None,
                         graph_feats=None,
                         session: Optional["StructureSession"] = None,
                         deadline_ms: Optional[float] = None) -> Future:
        """Raw-structure request: radius graph -> `build_graph_sample` ->
        the batched forward. `positions` may be a `serving.config.
        Structure` (explicit arguments override its fields). Without a
        `session` every call builds the graph fresh; with one, its
        neighbour list re-filters the candidate cache and rebuilds only
        past skin/2; the edges are the fresh build's either way. Runs on
        the caller's thread; the future carries `.rebuilt` and
        `.graph_build_ms` beside `.bucket`."""
        self._require_structure()
        # shed the host work too: fast-fail an open breaker, a full queue
        # or a shutdown before the neighbour update (submit() below stays
        # the authoritative check)
        with self._lock:
            self._admission_check()
        if isinstance(positions, Structure):
            struct = positions
            positions = struct.positions
            node_features = (struct.node_features if node_features is None
                             else node_features)
            cell = struct.cell if cell is None else cell
            graph_feats = (struct.graph_feats if graph_feats is None
                           else graph_feats)
        if node_features is None:
            raise ValueError(
                "submit_structure needs node_features (the "
                "Dataset.node_features layout; target columns may be "
                "zero-filled)")
        t0 = _spans.now()
        pos = np.asarray(positions, dtype=np.float64)
        edges = None
        rebuilt = True
        if session is not None:
            send, recv, shifts, rebuilt = session.nlist.update(
                pos, cell=cell if self._structure_pbc else None)
            edges = (send, recv, shifts)
        sample = build_graph_sample(
            np.asarray(node_features, dtype=np.float32), pos,
            self._structure_cfg, graph_feats=graph_feats, cell=cell,
            edges=edges, with_targets=False)
        build_s = _spans.now() - t0
        rec = _spans.current_recorder()
        if rec is not None:
            rec.add("serve.graph_build", t0, build_s, "serving",
                    {"rebuilt": bool(rebuilt),
                     "incremental": session is not None,
                     "edges": int(sample.num_edges)})
        with self._lock:
            self.structure_requests += 1
            self.nbr_updates += 1
            if rebuilt:
                self.nbr_rebuilds += 1
            updates, rebuilds = self.nbr_updates, self.nbr_rebuilds
        # two O(1) registry updates a request, as the engine's own
        # counters
        reg = get_registry()
        reg.counter_inc("serve.nbr_updates_total",
                        help="neighbor-list updates by submit_structure")
        if rebuilt:
            reg.counter_inc(
                "serve.nbr_rebuilds_total",
                help="full neighbor-list rebuilds (non-incremental "
                     "updates) by submit_structure")
        reg.gauge_set("serve.nbr_rebuild_fraction", rebuilds / updates,
                      help="rebuilds over neighbor-list updates since "
                           "engine start")
        fut = self.submit(sample, deadline_ms=deadline_ms)
        fut.rebuilt = bool(rebuilt)
        fut.graph_build_ms = build_s * 1e3
        return fut

    def health(self) -> dict:
        """Breaker state, queue depth, the failure and structure counters,
        dispatcher liveness, model version and uptime. Counters only."""
        with self._lock:
            return {
                "state": ("shutdown" if self._closed
                          else self._breaker_state),
                "model_version": self.model_version,
                "tier": self.tier,
                "uptime_s": time.monotonic() - self._started_at,
                "swap_count": self.swap_count,
                "queue_depth": self._queue.qsize(),
                "trip_count": self.trip_count,
                "probe_count": self.probe_count,
                # an open breaker whose window elapsed admits the next
                # submit as its probe
                "breaker_probe_due": (
                    self._breaker_state == "open"
                    and time.monotonic() >= self._open_until),
                "consecutive_failures": self._consec_failures,
                "batch_failures": self.batch_failures,
                "deadline_expired": self.deadline_expired,
                "queue_rejections": self.queue_rejections,
                "circuit_rejections": self.circuit_rejections,
                "requests_done": self.requests_done,
                "structure_requests": self.structure_requests,
                "nbr_updates": self.nbr_updates,
                "nbr_rebuilds": self.nbr_rebuilds,
                "nbr_rebuild_fraction": (
                    self.nbr_rebuilds / self.nbr_updates
                    if self.nbr_updates else 0.0),
                "dispatcher_alive": self._dispatcher.is_alive(),
            }

    def predict(self, samples: Sequence[GraphSample], timeout=None):
        """Submit all samples, wait, return the results in order."""
        futs = [self.submit(s) for s in samples]
        return [f.result(timeout=timeout) for f in futs]

    def swap_variables(self, variables, version: str) -> str:
        """Hot swap: serve `variables` (a Flax `{"params",
        "batch_stats"}` tree, as `utils/weights.load_jax_variables` takes
        it) tagged `version` from the next batch on; returns the version
        it replaced. A batch serves the old weights or the new, never a
        mix. The tree's paths, shapes and dtypes must be the served ones
        (ValueError before any change); the `swap-fail` fault site fires
        first, so an injected failure leaves the old version serving."""
        fault_point("swap-fail")
        new_vars = {"params": variables["params"],
                    "batch_stats": variables.get("batch_stats", {})}
        if variables_signature(new_vars) != self._signature:
            raise ValueError(
                "swap_variables: the new state's tree/shapes/dtypes do "
                "not match the serving state — the captured programs are "
                "shape-specialized; rebuild the engine for an "
                "architecture change instead of hot-swapping it")
        state = load_jax_variables(new_vars)
        with self._swap_lock:
            old_version = self.model_version
            with self._lock:
                self._pending_swap = (state, str(version))
            # Python's locks are not fair: under load the dispatcher
            # takes the forward lock first, and its next forward applies
            # the pending swap; else this does
            with self._forward_lock:
                self._apply_swap()
        return old_version

    # holds-lock: _forward_lock
    def _apply_swap(self) -> None:
        """Copy a pending swap's weights into the model's tensors (and the
        frozen bf16 copies), in place: the captured graphs read their
        storage."""
        if self._pending_swap is None:
            return
        with self._lock:
            (state, version), self._pending_swap = self._pending_swap, None
        frozen = getattr(self._model_fn, "frozen_variables", None)
        with torch.no_grad():
            for name, t in self.model.state_dict().items():
                t.copy_(state[name])
            if frozen is not None:
                for name, t in list(self.model.named_parameters()) + \
                        list(self.model.named_buffers()):
                    frozen[name].copy_(t.to(frozen[name].dtype))
        with self._lock:
            self.model_version = version
            self.swap_count += 1

    def latency_snapshot(self) -> List[float]:
        """Raw request latencies (seconds) since the last reset."""
        with self._lock:
            return list(self._latencies)

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
        outs, _ = self._forward([req], bucket)
        return self._unpad([req], bucket, outs)[0]

    def warmup(self) -> int:
        """Run one forward per bucket (on the card: build the kernels and
        capture the bucket's graph); returns the number of buckets run."""
        for bucket in self.buckets:
            self._forward([_Request(self._proto, Future())], bucket)
        return len(self.buckets)

    def start_metrics_server(self, host: str = "127.0.0.1", port: int = 0):
        """Serve this engine over HTTP (telemetry/http.py): GET /healthz
        gives `health()` as JSON (200 while serving, 503 after shutdown or
        the dispatcher's death), GET /metrics the Prometheus text of
        `stats()` and the process registry. `port=0` binds an ephemeral
        port; the server (`.port`, `.url`) is returned and `shutdown()`
        stops it. Loopback by default: pass host="0.0.0.0" on purpose."""
        if self._metrics_server is not None:
            return self._metrics_server
        from ..telemetry.http import serve_engine_metrics
        self._metrics_server = serve_engine_metrics(self, host=host,
                                                    port=port)
        return self._metrics_server

    def shutdown(self, wait: bool = True):
        """Stop accepting submissions and the metrics server; the
        dispatcher drains every queued request and exits. Idempotent."""
        server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.stop()
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
        """Zero the service counters (the graphs and the failure
        counters stay)."""
        with self._lock:
            self.requests_done = 0
            self.batches_run = 0
            self._occupancy_sum = 0.0
            self._real_node_slots = 0
            self._total_node_slots = 0
            self._real_edge_slots = 0
            self._total_edge_slots = 0
            self.max_queue_depth = 0
            self._latencies = []
            self.structure_requests = 0
            self.nbr_updates = 0
            self.nbr_rebuilds = 0

    def stats(self) -> dict:
        """Service counters: requests and batches, batch occupancy (real
        graphs over the chosen buckets' graph slots), padding fractions
        over the node and edge slots run, the failure and structure
        counters, the compile accounting and the graphs captured, the
        compute dtype and parity, and the request-latency percentiles
        (submit to result, ms). The counters are read under the lock, the
        percentiles computed outside it."""
        with self._lock:
            lat = list(self._latencies)
            out = {
                "requests": self.requests_done,
                "batches": self.batches_run,
                "batch_occupancy": (self._occupancy_sum / self.batches_run
                                    if self.batches_run else 0.0),
                "padding_frac_nodes": (
                    1.0 - self._real_node_slots / self._total_node_slots
                    if self._total_node_slots else 0.0),
                "padding_frac_edges": (
                    1.0 - self._real_edge_slots / self._total_edge_slots
                    if self._total_edge_slots else 0.0),
                "max_queue_depth": self.max_queue_depth,
                "captures": len(self.capture_ms),
                "compile_count": self.compile_count,
                "compile_store_hits": self.compile_store_hits,
                "compile_fresh": self.compile_fresh,
                "num_buckets": len(self.buckets),
                "compute_dtype": self.compute_dtype,
                "parity": self.parity,
                "tier": self.tier,
                "model_version": self.model_version,
                "swap_count": self.swap_count,
                "probe_count": self.probe_count,
                "batch_failures": self.batch_failures,
                "deadline_expired": self.deadline_expired,
                "queue_rejections": self.queue_rejections,
                "circuit_rejections": self.circuit_rejections,
                "trip_count": self.trip_count,
                "structure_requests": self.structure_requests,
                "nbr_updates": self.nbr_updates,
                "nbr_rebuilds": self.nbr_rebuilds,
                "nbr_rebuild_fraction": (
                    self.nbr_rebuilds / self.nbr_updates
                    if self.nbr_updates else 0.0),
            }
        out.update(latency_percentiles(lat))
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
        if (p.edge_attr is not None
                and sample.edge_attr.shape[1] != p.edge_attr.shape[1]):
            return ValueError(
                f"request edge_attr width {sample.edge_attr.shape[1]} != "
                f"engine schema width {p.edge_attr.shape[1]}")
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

    def _forward(self, reqs: List[_Request], bucket: PackBudget
                 ) -> Tuple[List[np.ndarray], str]:
        """(outputs, the model version that computed them)."""
        batch = self._collate_bucket([r.sample for r in reqs], bucket)
        with self._forward_lock:
            self._apply_swap()
            version = self.model_version
            self._prepare(bucket)
            if self.device.type == "cpu":
                return [o.numpy() for o in self._run(batch)], version
            if self._graph_ctx is None:
                self._graph_ctx = GraphContext(self.device,
                                               _take_stream(self.device))
            with torch.cuda.stream(self._graph_ctx.stream):
                cap = self._graphs.get(bucket)
                if cap is None:
                    cap = self._graphs[bucket] = self._capture(bucket, batch)
                else:
                    fill(cap.inputs, batch)
                cap.replay()
                return [o.cpu().numpy() for o in cap.outputs], version

    # holds-lock: _forward_lock
    def _prepare(self, bucket: PackBudget) -> None:
        """A bucket's first use: with a store, its kernel libraries from
        the bucket's entry (a hit installs them), or built here and saved
        there (fresh). The CPU runs the plain versions: its entries hold
        no library."""
        if bucket in self._compiled:
            return
        store = self._compile_store
        from_store = False
        if store is not None:
            key = self._store_key(bucket)
            cuda = self.device.type == "cuda"
            from_store = store.load(
                key, install=_build.install_libraries if cuda else None
            ) is not None
            if not from_store:
                store.save(key, _build.export_libraries() if cuda else
                           {"digest": _build._source_digest(), "libs": {},
                            "logs": {}})
        self._compiled.add(bucket)
        with self._lock:
            self.compile_count += 1
            if from_store:
                self.compile_store_hits += 1
            else:
                self.compile_fresh += 1

    def _store_key(self, bucket: PackBudget) -> str:
        """The compile-store key of one bucket: the JAX engine's fields
        (model config, bucket shape, shard count, neighbour width, EF,
        request schema, the precision mode: the compute dtype and, at
        int8, the calibration's digest) and the port's runtime (the
        device's kind and compute capability, the kernel sources'
        digest)."""
        p = self._proto
        schema = tuple(
            (name, None if getattr(p, name) is None
             else tuple(np.shape(getattr(p, name))[1:]))
            for name in ("x", "pos", "edge_attr", "edge_shifts", "cell"))
        capability = (torch.cuda.get_device_capability(self.device)
                      if self.device.type == "cuda" else None)
        return CompileStore.fingerprint(
            self.mcfg, (bucket.n_node, bucket.n_edge, bucket.n_graph), 1,
            self.neighbor_k, self.ef_forward, schema,
            (self.device.type, capability, _build._source_digest()),
            precision=(self.compute_dtype, self._quant_digest))

    def _release_graphs(self) -> None:
        """Drop the captured graphs and their pool (the dispatcher's
        exit), under the forward lock and the device's capture lock; hand
        the freed blocks back to CUDA and the stream to the next
        engine."""
        if self.device.type != "cuda":
            return
        with self._forward_lock:
            with capture_lock(self.device):
                ctx, self._graph_ctx = self._graph_ctx, None
                if ctx is None:
                    return
                ctx.stream.synchronize()
                self._graphs = {}
                stream = ctx.stream
                del ctx
                torch.cuda.empty_cache()
                with _FREE_STREAMS_LOCK:
                    _FREE_STREAMS.setdefault(self.device, []).append(stream)

    def _capture(self, bucket: PackBudget, batch: GraphBatch):
        """The bucket's graph, captured from a forward of `batch` (the
        warm-up runs and the captured call compute on it) on the graph
        context's stream."""
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

    def _fail_expired(self, req: _Request) -> None:
        with self._lock:
            self.deadline_expired += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExceededError(
                f"deadline expired after "
                f"{(time.perf_counter() - req.t_submit) * 1e3:.1f} ms "
                "in queue"))

    def _record_batch_failure(self) -> None:
        with self._lock:
            self.batch_failures += 1
            self._consec_failures += 1
            trip = (self._breaker_state == "half_open"
                    or (self._breaker_state == "closed"
                        and self.breaker_threshold > 0
                        and self._consec_failures >= self.breaker_threshold))
            if trip:
                self._breaker_state = "open"
                self._open_until = time.monotonic() + self.breaker_reset_s
                self.trip_count += 1

    def _record_batch_success(self) -> None:
        with self._lock:
            self._consec_failures = 0
            self._breaker_state = "closed"

    def _check_device(self) -> None:
        """After a failed batch: raise if the card no longer synchronises
        (a sticky CUDA error, which ends the dispatcher)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _execute(self, reqs: List[_Request]):
        # requests that expired while queued or coalescing resolve here
        # and take no slot in the batch
        now = time.perf_counter()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._fail_expired(r)
            else:
                live.append(r)
        reqs = live
        if not reqs:
            with self._lock:
                if self._breaker_state == "half_open":
                    # the probe expired unexecuted: re-open, so the next
                    # submit probes
                    self._breaker_state = "open"
            return
        try:
            fault_point("serving-dispatch")
            bucket = select_bucket(self.buckets, len(reqs),
                                   sum(r.n for r in reqs),
                                   sum(r.e for r in reqs))
            if bucket is None:
                raise RuntimeError(
                    f"internal error: a coalesced batch of {len(reqs)} "
                    "requests fits no bucket")
            # request spans: each request's queue wait (submit to
            # dispatch), then the batch's forward and unpad; one recorder
            # check a batch when off
            rec = _spans.current_recorder()
            if rec is not None:
                t_disp = _spans.now()
                for r in reqs:
                    rec.add("serve.queue_wait", r.t_submit,
                            t_disp - r.t_submit, "serving")
                t_fwd = _spans.now()
            outs, version = self._forward(reqs, bucket)
            if rec is not None:
                rec.add("serve.forward", t_fwd, _spans.now() - t_fwd,
                        "serving",
                        {"bucket": [bucket.n_node, bucket.n_edge,
                                    bucket.n_graph],
                         "requests": len(reqs), "parity": self.parity})
                t_unpad = _spans.now()
            results = self._unpad(reqs, bucket, outs)
            if rec is not None:
                rec.add("serve.unpad", t_unpad, _spans.now() - t_unpad,
                        "serving")
        except Exception as e:  # noqa: BLE001 — must reach the callers
            # a failed batch resolves only its own futures; the breaker
            # decides whether to keep admitting
            self._record_batch_failure()
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(e)
            self._check_device()
            return
        self._record_batch_success()
        done = time.perf_counter()
        tot_n = sum(r.n for r in reqs)
        tot_e = sum(r.e for r in reqs)
        with self._lock:
            self.batches_run += 1
            self.requests_done += len(reqs)
            self._occupancy_sum += len(reqs) / bucket.cap_graphs
            self._real_node_slots += tot_n
            self._real_edge_slots += tot_e
            self._total_node_slots += bucket.n_node
            self._total_edge_slots += bucket.n_edge
            self._latencies.extend(done - r.t_submit for r in reqs)
        for req, res in zip(reqs, results):
            req.future.bucket = bucket
            req.future.parity = self.parity
            req.future.parity_rtol = self.parity_rtol
            req.future.parity_atol = self.parity_atol
            req.future.model_version = version
            req.future.tier = self.tier
            req.future.set_result(res)

    def _coalesce(self, first: _Request, wait: bool = True):
        """Greedy arrival-order coalescing: grow the batch while the next
        request fits the largest bucket's node/edge budget and graph
        capacity; flush at max_batch_size requests or max_wait_ms after
        `first` was dequeued. An expired request met on the way resolves
        and is skipped. Returns (requests, leftover_or_sentinel)."""
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
            if nxt is _SHUTDOWN:
                leftover = nxt
                break
            if (nxt.deadline is not None
                    and time.perf_counter() > nxt.deadline):
                self._fail_expired(nxt)
                continue
            if nxt.n > rem_n or nxt.e > rem_e:
                leftover = nxt
                break
            reqs.append(nxt)
            rem_n -= nxt.n
            rem_e -= nxt.e
        return reqs, leftover

    def _fast_fail(self, req: _Request) -> bool:
        """Resolve with an error (True) a dequeued request that must not
        enter a batch: an expired deadline, or a request queued behind an
        open breaker. Past the probe window the breaker turns half-open
        and the request goes through as the probe."""
        if req.deadline is not None and time.perf_counter() > req.deadline:
            self._fail_expired(req)
            with self._lock:
                if self._breaker_state == "half_open":
                    # the probe expired unexecuted: re-open, or half_open
                    # would refuse everyone for good
                    self._breaker_state = "open"
            return True
        err = None
        with self._lock:
            if self._breaker_state == "open":
                if time.monotonic() < self._open_until:
                    self.circuit_rejections += 1
                    err = CircuitOpenError(
                        f"circuit open after {self.trip_count} trip(s); "
                        "request was queued before the trip")
                else:
                    self._breaker_state = "half_open"
                    self.probe_count += 1
        if err is None:
            return False
        if not req.future.done():
            req.future.set_exception(err)
        return True

    def _loop(self):
        pending = None
        try:
            while True:
                if pending is None:
                    req = self._queue.get()
                else:
                    req, pending = pending, None
                if req is _SHUTDOWN:
                    break
                if self._fast_fail(req):
                    continue
                reqs, pending = self._coalesce(req)
                self._execute(reqs)
        except Exception as e:  # noqa: BLE001 — recorded for every caller
            with self._lock:
                self._fatal = e
        finally:
            # drain what is still queued: a shutdown, or the dispatcher's
            # death, never leaves a caller's future hanging
            with self._lock:
                fatal = self._fatal
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is _SHUTDOWN:
                    continue
                if fatal is not None:
                    if not req.future.done():
                        req.future.set_exception(fatal)
                    continue
                reqs, leftover = self._coalesce(req, wait=False)
                try:
                    self._execute(reqs)
                except Exception as e:  # noqa: BLE001 — a sticky error
                    with self._lock:
                        self._fatal = fatal = e
                if leftover is not None and leftover is not _SHUTDOWN:
                    self._queue.put(leftover)
            with self._lock:
                closed = self._closed
            if closed:
                try:
                    self._release_graphs()
                except RuntimeError as exc:  # a sticky CUDA error
                    _log.warning("serving engine: releasing its graphs "
                                 "failed (%s)", exc)


class StructureSession:
    """One trajectory client's raw-structure handle: the Verlet-skin
    NeighborList its `submit_structure` calls share. From
    `InferenceEngine.structure_session()`; use from one client at a
    time."""

    __slots__ = ("nlist",)

    def __init__(self, nlist: NeighborList):
        self.nlist = nlist

    @property
    def rebuild_fraction(self) -> float:
        """Rebuilds over updates for this trajectory."""
        return self.nlist.rebuild_fraction
