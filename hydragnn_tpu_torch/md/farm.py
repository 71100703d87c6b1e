"""Device-resident MD: a trajectory farm that advances T independent
trajectories of one system shape K velocity-Verlet steps a dispatch
(counterpart: hydragnn_tpu/md/farm.py).

The single-session loop (md/loop.run_md) round-trips every step through
the host: the neighbour list's re-filter, the sample build, one structure
a forward. The farm keeps T trajectories on the device and batches twice:

* over trajectories: one EF forward (forces = -dE/dpos) serves all T
  structures, laid out as a T-fold replica of the engine's one bucket
  (trajectory t owns nodes [t n_node, (t + 1) n_node), edges
  [t n_edge, (t + 1) n_edge) and graph slots [t n_graph, (t + 1)
  n_graph), each padded exactly as the session's collated bucket), with
  the engine's `energy_forces_from_node_head` composition;
* over steps: K whole steps run per dispatch, on the card as one CUDA
  graph replay (`train/step_graphs.capture`, one graph per (T, n,
  candidate capacity, degree capacity), over static buffers). Between
  replays the host reads one small status tensor and rebuilds, on its
  own `NeighborList`, each trajectory that crossed its skin bound, about
  3-7 % of steps.

A step, in the JAX package's order: drift; the displacement check
against skin/2; the batched re-filter of each trajectory's candidate
cache (`make_batched_refilter`: the cutoff and the `max_neighbours` cap
rule of `graphs/radius._dense_select`); the compaction of the kept
candidates, in candidate order, into the trajectory's edge slots; the
forward; `accel_term` and `kick`; the masked state updates. A trajectory
that crossed its skin bound (or outgrew the bucket's edges) freezes
until the host has swapped its rebuilt cache in.

Bitwise contract: each trajectory equals the session loop's bit for bit,
positions and velocities, at any T and K. The integrator, the
displacement check and the re-filter's d² are exact on the grid
(md/integrator.py), so device and host agree on every value and every
decision (the farm checks the host's rebuild verdict against the
device's); rebuilds run on the session's own `NeighborList` class; and
per trajectory the forward sees the session's rows, edges in the
session's order, and kernels whose sums depend only on a segment's own
rows. The dense layers are the one place where the row count could
change a row's bits: the library GEMM may pick another kernel for
T n_node rows than for the session's n_node (on the H100, cuBLAS does so
for the node-level layers with a bias: 256 rows and 131,072 round
differently). So each dispatch key probes every linear layer of the
forward once (`dense_routes`) for the most trajectories G (a divisor of
T) whose [G r, in] products (and input gradients) equal G products of
the session's r rows bit for bit; the layer then runs as T / G products
of G r rows (T / G GEMM launches inside the graph; G = T is one
product). Energies are held to rtol 1e-9, as in the JAX package (whose
batched pooling may reassociate).

The JAX package's scatters drop out-of-range writes (`mode="drop"`);
torch has no such mode, so dropped writes go to an explicit trash row or
slot here. Nothing in a dispatch reads back to the host.

One farm per (system shape, model); not thread-safe.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graphs.batch import GraphBatch, collate
from ..graphs.neighborlist import NeighborList
from ..graphs.radius import _segment_layout
from ..telemetry import spans as _spans
from ..telemetry.registry import get_registry
from ..train.loss import energy_forces_from_node_head
from ..train.step_graphs import GraphContext, capture
from ..train.train_step import make_forward_fn
from ..utils.devices import resolve_device
from ..utils.weights import (export_jax_variables, load_jax_variables,
                             variables_signature)
from . import integrator as mdi

_CAND_MULTIPLE = 64  # static candidate-capacity rounding (the packing
# headroom rides on top)
_DEG_MULTIPLE = 8

# the state a dispatch updates in place, and its dtypes
_STATE = ("pos", "vd", "ad2", "steps_done", "has_acc", "skip_drift",
          "frozen", "overflow", "coord_ok", "energy_first", "energy_last")


def _roundup(x: float, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def make_batched_refilter(n_atoms: int, r: float,
                          max_neighbours: Optional[int], w_cap: int):
    """The batched candidate re-filter: `fn(pos [T, n, 3], send, recv,
    valid, seg_start [T, C], off [T, C, 3]) -> keep [T, C]`, the torch
    mirror of `NeighborList._emit`'s keep decision (the cutoff and the
    `radius._dense_select` cap rule) on the candidate layout of
    `pack_candidates` (index tensors int64, positions and offsets
    float64).

    On the position grid every d² is exact, so the mask, cap ties
    included, equals the host's bit for bit. Padding candidates carry
    `valid` False, a self-pointing `seg_start` and receiver `n_atoms`;
    their writes into the dense [n_atoms + 2, w_cap] matrix go to trash
    row n_atoms + 1 (JAX drops them), and row n_atoms, which only
    padding receivers read, stays +inf."""
    r2 = float(r) * float(r)  # the host compares d2 <= self.r * self.r
    k = None if max_neighbours is None else int(max_neighbours)

    def refilter(pos, send, recv, valid, seg_start, off):
        T, C = send.shape
        # row n_atoms: the padding receivers' (values unread)
        pos_ext = torch.cat([pos, pos.new_zeros((T, 1, 3))], dim=1)
        ps = torch.gather(pos_ext, 1, send[..., None].expand(T, C, 3))
        pr = torch.gather(pos_ext, 1, recv[..., None].expand(T, C, 3))
        g = (ps + off) - pr  # exact on the grid
        d2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
            + g[..., 2] * g[..., 2]
        ok = valid & (d2 <= r2)
        if k is None or k >= w_cap:
            return ok  # no receiver can exceed the cap (host keep_all)
        if k <= 0:
            return torch.zeros_like(ok)
        cand = torch.arange(C, device=send.device)
        idx = cand - seg_start
        d2m = torch.where(ok, d2, torch.full_like(d2, float("inf")))
        row = torch.where(valid, recv, torch.full_like(recv, n_atoms + 1))
        mat = torch.full((T, (n_atoms + 2) * w_cap), float("inf"),
                         dtype=d2.dtype, device=d2.device)
        mat.scatter_(1, row * w_cap + idx, d2m)
        kth = torch.sort(mat.view(T, n_atoms + 2, w_cap), dim=2)[0][
            :, :, k - 1]
        kth_e = torch.gather(kth, 1, recv)
        strict = d2m < kth_e
        scount = torch.zeros((T, n_atoms + 2), dtype=torch.int64,
                             device=send.device)
        scount.scatter_add_(1, recv, strict.to(torch.int64))
        quota = k - torch.gather(scount, 1, recv)
        eq = d2m == kth_e
        eqi = eq.to(torch.int64)
        run = torch.cumsum(eqi, dim=1)
        base = torch.gather(run, 1, seg_start) - torch.gather(eqi, 1,
                                                               seg_start)
        eq_rank = run - base
        return (strict | (eq & (eq_rank <= quota))) & ok

    return refilter


def pack_candidates(nl: NeighborList, c_cap: int, w_cap: int,
                    n_atoms: int, *, pbc: bool,
                    capped: bool) -> Dict[str, np.ndarray]:
    """One trajectory's candidate cache in the static layout the batched
    re-filter reads: padding candidates with `valid` False, self-pointing
    `seg_start` and receiver `n_atoms`; per-candidate float64 ghost
    offsets and float32 cartesian shifts (PBC). Raises when the cache
    outgrew the static capacities."""
    cs, cr, off, shift32, ref = nl.export_candidates()
    c = len(cs)
    if c > c_cap:
        raise ValueError(
            f"trajectory candidate count {c} exceeds the farm's static "
            f"capacity {c_cap} — raise cand_headroom "
            "(HYDRAGNN_MD_FARM_CAND_HEADROOM) or rebuild the farm")
    out = {
        "send": np.zeros(c_cap, np.int32),
        "recv": np.full(c_cap, n_atoms, np.int32),
        "valid": np.zeros(c_cap, bool),
        "seg_start": np.arange(c_cap, dtype=np.int32),
        "off": np.zeros((c_cap, 3), np.float64),
        "ref": np.asarray(ref, np.float64),
    }
    if pbc:
        out["shift"] = np.zeros((c_cap, 3), np.float32)
    if c:
        seg_id, starts, idx = _segment_layout(cr)
        width = int(idx.max()) + 1
        if capped and width > w_cap:
            raise ValueError(
                f"trajectory candidate max degree {width} exceeds the "
                f"farm's static degree capacity {w_cap} — raise "
                "cand_headroom (HYDRAGNN_MD_FARM_CAND_HEADROOM) or "
                "rebuild the farm")
        out["send"][:c] = cs
        out["recv"][:c] = cr
        out["valid"][:c] = True
        out["seg_start"][:c] = starts[seg_id]
        if pbc:
            out["off"][:c] = off
            out["shift"][:c] = shift32
    return out


def _slices(x: torch.Tensor, parts: int):
    """`parts` equal row blocks of x (`split`: one backward node, a cat)."""
    return x.split(x.shape[0] // parts)


def dense_routes(model, forward, batch, T: int, variables=None,
                 seed: int = 0) -> Dict[str, int]:
    """{linear layer: G, the trajectories one product covers} for the
    T-fold `batch`: one forward records each linear layer's rows; then,
    on random inputs of those rows, the layer's output and its input
    gradient computed as T / G products of G r rows (r = rows / T) are
    held against T products of r rows, each on its own tensor (the
    session's shape), for G over T's divisors from T down; the first G
    equal bit for bit is the layer's. G = 1 must hold (RuntimeError
    otherwise). `variables` are the weights the forward substitutes
    (make_forward_fn's bf16 copies), if any."""
    seen = {}

    def hook(name):
        def record(mod, inputs, output):
            seen.setdefault(name, (mod, inputs[0].shape[0],
                                   inputs[0].dtype))
        return record

    hooks = [mod.register_forward_hook(hook(name))
             for name, mod in model.named_modules()
             if isinstance(mod, torch.nn.Linear)]
    try:
        with torch.no_grad():
            forward(batch)
    finally:
        for h in hooks:
            h.remove()
    dev = batch.pos.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    routes = {}
    for name, (mod, rows, dtype) in sorted(seen.items()):
        sub = None
        if variables is not None:
            sub = {k[len(name) + 1:]: v for k, v in variables.items()
                   if k.startswith(name + ".")}

        def call(x, mod=mod, sub=sub):
            if sub is None:
                return type(mod).forward(mod, x)
            return torch.func.functional_call(mod, sub, (x,))

        def run(x, go, parts):
            x = x.detach().requires_grad_(True)
            y = torch.cat([call(xs) for xs in _slices(x, parts)])
            (gx,) = torch.autograd.grad(y, x, go)
            return y.detach(), gx

        x = torch.randn(rows, mod.in_features, generator=gen, device=dev
                        ).to(dtype)
        go = torch.randn(rows, mod.out_features, generator=gen, device=dev
                         ).to(dtype)
        want = [run(xs.clone(), gs.clone(), 1)
                for xs, gs in zip(_slices(x, T), _slices(go, T))]

        def equal(got):
            return all(torch.equal(a, w[0]) and torch.equal(b, w[1])
                       for a, b, w in zip(_slices(got[0], T),
                                          _slices(got[1], T), want))
        for g in (g for g in range(T, 0, -1) if T % g == 0):
            if equal(run(x, go, T // g)):
                routes[name] = g
                break
        else:
            raise RuntimeError(
                f"farm: linear layer {name} at {rows} rows rounds "
                f"differently from {rows // T} rows even as per-trajectory "
                "products — the bitwise contract with the session cannot "
                "be kept")
    return routes


def _cache_tensor(key: str, arr: np.ndarray, device) -> torch.Tensor:
    """A packed cache array as the re-filter's tensor (indices int64)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if key in ("send", "recv", "seg_start"):
        t = t.to(torch.int64)
    return t.to(device)


class _Dispatch:
    """The static buffers of one (T, n, c_cap, w_cap) key: state, caches,
    the T-fold batch template, the status row, and on the card the
    captured K-step graph."""

    def __init__(self, T: int, n: int, caches: Dict[str, np.ndarray],
                 template: GraphBatch, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.T, self.n = T, n
        self.state = {
            "pos": torch.zeros((T, n, 3), **f64),
            "vd": torch.zeros((T, n, 3), **f64),
            "ad2": torch.zeros((T, n, 3), **f64),
            "steps_done": torch.zeros(T, dtype=torch.int32, device=device),
            "has_acc": torch.zeros(T, dtype=torch.bool, device=device),
            "skip_drift": torch.zeros(T, dtype=torch.bool, device=device),
            "frozen": torch.zeros(T, dtype=torch.bool, device=device),
            "overflow": torch.zeros(T, dtype=torch.bool, device=device),
            "coord_ok": torch.ones((), dtype=torch.bool, device=device),
            "energy_first": torch.zeros(T, **f64),
            "energy_last": torch.zeros(T, **f64),
        }
        self.caches = {key: _cache_tensor(key, arr, device)
                       for key, arr in caches.items()}
        self.template = template.to(device)
        self.steps_target = torch.zeros((), dtype=torch.int32, device=device)
        # frozen, steps_done, overflow, coord_ok: one host read a dispatch
        self.status = torch.zeros(3 * T + 1, dtype=torch.int32,
                                  device=device)
        self.graph = None
        self.refilter = None
        self.routes: Optional[Dict[str, int]] = None


class TrajectoryFarm:
    """T trajectories of one system shape on one model. Build it with
    `InferenceEngine.trajectory_farm` (the engine's model, weights,
    precision, bucket and device) or directly.

    `run(pos0 [T, n, 3], vel0 [T, n, 3], steps, node_features=, cell=)`
    integrates every trajectory `steps` velocity-Verlet steps and returns
    the final state and the farm's statistics. Initial conditions are
    snapped to the integrator grid as `run_md` snaps its own.

    The farm runs on a copy of the model with the variables it is given
    (a Flax `{"params", "batch_stats"}` tree): an engine's later hot swap
    does not reach it; `swap_variables` swaps the farm's own, in place,
    so the captured graphs need no recapture."""

    def __init__(self, model, variables, mcfg, structure_config, *,
                 bucket, dt: float, skin: float = 0.3, mass: float = 1.0,
                 force_scale: float = 1.0, steps_per_dispatch: int = 8,
                 cand_headroom: float = 0.5,
                 compute_dtype: Optional[str] = None, scorer=None,
                 device="cuda"):
        ds = structure_config["Dataset"]
        arch = structure_config["NeuralNetwork"]["Architecture"]
        if ds.get("rotational_invariance", False):
            raise ValueError(
                "trajectory farms need Dataset.rotational_invariance off "
                "— the incremental neighbor list tracks displacements in "
                "the raw frame (the structure_session contract)")
        if arch.get("edge_features") or ds.get("Descriptors"):
            raise ValueError(
                "trajectory farms do not support edge_features/"
                "Descriptors configs — per-edge geometric features would "
                "have to be rebuilt on-device every step; serve these "
                "through the per-step submit_structure path instead")
        if mcfg.heads[0].head_type != "node":
            raise ValueError(
                "trajectory farms serve energy+forces from a node-level "
                "energy head (the energy_force_loss convention); got a "
                f"{mcfg.heads[0].head_type!r} head 0")
        if scorer is not None:
            raise NotImplementedError(
                "trajectory_farm(scorer=...) (the active-learning "
                "ensemble scorer) is not ported to hydragnn_tpu_torch yet "
                "(ROADMAP A10: md/active.py)")
        self._cfg = structure_config
        self.pbc = bool(arch.get("periodic_boundary_conditions", False))
        self.radius = float(arch.get("radius") or 5.0)
        mn = arch.get("max_neighbours")
        self.max_neighbours = None if mn is None else int(mn)
        self.skin = float(skin)
        if not np.isfinite(self.skin) or self.skin < 0.0:
            raise ValueError(f"farm skin must be finite >= 0, got {skin}")
        self.dt = float(dt)
        if not self.dt > 0.0:
            raise ValueError(f"farm dt must be > 0, got {dt}")
        self.mass = float(mass)
        self.force_scale = float(force_scale)
        self.steps_per_dispatch = int(steps_per_dispatch)
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        self.cand_headroom = float(cand_headroom)
        if self.cand_headroom < 0.0:
            raise ValueError("cand_headroom must be >= 0, got "
                             f"{cand_headroom}")
        self.bucket = bucket
        self.mcfg = mcfg
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        variables = {"params": variables["params"],
                     "batch_stats": variables.get("batch_stats", {})}
        self._signature = variables_signature(variables)
        # the farm's own weights: a copy of the module, loaded from the
        # given tree (strict), never the caller's tensors
        self._model = copy.deepcopy(model).to(self.device).eval()
        self._model.load_state_dict(load_jax_variables(variables))
        if variables_signature(export_jax_variables(self._model)) != \
                self._signature:
            raise ValueError("farm variables do not match the model's "
                             "tree/shapes/dtypes")
        self._forward = make_forward_fn(self._model, mcfg, compute_dtype,
                                        frozen=True)
        self._dispatches: Dict[tuple, _Dispatch] = {}
        self._graph_ctx: Optional[GraphContext] = None
        # lifetime graph captures (a new dispatch key on the card)
        self.fresh_compiles = 0
        self.version = "farm-init"
        self._last: Optional[_Dispatch] = None
        # the last run's {linear layer: trajectories a product}
        # (`dense_routes`)
        self.dense_routes: Dict[str, int] = {}

    def swap_variables(self, variables, version: str) -> str:
        """Hot-swap the farm's weights: the tree must match the current
        one leaf for leaf in shape and dtype (ValueError before any
        change); the values are copied into the farm's own tensors, so
        the captured graphs serve the new weights from the next dispatch
        with no recapture. Returns the previous version tag."""
        new = {"params": variables["params"],
               "batch_stats": variables.get("batch_stats", {})}
        if variables_signature(new) != self._signature:
            raise ValueError(
                "swap rejected: the new tree/shapes/dtypes do not match "
                "the farm's — farms only hot-swap shape/dtype-compatible "
                "variables (rebuild the farm for a new architecture)")
        state = load_jax_variables(new)
        frozen = getattr(self._forward, "frozen_variables", None)
        with torch.no_grad():
            for name, t in self._model.state_dict().items():
                t.copy_(state[name])
            if frozen is not None:
                for name, t in list(self._model.named_parameters()) + \
                        list(self._model.named_buffers()):
                    frozen[name].copy_(t.to(frozen[name].dtype))
        old_version, self.version = self.version, str(version)
        return old_version

    @property
    def model(self):
        """The farm's own copy of the model."""
        return self._model

    @property
    def graphs(self) -> Dict[tuple, object]:
        """{(T, n, c_cap, w_cap): the captured K-step graph} (the card)."""
        return {key: d.graph for key, d in self._dispatches.items()
                if d.graph is not None}

    def batch_now(self) -> GraphBatch:
        """The T-fold batch the last run's next step would serve, at its
        current positions (for measuring the forward's shapes)."""
        if self._last is None:
            raise RuntimeError("batch_now: run the farm first")
        with torch.no_grad():
            return self._compact(self._last, self._last.state["pos"])[0]

    def routed(self):
        """A context in which the farm's model runs the last run's dense
        routes (for measuring the forward at the farm's shapes)."""
        if self._last is None:
            raise RuntimeError("routed: run the farm first")
        return self._routed(self._last)

    # ------------------------------------------------------------ packing

    def _pack_traj(self, nl: NeighborList, c_cap: int, w_cap: int,
                   n: int) -> Dict[str, np.ndarray]:
        return pack_candidates(nl, c_cap, w_cap, n, pbc=self.pbc,
                               capped=self.max_neighbours is not None)

    def _template(self, b0: GraphBatch, T: int) -> GraphBatch:
        """The T-fold replica of the session's collated bucket: node,
        edge and graph ids offset per replica; positions, edges, masks
        and shifts are written by each step."""
        node_graph = (b0.node_graph[None, :].to(torch.int64)
                      + self.bucket.n_graph * torch.arange(T)[:, None]
                      ).reshape(-1)
        return GraphBatch(
            x=b0.x.repeat(T, 1), pos=b0.pos.repeat(T, 1),
            senders=b0.senders.repeat(T), receivers=b0.receivers.repeat(T),
            node_graph=node_graph.to(torch.int32),
            node_mask=b0.node_mask.repeat(T),
            edge_mask=b0.edge_mask.repeat(T),
            graph_mask=b0.graph_mask.repeat(T),
            edge_shifts=(None if b0.edge_shifts is None
                         else b0.edge_shifts.repeat(T, 1)),
            cell=None if b0.cell is None else b0.cell.repeat(T, 1, 1))

    # ----------------------------------------------------------- the step

    def _compact(self, d: _Dispatch, p_new: torch.Tensor):
        """(the T-fold batch at positions `p_new`, kept edges [T]): the
        re-filter's kept candidates, in candidate order, go to the
        trajectory's edge slots, the rest (and any overflow) to the trash
        slot e_cap; unfilled slots read the padding sentinel."""
        ca, tpl = d.caches, d.template
        T, n = d.T, d.n
        n_node, e_cap = self.bucket.n_node, self.bucket.n_edge
        dev = p_new.device
        keep = d.refilter(p_new, ca["send"], ca["recv"], ca["valid"],
                          ca["seg_start"], ca["off"])
        C = keep.shape[1]
        ki = keep.to(torch.int64)
        cnt = ki.sum(dim=1)
        rank = torch.cumsum(ki, dim=1) - 1
        slot = torch.where(keep & (rank < e_cap), rank,
                           torch.full_like(rank, e_cap))
        cidx = torch.full((T, e_cap + 1), C, dtype=torch.int64, device=dev)
        cidx.scatter_(1, slot, torch.arange(C, device=dev).expand(T, C))
        cidx = cidx[:, :e_cap]
        pad = torch.full((T, 1), n_node - 1, dtype=torch.int64, device=dev)
        senders = torch.gather(torch.cat([ca["send"], pad], 1), 1, cidx)
        receivers = torch.gather(torch.cat([ca["recv"], pad], 1), 1, cidx)
        node_off = (torch.arange(T, device=dev) * n_node)[:, None]
        emask = torch.arange(e_cap, device=dev)[None, :] < cnt[:, None]
        posf = torch.zeros((T, n_node, 3), dtype=torch.float32, device=dev)
        posf[:, :n] = p_new.to(torch.float32)
        eshift = None
        if "shift" in ca:
            shift_ext = torch.cat([ca["shift"], ca["shift"].new_zeros(
                (T, 1, 3))], 1)
            eshift = torch.gather(
                shift_ext, 1, cidx[..., None].expand(T, e_cap, 3)
            ).reshape(T * e_cap, 3)
        batch = tpl.replace(
            pos=posf.reshape(T * n_node, 3),
            senders=(senders + node_off).reshape(-1).to(torch.int32),
            receivers=(receivers + node_off).reshape(-1).to(torch.int32),
            edge_mask=emask.reshape(-1), edge_shifts=eshift)
        return batch, cnt

    def _step(self, d: _Dispatch, s_hi: float, s_lo: float,
              bound2: float) -> None:
        """One MD step of every trajectory, in place on d's buffers."""
        st = d.state
        T, n = d.T, d.n
        n_node, e_cap = self.bucket.n_node, self.bucket.n_edge
        n_graph = self.bucket.n_graph
        act = (~st["frozen"]) & (st["steps_done"] < d.steps_target)
        do_drift = act & st["has_acc"] & (~st["skip_drift"])
        drifted = mdi.drift_torch(st["pos"], st["vd"], st["ad2"])
        p_new = torch.where(do_drift[:, None, None], drifted, st["pos"])
        disp2 = mdi.displacement2_torch(p_new, d.caches["ref"])
        viol = act & (torch.amax(disp2, dim=1) > bound2)
        batch, cnt = self._compact(d, p_new)
        graph_e, forces = energy_forces_from_node_head(self._forward, batch)
        over = act & (~viol) & (cnt > e_cap)
        adv = act & (~viol) & (~over)
        acc_new = mdi.accel_term_torch(
            forces.view(T, n_node, 3)[:, :n], s_hi, s_lo)
        vd_new = mdi.kick_torch(st["vd"], st["ad2"], acc_new)
        e = graph_e.view(T, n_graph)[:, 0].to(torch.float64)
        first = adv & (~st["has_acc"])
        stepped = adv & st["has_acc"]
        new = {
            "pos": p_new,
            "vd": torch.where(stepped[:, None, None], vd_new, st["vd"]),
            "ad2": torch.where(adv[:, None, None], acc_new, st["ad2"]),
            "steps_done": st["steps_done"] + stepped.to(torch.int32),
            "has_acc": st["has_acc"] | adv,
            "skip_drift": st["skip_drift"] & (~adv),
            "frozen": st["frozen"] | viol | over,
            "overflow": st["overflow"] | over,
            "coord_ok": st["coord_ok"] & (torch.amax(torch.abs(p_new))
                                          <= mdi.COORD_LIMIT),
            "energy_first": torch.where(first, e, st["energy_first"]),
            "energy_last": torch.where(adv, e, st["energy_last"]),
        }
        for key in _STATE:
            st[key].copy_(new[key])

    def _k_steps(self, d: _Dispatch, s_hi, s_lo, bound2):
        """K steps, then the status row: the dispatch body."""
        for _ in range(self.steps_per_dispatch):
            self._step(d, s_hi, s_lo, bound2)
        st = d.state
        d.status.copy_(torch.cat([
            st["frozen"].to(torch.int32), st["steps_done"],
            st["overflow"].to(torch.int32),
            st["coord_ok"].to(torch.int32).view(1)]))
        return d.status

    @contextlib.contextmanager
    def _routed(self, d: _Dispatch):
        """The farm model's linear layers on d's routes for the body: a
        layer of G < T trajectories a product computes T / G products (an
        instance `forward`, taken off again after)."""
        mods = dict(self._model.named_modules())
        split = [(mods[name], d.T // g) for name, g in d.routes.items()
                 if g < d.T]
        for mod, parts in split:
            cls_forward = type(mod).forward

            def forward(x, mod=mod, cls_forward=cls_forward, parts=parts):
                return torch.cat([cls_forward(mod, xs)
                                  for xs in _slices(x, parts)])
            mod.forward = forward
        try:
            yield
        finally:
            for mod, _ in split:
                del mod.forward

    def _capture(self, d: _Dispatch, body) -> None:
        if self._graph_ctx is None:
            self._graph_ctx = GraphContext(self.device)
        snapshot = {key: t.clone() for key, t in d.state.items()}

        def restore(device: bool):
            if device:
                for key, t in d.state.items():
                    t.copy_(snapshot[key])

        d.graph = capture(self._graph_ctx, body, restore,
                          error_mode="thread_local")
        self.fresh_compiles += 1

    # ----------------------------------------------------------------- run

    def run(self, pos0, vel0, steps: int, *, node_features,
            cell=None) -> Dict:
        """Integrate T trajectories `steps` velocity-Verlet steps.

        `pos0` / `vel0`: [T, n_atoms, 3]; `node_features`: [n_atoms, F] in
        the dataset layout, shared by the trajectories; `cell`: [3, 3],
        required under PBC, shared. Returns the final positions and
        velocities, each trajectory's first and last energy and the
        farm's statistics (dispatches, rebuild swaps, and the time of the
        replays and of the host's work between them)."""
        from ..preprocess.transforms import build_graph_sample

        pos0 = np.asarray(pos0, np.float64)
        vel0 = np.asarray(vel0, np.float64)
        if pos0.ndim != 3 or pos0.shape[-1] != 3 or pos0.shape != vel0.shape:
            raise ValueError(
                "farm run needs pos0/vel0 of shape [T, n_atoms, 3]; got "
                f"{pos0.shape} / {vel0.shape}")
        T, n, _ = pos0.shape
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if self.pbc and cell is None:
            raise ValueError("periodic farm needs a [3, 3] cell")
        if n + 1 > self.bucket.n_node:
            raise ValueError(
                f"{n} atoms exceed the farm bucket's node capacity "
                f"{self.bucket.n_node - 1}")
        node_features = np.asarray(node_features, np.float32)

        # grid state, snapped as run_md snaps it
        pos, vd = mdi.init_state(pos0, vel0, self.dt)
        cellq = mdi.quantize_cell(cell) if self.pbc else None
        mdi.validate_ranges(float(np.abs(pos).max(initial=0.0)),
                            self.radius + self.skin)
        s_hi, s_lo = mdi.force_scale_split(self.dt, self.force_scale,
                                           self.mass)

        # one host neighbour list a trajectory; the first build is
        # rebuild 1, as a session's first update
        nls: List[NeighborList] = [
            NeighborList(self.radius, self.skin,
                         max_neighbours=self.max_neighbours,
                         pbc=(True, True, True) if self.pbc else None)
            for _ in range(T)]
        counts, widths = [], []
        edges0 = None
        for t in range(T):
            send, recv, shifts, _ = nls[t].update(
                pos[t], cell=cellq if self.pbc else None)
            if t == 0:
                edges0 = (send, recv, shifts)
            cs, cr, *_ = nls[t].export_candidates()
            counts.append(len(cs))
            if len(cr):
                widths.append(int(_segment_layout(cr)[2].max()) + 1)
        c_cap = _roundup(max(max(counts), 1) * (1.0 + self.cand_headroom),
                         _CAND_MULTIPLE)
        w_cap = _roundup(max(max(widths) if widths else 1, 1)
                         * (1.0 + self.cand_headroom), _DEG_MULTIPLE)

        # the batch template from the engine's own collate conventions
        sample0 = build_graph_sample(node_features, pos[0], self._cfg,
                                     cell=cellq, edges=edges0,
                                     with_targets=False)
        if sample0.edge_attr is not None:
            raise ValueError("farm configs must not produce edge_attr")
        b0 = collate([sample0], n_node=self.bucket.n_node,
                     n_edge=self.bucket.n_edge, n_graph=self.bucket.n_graph)
        b0 = b0.replace(y_graph=None, y_node=None, energy=None, forces=None)
        packed = [self._pack_traj(nls[t], c_cap, w_cap, n) for t in range(T)]
        caches = {key: np.stack([p[key] for p in packed])
                  for key in packed[0]}

        key = (T, n, c_cap, w_cap)
        d = self._dispatches.get(key)
        if d is None:
            d = self._dispatches[key] = _Dispatch(
                T, n, caches, self._template(b0, T), self.device)
        else:
            for name, arr in caches.items():
                d.caches[name].copy_(_cache_tensor(name, arr, self.device))
            tpl = self._template(b0, T)
            for f in ("x", "cell"):
                if getattr(tpl, f) is not None:
                    getattr(d.template, f).copy_(getattr(tpl, f))
        st = d.state
        with torch.no_grad():
            st["pos"].copy_(torch.from_numpy(pos))
            st["vd"].copy_(torch.from_numpy(vd))
            for name in ("ad2", "energy_first", "energy_last", "steps_done"):
                st[name].zero_()
            for name in ("has_acc", "skip_drift", "frozen", "overflow"):
                st[name].fill_(False)
            st["coord_ok"].fill_(True)
            d.steps_target.fill_(steps)
        d.refilter = make_batched_refilter(n, self.radius,
                                           self.max_neighbours, w_cap)
        self._last = d
        # NeighborList._needs_rebuild's expression: the same float, the
        # same strict > comparison
        bound2 = (0.5 * self.skin) ** 2

        if d.routes is None:
            d.routes = dense_routes(
                self._model, self._forward, self._compact(d, st["pos"])[0],
                T, getattr(self._forward, "frozen_variables", None))
        self.dense_routes = dict(d.routes)

        def body():
            with self._routed(d):
                return self._k_steps(d, s_hi, s_lo, bound2)

        on_card = self.device.type == "cuda"
        fresh_before = self.fresh_compiles
        if on_card and d.graph is None:
            self._capture(d, body)
        if on_card:
            # the replays' device time (CUDA events), beside the host's
            events = []

        reg = get_registry()
        swaps = dispatches = 0
        host_s = 0.0
        t_start = time.perf_counter()
        last_done = -1
        while True:
            t0 = _spans.now()
            if on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                d.graph.replay()
                ev[1].record()
                events.append(ev)
                ev[1].synchronize()
            else:
                body()
            dispatches += 1
            t_host = time.perf_counter()
            status = d.status.cpu().numpy()
            frozen = status[:T].astype(bool)
            done = int(status[T:2 * T].sum())
            overflow = status[2 * T:3 * T].astype(bool)
            if overflow.any():
                raise ValueError(
                    f"{int(overflow.sum())} trajectorie(s) exceeded the "
                    f"bucket edge capacity {self.bucket.n_edge} mid-run — "
                    "rebuild the farm with a roomier bucket (the engine "
                    "rejects such requests the same way)")
            if not status[3 * T]:
                raise ValueError(
                    "trajectory coordinates exceeded the grid "
                    f"integrator's exact range ({mdi.COORD_LIMIT}) — the "
                    "bitwise contract cannot be kept; recenter or shrink "
                    "the system")
            rec = _spans.current_recorder()
            if rec is not None:
                rec.add("md.farm_dispatch", t0, _spans.now() - t0, "md",
                        {"frozen": int(frozen.sum()), "steps_done": done})
            if done >= steps * T:
                host_s += time.perf_counter() - t_host
                break
            idx = np.flatnonzero(frozen)
            if idx.size == 0 and done == last_done:
                raise RuntimeError(
                    "farm made no progress in a dispatch with no frozen "
                    "trajectories — internal scheduling bug")
            last_done = done
            if idx.size:
                self._swap_in(d, nls, idx, cellq, c_cap, w_cap, n)
                swaps += int(idx.size)
            host_s += time.perf_counter() - t_host
        wall = time.perf_counter() - t_start
        replay_s = (sum(a.elapsed_time(b) for a, b in events) / 1e3
                    if on_card else wall - host_s)
        # copies: on the CPU the buffers are the next run's state
        final_pos, final_vd, e_first, e_last = (
            st[k].cpu().numpy().copy()
            for k in ("pos", "vd", "energy_first", "energy_last"))

        total_steps = steps * T
        reg.counter_inc("md.farm_steps_total", float(total_steps),
                        help="MD steps completed by trajectory farms")
        reg.counter_inc("md.farm_rebuild_swaps_total", float(swaps),
                        help="candidate-cache rebuild swaps performed by "
                             "trajectory farms")
        reg.counter_inc("md.farm_dispatches_total", float(dispatches),
                        help="device dispatches issued by trajectory "
                             "farms")
        reg.gauge_set("md.farm_steps_per_dispatch",
                      total_steps / dispatches if dispatches else 0.0,
                      help="completed steps per device dispatch "
                           "(aggregate over trajectories) of the last "
                           "farm run")
        reg.log_event(
            "md", "farm_run",
            data={"trajectories": T, "atoms": n, "steps": steps,
                  "rebuild_swaps": swaps, "dispatches": dispatches,
                  "steps_per_dispatch": self.steps_per_dispatch,
                  "cand_capacity": c_cap, "harvested": None},
            timing={"wall_s": wall,
                    "aggregate_steps_per_s": (total_steps / wall
                                              if wall > 0 else None)})
        return {
            "trajectories": T,
            "atoms": n,
            "steps": steps,
            "final_pos": final_pos,
            "final_vel": final_vd / self.dt,
            "energy_first": e_first,
            "energy_last": e_last,
            "wall_s": round(wall, 4),
            "aggregate_steps_per_s": (round(total_steps / wall, 3)
                                      if wall > 0 else None),
            "per_traj_steps_per_s": (round(steps / wall, 3)
                                     if wall > 0 else None),
            "dispatches": dispatches,
            "steps_per_dispatch": self.steps_per_dispatch,
            "steps_per_dispatch_effective": (
                round(total_steps / (dispatches * T), 3)
                if dispatches else None),
            "rebuild_swaps": swaps,
            "rebuild_fraction": round(swaps / total_steps, 4),
            "per_traj_rebuilds": [nl.rebuilds - 1 for nl in nls],
            "cand_capacity": c_cap,
            "max_degree_capacity": w_cap,
            "fresh_compiles_run": self.fresh_compiles - fresh_before,
            "capture_ms": (d.graph.capture_ms if d.graph is not None
                           else None),
            # the replays (CUDA events; on the CPU the eager bodies) and
            # the host's status reads and swaps, over the run
            "replay_s": replay_s,
            "host_s": host_s,
            "harvest": None,
            "max_uncertainty": None,
            "unc_trace": None,
            "adv_trace": None,
            "step_trace": None,
        }

    def _swap_in(self, d: _Dispatch, nls, idx: np.ndarray, cellq, c_cap,
                 w_cap, n) -> None:
        """Rebuild the frozen trajectories `idx` on their host neighbour
        lists, copy their caches into the static buffers in place and
        resume them with the drift skipped (their positions are the
        drifted ones already)."""
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        p = d.state["pos"].index_select(0, idx_t).cpu().numpy()
        packs = []
        for j, t in enumerate(idx):
            _s, _r, _sh, rebuilt = nls[int(t)].update(
                p[j], cell=cellq if self.pbc else None)
            if not rebuilt:
                raise RuntimeError(
                    "device flagged a skin-bound violation the host "
                    "NeighborList does not see — the grid exactness "
                    "contract is broken (report this)")
            packs.append(self._pack_traj(nls[int(t)], c_cap, w_cap, n))
        with torch.no_grad():
            for key, buf in d.caches.items():
                rows = _cache_tensor(key, np.stack([pk[key] for pk in packs]),
                                     self.device)
                buf.index_copy_(0, idx_t, rows)
            d.state["frozen"].index_fill_(0, idx_t, False)
            d.state["skip_drift"].index_fill_(0, idx_t, True)
