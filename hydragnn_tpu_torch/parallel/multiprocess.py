"""Multi-process data wiring for run_training (counterpart:
hydragnn_tpu/parallel/multiprocess.py).

Every rank holds a slice of the data, runs the same program and meets
the others at its collectives; whatever shapes that program (the padded
batch, the neighbour K, the pna_deg histogram, the normalization ranges)
must be the same on every rank, so it is reduced over the group first:

* `validate_multiprocess_spmd`: the per-rank loader's shard count and
  batch size from the global ones (one device per rank);
* `allreduce_max_int` / `sync_config_stats`: global statistics from each
  rank's local ones;
* `assert_equal_across_processes`: equal step counts, or the collectives
  would deadlock (bounded by HYDRAGNN_RENDEZVOUS_TIMEOUT_S);
* `slice_by_process`: a contiguous per-rank slice of replicated data
  (HYDRAGNN_MP_DATA=replicated);
* `packing_process_coords`: (pack_rank, pack_nproc) for slicing one
  global pack plan.

The pure pieces take `nproc` / `rank` arguments, default the group's.
Collectives run on the CPU under gloo and on the rank's card under NCCL,
which takes device tensors only.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import get_comm_size_and_rank

_LOG = logging.getLogger("hydragnn_tpu_torch")


class RendezvousTimeoutError(RuntimeError):
    """A bounded cross-process collective expired: a peer never arrived."""


def _run_bounded(fn, timeout_s: Optional[float], what: str):
    """Run a blocking collective with a wall-clock bound: it runs on a
    daemon thread, and expiry raises RendezvousTimeoutError in the caller
    (the thread stays blocked until the process exits: the caller is
    expected to abort). `timeout_s` None or <= 0: unbounded."""
    if not timeout_s or timeout_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name=f"bounded-collective:{what}")
    t.start()
    if not done.wait(timeout=float(timeout_s)):
        nproc, rank = get_comm_size_and_rank()
        raise RendezvousTimeoutError(
            f"{what}: cross-process collective timed out after "
            f"{timeout_s:g}s — at least one of the {nproc} processes "
            f"(a rank in 0..{nproc - 1} other than this process, rank "
            f"{rank}) never reached it. A dead or wedged peer rank "
            "cannot be recovered in place: abort every rank and restart "
            "the job from LATEST")
    if "error" in box:
        raise box["error"]
    return box["value"]


def is_multiprocess() -> bool:
    return get_comm_size_and_rank()[0] > 1


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the rank's card
    under NCCL, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def validate_multiprocess_spmd(num_shards: int, batch_size: int,
                               nproc: Optional[int] = None,
                               nlocal: int = 1):
    """(local shards, local batch size) for a global SPMD run of
    `num_shards` shards over `nproc` ranks of `nlocal` devices each (one:
    a rank drives one device, so `num_shards` must equal the world)."""
    nproc = nproc or get_comm_size_and_rank()[0]
    if num_shards % nproc:
        raise ValueError(
            f"num_shards {num_shards} must divide evenly over "
            f"{nproc} processes")
    if batch_size % nproc:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over "
            f"{nproc} processes")
    local_shards = num_shards // nproc
    if local_shards > nlocal:
        raise ValueError(
            f"{local_shards} shards per process > {nlocal} local devices")
    return local_shards, batch_size // nproc


def packing_process_coords(mp_data: str, nproc: Optional[int] = None,
                           rank: Optional[int] = None):
    """(pack_rank, pack_nproc): every rank packs the same global order
    over the full replicated data and takes its bin slice a step. Per-host
    shards (HYDRAGNN_MP_DATA=local) have no global order, so packing is
    refused there."""
    if mp_data != "replicated":
        raise ValueError(
            "batch packing requires replicated input data in multi-process "
            "runs: per-host shards (HYDRAGNN_MP_DATA=local / GraphStore "
            "shard dirs) have no global sample order to compute one pack "
            "plan from, and rank-local plans would diverge in step count "
            "and deadlock the collectives — disable "
            "Training.batch_packing / HYDRAGNN_PACKING or use "
            "HYDRAGNN_MP_DATA=replicated")
    world, grank = get_comm_size_and_rank()
    return (grank if rank is None else rank), (nproc or world)


def allreduce_max_int(*vals: int):
    """Element-wise max of small int tuples across the ranks (bucket
    sizes, neighbour K: anything that shapes the program)."""
    if not is_multiprocess():
        return tuple(int(v) for v in vals)
    t = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(int(v) for v in t.cpu().tolist())


def _allgather(values: np.ndarray, dtype) -> np.ndarray:
    """[world, *values.shape]: every rank's `values`."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype).to(
        collective_device())
    out = [torch.empty_like(t) for _ in range(get_comm_size_and_rank()[0])]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def assert_equal_across_processes(value: int, what: str,
                                  timeout_s: Optional[float] = None):
    """Allgather a per-rank integer and raise ValueError where it differs.
    `timeout_s` (default HYDRAGNN_RENDEZVOUS_TIMEOUT_S; unset: unbounded)
    bounds the allgather, so a dead peer surfaces as a
    RendezvousTimeoutError instead of wedging every other rank."""
    if not is_multiprocess():
        return
    if timeout_s is None:
        from ..utils.envflags import resolve_rendezvous_timeout
        timeout_s = resolve_rendezvous_timeout()
    arr = _run_bounded(lambda: _allgather(np.asarray([value], np.int64),
                                          torch.int64),
                       timeout_s, what).reshape(-1)
    if not (arr == arr[0]).all():
        raise ValueError(
            f"{what} differs across processes ({arr.tolist()}): every "
            "process must run the same number of steps or the collectives "
            "deadlock — equalize the per-host dataset shards")


def sync_config_stats(config: dict) -> dict:
    """Reduce the data-derived config statistics each rank computed from
    its local shard: pna_deg histograms add (max_neighbours follows),
    x_minmax / y_minmax ranges widen. No-op in one process."""
    if not is_multiprocess():
        return config
    arch = config["NeuralNetwork"]["Architecture"]
    deg = arch.get("pna_deg")
    if deg is not None:
        local = np.asarray(deg, np.int64)
        n = allreduce_max_int(len(local))[0]
        padded = np.zeros(n, np.int64)
        padded[:len(local)] = local
        merged = _allgather(padded, torch.int64).sum(axis=0)
        arch["pna_deg"] = [int(v) for v in merged]
        arch["max_neighbours"] = len(merged) - 1
    voi = config["NeuralNetwork"].get("Variables_of_interest", {})
    for key in ("x_minmax", "y_minmax"):
        mm = voi.get(key)
        if mm is None:
            continue
        gathered = _allgather(np.asarray(mm, np.float64), torch.float64)
        voi[key] = np.stack([gathered[:, 0].min(axis=0),
                             gathered[:, 1].max(axis=0)]).tolist()
    return config


def slice_by_process(ds, nproc: Optional[int] = None,
                     rank: Optional[int] = None, what: str = "dataset",
                     underflow: str = "raise"):
    """Contiguous per-rank slice of equal sizes (the tail is dropped so
    every rank runs the same step count). A split smaller than the world
    raises (`underflow='raise'`) or is kept whole on every rank with a
    warning (`underflow='replicate'`: redundant but correct eval)."""
    ds = list(ds)
    world, grank = get_comm_size_and_rank()
    nproc = nproc or world
    rank = grank if rank is None else rank
    per = len(ds) // nproc
    if per == 0 and len(ds) > 0:
        if underflow == "replicate":
            _LOG.warning(
                "%s has %d samples for %d processes — too few to shard; "
                "replicating the full split on every process (redundant "
                "but correct eval)", what, len(ds), nproc)
            return ds
        raise ValueError(
            f"{what} has {len(ds)} samples but {nproc} processes: "
            "slicing would leave some processes an empty split whose 0.0 "
            "loss corrupts keep_best/LR-plateau decisions — use a larger "
            "split, fewer processes, or underflow='replicate'")
    dropped = len(ds) - per * nproc
    if dropped:
        _LOG.info("%s: dropping %d tail sample(s) of %d so all %d "
                  "processes hold equal %d-sample slices",
                  what, dropped, len(ds), nproc, per)
    return ds[rank * per:(rank + 1) * per]
