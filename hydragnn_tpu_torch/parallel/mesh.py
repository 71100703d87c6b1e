"""The process group and the shard-count policy (counterpart:
hydragnn_tpu/parallel/mesh.py).

The JAX package runs one program over a mesh of devices; the port runs
one process per device, W ranks of a `torch.distributed` process group,
each with one device. So the data axis of a W-device mesh is the group's
W ranks, and every device budget the JAX package counts in devices is
the world size here.

* `init_distributed()` makes the group from what the JAX package reads:
  HYDRAGNN_MASTER_ADDR / HYDRAGNN_MASTER_PORT (default 12355), SLURM_NPROCS
  and SLURM_PROCID, and HYDRAGNN_RENDEZVOUS_TIMEOUT_S, which bounds the
  rendezvous. Without a coordinator (argument or env) it makes nothing
  and the run is one process. The backend is "nccl" for ranks on the
  card and "gloo" for ranks on the CPU unless the caller names one
  (two ranks sharing one card pass backend="gloo": NCCL refuses two
  ranks on one device).
* `get_comm_size_and_rank()`: (world, rank), (1, 0) without a group.
* `resolve_num_shards()`: the JAX package's policy with the world size
  as the device count.
* `zero_sharded()`: ZeRO's placement rule (`param_sharding_zero`).
"""
from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.envflags import resolve_rendezvous_timeout

# ZeRO's default `zero_min_shard_size` (Training.Optimizer), as in JAX
ZERO_MIN_SHARD_SIZE = 2 ** 14


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> Tuple[int, int]:
    """Join (or make) the process group; returns (world size, rank).

    `coordinator` is "host:port" (a TCP rendezvous) or an init-method URL
    ("tcp://host:port", "file:///path"); without it,
    HYDRAGNN_MASTER_ADDR[:HYDRAGNN_MASTER_PORT] names it, and without
    either no group is made: (1, 0). `num_processes` / `process_id`
    default to SLURM_NPROCS / SLURM_PROCID (1 / 0). `timeout_s` (default
    HYDRAGNN_RENDEZVOUS_TIMEOUT_S; None waits torch's default) bounds the
    rendezvous: a peer that never arrives raises a RuntimeError naming
    this process, the world and the coordinator. `backend` defaults to
    "nccl" when `device` is a CUDA device and "gloo" otherwise; an NCCL
    rank binds the card `rank % device_count()` and sets
    TORCH_NCCL_ASYNC_ERROR_HANDLING=0 (unless set), which CUDA graphs
    that hold an NCCL collective need. A group that exists already is
    joined as it is."""
    if dist.is_initialized():
        return get_comm_size_and_rank()
    addr = os.getenv("HYDRAGNN_MASTER_ADDR")
    if not coordinator and not addr:
        return 1, 0
    coord = coordinator or (
        addr + ":" + os.environ.get("HYDRAGNN_MASTER_PORT", "12355"))
    nproc = int(num_processes or os.environ.get("SLURM_NPROCS", 1))
    pid = int(process_id if process_id is not None
              else os.environ.get("SLURM_PROCID", 0))
    if timeout_s is None:
        timeout_s = resolve_rendezvous_timeout()
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else pid % torch.cuda.device_count())
    kwargs = {}
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    init_method = coord if "://" in coord else f"tcp://{coord}"
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=nproc, rank=pid, **kwargs)
    except (RuntimeError, ValueError) as exc:
        msg = str(exc).lower()
        if timeout_s and ("timeout" in msg or "timed out" in msg):
            raise RuntimeError(
                f"multi-process rendezvous timed out after {timeout_s:g}s: "
                f"this is process {pid} of {nproc} (coordinator {coord}) "
                f"— at least one rank in 0..{nproc - 1} besides {pid} "
                "never reached the coordinator (died before init, wrong "
                "address, or still spawning). Restart the whole job — a "
                "partial world cannot proceed") from exc
        raise
    return get_comm_size_and_rank()


def get_comm_size_and_rank() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def resolve_num_shards(num_shards: Optional[int], batch_size: int,
                       use_spmd: Optional[bool] = None,
                       device_budget: Optional[int] = None) -> int:
    """The JAX package's shard-count policy: default to every device when
    there is more than one, fall back to one shard when the batch does not
    divide or the request exceeds the devices (warning when the request
    was explicit). The device budget defaults to the world size: one
    device per rank."""
    ndev = (device_budget if device_budget is not None
            else get_comm_size_and_rank()[0])
    explicit = num_shards is not None
    if num_shards is None:
        num_shards = ndev if (use_spmd or (use_spmd is None and ndev > 1)) \
            else 1
    num_shards = max(int(num_shards), 1)
    if num_shards > ndev or batch_size % num_shards != 0:
        if explicit and num_shards > 1:
            reason = (f"exceeds device count {ndev}"
                      if num_shards > ndev else
                      f"does not divide batch_size {batch_size}")
            warnings.warn(
                f"requested num_shards={num_shards} {reason}; "
                f"falling back to a single-device run", stacklevel=2)
        return 1
    return num_shards


def zero_sharded(shape: Sequence[int], world: int,
                 min_size: int = ZERO_MIN_SHARD_SIZE) -> bool:
    """ZeRO's placement rule for one optimizer-state leaf (JAX
    `param_sharding_zero`): a leaf of at least `min_size` elements whose
    leading dim divides by the world size is split by its leading dim
    over the ranks; the rest stay whole on every rank."""
    numel = 1
    for d in shape:
        numel *= int(d)
    return (len(shape) >= 1 and numel >= min_size
            and int(shape[0]) % max(int(world), 1) == 0)
