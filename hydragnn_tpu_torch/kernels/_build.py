"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `hydragnn_tpu_torch/csrc/*.cu` source becomes one shared library with
a plain C interface, compiled for Hopper (`sm_90a`) by one `nvcc` process
per source, all started together. Libraries land in
`build/hydragnn_tpu_torch/<hash>/` at the checkout's root, keyed by a hash
of the sources and the flags, so an edited source rebuilds and an
unchanged one loads from disk. Processes that build at once (the ranks of
a data-parallel run, a fleet's replicas) take turns at an `fcntl` lock on
`.build.lock` in the digest directory around the check and the compile,
so `nvcc` runs once; the lock goes with its process, so a killed build
leaves none behind. A missing `nvcc` or a failed compile raises with the
compiler's output. Importing this module builds nothing.

A compile store (`utils/devices.CompileStore`) carries the built
libraries to another checkout or process: `export_libraries()` gives them
and their build logs as bytes, `install_libraries(payload)` writes them
into the digest directory, where `build_all` then finds them and runs no
`nvcc`; `nvcc_runs` counts the compiler processes this process started.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "hydragnn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output per source (ptxas register and shared-memory report),
# kept beside each library as lib<stem>.log and read back when the
# library is loaded from disk
build_log: Dict[str, str] = {}
# nvcc processes started by this process
nvcc_runs = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError(
        "hydragnn_tpu_torch: nvcc not found (CUDA_HOME="
        f"{CUDA_HOME!r}) — the CUDA kernels are built from "
        "hydragnn_tpu_torch/csrc at first use and need the CUDA toolkit")


def _source_digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns
    {source stem: CDLL}. Thread-safe and process-safe (the digest
    directory's lock file); builds at most once per process."""
    with _lock:
        if _libs:
            return _libs
        sources = sorted(CSRC_DIR.glob("*.cu"))
        out_dir = BUILD_ROOT / _source_digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            todo = [s for s in sources
                    if not (out_dir / f"lib{s.stem}.so").exists()]
            if todo:
                _compile(todo, out_dir)
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
            log = out_dir / f"lib{src.stem}.log"
            if src.stem not in build_log and log.exists():
                build_log[src.stem] = log.read_text()
        return _libs


def export_libraries() -> Dict[str, Any]:
    """The libraries of this checkout's sources (built first if needed)
    and their build logs: {"digest": the sources' digest, "libs": {stem:
    bytes of lib<stem>.so}, "logs": {stem: text}}."""
    build_all()
    out_dir = BUILD_ROOT / _source_digest()
    stems = sorted(s.stem for s in CSRC_DIR.glob("*.cu"))
    logs = {}
    for stem in stems:
        log = out_dir / f"lib{stem}.log"
        logs[stem] = log.read_text() if log.exists() else ""
    return {"digest": _source_digest(),
            "libs": {stem: (out_dir / f"lib{stem}.so").read_bytes()
                     for stem in stems},
            "logs": logs}


def install_libraries(payload: Dict[str, Any]) -> int:
    """Write an `export_libraries` payload into this checkout's digest
    directory (each file atomically; a library already there is kept);
    returns the number of libraries written. Raises ValueError for a
    payload of other sources or flags (another digest) or one that lacks
    a source's library."""
    digest = _source_digest()
    if payload.get("digest") != digest:
        raise ValueError(f"kernel libraries of sources "
                         f"{payload.get('digest')!r}, this checkout's are "
                         f"{digest!r}")
    stems = sorted(s.stem for s in CSRC_DIR.glob("*.cu"))
    libs, logs = payload.get("libs") or {}, payload.get("logs") or {}
    missing = [stem for stem in stems
               if not isinstance(libs.get(stem), bytes)]
    if missing:
        raise ValueError(f"kernel libraries missing from the payload: "
                         f"{missing}")
    out_dir = BUILD_ROOT / digest
    out_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    with _lock:
        for stem in stems:
            lib = out_dir / f"lib{stem}.so"
            if lib.exists():
                continue
            _write_atomic(out_dir / f"lib{stem}.log",
                          str(logs.get(stem, "")).encode())
            _write_atomic(lib, libs[stem])
            written += 1
    return written


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _compile(sources, out_dir: Path) -> None:
    global nvcc_runs
    nvcc = _nvcc()
    procs = {}
    try:
        for src in sources:
            tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
            nvcc_runs += 1
            procs[src.stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        failed = []
        for stem, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[stem] = out
            if proc.returncode != 0:
                failed.append(f"--- {stem}.cu (exit {proc.returncode})\n{out}")
            else:
                (out_dir / f"lib{stem}.log").write_text(out)
                os.replace(tmp, out_dir / f"lib{stem}.so")
        if failed:
            raise RuntimeError("hydragnn_tpu_torch: nvcc failed:\n"
                               + "\n".join(failed))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# the C entry point's suffix per element type (`hg_<kernel>_<suffix>`)
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu`."""
    return build_all()[stem]


def check_launch(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry point
    (it returns cudaGetLastError() right after its launch)."""
    if err != 0:
        raise RuntimeError(f"hydragnn_tpu_torch: {name} kernel launch "
                           f"failed with cudaError_t {err}")
