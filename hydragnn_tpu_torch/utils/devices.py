"""Device selection for the port's entry points, and the compile store
of its serving replicas (`CompileStore`).

Entry points run on the GPU unless the caller asks for the CPU: a missing
GPU is an error, never a silent fallback. Float32 matmuls and convolutions
are pinned to full float32 (no TF32), the precision the JAX reference
computes its dense layers in, and bf16 matmuls to float32 accumulation
(no reduced-precision reductions: the mixed-precision policy sums in
float32)."""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import zipfile
from typing import Any, Callable, Dict, Optional

import torch

_log = logging.getLogger("hydragnn_tpu_torch")


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hydragnn_tpu_torch: device 'cuda' was requested but no CUDA "
                "device is available — pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    return dev


class CompileStore:
    """Persistent store of what a serving replica compiles, keyed by a
    caller's fingerprint (counterpart: hydragnn_tpu/utils/devices.py
    `CompileStore`, which pickles XLA executables).

    The port's compiled artifacts are the Hopper kernel libraries
    (`kernels/_build.py`); a CUDA graph has no serialised form and is
    captured in each process. An entry is a zip of one bucket's payload:
    the libraries and their build logs (`_build.export_libraries`), with
    the key it was saved under. `InferenceEngine` keys one entry per
    bucket (`_store_key`), so a replica that finds every key installs the
    libraries and runs no `nvcc`.

    `fingerprint()` folds the torch and CUDA versions into every key (the
    engine adds the device's compute capability and the sources' digest);
    any load failure (a missing, corrupt or foreign entry, or a payload
    `install` refuses) degrades to a miss with a "compiling fresh"
    warning, and the caller builds and overwrites. Writes are atomic (tmp
    + `os.replace`). Thread-safe; one store may back every replica in a
    process."""

    SUFFIX = ".kernels"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.saves = 0  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock

    @staticmethod
    def fingerprint(*parts, precision=None) -> str:
        """Stable key from repr()s of the parts, the torch and CUDA
        versions and the labelled precision field (the engine passes its
        compute dtype there, so two precisions never share a key)."""
        h = hashlib.sha256()
        h.update(f"torch={torch.__version__}".encode())
        h.update(f";cuda={torch.version.cuda}".encode())
        h.update(f";precision={precision!r}".encode())
        for p in parts:
            h.update(b";")
            h.update(repr(p).encode())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + self.SUFFIX)

    def load(self, key: str, install: Optional[Callable] = None):
        """The payload saved under `key` ({"libs", "logs", ...}), after
        `install(payload)` if given, or None on a miss, including any
        failure to read, check or install it."""
        path = self._path(key)
        if not os.path.exists(path):
            with self._lock:
                self.misses += 1
            return None
        try:
            payload = _read_entry(path, key)
            if install is not None:
                install(payload)
        except Exception as exc:  # noqa: BLE001 — degrade to a miss
            _log.warning("compile store entry %s is unloadable (%s: %s); "
                         "compiling fresh", path, type(exc).__name__, exc)
            with self._lock:
                self.errors += 1
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return payload

    def save(self, key: str, payload: Dict[str, Any]) -> bool:
        """Write `payload` under `key`, atomically; best effort (a full
        or read-only disk warns and returns False)."""
        tmp = self._path(key) + f".tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            _write_entry(tmp, key, payload)
            os.replace(tmp, self._path(key))
        except Exception as exc:  # noqa: BLE001 — best-effort persistence
            _log.warning("compile store save for %s failed (%s: %s); "
                         "continuing without persisting", key[:12],
                         type(exc).__name__, exc)
            with self._lock:
                self.errors += 1
            return False
        with self._lock:
            self.saves += 1
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "saves": self.saves, "errors": self.errors,
                    "root": self.root}


def _write_entry(path: str, key: str, payload: Dict[str, Any]) -> None:
    meta = {"key": key, "digest": payload.get("digest"),
            "libs": sorted(payload.get("libs", {})),
            "logs": {k: str(v) for k, v in payload.get("logs", {}).items()}}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, sort_keys=True))
        for stem, data in sorted(payload.get("libs", {}).items()):
            z.writestr(f"lib{stem}.so", data)


def _read_entry(path: str, key: str) -> Dict[str, Any]:
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("key") != key:
            raise ValueError(f"entry saved under key {meta.get('key')!r}")
        libs = {stem: z.read(f"lib{stem}.so") for stem in meta["libs"]}
    return {"key": key, "digest": meta["digest"], "libs": libs,
            "logs": dict(meta["logs"])}
