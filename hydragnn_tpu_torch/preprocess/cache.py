"""Content-addressed array shards of the sampled loader's feature store
(counterpart: the array-shard part of hydragnn_tpu/preprocess/cache.py,
whose key strings and on-disk layout this copy keeps: a shard one package
writes, the other opens with the same arrays).

A shard is one directory, ``featstore-<key>`` under the cache directory,
written to a temporary directory and renamed into place:

* ``data.bin``: the named arrays back to back in sorted name order, each
  16-byte aligned;
* ``index.json``: name -> [dtype, shape, offset];
* ``meta.json``: the schema version, the key, the array count, the data's
  size and sha256, and extra metadata (numpy arrays JSON-encoded).

A load memory-maps ``data.bin`` read-only (zero-copy views) after checking
the metadata and, by default, the checksum: a plain miss raises
FileNotFoundError, anything unservable `CacheInvalid`.

The sample shards and `PreprocessedCache` are not ported (ROADMAP A10).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

CACHE_SCHEMA_VERSION = 1
_ALIGN = 16


class CacheInvalid(RuntimeError):
    """A shard exists but cannot be served (corrupt, truncated, or built
    for another key or schema). Callers rebuild."""


def _encode_meta(extra: Optional[Dict]) -> Optional[Dict]:
    """JSON-encode a flat dict whose values may be numpy arrays."""
    if extra is None:
        return None
    out = {}
    for k, v in extra.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": True, "dtype": str(v.dtype),
                      "shape": list(v.shape), "data": v.ravel().tolist()}
        else:
            out[k] = v
    return out


def _decode_meta(extra: Optional[Dict]) -> Optional[Dict]:
    if extra is None:
        return None
    out = {}
    for k, v in extra.items():
        if isinstance(v, dict) and v.get("__ndarray__"):
            out[k] = np.asarray(v["data"], dtype=v["dtype"]).reshape(
                v["shape"])
        else:
            out[k] = v
    return out


def _array_shard_dir(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"featstore-{key}")


def feature_store_key(graph_fingerprint, partition_fingerprint,
                      extra=None) -> str:
    """The address of one partitioned feature store: sha256 over (the
    graph's identity, the partition map's[, extra]); a new graph or
    partition lands on a new key."""
    blob = json.dumps({"graph": graph_fingerprint,
                       "partition": partition_fingerprint,
                       "extra": extra, "schema": CACHE_SCHEMA_VERSION},
                      sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def save_array_shard(cache_dir: str, key: str,
                     arrays: Dict[str, np.ndarray],
                     extra_meta: Optional[Dict] = None) -> str:
    """Write named arrays as one shard (the layout above) and return its
    directory. A concurrent writer's identical shard may win the rename."""
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".featstore-{key}-", dir=cache_dir)
    try:
        index = {}
        h = hashlib.sha256()
        offset = 0
        with open(os.path.join(tmp, "data.bin"), "wb") as f:
            for name in sorted(arrays):
                arr = np.ascontiguousarray(arrays[name])
                pad = (-offset) % _ALIGN
                if pad:
                    f.write(b"\0" * pad)
                    h.update(b"\0" * pad)
                    offset += pad
                buf = arr.tobytes()
                f.write(buf)
                h.update(buf)
                index[name] = [str(arr.dtype), list(arr.shape), offset]
                offset += len(buf)
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump({"arrays": index}, f)
        meta = {
            "schema": CACHE_SCHEMA_VERSION,
            "key": key,
            "num_arrays": len(index),
            "data_size": offset,
            "data_sha256": h.hexdigest(),
            "extra": _encode_meta(extra_meta),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        dst = _array_shard_dir(cache_dir, key)
        if os.path.exists(dst):
            trash = tempfile.mkdtemp(prefix=".featstore-trash-",
                                     dir=cache_dir)
            os.replace(dst, os.path.join(trash, "old"))
            shutil.rmtree(trash, ignore_errors=True)
        try:
            os.replace(tmp, dst)
        except OSError:
            # a concurrent writer won the rename: the same content by
            # construction (the key addresses it), keep theirs
            shutil.rmtree(tmp, ignore_errors=True)
        return dst
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_array_shard(cache_dir: str, key: str, verify: bool = True
                     ) -> Tuple[Dict[str, np.ndarray], Optional[Dict]]:
    """(arrays as read-only views of the memory-mapped data, extra
    metadata). FileNotFoundError on a miss, `CacheInvalid` on a shard
    that cannot be served."""
    path = _array_shard_dir(cache_dir, key)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)["arrays"]
    except (OSError, ValueError, KeyError) as exc:
        raise CacheInvalid(f"{path}: unreadable shard metadata "
                           f"({type(exc).__name__}: {exc})") from exc
    if meta.get("schema") != CACHE_SCHEMA_VERSION:
        raise CacheInvalid(
            f"{path}: shard schema {meta.get('schema')} != "
            f"{CACHE_SCHEMA_VERSION}")
    if meta.get("key") != key:
        raise CacheInvalid(f"{path}: shard was built for key "
                           f"{meta.get('key')}, not {key}")
    if len(index) != meta.get("num_arrays"):
        raise CacheInvalid(f"{path}: index lists {len(index)} arrays, "
                           f"meta says {meta.get('num_arrays')}")
    data_path = os.path.join(path, "data.bin")
    try:
        size = os.path.getsize(data_path)
    except OSError as exc:
        raise CacheInvalid(f"{path}: missing data.bin") from exc
    if size != meta.get("data_size"):
        raise CacheInvalid(f"{path}: data.bin is {size} bytes, meta "
                           f"says {meta.get('data_size')}")
    mm = (np.memmap(data_path, dtype=np.uint8, mode="r") if size
          else np.empty(0, np.uint8))
    if verify and size:
        digest = hashlib.sha256(mm).hexdigest()
        if digest != meta.get("data_sha256"):
            raise CacheInvalid(f"{path}: data.bin checksum mismatch "
                               "(corrupted shard)")
    arrays: Dict[str, np.ndarray] = {}
    try:
        for name in sorted(index):
            dtype, shape, offset = index[name]
            dt = np.dtype(dtype)
            count = int(np.prod(shape, dtype=np.int64))
            if count == 0:
                arrays[name] = np.empty(shape, dt)
            else:
                arrays[name] = np.frombuffer(
                    mm, dtype=dt, count=count,
                    offset=int(offset)).reshape(shape)
    except (TypeError, ValueError, KeyError) as exc:
        raise CacheInvalid(f"{path}: malformed array index "
                           f"({type(exc).__name__}: {exc})") from exc
    return arrays, _decode_meta(meta.get("extra"))
