"""Background batch building for the sampled-training loader (counterpart:
two pieces of hydragnn_tpu/datasets/async_loader.py):

* `resolve_async_workers`: the background depth, 0 for synchronous
  building. An explicit override wins, then the HYDRAGNN_ASYNC_LOADER
  kill switch (default on) sized by HYDRAGNN_LOADER_WORKERS (default
  `DEFAULT_WORKERS`);
* `background_iterate`: one producer thread and a bounded queue ahead of
  the consumer, order kept, a producer's exception re-raised on the
  consumer, the producer stopped promptly when the stream is abandoned,
  and the overlap accounting the sampled loader reports.

Only `preprocess/sampling.NeighborSamplingLoader` reads these knobs in the
port. `GraphDataLoader`'s worker pool and batch cache are not ported
(ROADMAP A10): its config keys are refused, its env knobs unread.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

from ..utils.envflags import env_flag, env_int

DEFAULT_WORKERS = 2


def resolve_async_workers(override: Optional[int] = None) -> int:
    """The background depth: 0 = synchronous. `override` (the loader's
    argument), else HYDRAGNN_ASYNC_LOADER (off when falsy) with
    HYDRAGNN_LOADER_WORKERS (0 honoured: synchronous)."""
    if override is not None:
        return max(int(override), 0)
    if not env_flag("HYDRAGNN_ASYNC_LOADER", True):
        return 0
    return max(env_int("HYDRAGNN_LOADER_WORKERS", DEFAULT_WORKERS), 0)


_SENTINEL = object()


def background_iterate(iterable, depth: int = 2,
                       stats: Optional[Dict[str, float]] = None) -> Iterator:
    """Yield the items of `iterable`, built by one producer thread up to
    `depth` items ahead of the consumer.

    `stats` (mutated in place, when given) accumulates ``items`` consumed,
    ``ready_items`` that were already waiting when the consumer asked (the
    producer was ahead) and ``consumer_wait_s`` blocked on the queue;
    ready_items / items is 1.0 when building hides fully behind the
    consumer's work. Abandoning the generator stops the producer, which is
    joined (at most one item build) before control returns."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    if stats is not None:
        stats.setdefault("items", 0)
        stats.setdefault("ready_items", 0)
        stats.setdefault("consumer_wait_s", 0.0)

    def put_until_stopped(entry):
        # blocks until taken or abandoned: a timeout could drop the final
        # sentinel while the consumer is busy and leave it waiting forever
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce():
        try:
            for item in iterable:
                put_until_stopped((item, None))
                if stop.is_set():
                    return
            put_until_stopped((_SENTINEL, None))
        except BaseException as exc:  # noqa: BLE001 — re-raised on the consumer
            put_until_stopped((_SENTINEL, exc))

    t = threading.Thread(target=produce, name="hydragnn-producer",
                         daemon=True)
    t.start()
    try:
        while True:
            if stats is None:
                item, exc = q.get()
            else:
                ready = not q.empty()
                t0 = time.perf_counter()
                item, exc = q.get()
                stats["consumer_wait_s"] += time.perf_counter() - t0
                if item is not _SENTINEL:
                    stats["items"] += 1
                    stats["ready_items"] += int(ready)
            if item is _SENTINEL:
                if exc is not None:
                    raise exc
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        # a live producer mutates the iterable's state (the loader's
        # counters): join it before the caller re-seeds an epoch
        t.join(timeout=30)
