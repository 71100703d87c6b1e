"""The port's serving fleet (hydragnn_tpu_torch/serving/fleet.py), its
compile store (utils/devices.CompileStore, kernels/_build.py's hooks),
the fleet metrics (telemetry/http.py) and run_prediction's fleet path on
the CPU: the cases of tests/test_serving_fleet.py on the port, and
against the JAX package's live output.

* least-queue-depth routing, ties by index; a ``replica-kill`` loses no
  future and resolves each once; an all-dead fleet fast-fails;
* one replica's tripped breaker is its own, and a probe re-admits it;
* hot swap echoes the version, ``swap-fail`` leaves the old version
  serving, a mismatched tree is refused, the BEST checkpoint feeds it;
* the compile store: the second replica and a restart warm from it, a
  corrupt or foreign entry degrades to a miss, the keys fold what they
  must; the build hooks install and export libraries and a store hit
  starts no nvcc;
* one aggregated /healthz + /metrics; ephemeral ports never collide;
* against JAX: `resolve_fleet` fields, `_pick` / `_pick_from` choices
  with tiers and quota over scripted health snapshots, and
  `fleet_prometheus` text (bitwise); run_prediction through two replicas
  is bitwise the single engine and within rtol 1e-4 / atol 1e-5 of JAX;
* many submitting threads with kills, and launch counters that keep
  other threads' replays while a capture takes its own back.

The import boundary of the new modules is held in
tests/test_torch_serving.py, beside the package's.

Sized for the CPU: a GIN of the deterministic test dataset, 2-3
replicas, one-bucket ladders.
"""
import copy
import dataclasses
import json
import os
import pathlib
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.serving import fleet as jfleet
from hydragnn_tpu.serving.config import resolve_fleet as j_resolve_fleet
from hydragnn_tpu.telemetry import http as jhttp
from hydragnn_tpu.telemetry.registry import MetricsRegistry as JRegistry
from hydragnn_tpu.utils import faults as jfaults
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.kernels import _build
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.serving import fleet as tfleet
from hydragnn_tpu_torch.serving.config import FleetConfig, resolve_fleet
from hydragnn_tpu_torch.serving.engine import InferenceEngine
from hydragnn_tpu_torch.serving.fleet import (FleetUnavailableError,
                                              ReplicaRouter, SwapFailedError,
                                              TierPolicy)
from hydragnn_tpu_torch.telemetry import http as thttp
from hydragnn_tpu_torch.telemetry.registry import MetricsRegistry
from hydragnn_tpu_torch.utils.devices import CompileStore
from hydragnn_tpu_torch.utils.faults import (install_fault_plan,
                                             parse_fault_plan)
from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                              random_flax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    install_fault_plan(None)
    jfaults.install_fault_plan(None)


@pytest.fixture(scope="module")
def served():
    jsamples = deterministic_graph_dataset(num_configs=24)
    samples = to_port_samples(jsamples)
    cfg = tcfg.update_config(make_config("GIN"), samples)
    mcfg = tcfg.build_model_config(cfg)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 0)
    return samples, jsamples, mcfg, variables


def scaled(variables, scale):
    """`variables` with every parameter times `scale`."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v * np.float32(scale)
                for k, v in tree.items()}
    return {"params": walk(variables["params"]),
            "batch_stats": copy.deepcopy(variables.get("batch_stats", {}))}


def model_on(mcfg, variables):
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(variables))
    return model


def factory(served, store=None, **kw):
    samples, _, mcfg, variables = served
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("model_version", "v1")

    def make(idx):
        return InferenceEngine(model_on(mcfg, variables), mcfg,
                               reference_samples=samples,
                               compile_store=store, device="cpu", **kw)
    return make


def drain(futs, timeout=60):
    for f in futs:
        f.exception(timeout=timeout)


# ---------------------------------------------------------------- routing

class _Park:
    """Park one engine's dispatcher inside _execute, so that the test
    sets the queue depths instead of racing the batch loop."""

    def __init__(self, eng):
        self.entered = threading.Event()
        self.release = threading.Event()
        orig = eng._execute

        def blocked(reqs):
            self.entered.set()
            assert self.release.wait(30)
            return orig(reqs)

        eng._execute = blocked


def test_least_queue_depth_routing(served):
    samples = served[0]
    router = ReplicaRouter(factory(served), 2)
    try:
        f0 = router.submit(samples[0])          # tie at depth 0 -> 0
        assert f0.result(timeout=60) is not None
        assert f0.replica == 0
        parks = [_Park(router._replicas[i].engine) for i in (0, 1)]
        try:
            fa = router.submit(samples[1])      # tie (0, 0) -> 0
            assert parks[0].entered.wait(30)    # dequeued, parked
            fb = router.submit(samples[2])      # tie -> 0, stays queued
            fc = router.submit(samples[3])      # (1, 0) -> 1
            assert parks[1].entered.wait(30)
            fd = router.submit(samples[4])      # (1, 0) -> 1: (1, 1)
            fe = router.submit(samples[5])      # tie (1, 1) -> 0
        finally:
            for p in parks:
                p.release.set()
        futs = [fa, fb, fc, fd, fe]
        drain(futs)
        assert [f.replica for f in futs] == [0, 0, 1, 1, 0]
        assert all(f.exception(timeout=0) is None for f in futs)
    finally:
        router.shutdown()


def test_replica_kill_redispatches_exactly_once(served):
    samples = served[0]
    router = ReplicaRouter(factory(served), 2)
    try:
        install_fault_plan(parse_fault_plan("replica-kill@2"))
        futs = [router.submit(s) for s in samples[:10]]
        drain(futs)
        assert all(f.exception(timeout=0) is None for f in futs)
        assert router.kill_count == 1
        assert router.requests_done == 10
        assert all(hasattr(f, "model_version") and hasattr(f, "replica")
                   for f in futs)
        health = router.health()
        dead = [i for i, h in sorted(health["replicas"].items())
                if not h["alive"]]
        assert len(dead) == 1
        assert health["state"] == "serving"
        f = router.submit(samples[0])
        assert f.result(timeout=60) is not None
        assert str(f.replica) != dead[0]
    finally:
        router.shutdown()


def test_fleet_unavailable_fast_fails(served):
    samples = served[0]
    router = ReplicaRouter(factory(served), 2, unavailable_wait_s=0.1)
    try:
        router.kill_replica(0)
        router.kill_replica(1)
        assert router.health()["state"] == "unavailable"
        with pytest.raises(FleetUnavailableError):
            router.submit(samples[0]).result(timeout=60)
    finally:
        router.shutdown()


def test_breaker_isolation_and_probe_readmission(served):
    samples = served[0]
    router = ReplicaRouter(
        factory(served, breaker_threshold=1, breaker_reset_s=1.0), 2)
    try:
        router.warmup()
        install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        f = router.submit(samples[0])
        assert f.result(timeout=60) is not None     # re-dispatched
        assert router.redispatch_count >= 1
        states = {i: h["state"]
                  for i, h in router.health()["replicas"].items()}
        assert sorted(states.values()) == ["closed", "open"]
        tripped = next(i for i, s in sorted(states.items()) if s == "open")
        healthy = next(i for i, s in sorted(states.items())
                       if s == "closed")
        for s in samples[1:4]:
            g = router.submit(s)
            assert g.result(timeout=60) is not None
            assert str(g.replica) == healthy
        time.sleep(1.1)
        g = router.submit(samples[4])               # the half-open probe
        assert g.result(timeout=60) is not None
        assert str(g.replica) == tripped
        health = router.health()["replicas"][tripped]
        assert health["state"] == "closed"
        assert health["probe_count"] == 1
        assert health["trip_count"] == 1
    finally:
        router.shutdown()


# ------------------------------------------------------------ hot swap

def test_hot_swap_changes_echoed_version(served):
    samples, _, _, variables = served
    router = ReplicaRouter(factory(served), 2)
    try:
        before = [router.submit(s) for s in samples[:4]]
        drain(before)
        assert {f.model_version for f in before} == {"v1"}
        report = router.hot_swap(scaled(variables, 2.0), "v2")
        assert report["failed"] == []
        assert sorted(report["replicas"]) == ["0", "1"]
        after = [router.submit(s) for s in samples[:4]]
        drain(after)
        assert {f.model_version for f in after} == {"v2"}
        a = np.asarray(before[0].result(timeout=0)[0])
        b = np.asarray(after[0].result(timeout=0)[0])
        assert not np.array_equal(a, b)
        assert all(f.exception(timeout=0) is None for f in before + after)
        assert all(h["model_version"] == "v2"
                   for h in router.health()["replicas"].values())
    finally:
        router.shutdown()


def test_swap_fail_injection_rolls_back(served):
    samples, _, _, variables = served
    router = ReplicaRouter(factory(served), 2)
    try:
        install_fault_plan(parse_fault_plan("swap-fail@0,1"))
        with pytest.raises(SwapFailedError):
            router.hot_swap(scaled(variables, 2.0), "v2")
        futs = [router.submit(s) for s in samples[:4]]
        drain(futs)
        assert all(f.exception(timeout=0) is None for f in futs)
        assert {f.model_version for f in futs} == {"v1"}
        report = router.hot_swap(scaled(variables, 2.0), "v2")
        assert report["failed"] == []
        f = router.submit(samples[0])
        f.result(timeout=60)
        assert f.model_version == "v2"
        assert router.health()["swap_failures"] == 2
    finally:
        router.shutdown()


def test_swap_variables_shape_mismatch_rejected(served):
    samples, _, _, variables = served
    eng = factory(served)(0)
    try:
        eng.warmup()
        bad = copy.deepcopy(variables)
        node = bad["params"]
        while not isinstance(node.get("kernel"), np.ndarray):
            node = node[sorted(k for k in node
                               if isinstance(node[k], dict))[0]]
        node["kernel"] = np.zeros(
            tuple(s + 1 for s in node["kernel"].shape), np.float32)
        with pytest.raises(ValueError, match="shape"):
            eng.swap_variables(bad, "v2")
        assert eng.health()["model_version"] == "v1"
        assert eng.submit(samples[0]).result(timeout=60) is not None
    finally:
        eng.shutdown()


def test_hot_swap_from_best_checkpoint(served, tmp_path):
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    from hydragnn_tpu_torch.utils.checkpoint import save_model
    samples, _, mcfg, variables = served
    tx = select_optimizer({"Optimizer": {"type": "AdamW",
                                         "learning_rate": 1e-3}})
    state = TrainState.create(model_on(mcfg, scaled(variables, 3.0)), tx)
    save_model(state, "fleet_test", path=str(tmp_path), mark_best=True,
               best_val=0.5)
    template = TrainState.create(model_on(mcfg, variables), tx)
    router = ReplicaRouter(factory(served), 2)
    fresh = factory(served, model_version="x")(0)
    try:
        report = router.hot_swap_from_checkpoint(
            template, "fleet_test", path=str(tmp_path), which="best")
        assert report["version"] == "best:step_0"
        f = router.submit(samples[0])
        got = f.result(timeout=60)
        assert f.model_version == "best:step_0"
        fresh.swap_variables(scaled(variables, 3.0), "x3")
        want = fresh.forward_single(samples[0], bucket=f.bucket)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    finally:
        router.shutdown()
        fresh.shutdown()


def test_kill_restart_and_swap_under_a_stream(served, tmp_path):
    """A stream with a kill, a restart and a rolling swap in flight: no
    future lost or failed, each resolved once, both versions echoed, and
    the restart warmed from the store."""
    samples, _, _, variables = served
    store = CompileStore(str(tmp_path / "store"))
    router = ReplicaRouter(factory(served, store), 2)
    try:
        router.warmup()
        install_fault_plan(parse_fault_plan("replica-kill@6"))
        futs, restart = [], {}
        swap_thread = None
        for i in range(3):
            for s in samples:
                futs.append(router.submit(s))
                time.sleep(0.001)
            if i == 0:
                restart = router.restart_replica(
                    next(int(k) for k, h in sorted(
                        router.health()["replicas"].items())
                        if not h["alive"]))
            if i == 1:
                swap_thread = threading.Thread(
                    target=router.hot_swap,
                    args=(scaled(variables, 2.0), "v2"))
                swap_thread.start()
        swap_thread.join(timeout=120)
        assert not swap_thread.is_alive()
        after = [router.submit(s) for s in samples[:4]]
        drain(futs + after, timeout=120)
        futs += after
        assert all(f.exception(timeout=0) is None for f in futs)
        assert router.requests_done == len(futs)
        assert {f.model_version for f in futs} == {"v1", "v2"}
        assert {f.model_version for f in after} == {"v2"}
        assert router.kill_count == 1 and router.restart_count == 1
        assert restart["fresh"] == 0
        assert restart["store_hits"] == restart["compiled"] > 0
    finally:
        router.shutdown()


def test_router_stress_many_submitters_with_kills(served):
    """More submitting threads than cores, a short switch interval, and
    two kill-and-restart cycles: every future resolves once, none fails,
    and the router's count equals the submissions (a lost update in its
    bookkeeping would break one of them)."""
    samples = served[0]
    router = ReplicaRouter(factory(served), 2)
    interval = sys.getswitchinterval()
    futs, lock = [], threading.Lock()

    def submitter(k):
        for i in range(12):
            f = router.submit(samples[(k + i) % len(samples)])
            with lock:
                futs.append(f)

    try:
        router.warmup()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for idx in (1, 0):
            time.sleep(0.01)
            router.kill_replica(idx)
            router.restart_replica(idx)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        drain(futs, timeout=120)
    finally:
        sys.setswitchinterval(interval)
        router.shutdown()
    assert all(f.exception(timeout=0) is None for f in futs)
    assert router.requests_done == len(futs) == 12 * len(threads)
    assert router.kill_count == 2 and router.restart_count == 2


def test_launch_counts_keep_replays_during_a_capture():
    """A capture takes back only its own wrapper calls: replays that other
    threads add meanwhile stay counted, under a short switch interval
    with more threads than cores (the counters' lock)."""
    from hydragnn_tpu_torch import kernels as tk
    from hydragnn_tpu_torch.kernels import segment
    interval = sys.getswitchinterval()
    before = tk.launch_counts()
    replay = dict.fromkeys(before, 0)
    replay["segment_sum"] = 1
    replay["pna_edge_aggregate"] = 6

    def replays():
        for _ in range(300):
            tk.add_launch_counts(replay)

    try:
        sys.setswitchinterval(1e-6)
        mark = tk.counts_mark()
        threads = [threading.Thread(target=replays)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for _ in range(500):            # the capturing thread's wrapper
            with tk.COUNTS_LOCK:
                segment.launches += 1
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        own = tk.take_back_since(mark)
        after = tk.launch_counts()
    finally:
        sys.setswitchinterval(interval)
        tk.set_launch_counts(before)
    n = 300 * len(threads)
    assert own["segment_sum"] == 500 and own["pna_edge_aggregate"] == 0
    assert sum(own.values()) == 500
    assert after["segment_sum"] == before["segment_sum"] + n
    assert after["pna_edge_aggregate"] == before["pna_edge_aggregate"] + 6 * n


# ------------------------------------------------------- compile store

def test_compile_store_warms_second_replica_and_restart(served, tmp_path):
    samples = served[0]
    store = CompileStore(str(tmp_path / "store"))
    router = ReplicaRouter(factory(served, store=store), 2)
    try:
        reports = router.warmup()
        assert reports[0]["fresh"] == reports[0]["compiled"] > 0
        assert reports[1]["fresh"] == 0
        assert reports[1]["store_hits"] == reports[1]["compiled"]
        router.kill_replica(0)
        restart = router.restart_replica(0)
        assert restart["fresh"] == 0
        assert restart["store_hits"] == restart["compiled"] > 0
        f = router.submit(samples[0])
        assert f.result(timeout=60) is not None
        assert router.health()["state"] == "serving"
        st = router.stats()["replicas"]["0"]
        assert st["compile_fresh"] == 0
        assert st["compile_store_hits"] == st["compile_count"]
    finally:
        router.shutdown()


def test_compile_store_corrupt_entry_degrades_to_miss(served, tmp_path,
                                                      caplog):
    """A payload round-trips; a corrupt entry, and one saved under
    another key, load as a miss with the "compiling fresh" warning; an
    engine over a corrupt entry compiles fresh and rewrites it."""
    store = CompileStore(str(tmp_path))
    payload = {"digest": "d", "libs": {"segment_sum": b"\x7fELF..."},
               "logs": {"segment_sum": "ptxas info"}}
    key = CompileStore.fingerprint("unit", (4,))
    assert store.save(key, payload)
    loaded = store.load(key)
    assert loaded["libs"] == payload["libs"]
    assert loaded["logs"] == payload["logs"]
    with open(store._path(key), "wb") as f:
        f.write(b"not a zip")
    with caplog.at_level("WARNING", logger="hydragnn_tpu_torch"):
        assert store.load(key) is None
    assert "compiling fresh" in caplog.text
    other = CompileStore.fingerprint("unit", (5,))
    assert store.save(other, payload)
    os.replace(store._path(other), store._path(key))   # a foreign entry
    assert store.load(key) is None
    st = store.stats()
    assert st["errors"] == 2 and st["hits"] == 1 and st["saves"] == 2

    store = CompileStore(str(tmp_path / "engine"))
    eng = factory(served, store=store)(0)
    try:
        key = eng._store_key(eng.buckets[0])
        with open(store._path(key), "wb") as f:
            f.write(b"garbage")
        eng.warmup()
        st = eng.stats()
        assert st["compile_fresh"] == st["compile_count"] == 1
        assert store.load(key) is not None       # rewritten
    finally:
        eng.shutdown()


def test_compile_store_key_sensitivity(served, monkeypatch):
    a = CompileStore.fingerprint("cfg", (64, 128, 3), "float32")
    b = CompileStore.fingerprint("cfg", (64, 128, 3), "bfloat16")
    c = CompileStore.fingerprint("cfg", (64, 256, 3), "float32")
    d = CompileStore.fingerprint("cfg", (64, 128, 3), precision="bfloat16")
    assert len({a, b, c, d}) == 4
    assert a == CompileStore.fingerprint("cfg", (64, 128, 3), "float32")
    samples, _, mcfg, variables = served
    make = factory(served, max_batch_size=4)
    e1, e2 = make(0), make(1)
    e3 = factory(served, max_batch_size=4, compute_dtype="bf16")(0)
    try:
        bucket = e1.buckets[0]
        key = e1._store_key(bucket)
        assert key == e2._store_key(bucket)              # a twin engine
        wider = dataclasses.replace(bucket, n_edge=bucket.n_edge + 64)
        assert key != e1._store_key(wider)               # by bucket
        assert key != e3._store_key(bucket)              # by precision
        monkeypatch.setattr(_build, "_source_digest", lambda: "edited")
        assert key != e1._store_key(bucket)              # by the sources
    finally:
        for e in (e1, e2, e3):
            e.shutdown()


def test_build_hooks_export_install_and_count_no_nvcc(tmp_path,
                                                      monkeypatch):
    """Libraries exported from one build root install into an empty one,
    where build_all then finds them and starts no nvcc; a payload of
    other sources, or one missing a library, is refused."""
    stems = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    digest = _build._source_digest()
    src_root = tmp_path / "built"
    (src_root / digest).mkdir(parents=True)
    for stem in stems:
        (src_root / digest / f"lib{stem}.so").write_bytes(
            f"lib {stem}".encode())
        (src_root / digest / f"lib{stem}.log").write_text(f"log {stem}")
    loaded = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or path)
    monkeypatch.setattr(_build, "BUILD_ROOT", src_root)
    payload = _build.export_libraries()
    assert payload["digest"] == digest
    assert payload["libs"] == {s: f"lib {s}".encode() for s in stems}
    assert payload["logs"] == {s: f"log {s}" for s in stems}
    runs = _build.nvcc_runs
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "empty")
    monkeypatch.setattr(_build, "_compile", lambda *a: pytest.fail(
        "build_all compiled although the libraries were installed"))
    assert _build.install_libraries(payload) == len(stems)
    assert _build.install_libraries(payload) == 0       # already there
    assert sorted(_build.build_all()) == stems
    assert _build.nvcc_runs == runs
    with pytest.raises(ValueError, match="sources"):
        _build.install_libraries(dict(payload, digest="other"))
    with pytest.raises(ValueError, match="missing"):
        _build.install_libraries(dict(payload, libs={}))


# ------------------------------------------------------- observability

def test_fleet_metrics_endpoint_aggregates(served):
    samples = served[0]
    router = ReplicaRouter(factory(served), 2)
    try:
        router.submit(samples[0]).result(timeout=60)
        server = router.start_metrics_server(port=0)
        assert server.port != 0
        with urllib.request.urlopen(f"{server.url}/healthz") as r:
            assert r.status == 200
            health = json.loads(r.read())
        assert health["state"] == "serving"
        assert health["replicas"]["0"]["model_version"] == "v1"
        assert health["replicas"]["1"]["uptime_s"] >= 0.0
        with urllib.request.urlopen(f"{server.url}/metrics") as r:
            text = r.read().decode()
        assert ('hydragnn_serving_replica_breaker_state{replica="0",'
                'state="closed"} 1' in text)
        assert ('hydragnn_serving_replica_breaker_state{replica="1",'
                'state="open"} 0' in text)
        assert 'hydragnn_serving_fleet_replicas 2' in text
        assert ('hydragnn_serving_replica_model{replica="0",'
                'version="v1"} 1' in text)
        assert "hydragnn_serving_fleet_latency_ms" in text
    finally:
        router.shutdown()


def test_engine_ephemeral_metrics_ports_do_not_collide(served):
    make = factory(served)
    e1, e2 = make(0), make(1)
    try:
        s1 = e1.start_metrics_server(port=0)
        s2 = e2.start_metrics_server(port=0)
        assert s1.port != 0 and s2.port != 0 and s1.port != s2.port
        for s in (s1, s2):
            with urllib.request.urlopen(f"{s.url}/healthz") as r:
                h = json.loads(r.read())
            assert "model_version" in h and "uptime_s" in h
    finally:
        e1.shutdown()
        e2.shutdown()


def test_engine_health_gains_version_and_uptime(served):
    eng = factory(served)(0)
    try:
        h = eng.health()
        assert h["model_version"] == "v1"
        assert h["uptime_s"] >= 0.0
        assert h["swap_count"] == 0
        t0 = h["uptime_s"]
        time.sleep(0.01)
        assert eng.health()["uptime_s"] > t0
        st = eng.stats()
        assert st["model_version"] == "v1"
        assert {"compile_store_hits", "compile_fresh", "compile_count",
                "probe_count", "captures"} <= set(st)
        assert eng.tier == "float32"
        assert factory(served, tier="fast")(0).tier == "fast"
    finally:
        eng.shutdown()


class _StubRouter:
    """health()/stats() of a three-replica fleet mid-publish, for the
    Prometheus text of both packages."""

    def health(self):
        reps = {}
        for i, (state, ver) in enumerate((("closed", "v1"),
                                          ("open", "v2"),
                                          ("half_open", "best:step_3"))):
            reps[str(i)] = dict(
                alive=i != 2, queue_depth=3 * i, uptime_s=1.5 + i,
                trip_count=i, probe_count=2 * i, state=state,
                model_version=ver, canary=i == 1, retired=i == 2)
        return {"state": "serving", "num_replicas": 3,
                "routable_replicas": 1, "replicas": reps,
                "swap_attempts": 4, "swap_failures": 1,
                "shadow_mirrored": 7, "retires": 1, "adds": 2,
                "quarantined_versions": ["bad:step_9", "v0"]}

    def stats(self):
        return {"requests_done": 41, "redispatches": 3,
                "duplicate_resolutions": 2, "stale_failures": 1,
                "kills": 1, "restarts": 1, "p50_ms": 1.25,
                "p95_ms": 7.5, "p99_ms": 12.0, "mean_ms": 2.0,
                "replicas": {"0": {"requests": 30}, "1": {"requests": 11}}}


def test_fleet_prometheus_matches_jax_bitwise():
    got = thttp.fleet_prometheus(_StubRouter(), MetricsRegistry())
    want = jhttp.fleet_prometheus(_StubRouter(), JRegistry())
    assert got == want
    assert 'replica="2",state="retired"} 1' in got


# ------------------------------------------------- routing against JAX

class _StubEngine:
    def __init__(self, idx):
        self.idx = idx
        self.tier = None
        self.h = {}

    def health(self):
        return dict(self.h)

    def shutdown(self, wait=True):
        pass


def _scripted(rng, routers, n):
    """One random fleet state, written into both routers' replicas."""
    states = ("closed", "closed", "closed", "open", "half_open",
              "shutdown")
    tiers = ("int8", "float32")
    for i in range(n):
        h = {"state": states[rng.integers(len(states))],
             "dispatcher_alive": bool(rng.random() > 0.1),
             "queue_depth": int(rng.integers(0, 3)),
             "breaker_probe_due": bool(rng.random() > 0.5)}
        tier = tiers[rng.integers(2)]
        flags = dict(alive=bool(rng.random() > 0.15),
                     draining=bool(rng.random() > 0.85),
                     canary=bool(rng.random() > 0.9))
        for r in routers:
            rep = r._replicas[i]
            rep.engine.h = dict(h)
            rep.engine.tier = tier
            for k, v in flags.items():
                setattr(rep, k, v)
    dispatches = {t: int(rng.integers(0, 6)) for t in tiers}
    for r in routers:
        r._tier_dispatches = dict(dispatches)


@pytest.mark.parametrize("policy", [None, dict(priority_min=2),
                                    dict(priority_min=1, quota=0.4)])
def test_pick_matches_jax_over_scripted_snapshots(policy):
    """`_pick` (and through it `_pick_from` and `_preferred_tier`) picks
    the replica the JAX router picks, and moves the same counters and
    dead marks, over 300 scripted fleets of 1-4 replicas."""
    rng = np.random.default_rng(7)
    for case in range(300):
        n = int(rng.integers(1, 5))
        mk = [lambda i, cls=_StubEngine: cls(i)]
        port = ReplicaRouter(mk[0], n, tier_policy=(
            None if policy is None else TierPolicy(**policy)))
        ref = jfleet.ReplicaRouter(mk[0], n, tier_policy=(
            None if policy is None else jfleet.TierPolicy(**policy)))
        _scripted(rng, (port, ref), n)
        priority = int(rng.integers(0, 4))
        tried = {int(i) for i in range(n) if rng.random() > 0.7}
        rr = tfleet._RouterRequest(None, None, priority=priority)
        jr = jfleet._RouterRequest(None, None, priority=priority)
        rr.tried, jr.tried = set(tried), set(tried)
        got, want = port._pick(rr), ref._pick(jr)
        assert (None if got is None else got.idx) == \
            (None if want is None else want.idx), case
        assert port.tier_fallbacks == ref.tier_fallbacks, case
        assert port.tier_downgrades == ref.tier_downgrades, case
        assert [r.alive for r in port._replicas] == \
            [r.alive for r in ref._replicas], case


# ------------------------------------------------------- run_prediction

def test_run_prediction_fleet_matches_single_engine_and_jax(served,
                                                            tmp_path):
    """Serving.fleet.replicas 2 with a compile store: predictions bitwise
    the single engine's (one request a batch, so each sits on the same
    bucket and row either way), the store populated, and within rtol
    1e-4 / atol 1e-5 of JAX's run_prediction on the same weights."""
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.models.create import create_model as j_create_model
    from hydragnn_tpu.train.optimizer import select_optimizer
    from hydragnn_tpu.train.train_step import TrainState
    from hydragnn_tpu_torch import run_prediction
    samples, jsamples, _, variables = served
    n = len(samples)
    cut = (int(0.6 * n), int(0.8 * n))

    def split(s):
        return s[:cut[0]], s[cut[0]:cut[1]], s[cut[1]:]
    cfg = make_config("GIN")
    single_cfg = copy.deepcopy(cfg)
    single_cfg["Serving"] = {"enabled": True, "max_batch_size": 1}
    fleet_cfg = copy.deepcopy(single_cfg)
    fleet_cfg["Serving"]["fleet"] = {
        "replicas": 2, "compile_store": str(tmp_path / "store")}
    t1, p1 = run_prediction(single_cfg, datasets=split(samples),
                            variables=variables, device="cpu")
    t2, p2 = run_prediction(fleet_cfg, datasets=split(samples),
                            variables=variables, device="cpu")
    for a, b in zip(t1 + p1, t2 + p2):
        np.testing.assert_array_equal(a, b)
    assert any(f.endswith(CompileStore.SUFFIX)
               for f in os.listdir(tmp_path / "store"))
    jcfg_done = copy.deepcopy(cfg)
    from hydragnn_tpu.config import config as jcfg
    jcfg_done = jcfg.update_config(jcfg_done, *split(jsamples))
    jmodel = j_create_model(jcfg.build_model_config(jcfg_done))
    jvars = jax.tree_util.tree_map(np.asarray, variables)
    state = TrainState.create(
        {"params": jvars["params"],
         "batch_stats": jvars.get("batch_stats", {})},
        select_optimizer(cfg["NeuralNetwork"]["Training"]))
    jt, jp = j_run_prediction(copy.deepcopy(cfg), datasets=split(jsamples),
                              state=state, model=jmodel, serve=False)
    for a, b in zip(t2, jt):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(p2, jp):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), **RP_TOL)


def test_run_prediction_refuses_shards_naming_a8(served, monkeypatch):
    """The engine route's sharding over devices is not ported and raises
    naming A8 before any work, where the count resolves above 1 (over a
    world of two here; C11: it is resolved first, as JAX resolves it,
    tests/test_torch_knobs.py); the loop shards over a process group's
    ranks (tests/test_torch_parallel_run.py)."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "get_comm_size_and_rank", lambda: (2, 0))
    with pytest.raises(NotImplementedError, match="A8"):
        run_prediction(make_config("GIN"), datasets=([], [], []),
                       device="cpu", num_shards=2, serve=True)


# ------------------------------------------------------------- knobs

FLEET_CASES = [
    ({}, {}),
    ({"replicas": 3, "compile_store": "/tmp/store", "redispatch_max": 5,
      "drain_timeout_s": 7.0}, {}),
    ({"replicas": 3, "compile_store": "/tmp/store"},
     {"HYDRAGNN_FLEET_REPLICAS": "4",
      "HYDRAGNN_FLEET_COMPILE_STORE": "/env/store",
      "HYDRAGNN_FLEET_REDISPATCH_MAX": "2",
      "HYDRAGNN_FLEET_DRAIN_TIMEOUT_S": "9.5"}),
    ({"replicas": 2}, {"HYDRAGNN_FLEET_REPLICAS": "three",
                       "HYDRAGNN_FLEET_DRAIN_TIMEOUT_S": "soon"}),
    ({"compile_store": "  "}, {"HYDRAGNN_FLEET_COMPILE_STORE": ""}),
    ({"tier_priority_min": 2, "tier_quota": 0.25, "tier_fast": "bf16"},
     {"HYDRAGNN_FLEET_TIER_ACCURATE": "fp32",
      "HYDRAGNN_FLEET_TIER_QUOTA": "a lot"}),
    ({"replicas": 0, "redispatch_max": None},
     {"HYDRAGNN_FLEET_TIER_PRIORITY_MIN": "5",
      "HYDRAGNN_FLEET_TIER_FAST": "int8-student"}),
]
FLEET_ENVS = ("HYDRAGNN_FLEET_REPLICAS", "HYDRAGNN_FLEET_COMPILE_STORE",
              "HYDRAGNN_FLEET_REDISPATCH_MAX",
              "HYDRAGNN_FLEET_DRAIN_TIMEOUT_S",
              "HYDRAGNN_FLEET_TIER_PRIORITY_MIN", "HYDRAGNN_FLEET_TIER_QUOTA",
              "HYDRAGNN_FLEET_TIER_FAST", "HYDRAGNN_FLEET_TIER_ACCURATE")


@pytest.mark.parametrize("block,env", FLEET_CASES)
def test_resolve_fleet_matches_jax(monkeypatch, caplog, block, env):
    """Every field as the JAX package resolves it, config or env, typos
    (warned in both packages) included."""
    for name in FLEET_ENVS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = {"Serving": {"fleet": block}}
    with caplog.at_level("WARNING"):
        got = resolve_fleet(cfg)
        want = j_resolve_fleet(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    warned = {r.name for r in caplog.records}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)
    assert isinstance(got, FleetConfig)


@pytest.mark.parametrize("replicas", [1, 2])
def test_run_prediction_tags_engines_with_the_state_step(served, monkeypatch,
                                                         replicas):
    """C8: run_prediction from a TrainState at step 7 serves as
    "step_7", as JAX's does: `health()["model_version"]` (per replica in
    a fleet) and the scrape's `serving_model{version=...}` lines equal
    JAX's, on one engine and on a fleet of 2; `variables=` keeps "v0"."""
    import importlib
    import re
    from hydragnn_tpu import run_prediction as j_run_prediction
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.models.create import create_model as j_create_model
    from hydragnn_tpu.serving import engine as jengine
    from hydragnn_tpu.train.optimizer import select_optimizer as j_select
    from hydragnn_tpu.train.train_step import TrainState as JState
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    for name in ("HYDRAGNN_SERVE", "HYDRAGNN_FLEET_REPLICAS",
                 "HYDRAGNN_SERVE_PRECISION"):
        monkeypatch.delenv(name, raising=False)
    samples, jsamples, mcfg, variables = served
    cfg = make_config("GIN")
    cfg["Serving"] = {"enabled": True, "fleet": {"replicas": replicas}}
    train_cfg = cfg["NeuralNetwork"]["Training"]
    seen = {}

    def spy(package, mod, cls_name, prom):
        cls = getattr(mod, cls_name)

        class Spy(cls):
            def predict(self, *a, **kw):
                out = super().predict(*a, **kw)
                if replicas == 1 or cls_name == "ReplicaRouter":
                    h = self.health()
                    versions = ([r["model_version"] for _, r in
                                 sorted(h["replicas"].items())]
                                if "replicas" in h
                                else [h["model_version"]])
                    lines = sorted(re.findall(r"hydragnn_serving_model\{.*",
                                              prom(self)))
                    seen[package] = (versions, lines)
                return out
        monkeypatch.setattr(mod, cls_name, Spy)

    rp = importlib.import_module("hydragnn_tpu_torch.run_prediction")
    spy("port", rp, "InferenceEngine", thttp.engine_prometheus)
    spy("jax", jengine, "InferenceEngine", jhttp.engine_prometheus)
    spy("port", tfleet, "ReplicaRouter", thttp.fleet_prometheus)
    spy("jax", jfleet, "ReplicaRouter", jhttp.fleet_prometheus)

    def split(s):
        return s[:14], s[14:19], s[19:]
    model = model_on(mcfg, variables)
    state = TrainState.create(model, select_optimizer(train_cfg))
    state.step = 7
    run_prediction(copy.deepcopy(cfg), datasets=split(samples), state=state,
                   device="cpu")
    jdone = jcfg.update_config(copy.deepcopy(cfg), *split(jsamples))
    jmodel = j_create_model(jcfg.build_model_config(jdone))
    jvars = jax.tree_util.tree_map(np.asarray, variables)
    jstate = JState.create({"params": jvars["params"],
                            "batch_stats": jvars.get("batch_stats", {})},
                           j_select(train_cfg)).replace(step=7)
    j_run_prediction(copy.deepcopy(cfg), datasets=split(jsamples),
                     state=jstate, model=jmodel)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ["step_7"] * replicas
    run_prediction(copy.deepcopy(cfg), datasets=split(samples),
                   variables=variables, device="cpu")
    assert seen["port"][0] == ["v0"] * replicas
