"""The port's continuous loop over the fleet (hydragnn_tpu_torch/serving/
publish.py and autoscale.py) on the CPU: the cases of
tests/test_serving_publish.py on the port, and against the JAX package's
live output.

* `pair_rel_err` and `adjudicate_window`: the verdicts, bitwise the JAX
  functions' on the same windows;
* the publisher promotes a good BEST/COMMITTED checkpoint through the
  canary (one drained replica, a mirrored slice, the verdict, the roll)
  with no future lost, and rolls a poisoned one back with quarantine; a
  fresh publisher skips the quarantined version;
* an uncommitted BEST marker: `hot_swap_from_checkpoint` raises naming
  the dir, the publisher counts and retries;
* a partial hot swap names both sides of the mixed fleet; a promote that
  fails part way restores one version and quarantines the candidate;
* the autoscaler: watermarks, clamps, the p99 signal, slot revival,
  cooldown and the canary freeze on a stub router, its decisions equal
  to the JAX autoscaler's over a scripted run, and one up-and-down cycle
  on a real CPU fleet warmed from the store;
* health(), stats() and /metrics carry the canary and quarantine state;
* `resolve_publish` and `resolve_autoscale` equal JAX's, typos included.
"""
import copy
import dataclasses
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from hydragnn_tpu.serving import autoscale as jautoscale
from hydragnn_tpu.serving import publish as jpublish
from hydragnn_tpu.serving.config import (AutoscaleConfig as JAutoscaleConfig,
                                         PublishConfig as JPublishConfig,
                                         resolve_autoscale as
                                         j_resolve_autoscale,
                                         resolve_publish as j_resolve_publish)
from hydragnn_tpu.utils import faults as jfaults
from hydragnn_tpu_torch.serving.autoscale import QueueDepthAutoscaler
from hydragnn_tpu_torch.serving.config import (AutoscaleConfig,
                                               PublishConfig,
                                               resolve_autoscale,
                                               resolve_publish)
from hydragnn_tpu_torch.serving.fleet import ReplicaRouter, SwapFailedError
from hydragnn_tpu_torch.serving.publish import (CheckpointPublisher,
                                                adjudicate_window,
                                                pair_rel_err)
from hydragnn_tpu_torch.utils.checkpoint import (COMMIT_MARKER,
                                                 UncommittedCheckpointError,
                                                 marker_target, save_model)
from hydragnn_tpu_torch.utils.devices import CompileStore
from hydragnn_tpu_torch.utils.faults import (install_fault_plan,
                                             parse_fault_plan)
from tests.test_torch_fleet import factory, model_on, scaled, served  # noqa

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    install_fault_plan(None)
    jfaults.install_fault_plan(None)


def save_best(served, tmp_path, log, scale, poison=False):
    """A BEST/COMMITTED checkpoint of the fixture's weights times `scale`
    (with `poison`, one NaN); returns the serving TrainState template."""
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    _, _, mcfg, variables = served
    tx = select_optimizer({"Optimizer": {"type": "AdamW",
                                         "learning_rate": 1e-3}})
    model = model_on(mcfg, scaled(variables, scale))
    if poison:
        with torch.no_grad():
            next(iter(model.parameters())).view(-1)[0] = float("nan")
    save_model(TrainState.create(model, tx), log, path=str(tmp_path),
               mark_best=True, best_val=0.5)
    return TrainState.create(model_on(mcfg, variables), tx)


FAST = dict(poll_interval_s=0.05, mirror_every=1, window_pairs=4,
            min_pairs=2, window_timeout_s=30.0, max_rel_err=5.0,
            latency_factor=100.0, latency_floor_ms=1000.0)


def with_traffic(router, samples, fn, max_submits=4000):
    """Run `fn` on a thread while this thread pumps requests, one at a
    time (a shadow window fills only under load); returns (fn's result,
    every primary future)."""
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("out", fn()))
    t.start()
    futs = []
    i = 0
    while t.is_alive() and i < max_submits:
        f = router.submit(samples[i % len(samples)])
        futs.append(f)
        f.exception(timeout=60)
        i += 1
    t.join(timeout=120)
    assert not t.is_alive(), "publish did not finish under traffic"
    return box.get("out"), futs


# ---------------------------------------------------------- adjudication

def test_pair_rel_err_semantics_and_jax():
    a = [np.ones((3, 2)), np.full((4,), 2.0)]
    cases = [
        [x.copy() for x in a],
        [x * 1.1 for x in a],
        [np.ones((3, 2)), np.array([1.0, np.nan, 1.0, 1.0])],
        [np.ones((2, 3)), a[1]],
        [a[0]],
        [np.ones((3, 2)) * -3.0, np.full((4,), np.inf)],
        [np.zeros((3, 2)), np.full((4,), 2.0 + 1e-9)],
    ]
    assert pair_rel_err(a, cases[0]) == 0.0
    assert 0.05 < pair_rel_err(a, cases[1]) < 0.2
    for bad in cases[2:5]:
        assert pair_rel_err(a, bad) == float("inf")
    for cand in cases:
        assert pair_rel_err(a, cand) == jpublish.pair_rel_err(a, cand)
    tree = {"energy": np.array([1.5]), "forces": np.ones((5, 3))}
    other = {"energy": np.array([1.25]), "forces": np.ones((5, 3)) * 0.5}
    assert pair_rel_err(tree, other) == jpublish.pair_rel_err(tree, other)
    assert pair_rel_err([np.zeros((0, 2))], [np.zeros((0, 2))]) == 0.0


def test_adjudicate_window_verdicts_and_jax():
    cfg = PublishConfig(min_pairs=3, max_rel_err=0.25, latency_factor=2.0,
                        latency_floor_ms=1.0)
    jcfg = JPublishConfig(min_pairs=3, max_rel_err=0.25,
                          latency_factor=2.0, latency_floor_ms=1.0)
    good = [{"err": 0.01, "primary_ms": 10.0, "shadow_ms": 12.0}
            for _ in range(4)]
    v = adjudicate_window(good, 0, cfg)
    assert v["promote"] and v["enough"] and v["error_ok"] and v["latency_ok"]
    assert v["incumbent_p99_ms"] == pytest.approx(10.0)
    assert v["candidate_p99_ms"] == pytest.approx(12.0)
    v = adjudicate_window(good[:2], 0, cfg)
    assert not v["enough"] and not v["promote"] and v["error_ok"]
    drifty = good[:3] + [{"err": 0.9, "primary_ms": 10.0,
                          "shadow_ms": 10.0}]
    v = adjudicate_window(drifty, 0, cfg)
    assert v["enough"] and not v["error_ok"] and not v["promote"]
    assert not adjudicate_window(good, 1, cfg)["error_ok"]
    slow = [{"err": 0.0, "primary_ms": 10.0, "shadow_ms": 50.0}
            for _ in range(4)]
    v = adjudicate_window(slow, 0, cfg)
    assert v["error_ok"] and not v["latency_ok"] and not v["promote"]
    assert v["latency_budget_ms"] == pytest.approx(20.0)
    rng = np.random.default_rng(3)
    windows = [good, good[:2], drifty, slow, []] + [
        [{"err": float(rng.exponential(0.1)),
          "primary_ms": float(rng.uniform(0.5, 20)),
          "shadow_ms": float(rng.uniform(0.5, 40))}
         for _ in range(int(rng.integers(0, 12)))] for _ in range(20)]
    for w in windows:
        for failures in (0, 2):
            assert adjudicate_window(w, failures, cfg) == \
                jpublish.adjudicate_window(w, failures, jcfg)


# -------------------------------------------------------- promote path

def test_publisher_promotes_good_candidate(served, tmp_path):
    samples = served[0]
    template = save_best(served, tmp_path, "pub_good", 1.001)
    router = ReplicaRouter(factory(served), 2)
    try:
        pub = CheckpointPublisher(
            router, template, "pub_good", path=str(tmp_path),
            incumbent_variables=scaled(served[3], 1.0),
            incumbent_version="v1", config=PublishConfig(**FAST))
        out, futs = with_traffic(router, samples, pub.poll_once)
        assert out is not None and out["action"] == "promoted", out
        assert out["version"] == "best:step_0"
        assert out["verdict"]["pairs"] >= 2
        health = router.health()
        assert {h["model_version"]
                for h in health["replicas"].values()} == {"best:step_0"}
        assert not any(h["canary"] for h in health["replicas"].values())
        snap = pub.snapshot()
        assert snap["incumbent_version"] == "best:step_0"
        assert snap["promote_count"] == 1 and snap["rollback_count"] == 0
        assert [e["event"] for e in snap["history"]] == [
            "canary_start", "promoted"]
        assert all(f.exception(timeout=0) is None for f in futs)
        assert pub.poll_once() is None
    finally:
        router.shutdown()


@pytest.mark.parametrize("poison", ["scaled", "nan"])
def test_publisher_rolls_back_poisoned_candidate(served, tmp_path, poison):
    samples = served[0]
    template = save_best(served, tmp_path, "pub_poison",
                         1e3 if poison == "scaled" else 1.0,
                         poison=poison == "nan")
    router = ReplicaRouter(factory(served), 2)
    try:
        def publisher():
            return CheckpointPublisher(
                router, template, "pub_poison", path=str(tmp_path),
                incumbent_variables=scaled(served[3], 1.0),
                incumbent_version="v1", config=PublishConfig(**FAST))
        pub = publisher()
        out, futs = with_traffic(router, samples, pub.poll_once)
        assert out is not None and out["action"] == "rolled_back", out
        health = router.health()
        assert {h["model_version"]
                for h in health["replicas"].values()} == {"v1"}
        assert all(f.exception(timeout=0) is None for f in futs)
        assert {f.model_version for f in futs} == {"v1"}
        assert "best:step_0" in router.quarantined_versions()
        snap = pub.snapshot()
        assert snap["rollback_count"] == 1 and snap["promote_count"] == 0
        pub2 = publisher()
        assert pub2.poll_once() is None
        assert [e["event"] for e in pub2.snapshot()["history"]] == [
            "skipped_quarantined"]
        assert router.health()["swap_failures"] == 0
    finally:
        router.shutdown()


def test_uncommitted_marker_refused_and_named(served, tmp_path):
    template = save_best(served, tmp_path, "pub_torn", 1.001)
    target = marker_target("pub_torn", path=str(tmp_path), which="best")
    os.remove(os.path.join(target, COMMIT_MARKER))
    router = ReplicaRouter(factory(served), 2)
    try:
        with pytest.raises(UncommittedCheckpointError) as ei:
            router.hot_swap_from_checkpoint(template, "pub_torn",
                                            path=str(tmp_path))
        msg = str(ei.value)
        assert target in msg
        assert "COMMITTED" in msg and "wait_for_checkpoints" in msg
        assert {h["model_version"] for h in
                router.health()["replicas"].values()} == {"v1"}
        pub = CheckpointPublisher(
            router, template, "pub_torn", path=str(tmp_path),
            incumbent_variables=scaled(served[3], 1.0),
            incumbent_version="v1", config=PublishConfig(**FAST))
        assert pub.poll_once() is None
        assert pub.snapshot()["skipped_uncommitted"] == 1
        assert pub.snapshot()["last_step"] == -1
    finally:
        router.shutdown()


def test_hot_swap_failure_names_mixed_fleet(served):
    samples, _, _, variables = served
    router = ReplicaRouter(factory(served), 3)
    try:
        install_fault_plan(parse_fault_plan("swap-fail@1"))
        with pytest.raises(SwapFailedError) as ei:
            router.hot_swap(scaled(variables, 2.0), "v2")
        assert "MIXED-VERSION" in str(ei.value)
        report = ei.value.report
        assert sorted(int(i) for i in report["replicas"]) == [0, 2]
        assert [f["replica"] for f in report["failed"]] == [1]
        health = router.health()
        assert [health["replicas"][str(i)]["model_version"]
                for i in range(3)] == ["v2", "v1", "v2"]
        futs = [router.submit(s) for s in samples[:6]]
        assert all(f.exception(timeout=60) is None for f in futs)
        assert {f.model_version for f in futs} <= {"v1", "v2"}
        assert router.hot_swap(scaled(variables, 2.0), "v2")["failed"] == []
    finally:
        router.shutdown()


def test_promote_failure_restores_one_coherent_version(served):
    samples, _, _, variables = served
    router = ReplicaRouter(factory(served), 3)
    try:
        pub = CheckpointPublisher(
            router, None, "unused", incumbent_variables=scaled(variables, 1.0),
            incumbent_version="v1", config=PublishConfig(**FAST))
        # consultation 0: the canary's swap; 1: the first promote swap
        install_fault_plan(parse_fault_plan("swap-fail@1"))
        out, futs = with_traffic(
            router, samples,
            lambda: pub.publish(scaled(variables, 1.001), "v2"))
        assert out["action"] == "rolled_back", out
        assert "promote failed on replica 0" in out["reason"]
        health = router.health()
        assert {h["model_version"]
                for h in health["replicas"].values()} == {"v1"}
        assert not any(h["canary"] for h in health["replicas"].values())
        assert "v2" in router.quarantined_versions()
        assert all(f.exception(timeout=0) is None for f in futs)
        with pytest.raises(ValueError, match="quarantined"):
            router.hot_swap(scaled(variables, 1.001), "v2")
    finally:
        router.shutdown()


# ------------------------------------------------------------ autoscaler

class FakeRouter:
    """A health()-shaped stub: depths set per test, scale calls recorded
    and applied to the fake fleet."""

    def __init__(self, depths, canary=None, retired=()):
        self.depth = {i: float(d) for i, d in enumerate(depths)}
        self.retired = set(retired)
        self.canary = canary
        self.calls = []
        self.latencies_ms = []

    def health(self):
        reps = {}
        for i in sorted(set(self.depth) | self.retired):
            dead = i in self.retired
            reps[str(i)] = {"alive": not dead, "retired": dead,
                            "draining": False, "dispatcher_alive": not dead,
                            "canary": i == self.canary,
                            "queue_depth": self.depth.get(i, 0.0)}
        return {"state": "serving", "replicas": reps}

    def restart_replica(self, idx):
        self.calls.append(("restart", idx))
        self.retired.discard(idx)
        self.depth[idx] = 0.0
        return {"replica": idx, "fresh": 0, "warmup_s": 0.0}

    def add_replica(self):
        idx = len(self.depth) + len(self.retired)
        self.calls.append(("add", idx))
        self.depth[idx] = 0.0
        return {"replica": idx, "fresh": 0, "warmup_s": 0.0}

    def retire_replica(self, idx, timeout_s=None):
        self.calls.append(("retire", idx))
        self.retired.add(idx)
        self.depth.pop(idx, None)
        return {"replica": idx, "retired": True}

    def stats(self):
        if not self.latencies_ms:
            return {"count": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                    "p99_ms": 0.0, "mean_ms": 0.0}
        arr = sorted(float(x) for x in self.latencies_ms)
        return {"count": len(arr), "p50_ms": arr[len(arr) // 2],
                "p95_ms": arr[-1], "p99_ms": arr[-1],
                "mean_ms": sum(arr) / len(arr)}


def as_cfg(**kw):
    kw.setdefault("cooldown_s", 0.0)
    return AutoscaleConfig(**kw)


def test_autoscaler_watermarks_and_clamps():
    fr = FakeRouter([6.0, 6.0])
    ev = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=3)).step()
    assert ev["action"] == "scale_up" and not ev["revived"]
    assert fr.calls == [("add", 2)]
    fr = FakeRouter([6.0, 6.0])
    a = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=2))
    assert a.step() is None and fr.calls == []
    fr = FakeRouter([0.0, 0.0, 0.0])
    ev = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=4)).step()
    assert ev["action"] == "scale_down" and ev["replica"] == 2
    assert QueueDepthAutoscaler(FakeRouter([0.0]),
                                config=as_cfg()).step() is None
    assert QueueDepthAutoscaler(FakeRouter([2.0, 2.0]),
                                config=as_cfg(max_replicas=4)).step() is None


def test_autoscaler_p99_latency_signal():
    cfg = as_cfg(signal="p99_latency", high_p99_ms=100.0, low_p99_ms=10.0,
                 max_replicas=4)
    fr = FakeRouter([0.0, 0.0])
    fr.latencies_ms = [5.0, 8.0, 250.0]
    ev = QueueDepthAutoscaler(fr, config=cfg).step()
    assert ev["action"] == "scale_up" and ev["signal"] == "p99_latency"
    assert ev["avg_depth"] == 250.0
    fr = FakeRouter([9.0, 9.0, 9.0])
    fr.latencies_ms = [1.0, 2.0, 3.0]
    assert QueueDepthAutoscaler(fr, config=cfg).step()["action"] == \
        "scale_down"
    fr = FakeRouter([9.0, 9.0, 9.0])
    assert QueueDepthAutoscaler(fr, config=cfg).step() is None
    assert fr.calls == []


def test_autoscaler_revives_retired_slot_first():
    fr = FakeRouter([6.0], retired={1})
    ev = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=3)).step()
    assert ev["action"] == "scale_up" and ev["revived"]
    assert fr.calls == [("restart", 1)]
    assert ev["fresh_compiles"] == 0


def test_autoscaler_cooldown_and_canary_freeze():
    fr = FakeRouter([6.0, 6.0])
    a = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=8,
                                               cooldown_s=3600.0))
    assert a.step() is not None
    fr.depth = {i: 6.0 for i in fr.depth}
    assert a.step() is None
    assert a.snapshot()["scale_up_count"] == 1
    fr = FakeRouter([6.0, 6.0], canary=1)
    a = QueueDepthAutoscaler(fr, config=as_cfg(max_replicas=4))
    assert a.step() is None
    assert a.snapshot()["skipped_canary"] == 1
    with pytest.raises(ValueError, match="min_replicas"):
        QueueDepthAutoscaler(fr, config=AutoscaleConfig(min_replicas=0))
    with pytest.raises(ValueError, match="max_replicas"):
        QueueDepthAutoscaler(fr, config=AutoscaleConfig(min_replicas=3,
                                                        max_replicas=2))


@pytest.mark.parametrize("signal", ["queue_depth", "p99_latency"])
def test_autoscaler_decisions_match_jax(signal):
    """The port's and JAX's autoscalers over twin stub fleets and one
    scripted run of 60 snapshots (depths, latencies, a canary now and
    then): the same actions on the same replicas, in the same order."""
    rng = np.random.default_rng(11)
    kw = dict(signal=signal, min_replicas=1, max_replicas=5,
              high_depth=3.0, low_depth=0.5, high_p99_ms=80.0,
              low_p99_ms=20.0, cooldown_s=0.0)
    port, ref = FakeRouter([1.0, 1.0]), FakeRouter([1.0, 1.0])
    a = QueueDepthAutoscaler(port, config=AutoscaleConfig(**kw))
    b = jautoscale.QueueDepthAutoscaler(ref, config=JAutoscaleConfig(**kw))
    for _ in range(60):
        level = float(rng.choice([0.0, 0.2, 1.5, 4.0, 9.0]))
        lat = [float(x) for x in rng.uniform(1.0, 150.0,
                                             int(rng.integers(0, 4)))]
        canary = int(rng.integers(0, 3)) if rng.random() > 0.8 else None
        for fr in (port, ref):
            fr.depth = {i: level for i in fr.depth}
            fr.latencies_ms = list(lat)
            fr.canary = canary
        got, want = a.step(), b.step()
        assert (got is None) == (want is None)
        if got is not None:
            strip = ("t_s", "warmup_s")
            assert {k: v for k, v in got.items() if k not in strip} == \
                {k: v for k, v in want.items() if k not in strip}
    assert port.calls == ref.calls and len(port.calls) > 4
    snap_a, snap_b = a.snapshot(), b.snapshot()
    for key in ("scale_up_count", "scale_down_count", "skipped_canary"):
        assert snap_a[key] == snap_b[key]


def test_autoscale_cycle_on_real_fleet(served, tmp_path):
    """add_replica warms from the shared store and joins on the published
    version; retire drains (no future lost); restart_replica revives the
    retired slot from the store."""
    samples, _, _, variables = served
    store = CompileStore(str(tmp_path / "store"))
    router = ReplicaRouter(factory(served, store), 1)
    try:
        router.warmup()
        router.hot_swap(scaled(variables, 2.0), "v2")
        report = router.add_replica()
        assert report["replica"] == 1
        assert report["fresh"] == 0 and report["store_hits"] > 0
        assert router.health()["replicas"]["1"]["model_version"] == "v2"
        futs = [router.submit(s) for s in samples[:8]]
        assert all(f.exception(timeout=60) is None for f in futs)
        router.retire_replica(1)
        health = router.health()
        assert health["replicas"]["1"]["retired"]
        assert not health["replicas"]["1"]["alive"]
        assert health["retires"] == 1
        with pytest.raises(ValueError, match="retired"):
            router.retire_replica(1)
        futs = [router.submit(s) for s in samples[:4]]
        assert all(f.exception(timeout=60) is None for f in futs)
        assert {f.replica for f in futs} == {0}
        report = router.restart_replica(1)
        assert report["fresh"] == 0
        h1 = router.health()["replicas"]["1"]
        assert h1["alive"] and not h1["retired"]
        assert h1["model_version"] == "v2"
        # and the autoscaler drives one cycle on it
        scaler = QueueDepthAutoscaler(router, config=as_cfg(
            max_replicas=3, high_depth=0.0, low_depth=-1.0))
        ev = scaler.step()
        assert ev["action"] == "scale_up" and ev["fresh_compiles"] == 0
        scaler.cfg = as_cfg(max_replicas=3, high_depth=1e9, low_depth=1e9)
        ev = scaler.step()
        assert ev["action"] == "scale_down" and ev["replica"] == 2
        futs = [router.submit(s) for s in samples[:6]]
        assert all(f.exception(timeout=60) is None for f in futs)
    finally:
        router.shutdown()


# --------------------------------------------------------- observability

def test_health_stats_and_metrics_surface_canary_state(served):
    samples = served[0]
    router = ReplicaRouter(factory(served), 2)
    try:
        router.submit(samples[0]).result(timeout=60)
        router.set_canary(1, True)
        router.quarantine_version("bad:step_9", "test poison")
        health = router.health()
        assert health["replicas"]["1"]["canary"]
        assert not health["replicas"]["0"]["canary"]
        assert health["quarantined_versions"] == ["bad:step_9"]
        st = router.stats()
        assert st["canary_replicas"] == [1]
        assert st["quarantined_versions"] == ["bad:step_9"]
        futs = [router.submit(s) for s in samples[:6]]
        assert all(f.exception(timeout=60) is None for f in futs)
        assert {f.replica for f in futs} == {0}
        server = router.start_metrics_server(port=0)
        with urllib.request.urlopen(f"{server.url}/metrics") as r:
            text = r.read().decode()
        for line in (
                'hydragnn_serving_replica_version_info{replica="0",'
                'state="primary",version="v1"} 1',
                'hydragnn_serving_replica_version_info{replica="1",'
                'state="canary",version="v1"} 1',
                'hydragnn_serving_replica_canary_state{replica="1",'
                'state="canary"} 1',
                'hydragnn_serving_replica_canary_state{replica="1",'
                'state="primary"} 0',
                'hydragnn_serving_replica_canary_state{replica="0",'
                'state="primary"} 1',
                'hydragnn_serving_fleet_quarantined_versions 1',
                'hydragnn_serving_fleet_quarantined_info'
                '{version="bad:step_9"} 1'):
            assert line in text, line
    finally:
        router.shutdown()


# ---------------------------------------------------------------- config

PUBLISH_CASES = [
    ({}, {}),
    ({"window_pairs": 16, "max_rel_err": 0.1}, {}),
    ({"window_pairs": 16, "max_rel_err": 0.1},
     {"HYDRAGNN_PUBLISH_WINDOW_PAIRS": "32",
      "HYDRAGNN_PUBLISH_LATENCY_FACTOR": "5.5"}),
    ({"window_pairs": 16}, {"HYDRAGNN_PUBLISH_WINDOW_PAIRS": "lots",
                            "HYDRAGNN_PUBLISH_POLL_S": "often"}),
    ({"mirror_every": 0, "min_pairs": None},
     {"HYDRAGNN_PUBLISH_MIN_PAIRS": "", "HYDRAGNN_PUBLISH_MIRROR_EVERY": "3",
      "HYDRAGNN_PUBLISH_WINDOW_TIMEOUT_S": "12.5",
      "HYDRAGNN_PUBLISH_MAX_REL_ERR": "0.5",
      "HYDRAGNN_PUBLISH_LATENCY_FLOOR_MS": "5"}),
]
AUTOSCALE_CASES = [
    ({}, {}),
    ({"max_replicas": 8, "high_depth": 12.0}, {}),
    ({"max_replicas": 8}, {"HYDRAGNN_AUTOSCALE_MAX": "6",
                           "HYDRAGNN_AUTOSCALE_LOW_DEPTH": "0.25"}),
    ({"max_replicas": 8}, {"HYDRAGNN_AUTOSCALE_MAX": "many"}),
    ({}, {"HYDRAGNN_AUTOSCALE_SIGNAL": "p99_latency",
          "HYDRAGNN_AUTOSCALE_HIGH_P99_MS": "150"}),
    ({}, {"HYDRAGNN_AUTOSCALE_SIGNAL": "p99"}),
    ({"signal": "p99_latency", "low_p99_ms": 5.0},
     {"HYDRAGNN_AUTOSCALE_MIN": "2", "HYDRAGNN_AUTOSCALE_COOLDOWN_S": "1",
      "HYDRAGNN_AUTOSCALE_POLL_S": "0.5",
      "HYDRAGNN_AUTOSCALE_DRAIN_TIMEOUT_S": "x",
      "HYDRAGNN_AUTOSCALE_HIGH_DEPTH": "7"}),
]


def _resolved(monkeypatch, caplog, prefix, env, port_fn, jax_fn, cfg):
    for name in list(os.environ):
        if name.startswith(prefix):
            monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with caplog.at_level("WARNING"):
        got, want = port_fn(cfg), jax_fn(cfg)
    warned = {r.name for r in caplog.records}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)
    return dataclasses.asdict(got), dataclasses.asdict(want)


@pytest.mark.parametrize("block,env", PUBLISH_CASES)
def test_resolve_publish_matches_jax(monkeypatch, caplog, block, env):
    got, want = _resolved(monkeypatch, caplog, "HYDRAGNN_PUBLISH_", env,
                          resolve_publish, j_resolve_publish,
                          {"Serving": {"publish": copy.deepcopy(block)}})
    assert got == want


@pytest.mark.parametrize("block,env", AUTOSCALE_CASES)
def test_resolve_autoscale_matches_jax(monkeypatch, caplog, block, env):
    got, want = _resolved(monkeypatch, caplog, "HYDRAGNN_AUTOSCALE_", env,
                          resolve_autoscale, j_resolve_autoscale,
                          {"Serving": {"autoscale": copy.deepcopy(block)}})
    assert got == want
