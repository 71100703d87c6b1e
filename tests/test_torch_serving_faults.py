"""The port's serving failure semantics and hot swap (hydragnn_tpu_torch/
serving/engine.py) on its CPU engine: the tests of
tests/test_serving_faults.py on the port, and against the JAX engine.

* every accepted future resolves, result or error, under injected
  dispatch faults, and a failed batch fails only its own futures;
* the bounded admission queue fast-fails with QueueFullError;
* an expired request never enters a batch;
* the breaker trips, fast-fails, recovers through one half-open probe,
  re-opens on a failed or expired probe, fails queued requests fast, and
  admits exactly one probe under a concurrent hammer;
* the same fault plan on a one-at-a-time stream gives the JAX engine's
  `health()` keys and counters;
* `swap_variables` serves bitwise what a fresh engine on the new weights
  serves, echoes the version, refuses a mismatched tree before any
  change, and leaves the old version serving when `swap-fail` fires.
"""
import copy
import threading
import time

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.graphs.batch import collate as j_collate
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.models.create import init_params as j_init_params
from hydragnn_tpu.serving.engine import InferenceEngine as JEngine
from hydragnn_tpu.utils import faults as jfaults
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.serving.engine import (CircuitOpenError,
                                               DeadlineExceededError,
                                               InferenceEngine,
                                               QueueFullError)
from hydragnn_tpu_torch.utils.faults import (InjectedFault,
                                             active_fault_plan,
                                             install_fault_plan,
                                             parse_fault_plan)
from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                              random_flax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)


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
    model = create_model(mcfg, device="cpu")
    variables = random_flax_variables(model, 0)
    model.load_state_dict(load_jax_variables(variables))
    return samples, jsamples, mcfg, model, variables


def _engine(served, **kw):
    samples, _, mcfg, model, _ = served
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 5.0)
    return InferenceEngine(model, mcfg, reference_samples=samples,
                           device="cpu", **kw)


class _BlockedDispatcher:
    """Park the dispatcher inside its first _execute, so a test can fill
    or expire the queue without racing the batch loop."""

    def __init__(self, eng):
        self.entered = threading.Event()
        self.release = threading.Event()
        orig = eng._execute

        def blocked(reqs):
            self.entered.set()
            assert self.release.wait(30)
            return orig(reqs)

        eng._execute = blocked


def _wait_all(futs):
    for f in futs:
        f.exception(timeout=60)
    assert all(f.done() for f in futs)


# ------------------------------------------------------- injected failures

def test_dispatch_fault_resolves_only_its_batch(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=2, breaker_threshold=0)
    try:
        plan = install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        assert active_fault_plan() is plan
        futs = [eng.submit(s) for s in samples[:8]]
        _wait_all(futs)
        # one count a batch the dispatcher ran, the first of them fired
        assert plan.fired() == [("serving-dispatch", 0)]
        assert plan.counts() == {"serving-dispatch":
                                 eng.stats()["batches"] + 1}
        errs = [f for f in futs if f.exception(timeout=0) is not None]
        oks = [f for f in futs if f.exception(timeout=0) is None]
        assert 1 <= len(errs) <= 2
        assert all(isinstance(f.exception(timeout=0), InjectedFault)
                   for f in errs)
        assert oks, "the dispatcher must survive a failed batch"
        for s, f in zip(samples[:8], futs):
            if f.exception(timeout=0) is None:
                ref = eng.forward_single(s, bucket=f.bucket)
                for a, b in zip(f.result(timeout=0), ref):
                    np.testing.assert_array_equal(a, b)
                assert f.model_version == "v0"
        assert eng.health()["batch_failures"] == 1
    finally:
        eng.shutdown()


def test_no_futures_lost_under_repeated_faults(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=2, breaker_threshold=0)
    try:
        install_fault_plan(parse_fault_plan("serving-dispatch@0,2,4"))
        futs = [eng.submit(s) for s in samples[:16]]
        _wait_all(futs)
        health = eng.health()
        assert health["batch_failures"] == 3
        assert health["dispatcher_alive"]
        assert eng.submit(samples[0]).result(timeout=60) is not None
    finally:
        eng.shutdown()
    assert not eng.health()["dispatcher_alive"]


# -------------------------------------------------------------- admission

def test_queue_full_fast_fails_without_blocking(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0, max_queue=2)
    block = _BlockedDispatcher(eng)
    try:
        f1 = eng.submit(samples[0])
        assert block.entered.wait(30)
        f2 = eng.submit(samples[1])
        f3 = eng.submit(samples[2])
        t0 = time.perf_counter()
        with pytest.raises(QueueFullError):
            eng.submit(samples[3])
        assert time.perf_counter() - t0 < 1.0
        assert eng.health()["queue_rejections"] == 1
        assert eng.stats()["max_queue_depth"] == 2
        block.release.set()
        for f in (f1, f2, f3):
            assert f.result(timeout=60) is not None
    finally:
        block.release.set()
        eng.shutdown()


def test_deadline_expired_never_enters_a_batch(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0,
                  default_deadline_ms=1.0)
    block = _BlockedDispatcher(eng)
    try:
        f1 = eng.submit(samples[0], deadline_ms=60_000.0)
        assert block.entered.wait(30)
        f2 = eng.submit(samples[1])     # the engine's default deadline
        time.sleep(0.05)
        block.release.set()
        assert f1.result(timeout=60) is not None
        with pytest.raises(DeadlineExceededError):
            f2.result(timeout=60)
        st = eng.stats()
        assert st["deadline_expired"] == 1
        assert st["requests"] == 1
    finally:
        block.release.set()
        eng.shutdown()


# --------------------------------------------------------- circuit breaker

def test_circuit_breaker_trips_and_recovers(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0,
                  breaker_threshold=2, breaker_reset_s=0.2)
    try:
        install_fault_plan(parse_fault_plan("serving-dispatch@0,1"))
        for i in range(2):
            with pytest.raises(InjectedFault):
                eng.submit(samples[i]).result(timeout=60)
        health = eng.health()
        assert health["state"] == "open"
        assert health["trip_count"] == 1
        assert health["consecutive_failures"] == 2
        with pytest.raises(CircuitOpenError):
            eng.submit(samples[2])
        assert eng.health()["circuit_rejections"] == 1
        time.sleep(0.25)
        assert eng.health()["breaker_probe_due"]
        probe = eng.submit(samples[3])
        assert probe.result(timeout=60) is not None
        health = eng.health()
        assert health["state"] == "closed"
        assert health["consecutive_failures"] == 0
        assert health["probe_count"] == 1
        assert eng.submit(samples[4]).result(timeout=60) is not None
    finally:
        eng.shutdown()


def test_breaker_reopens_on_failed_probe(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0,
                  breaker_threshold=1, breaker_reset_s=0.15)
    try:
        install_fault_plan(parse_fault_plan("serving-dispatch@0,1"))
        with pytest.raises(InjectedFault):
            eng.submit(samples[0]).result(timeout=60)
        assert eng.health()["state"] == "open"
        time.sleep(0.2)
        with pytest.raises(InjectedFault):
            eng.submit(samples[1]).result(timeout=60)
        health = eng.health()
        assert health["state"] == "open"
        assert health["trip_count"] == 2
        time.sleep(0.2)
        assert eng.submit(samples[2]).result(timeout=60) is not None
        assert eng.health()["state"] == "closed"
    finally:
        eng.shutdown()


def test_expired_probe_reopens_instead_of_wedging(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0,
                  breaker_threshold=1, breaker_reset_s=0.1)
    block = None
    try:
        eng.warmup()
        install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        with pytest.raises(InjectedFault):
            eng.submit(samples[0]).result(timeout=60)
        assert eng.health()["state"] == "open"
        time.sleep(0.15)
        block = _BlockedDispatcher(eng)
        probe = eng.submit(samples[1], deadline_ms=20.0)
        assert eng.health()["state"] == "half_open"
        assert eng.health()["probe_count"] == 1
        with pytest.raises(CircuitOpenError):
            eng.submit(samples[2])
        time.sleep(0.05)
        block.release.set()
        with pytest.raises(DeadlineExceededError):
            probe.result(timeout=60)
        assert eng.health()["state"] == "open"
        f = eng.submit(samples[3])
        assert f.result(timeout=60) is not None
        assert eng.health()["state"] == "closed"
        assert eng.health()["probe_count"] == 2
    finally:
        if block is not None:
            block.release.set()
        eng.shutdown()


def test_queued_requests_fail_fast_behind_open_breaker(served):
    samples = served[0]
    eng = _engine(served, max_batch_size=1, max_wait_ms=0.0,
                  breaker_threshold=1, breaker_reset_s=30.0)
    block = _BlockedDispatcher(eng)
    try:
        install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        f1 = eng.submit(samples[0])
        assert block.entered.wait(30)
        f2 = eng.submit(samples[1])
        block.release.set()
        with pytest.raises(InjectedFault):
            f1.result(timeout=60)
        with pytest.raises(CircuitOpenError):
            f2.result(timeout=60)
    finally:
        block.release.set()
        eng.shutdown()


def test_half_open_single_probe_hammer(served):
    """With the breaker open and its window elapsed, 16 concurrent
    submits from 8 threads admit exactly one probe; it succeeds, every
    admitted future resolves, and the circuit closes."""
    samples = served[0]
    eng = _engine(served, max_batch_size=2, max_wait_ms=0.0,
                  breaker_threshold=1, breaker_reset_s=0.3)
    try:
        eng.warmup()
        install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        with pytest.raises(InjectedFault):
            eng.submit(samples[0]).result(timeout=60)
        assert eng.health()["state"] == "open"
        time.sleep(0.35)
        barrier = threading.Barrier(8)
        futs, refused = [], []
        lock = threading.Lock()

        def hammer(k):
            barrier.wait()
            for s in samples[1 + 2 * k:3 + 2 * k]:
                try:
                    f = eng.submit(s)
                except CircuitOpenError:
                    with lock:
                        refused.append(s)
                    continue
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        _wait_all(futs)
        health = eng.health()
        assert health["probe_count"] == 1
        assert health["trip_count"] == 1
        assert health["state"] == "closed"
        assert len(futs) + len(refused) == 16 and len(futs) >= 1
        assert health["circuit_rejections"] == len(refused)
        assert all(f.exception(timeout=0) is None for f in futs)
        assert eng.submit(samples[0]).result(timeout=60) is not None
    finally:
        eng.shutdown()


# ----------------------------------------------------------- against JAX

def _stream(eng, samples, plan_mod, errors):
    """One request at a time through `eng` under the plan
    serving-dispatch@1,2,5 (breaker 2, reset 0.3 s): served, two failed
    batches (trip), a refused submit, the probe after the window, served,
    a failure, served, and an expired request. Returns the outcome of
    each request."""
    plan_mod.install_fault_plan(
        plan_mod.parse_fault_plan("serving-dispatch@1,2,5"))
    outcome = []
    for i in range(9):
        if i == 4:
            time.sleep(0.35)
        try:
            fut = eng.submit(samples[i],
                             deadline_ms=1e-6 if i == 8 else None)
        except errors as exc:
            outcome.append(type(exc).__name__)
            continue
        exc = fut.exception(timeout=300)
        outcome.append("ok" if exc is None else type(exc).__name__)
    plan_mod.install_fault_plan(None)
    return outcome


def test_fault_stream_health_matches_jax(served):
    samples, jsamples, _, _, variables = served
    jc = jcfg.update_config(make_config("GIN"), jsamples)
    jmcfg = jcfg.build_model_config(jc)
    jmodel = j_create_model(jmcfg)
    jvars = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(
        j_init_params(jmodel, j_collate(jsamples[:4])))))
    from hydragnn_tpu.serving import engine as jengine
    kw = dict(max_batch_size=1, max_wait_ms=0.0, breaker_threshold=2,
              breaker_reset_s=0.3)
    jeng = JEngine(jmodel, jvars, jmcfg, reference_samples=jsamples, **kw)
    try:
        jeng.warmup()
        want = _stream(jeng, jsamples, jfaults, (jengine.ServingError,))
        want_health = jeng.health()
    finally:
        jeng.shutdown()
    from hydragnn_tpu_torch.serving import engine as tengine
    from hydragnn_tpu_torch.utils import faults as tfaults
    eng = _engine(served, **kw)
    try:
        eng.warmup()
        got = _stream(eng, samples, tfaults, (tengine.ServingError,))
        got_health = eng.health()
    finally:
        eng.shutdown()
    assert want == ["ok", "InjectedFault", "InjectedFault",
                    "CircuitOpenError", "ok", "ok", "InjectedFault", "ok",
                    "DeadlineExceededError"]
    assert got == want
    assert set(got_health) == set(want_health)
    for key in set(want_health) - {"uptime_s"}:
        assert got_health[key] == want_health[key], key


# --------------------------------------------------------------- hot swap

def test_swap_variables_serves_the_new_weights_bitwise(served):
    samples, _, mcfg, model, variables = served
    new_vars = random_flax_variables(model, 7)
    fresh_model = create_model(mcfg, device="cpu")
    fresh_model.load_state_dict(load_jax_variables(new_vars))
    fresh = InferenceEngine(fresh_model, mcfg, reference_samples=samples,
                            max_batch_size=4, device="cpu")
    eng = _engine(served, model_version="step_3")
    try:
        before = eng.predict(samples[:4])
        assert eng.swap_variables(new_vars, "step_9") == "step_3"
        futs = [eng.submit(s) for s in samples[:6]]
        after = [f.result(timeout=60) for f in futs]
        assert all(f.model_version == "step_9" for f in futs)
        for s, f, res in zip(samples, futs, after):
            want = fresh.forward_single(s, bucket=f.bucket)
            for a, b in zip(res, want):
                np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a[0], b[0])
                   for a, b in zip(before, after))
        health = eng.health()
        assert (health["model_version"], health["swap_count"]) == \
            ("step_9", 1)
        # back to the first weights: the engine's first answers again
        eng.swap_variables(variables, "step_3")
        for a, b in zip(eng.predict(samples[:4]), before):
            np.testing.assert_array_equal(a[0], b[0])
    finally:
        eng.shutdown()
        fresh.shutdown()


def test_swap_variables_refuses_mismatches_and_injected_failure(served):
    samples, _, _, model, variables = served
    eng = _engine(served)
    try:
        before = eng.predict(samples[:2])
        state = copy.deepcopy(model.state_dict())
        bad_shape = copy.deepcopy(variables)
        node = bad_shape["params"]
        while True:     # the first leaf, one axis longer
            key = sorted(node)[0]
            if not isinstance(node[key], dict):
                break
            node = node[key]
        node[key] = np.zeros(node[key].shape + (1,), np.float32)
        bad_dtype = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
        missing = copy.deepcopy(variables)
        missing["params"].pop(next(iter(missing["params"])))
        for bad in (bad_shape, bad_dtype, missing):
            with pytest.raises(ValueError, match="swap_variables"):
                eng.swap_variables(bad, "broken")
        install_fault_plan(parse_fault_plan("swap-fail@0"))
        with pytest.raises(InjectedFault):
            eng.swap_variables(random_flax_variables(model, 11), "v1")
        for name, t in model.state_dict().items():
            assert torch.equal(t, state[name]), name
        health = eng.health()
        assert (health["model_version"], health["swap_count"]) == ("v0", 0)
        futs = [eng.submit(s) for s in samples[:2]]
        for f, b in zip(futs, before):
            np.testing.assert_array_equal(f.result(timeout=60)[0], b[0])
            assert f.model_version == "v0"
    finally:
        eng.shutdown()


def test_engine_construction_checks(served):
    samples, _, mcfg, model, _ = served
    from hydragnn_tpu_torch.graphs.packing import PackBudget
    with pytest.raises(ValueError, match="reference_samples"):
        InferenceEngine(model, mcfg, device="cpu")
    with pytest.raises(ValueError, match="n_graph >= 2"):
        InferenceEngine(model, mcfg, buckets=[PackBudget(64, 256, 1)],
                        proto_sample=samples[0], device="cpu")
    with pytest.raises(ValueError, match="proto_sample"):
        InferenceEngine(model, mcfg, buckets=[PackBudget(64, 256, 3)],
                        device="cpu")
    with pytest.raises(ValueError, match="neighbor_k"):
        InferenceEngine(model, mcfg, buckets=[PackBudget(64, 256, 3)],
                        proto_sample=samples[0], neighbor_format=True,
                        device="cpu")
    # an explicit ladder of 2 graph slots caps the fill below
    # max_batch_size
    eng = InferenceEngine(model, mcfg, buckets=[PackBudget(128, 1024, 3)],
                          proto_sample=samples[0], max_batch_size=8,
                          max_wait_ms=50.0, device="cpu")
    try:
        assert eng._fill_cap == 2
        futs = [eng.submit(s) for s in samples[:6]]
        _wait_all(futs)
        assert all(f.exception(timeout=0) is None for f in futs)
        assert eng.stats()["batches"] >= 3
    finally:
        eng.shutdown()
