"""The port's telemetry (hydragnn_tpu_torch/telemetry/) against the JAX
package's on the CPU:

* the metrics registry: driven by the same calls, the port's and the JAX
  package's give identical Prometheus text, snapshots and JSONL events
  (apart from each event's `ts`), and the same type errors;
* the span recorder: `chrome_trace` holds the same events as the JAX
  package's recorder for the same calls (apart from the clock), bounded
  with a visible drop count, and the module helpers are off without a
  recorder;
* /healthz and /metrics of a CPU engine on an ephemeral loopback port,
  the server stopped by `shutdown()`;
* `submit_structure`'s registry writes equal the JAX engine's for the
  same structure sequence, and the engine's spans;
* `resolve_md_farm` as the JAX package resolves it, env over config,
  malformed values warning;
* `Serving.metrics_port` > 0 is no longer refused and makes
  run_prediction start the server; `fleet.replicas` > 1 is no longer
  refused either (tests/test_torch_fleet.py), while the int8 tier is.
"""
import copy
import json
import logging
import socket
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from hydragnn_tpu.config import config as jcfg
from hydragnn_tpu.models.create import create_model as j_create_model
from hydragnn_tpu.preprocess.transforms import \
    build_graph_sample as j_build_graph_sample
from hydragnn_tpu.serving.config import resolve_md_farm as j_resolve_md_farm
from hydragnn_tpu.serving.engine import InferenceEngine as JEngine
from hydragnn_tpu.telemetry import registry as jregistry
from hydragnn_tpu.telemetry import spans as jspans
from hydragnn_tpu_torch.config import config as tcfg
from hydragnn_tpu_torch.md import integrator as mdi
from hydragnn_tpu_torch.md.loop import (init_lattice, lj_md_config,
                                        md_buckets)
from hydragnn_tpu_torch.models.create import create_model
from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
from hydragnn_tpu_torch.serving.config import (MdFarm, resolve_md_farm,
                                               resolve_serving)
from hydragnn_tpu_torch.serving.engine import InferenceEngine
from hydragnn_tpu_torch.telemetry import http as thttp
from hydragnn_tpu_torch.telemetry import registry as tregistry
from hydragnn_tpu_torch.telemetry import spans as tspans
from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                              random_flax_variables)
from tests.deterministic_data import deterministic_graph_dataset
from tests.test_torch_train import to_port_samples
from tests.utils import make_config

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

EF_TOL = dict(rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- registry

def _drive(reg):
    """One fixed sequence of reports: counters with and without labels,
    gauges, histograms with default and custom buckets, labels needing
    escapes, HELP text with a newline, and events."""
    reg.counter_inc("requests_total", 2, help="requests\nserved")
    reg.counter_inc("requests_total", 3.5)
    reg.counter_inc("retries_total", 1, reason='bad "quote"\\n', kind="io")
    reg.counter_inc("retries_total", 2, kind="io", reason="timeout")
    reg.gauge_set("queue_depth", 7, help="queued requests")
    reg.gauge_set("queue_depth", 3)
    reg.gauge_set("serve.nbr_rebuild_fraction", 0.0625)
    reg.gauge_set("9lives", 1.5, state="open")
    for v in (0.0005, 0.02, 0.3, 7.0, 20.0):
        reg.histogram_observe("latency_s", v, help="request latency")
    for v in (1, 2, 3, 5, 8):
        reg.histogram_observe("batch", v, buckets=(2, 4), tier="a")
    reg.log_event("md", "farm_run", data={"steps": 6, "trajectories": 1},
                  timing={"wall_s": 0.25})
    reg.log_event("serve", "swap", data={"version": "v1"})
    reg.log_event("epoch", "end")


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_registry_prometheus_and_events_match_jax(tmp_path):
    got, want = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _drive(got)
    _drive(want)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_prometheus(prefix="x_") == want.to_prometheus(prefix="x_")
    assert got.snapshot() == want.snapshot()
    assert _strip_ts(got.events) == _strip_ts(want.events)
    paths = [tmp_path / "port.jsonl", tmp_path / "jax.jsonl"]
    assert got.write_jsonl(str(paths[0])) == \
        want.write_jsonl(str(paths[1])) == 3
    lines = [[json.loads(line) for line in p.read_text().splitlines()]
             for p in paths]
    assert _strip_ts(lines[0]) == _strip_ts(lines[1])
    text = got.to_prometheus()
    assert '# HELP hydragnn_requests_total requests\\nserved' in text
    assert 'reason="bad \\"quote\\"\\\\n"' in text
    assert "hydragnn_latency_s_bucket{le=\"+Inf\"} 5" in text
    assert "hydragnn_9lives{state=\"open\"} 1.5" in text


def test_registry_type_discipline_and_seeding_match_jax():
    for mod in (tregistry, jregistry):
        reg = mod.MetricsRegistry()
        reg.counter_inc("x_total")
        with pytest.raises(mod.MetricTypeError, match="already registered"):
            reg.gauge_set("x_total", 1.0)
        with pytest.raises(ValueError, match=">= 0"):
            reg.counter_inc("x_total", -1)
    got, want = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg, mod in ((got, tregistry), (want, jregistry)):
        src = mod.MetricsRegistry()
        _drive(src)
        reg.gauge_set("queue_depth", 99)
        reg.seed_from(src)
        assert reg.events == []
    assert got.to_prometheus() == want.to_prometheus()
    got.clear()
    assert got.to_prometheus() == "\n" and got.snapshot() == {}


def test_process_registry_swap():
    fresh = tregistry.MetricsRegistry()
    prev = tregistry.set_registry(fresh)
    try:
        assert tregistry.get_registry() is fresh
        tregistry.get_registry().counter_inc("a_total")
    finally:
        assert tregistry.set_registry(prev) is fresh
    assert tregistry.get_registry() is prev
    assert "a_total" not in prev.snapshot()


# -------------------------------------------------------------------- spans

def _record_spans(mod):
    rec = mod.SpanRecorder(process_name="unit", max_events=7)
    prev = mod.install_recorder(rec)
    try:
        t0 = mod.now()
        mod.record("serve.queue_wait", t0, 0.002, "serving")
        mod.record("serve.forward", t0, 0.001, "serving", requests=3,
                   bucket=[64, 128, 3])
        with mod.span("md.farm_dispatch", "md", frozen=2):
            pass
        with mod.span("plain"):
            pass
        rec.instant("marker", args={"k": 1})
        rec.add("negative", t0, -1.0)
        for i in range(3):          # past max_events: dropped, counted
            rec.add(f"late{i}", t0, 0.001)
    finally:
        assert mod.install_recorder(prev) is rec
    return rec


def _shape(events):
    keep = ("name", "cat", "ph", "s", "args")
    return [{k: e[k] for k in keep if k in e} for e in events]


def test_span_recorder_chrome_trace_matches_jax(tmp_path):
    got, want = _record_spans(tspans), _record_spans(jspans)
    tg, tw = got.chrome_trace(), want.chrome_trace()
    assert _shape(tg["traceEvents"]) == _shape(tw["traceEvents"])
    assert tg["displayTimeUnit"] == "ms" and got.dropped == 3
    meta, *spans, drop = tg["traceEvents"]
    assert meta["ph"] == "M" and meta["args"] == {"name": "unit"}
    for e in spans:
        assert e["pid"] == got.pid and isinstance(e["tid"], int)
        assert e["ts"] >= 0.0
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
    assert [e["dur"] for e in spans if e["name"] == "negative"] == [0.0]
    assert drop["name"] == "spans_dropped_at_cap: 3"
    assert drop["args"] == {"dropped": 3, "max_events": 7}
    path = tmp_path / "trace.json"
    assert got.write(str(path)) == len(tg["traceEvents"])
    assert json.loads(path.read_text())["traceEvents"][1]["name"] == \
        "serve.queue_wait"


def test_span_helpers_are_off_without_a_recorder():
    assert tspans.current_recorder() is None and not tspans.enabled()
    tspans.record("x", tspans.now(), 1.0)
    with tspans.span("y"):
        pass
    assert tspans.current_recorder() is None


# ---------------------------------------------------------- metrics server

@pytest.fixture(scope="module")
def served():
    jsamples = deterministic_graph_dataset(num_configs=16)
    samples = to_port_samples(jsamples)
    cfg = tcfg.update_config(make_config("GIN"), samples)
    mcfg = tcfg.build_model_config(cfg)
    model = create_model(mcfg, device="cpu")
    model.load_state_dict(load_jax_variables(random_flax_variables(model,
                                                                   0)))
    return samples, mcfg, model


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], \
                resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers["Content-Type"], exc.read().decode()


def test_metrics_endpoint_scrape_roundtrip(served):
    samples, mcfg, model = served
    eng = InferenceEngine(model, mcfg, reference_samples=samples,
                          max_batch_size=4, device="cpu")
    reg = tregistry.MetricsRegistry()
    reg.counter_inc("md.farm_steps_total", 12.0, help="farm steps")
    prev = tregistry.set_registry(reg)
    try:
        server = eng.start_metrics_server(port=0)
        assert eng.start_metrics_server() is server
        assert server.port > 0 and server.url.startswith("http://127.0.0.1")
        eng.warmup()
        for f in [eng.submit(s) for s in samples[:6]]:
            f.result(timeout=60)
        status, ctype, body = _get(server.url + "/healthz")
        assert status == 200 and ctype == "application/json"
        health = json.loads(body)
        assert health["state"] == "closed" and health["dispatcher_alive"]
        assert health["requests_done"] == 6
        status, ctype, text = _get(server.url + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "hydragnn_serving_requests_total 6.0" in text
        assert f"hydragnn_serving_captures {float(len(eng.buckets))}" \
            not in text  # the CPU captures no graph
        assert "hydragnn_serving_captures 0.0" in text
        assert 'hydragnn_serving_breaker_state{state="closed"} 1.0' in text
        assert 'hydragnn_serving_model{version="v0"} 1.0' in text
        assert 'hydragnn_serving_latency_ms{quantile="p99"}' in text
        # the process registry follows the engine's counters
        assert "# HELP hydragnn_md_farm_steps_total farm steps" in text
        assert "hydragnn_md_farm_steps_total 12.0" in text
        assert _get(server.url + "/nope")[0] == 404
    finally:
        tregistry.set_registry(prev)
        eng.shutdown()
    assert eng._metrics_server is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(server.url + "/healthz", timeout=5)


def test_healthz_reports_a_shut_down_engine(served):
    samples, mcfg, model = served
    eng = InferenceEngine(model, mcfg, reference_samples=samples,
                          device="cpu")
    server = thttp.serve_engine_metrics(eng, port=0)
    try:
        assert _get(server.url + "/healthz")[0] == 200
        eng.shutdown()
        status, _, body = _get(server.url + "/healthz")
        assert status == 503 and json.loads(body)["state"] == "shutdown"
        assert 'serving_breaker_state{state="shutdown"} 1.0' in \
            _get(server.url + "/metrics")[2]
    finally:
        server.stop()
        server.stop()  # idempotent


def test_metrics_server_handler_error_is_a_500():
    def boom():
        raise KeyError("missing")
    server = thttp.MetricsServer({"/x": boom}, port=0)
    server.start()
    try:
        status, _, body = _get(server.url + "/x")
        assert status == 500 and "KeyError" in body
    finally:
        server.stop()


# -------------------------------------------------- submit_structure writes

@pytest.fixture(scope="module")
def lj_pair():
    """The LJ MD system of 4³ atoms as a port and a JAX structure engine
    with the same Flax weights."""
    pos0, cell = init_lattice(4, 1.2, 0.05, seed=1)
    n = len(pos0)
    nf = np.ones((n, 1), np.float32)
    cfg = lj_md_config()
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell, with_targets=False)
    done = tcfg.update_config(copy.deepcopy(cfg), [frame0])
    mcfg = tcfg.build_model_config(done)
    model = create_model(mcfg, device="cpu")
    variables = random_flax_variables(model, 3)
    model.load_state_dict(load_jax_variables(variables))
    jframe0 = j_build_graph_sample(nf, pos0, cfg, cell=cell,
                                   with_targets=False)
    jdone = jcfg.update_config(copy.deepcopy(cfg), [jframe0])
    jmcfg = jcfg.build_model_config(jdone)
    return dict(pos0=pos0, cell=cell, nf=nf, n=n, frame0=frame0, done=done,
                mcfg=mcfg, model=model, jframe0=jframe0, jdone=jdone,
                jmcfg=jmcfg,
                jvars=jax.tree_util.tree_map(jax.numpy.asarray, variables))


def _structure_run(eng, lj, reg_mod, span_mod):
    """A session's 6 steps (the last past skin/2) and one session-less
    submit, under a fresh registry and recorder of `reg_mod` /
    `span_mod`: (registry, recorder, results)."""
    rng = np.random.RandomState(8)
    frames = [lj["pos0"]]
    for k in range(5):
        frames.append(frames[-1] + rng.randn(*lj["pos0"].shape)
                      * (0.005 if k < 4 else 0.3))
    cell = mdi.quantize_cell(lj["cell"])
    reg = reg_mod.MetricsRegistry()
    rec = span_mod.SpanRecorder()
    prev_reg = reg_mod.set_registry(reg)
    prev_rec = span_mod.install_recorder(rec)
    try:
        sess = eng.structure_session()
        results = [eng.submit_structure(p, lj["nf"], cell=cell,
                                        session=sess).result(timeout=300)
                   for p in frames]
        results.append(eng.submit_structure(frames[0], lj["nf"], cell=cell
                                            ).result(timeout=300))
    finally:
        reg_mod.set_registry(prev_reg)
        span_mod.install_recorder(prev_rec)
    return reg, rec, results


def test_submit_structure_registry_writes_match_jax_engine(lj_pair):
    lj = lj_pair
    jeng = JEngine(
        j_create_model(lj["jmcfg"]), lj["jvars"], lj["jmcfg"],
        buckets=md_buckets(lj["n"], lj["jframe0"].num_edges),
        proto_sample=lj["jframe0"], max_batch_size=1, max_wait_ms=0.0,
        structure_config=lj["jdone"], md_skin=0.3, ef_forward=True)
    try:
        want_reg, want_rec, want = _structure_run(jeng, lj, jregistry,
                                                  jspans)
    finally:
        jeng.shutdown()
    with InferenceEngine(
            lj["model"], lj["mcfg"],
            buckets=md_buckets(lj["n"], lj["frame0"].num_edges),
            proto_sample=lj["frame0"], max_batch_size=1, max_wait_ms=0.0,
            structure_config=lj["done"], md_skin=0.3, ef_forward=True,
            device="cpu") as eng:
        got_reg, got_rec, got = _structure_run(eng, lj, tregistry, tspans)
    assert got_reg.to_prometheus() == want_reg.to_prometheus()
    snap = got_reg.snapshot()
    assert snap["serve.nbr_updates_total"]["values"][()] == 7.0
    assert snap["serve.nbr_rebuilds_total"]["values"][()] == 3.0
    assert snap["serve.nbr_rebuild_fraction"]["values"][()] == 3.0 / 7.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], np.asarray(w[0]), **EF_TOL)

    def spans(rec, name):
        return [e.get("args") for e in rec.chrome_trace()["traceEvents"]
                if e["name"] == name]
    assert spans(got_rec, "serve.graph_build") == \
        spans(want_rec, "serve.graph_build")
    assert [a["rebuilt"] for a in spans(got_rec, "serve.graph_build")] == \
        [True, False, False, False, False, True, True]
    for name in ("serve.queue_wait", "serve.forward", "serve.unpad"):
        assert len(spans(got_rec, name)) == 7, name
    assert spans(got_rec, "serve.forward")[0] == {
        "bucket": [eng.buckets[0].n_node, eng.buckets[0].n_edge,
                   eng.buckets[0].n_graph],
        "requests": 1, "parity": "bitwise"}


# ------------------------------------------------------------------ knobs

FARM_ENVS = ("HYDRAGNN_MD_FARM_STEPS_PER_DISPATCH",
             "HYDRAGNN_MD_FARM_CAND_HEADROOM")
# (MdFarm field, env var, block value, well-formed env, malformed env)
FARM_KNOBS = [
    ("steps_per_dispatch", "HYDRAGNN_MD_FARM_STEPS_PER_DISPATCH", 3, "16",
     "eight"),
    ("cand_headroom", "HYDRAGNN_MD_FARM_CAND_HEADROOM", 0.25, "1.5",
     "lots"),
]


@pytest.mark.parametrize("how", ["default", "config", "env_over_config",
                                 "set_but_empty", "malformed", "no_block"])
@pytest.mark.parametrize("knob", FARM_KNOBS, ids=[k[0] for k in FARM_KNOBS])
def test_resolve_md_farm_matches_jax(monkeypatch, caplog, knob, how):
    field, env, value, good, bad = knob
    for name in FARM_ENVS:
        monkeypatch.delenv(name, raising=False)
    cfg = {"Serving": {"md_farm": {} if how == "default"
                       else {field: value}}}
    if how == "no_block":
        cfg = None
    if how in ("env_over_config", "set_but_empty", "malformed"):
        monkeypatch.setenv(env, {"env_over_config": good,
                                 "set_but_empty": "  ",
                                 "malformed": bad}[how])
    with caplog.at_level(logging.WARNING):
        want = j_resolve_md_farm(cfg)
        got = resolve_md_farm(cfg)
    assert set(MdFarm.__dataclass_fields__) == \
        set(type(want).__dataclass_fields__)
    assert {f: getattr(got, f) for f in MdFarm.__dataclass_fields__} == \
        {f: getattr(want, f) for f in MdFarm.__dataclass_fields__}
    expect = {"default": None, "no_block": None, "config": value,
              "env_over_config": type(value)(good), "set_but_empty": value,
              "malformed": value}[how]
    if expect is not None:
        assert getattr(got, field) == expect
    warned = {r.name for r in caplog.records if env in r.getMessage()}
    assert ("hydragnn_tpu_torch" in warned) == ("hydragnn_tpu" in warned)
    assert ("hydragnn_tpu_torch" in warned) == (how == "malformed")


def test_metrics_port_is_served_and_the_fleet_still_refused(monkeypatch):
    """The metrics port resolves; since the fleet was ported a replica
    count resolves too (the router serves /metrics for the fleet), and
    since the int8 tier was ported its precision resolves beside them,
    env over block, as the JAX package's does."""
    from hydragnn_tpu_torch.serving.config import resolve_fleet
    for name in ("HYDRAGNN_SERVE_METRICS_PORT", "HYDRAGNN_FLEET_REPLICAS",
                 "HYDRAGNN_SERVE_PRECISION"):
        monkeypatch.delenv(name, raising=False)
    assert resolve_serving({"Serving": {"metrics_port": 9100}}
                           ).metrics_port == 9100
    monkeypatch.setenv("HYDRAGNN_SERVE_METRICS_PORT", "9200")
    assert resolve_serving({}).metrics_port == 9200
    cfg = {"Serving": {"fleet": {"replicas": 2}}}
    assert resolve_serving(cfg).metrics_port == 9200
    assert resolve_fleet(cfg).replicas == 2
    monkeypatch.setenv("HYDRAGNN_FLEET_REPLICAS", "3")
    assert resolve_fleet(cfg).replicas == 3
    cfg = resolve_serving({"Serving": {"metrics_port": 9100,
                                       "precision": "int8"}})
    assert (cfg.precision, cfg.metrics_port) == ("int8", 9200)


def test_run_prediction_starts_the_metrics_server(monkeypatch):
    """Serving.metrics_port > 0: run_prediction's engine serves /metrics
    on that port during the run and stops it with the engine."""
    import importlib
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.serving import engine as tengine
    rp = importlib.import_module("hydragnn_tpu_torch.run_prediction")
    for name in ("HYDRAGNN_SERVE_METRICS_PORT", "HYDRAGNN_FLEET_REPLICAS",
                 "HYDRAGNN_SERVE"):
        monkeypatch.delenv(name, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    scraped = []

    class Spy(tengine.InferenceEngine):
        def predict(self, samples, timeout=None):
            out = super().predict(samples, timeout=timeout)
            scraped.append(_get(f"http://127.0.0.1:{port}/metrics"))
            return out

    monkeypatch.setattr(rp, "InferenceEngine", Spy)
    jsamples = deterministic_graph_dataset(num_configs=20)
    samples = to_port_samples(jsamples)
    splits = (samples[:12], samples[12:16], samples[16:])
    cfg = make_config("GIN")
    cfg["Serving"] = {"metrics_port": port}
    done = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = tcfg.build_model_config(done)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 0)
    preds = run_prediction(cfg, datasets=splits, variables=variables,
                           serve=True, device="cpu")[1]
    assert preds[0].shape[0] == len(splits[2])
    (status, _, text), = scraped
    assert status == 200
    assert f"hydragnn_serving_requests_total {float(len(splits[2]))}" in text
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=5)
