"""HTTP telemetry endpoint: /healthz and /metrics (counterpart:
hydragnn_tpu/telemetry/http.py).

* ``GET /healthz``: JSON of ``engine.health()``; HTTP 200 while the
  engine can serve, 503 once it is shut down or its dispatcher died. For
  a fleet (`serve_fleet_metrics`) the router's health(): 200 while a
  replica is routable.
* ``GET /metrics``: Prometheus text: the engine's service counters under
  ``hydragnn_serving_*`` (a fleet's `fleet_prometheus`: the fleet
  counters and per-replica gauges with a ``replica`` label), then
  everything in the process registry.

Scrape-driven, standard library only: each GET snapshots under the
engine's lock and formats outside it, so a slow scraper never stalls the
dispatcher. Binds loopback by default.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .registry import MetricsRegistry, get_registry

# route -> () -> (status, content_type, body)
Handler = Callable[[], Tuple[int, str, str]]


def engine_prometheus(engine, registry: Optional[MetricsRegistry] = None
                      ) -> str:
    """Prometheus text for one engine: service counters + breaker state
    one-hot + latency quantiles, followed by the process registry's
    exposition so one scrape sees the whole process."""
    scrape = MetricsRegistry()
    stats = engine.stats()
    health = engine.health()
    counters = (
        ("serving_requests_total", stats["requests"],
         "requests resolved by the dispatcher"),
        ("serving_batches_total", stats["batches"],
         "coalesced batches executed"),
        ("serving_batch_failures_total", stats["batch_failures"],
         "batches whose forward raised"),
        ("serving_deadline_expired_total", stats["deadline_expired"],
         "requests expired before execution"),
        ("serving_queue_rejections_total", stats["queue_rejections"],
         "submits fast-failed on the bounded queue"),
        ("serving_circuit_rejections_total", stats["circuit_rejections"],
         "submits fast-failed by the open breaker"),
        ("serving_breaker_trips_total", stats["trip_count"],
         "circuit-breaker open transitions"),
        ("serving_breaker_probes_total", stats["probe_count"],
         "half-open probes admitted (one per open window)"),
        ("serving_swaps_total", stats["swap_count"],
         "model hot-swaps applied (swap_variables)"),
        # raw-structure serving: rebuilds against updates tells a
        # neighbour-bound stream from a compute-bound one
        ("serving_structure_requests_total", stats["structure_requests"],
         "raw-structure requests served via submit_structure"),
        ("serving_nbr_updates_total", stats["nbr_updates"],
         "neighbor-list updates performed by submit_structure"),
        ("serving_nbr_rebuilds_total", stats["nbr_rebuilds"],
         "full (non-incremental) neighbor-list rebuilds"),
    )
    for name, value, help_text in counters:
        scrape.counter_inc(name, float(value), help=help_text)
    gauges = (
        ("serving_batch_occupancy", stats["batch_occupancy"],
         "mean real graphs over graph-slot capacity"),
        ("serving_padding_frac_nodes", stats["padding_frac_nodes"],
         "fraction of executed node slots that were padding"),
        ("serving_padding_frac_edges", stats["padding_frac_edges"],
         "fraction of executed edge slots that were padding"),
        ("serving_queue_depth", health["queue_depth"],
         "requests currently queued"),
        ("serving_max_queue_depth", stats["max_queue_depth"],
         "high-water queue depth since reset"),
        ("serving_captures", stats["captures"],
         "CUDA graphs captured, one a bucket (frozen after warmup)"),
        ("serving_num_buckets", stats["num_buckets"],
         "bucket ladder length"),
        ("serving_dispatcher_alive", float(health["dispatcher_alive"]),
         "1 while the dispatcher thread is live"),
        ("serving_nbr_rebuild_fraction", stats["nbr_rebuild_fraction"],
         "neighbor-list rebuilds over updates since engine start"),
    )
    for name, value, help_text in gauges:
        scrape.gauge_set(name, float(value), help=help_text)
    # breaker state as a one-hot labeled gauge: scrapers alert on
    # `hydragnn_serving_breaker_state{state="open"} == 1`
    for s in ("closed", "open", "half_open", "shutdown"):
        scrape.gauge_set("serving_breaker_state",
                         1.0 if health["state"] == s else 0.0,
                         help="one-hot breaker state", state=s)
    # the served version as an info gauge, so a scrape sees a hot swap
    scrape.gauge_set("serving_model", 1.0,
                     help="info gauge: the model version being served",
                     version=str(health["model_version"]))
    # latency quantiles (stats() has the full key set, zeros before any
    # traffic)
    for q in ("p50_ms", "p95_ms", "p99_ms", "mean_ms"):
        scrape.gauge_set("serving_latency_ms", float(stats.get(q, 0.0)),
                         help="request latency quantiles",
                         quantile=q[:-3])
    text = scrape.to_prometheus()
    reg = registry if registry is not None else get_registry()
    return text + reg.to_prometheus()


class MetricsServer:
    """Threaded HTTP server over a {path: handler} route table.

    `port=0` binds an ephemeral port (tests); the bound port is `.port`
    after `start()`. `stop()` is idempotent and joins the serve thread."""

    def __init__(self, routes: Dict[str, Handler],
                 host: str = "127.0.0.1", port: int = 0):
        self.routes = dict(routes)
        self.host = host
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        routes = self.routes

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                handler = routes.get(self.path.split("?", 1)[0])
                if handler is None:
                    self.send_error(404, "unknown path")
                    return
                try:
                    status, ctype, body = handler()
                except Exception as exc:  # noqa: BLE001 — a scrape must
                    # never kill the server thread
                    status, ctype = 500, "text/plain; charset=utf-8"
                    body = f"handler error: {type(exc).__name__}: {exc}"
                payload = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hydragnn-metrics",
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def fleet_prometheus(router, registry: Optional[MetricsRegistry] = None
                     ) -> str:
    """Prometheus text for a ReplicaRouter: the fleet counters, latency
    quantiles over every replica's raw latencies, and per-replica gauges
    with a ``replica`` label (the breaker state one-hot, the model
    version, the publish role), then the process registry."""
    scrape = MetricsRegistry()
    health = router.health()
    stats = router.stats()
    fleet_counters = (
        ("serving_fleet_requests_total", stats["requests_done"],
         "router-level requests resolved (exactly once each)"),
        ("serving_fleet_redispatches_total", stats["redispatches"],
         "requests re-dispatched off a dead/failed replica"),
        ("serving_fleet_duplicate_resolutions_total",
         stats["duplicate_resolutions"],
         "late replica results dropped by the exactly-once gate"),
        ("serving_fleet_stale_failures_total", stats["stale_failures"],
         "failures from kill-superseded dispatches, dropped (the live "
         "re-dispatched copy owns the outcome)"),
        ("serving_fleet_kills_total", stats["kills"],
         "replicas removed from rotation by kill_replica"),
        ("serving_fleet_restarts_total", stats["restarts"],
         "replicas replaced by restart_replica"),
        ("serving_fleet_swap_attempts_total", health["swap_attempts"],
         "hot-swap rolls attempted"),
        ("serving_fleet_swap_failures_total", health["swap_failures"],
         "per-replica hot-swap failures (old version kept serving)"),
        ("serving_fleet_shadow_mirrored_total",
         health.get("shadow_mirrored", 0),
         "requests copied to the canary replica by the publish mirror"),
        ("serving_fleet_retires_total", health.get("retires", 0),
         "replicas scaled down through drain (retire_replica)"),
        ("serving_fleet_adds_total", health.get("adds", 0),
         "replicas added after construction (add_replica)"),
    )
    for name, value, help_text in fleet_counters:
        scrape.counter_inc(name, float(value), help=help_text)
    scrape.gauge_set("serving_fleet_replicas",
                     float(health["num_replicas"]),
                     help="replicas configured")
    scrape.gauge_set("serving_fleet_routable_replicas",
                     float(health["routable_replicas"]),
                     help="replicas currently accepting dispatches")
    quarantined = health.get("quarantined_versions", [])
    scrape.gauge_set("serving_fleet_quarantined_versions",
                     float(len(quarantined)),
                     help="model versions currently quarantined after "
                          "a failed canary")
    for v in quarantined:
        scrape.gauge_set("serving_fleet_quarantined_info", 1.0,
                         help="info gauge: one series per quarantined "
                              "model version",
                         version=str(v))
    for q in ("p50_ms", "p95_ms", "p99_ms", "mean_ms"):
        scrape.gauge_set("serving_fleet_latency_ms",
                         float(stats.get(q, 0.0)),
                         help="fleet-wide request latency quantiles "
                              "(raw latencies pooled across replicas)",
                         quantile=q[:-3])
    for idx in sorted(health["replicas"]):
        h = health["replicas"][idx]
        st = stats["replicas"].get(idx, {})
        scrape.gauge_set("serving_replica_alive",
                         1.0 if h["alive"] else 0.0,
                         help="1 while the replica is in the rotation "
                              "set (0 = killed/dead)", replica=idx)
        scrape.gauge_set("serving_replica_queue_depth",
                         float(h["queue_depth"]),
                         help="requests queued on this replica",
                         replica=idx)
        scrape.gauge_set("serving_replica_uptime_s", float(h["uptime_s"]),
                         help="seconds since this replica engine started",
                         replica=idx)
        scrape.counter_inc("serving_replica_requests_total",
                           float(st.get("requests", 0)),
                           help="requests this replica resolved",
                           replica=idx)
        scrape.counter_inc("serving_replica_breaker_trips_total",
                           float(h["trip_count"]),
                           help="breaker open transitions on this replica",
                           replica=idx)
        scrape.counter_inc("serving_replica_breaker_probes_total",
                           float(h["probe_count"]),
                           help="half-open probes this replica admitted",
                           replica=idx)
        for s in ("closed", "open", "half_open", "shutdown"):
            scrape.gauge_set("serving_replica_breaker_state",
                             1.0 if h["state"] == s else 0.0,
                             help="one-hot breaker state per replica",
                             replica=idx, state=s)
        scrape.gauge_set("serving_replica_model",
                         1.0, help="info gauge: the model version this "
                                   "replica is serving (hot-swap tag)",
                         replica=idx, version=str(h["model_version"]))
        # the publish role (primary, canary, retired) beside the
        # version, and as a one-hot gauge
        role = ("canary" if h.get("canary")
                else "retired" if h.get("retired") else "primary")
        scrape.gauge_set("serving_replica_version_info", 1.0,
                         help="info gauge: model version + publish role "
                              "per replica (canary rollout state)",
                         replica=idx, version=str(h["model_version"]),
                         state=role)
        for s in ("primary", "canary", "retired"):
            scrape.gauge_set("serving_replica_canary_state",
                             1.0 if role == s else 0.0,
                             help="one-hot publish role per replica",
                             replica=idx, state=s)
    text = scrape.to_prometheus()
    reg = registry if registry is not None else get_registry()
    return text + reg.to_prometheus()


def serve_fleet_metrics(router, host: str = "127.0.0.1", port: int = 0,
                        registry: Optional[MetricsRegistry] = None
                        ) -> MetricsServer:
    """One MetricsServer for a fleet: /healthz gives the router's
    health() (200 while a replica is routable, 503 when the fleet is
    unavailable or shut down), /metrics `fleet_prometheus`. port=0 binds
    an ephemeral port, so engines and a router in one process never
    collide."""

    def healthz() -> Tuple[int, str, str]:
        h = router.health()
        return (200 if h["state"] == "serving" else 503,
                "application/json", json.dumps(h, sort_keys=True))

    def metrics() -> Tuple[int, str, str]:
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                fleet_prometheus(router, registry))

    server = MetricsServer({"/healthz": healthz, "/metrics": metrics},
                           host=host, port=port)
    server.start()
    return server


def serve_engine_metrics(engine, host: str = "127.0.0.1", port: int = 0,
                         registry: Optional[MetricsRegistry] = None
                         ) -> MetricsServer:
    """Start a MetricsServer exposing `engine` on /healthz + /metrics.

    /healthz returns 200 while the engine accepts work and 503 once it is
    shut down or the dispatcher died, so probes catch both."""

    def healthz() -> Tuple[int, str, str]:
        h = engine.health()
        ok = h["state"] != "shutdown" and h["dispatcher_alive"]
        return (200 if ok else 503, "application/json",
                json.dumps(h, sort_keys=True))

    def metrics() -> Tuple[int, str, str]:
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                engine_prometheus(engine, registry))

    server = MetricsServer({"/healthz": healthz, "/metrics": metrics},
                           host=host, port=port)
    server.start()
    return server
