"""Serving-grade telemetry endpoint (the fleet plane's scrape surface;
port of `dispatches_tpu/obs/exporter.py`).

A tiny stdlib ``http.server`` thread that turns the process-local
observability state — the `obs.metrics` registry (which, in fleet mode,
already aggregates every shard child via `MetricsRegistry.merge`), the
fleet's liveness view, and the journal's journey records — into the
three endpoints an operator actually points things at:

- ``/metrics``  — Prometheus text exposition (0.0.4) of the registry;
  in fleet mode this carries both the ``shard``-labeled per-child
  series and the label-free fleet aggregates.
- ``/healthz``  — JSON from an injectable ``health_fn`` (the fleet's
  `FleetService.health`); HTTP 200 while ``ok`` is true, 503 otherwise,
  so a dumb prober flags a down/backing-off shard without parsing.
- ``/slo``      — `obs.slo.evaluate` over the live journal's journey
  records: per-priority burn rates, worst burn, breaches.
- ``/snapshot`` — the registry's JSON `snapshot()` (the machine-friendly
  twin of ``/metrics``; `tools/fleet_top.py` live mode reads this).
- ``/conformance`` — the attached ``conformance_fn`` (the fleet's
  `FleetService.conformance_report`): the KKT checker's policy, outcome
  counts, and worst certificates plus the canary scheduler's per-golden
  last scores. 404 until a callback is attached, so deployments without
  the accuracy plane cost nothing.

- ``/query``   — the attached `obs.timeseries.SeriesStore`
  (``?name=...&window=...&agg=raw|rate|delta``, other parameters match
  labels); 404 until a store is attached.
- ``/alerts``  — the attached `obs.alerts.AlertManager`'s report.
- ``/lanes``   — the attached ``lanes_fn`` (the service's
  `lane_report`): the lane observatory's scoreboards and route advice.
- ``/capacity`` — the attached ``capacity_fn`` (the fleet's
  `capacity_report`, or a service's ``capacity.report``): the measured
  service laws, the twin's knee, the breach forecast and the shard
  recommendation; 404 until one is attached.

Design rules, same as the rest of `obs`: stdlib only, off by default
(nothing starts a server unless a tool passes ``--exporter-port``),
daemon threads so a dying process never blocks on the exporter, and
zero interaction with solves — the handlers only *read* registries and
journals, so results stay bitwise identical with the exporter running.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Sequence

from . import metrics as obs_metrics


class TelemetryExporter:
    """One HTTP server thread serving the endpoints above.

    `port=0` binds an ephemeral port (read it back from ``.port`` after
    `start()` — how tests and the loadgen self-check avoid collisions).
    `health_fn` returns a JSON-safe dict whose ``ok`` key picks the
    status code; `slo_fn` overrides the default journal-backed SLO
    report (both are called per request, under no lock of ours — they
    must do their own synchronization, which `FleetService.health` and
    the metrics registry already do)."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        *,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        slo_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        slos: Optional[Sequence[Any]] = None,
        store: Optional[Any] = None,
        alerts: Optional[Any] = None,
        conformance_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        capacity_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        lanes_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ):
        self.host = str(host)
        self.port = int(port)
        self.registry = registry
        self.health_fn = health_fn
        self.slo_fn = slo_fn
        self.slos = slos
        self.store = store  # obs.timeseries.SeriesStore, serves /query
        self.alerts = alerts  # obs.alerts.AlertManager, serves /alerts
        self.conformance_fn = conformance_fn  # serves /conformance
        self.lanes_fn = lanes_fn  # serves /lanes
        self.capacity_fn = capacity_fn  # serves /capacity
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- request handling ----------------------------------------------
    def _registry(self) -> obs_metrics.MetricsRegistry:
        return self.registry if self.registry is not None else obs_metrics.get_registry()

    def _health(self) -> Dict[str, Any]:
        if self.health_fn is None:
            return {"ok": True}
        return self.health_fn()

    def _slo(self) -> Dict[str, Any]:
        if self.slo_fn is not None:
            return self.slo_fn()
        from . import slo as obs_slo
        from .journal import get_tracer

        records = list(get_tracer().events)
        report = obs_slo.evaluate(
            records, self.slos if self.slos is not None else obs_slo.DEFAULT_SLOS
        )
        return {
            "slos": report,
            "worst_burn_rate": obs_slo.worst_burn_rate(report),
            "breaches": [
                {"slo": n, "window": w, "burn_rate": b}
                for n, w, b in obs_slo.breaches(report)
            ],
        }

    def _query(self, qs: str):
        """``/query``: name (required), window (seconds, default 300),
        agg (raw|rate|delta); any other parameter is a label match."""
        from urllib.parse import parse_qsl

        if self.store is None:
            return 404, "text/plain; charset=utf-8", b"no series store attached\n"
        params = dict(parse_qsl(qs, keep_blank_values=True))
        name = params.pop("name", None)
        if not name:
            return (
                400, "application/json",
                _json_bytes({"error": "missing required parameter: name"}),
            )
        window = float(params.pop("window", 300.0))
        agg = params.pop("agg", "raw")
        series = self.store.query(name, params or None, window=window, agg=agg)
        return 200, "application/json", _json_bytes({
            "name": name,
            "labels": params,
            "window": window,
            "agg": agg,
            "series": series,
        })

    def handle_path(self, path: str):
        """Route one GET: returns (status, content_type, body_bytes).
        Exposed for tests that don't want a real socket."""
        path, _, qs = path.partition("?")
        try:
            if path == "/metrics":
                body = self._registry().render_prometheus()
                return 200, "text/plain; version=0.0.4; charset=utf-8", body.encode("utf-8")
            if path == "/healthz":
                h = self._health()
                status = 200 if h.get("ok", True) else 503
                return status, "application/json", _json_bytes(h)
            if path == "/slo":
                return 200, "application/json", _json_bytes(self._slo())
            if path == "/snapshot":
                return 200, "application/json", _json_bytes(self._registry().snapshot())
            if path == "/query":
                return self._query(qs)
            if path == "/alerts":
                if self.alerts is None:
                    return 404, "text/plain; charset=utf-8", b"no alert manager attached\n"
                return 200, "application/json", _json_bytes(self.alerts.report())
            if path == "/lanes":
                if self.lanes_fn is None:
                    return (
                        404, "text/plain; charset=utf-8",
                        b"no lane observatory attached\n",
                    )
                return 200, "application/json", _json_bytes(self.lanes_fn())
            if path == "/capacity":
                if self.capacity_fn is None:
                    return (
                        404, "text/plain; charset=utf-8",
                        b"no capacity plane attached\n",
                    )
                return 200, "application/json", _json_bytes(self.capacity_fn())
            if path == "/conformance":
                if self.conformance_fn is None:
                    return (
                        404, "text/plain; charset=utf-8",
                        b"no conformance plane attached\n",
                    )
                return 200, "application/json", _json_bytes(self.conformance_fn())
            return 404, "text/plain; charset=utf-8", b"not found\n"
        except Exception as e:  # a broken callback must not kill the server
            return (
                500, "application/json",
                _json_bytes({"error": f"{type(e).__name__}: {e}"}),
            )

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TelemetryExporter":
        if self._server is not None:
            raise RuntimeError("exporter already started")
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (http.server API)
                status, ctype, body = exporter.handle_path(self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes every few seconds: stay silent

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="telemetry-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down. Idempotent."""
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def __enter__(self) -> "TelemetryExporter":
        return self.start() if self._server is None else self

    def __exit__(self, *exc) -> None:
        self.stop()


def _json_bytes(obj: Any) -> bytes:
    return (json.dumps(obj, indent=1, default=str) + "\n").encode("utf-8")


def start_exporter(port: int, **kw: Any) -> TelemetryExporter:
    """Convenience: build + start in one call (the ``--exporter-port``
    entry point in `tools/torch_serve_dispatch.py` / `tools/torch_loadgen.py`)."""
    return TelemetryExporter(port, **kw).start()
