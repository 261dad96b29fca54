#!/usr/bin/env python
"""JSONL front door for the PyTorch port's dispatch service (the port's
`tools/serve_dispatch.py`). The engines run on the card unless
``--device cpu`` asks for the CPU.

    python tools/torch_serve_dispatch.py < requests.jsonl
    python tools/torch_serve_dispatch.py --shards 2 --reqtrace --exporter-port 0

Reads one JSON request per line from stdin (or --input FILE), writes one
JSON response per line to stdout as completions land — responses are
asynchronous and carry the request ``id``, so they may interleave out of
submission order under load (that is the point of the service).

Request lines:

    {"op": "solve", "id": "r1",
     "problem": {"A": [[...]], "b": [...], "c": [...],
                 "l": [...], "u": [...], "c0": 0.0},
     "priority": "interactive" | "normal" | "batch",   # default normal
     "timeout": 0.5,                                    # optional, seconds
     "tenant": "team-a",                 # fairness id (--shards mode only)
     "traceparent": "00-<32hex>-<16hex>-01"}            # optional caller ctx
    {"op": "stats"}        # service counters + latency percentiles
    {"op": "drain"}        # block until queue and slots are empty

Responses:

    {"id": "r1", "verdict": "healthy", "objective": ..., "x": [...],
     "iterations": 17, "latency_s": 0.012, "from_cache": false}

With ``--reqtrace`` the service records a journey per request (see
docs/observability.md §8): a request's ``traceparent``
field parents its journey onto the caller's span, and the response
echoes the journey's own ``traceparent`` (plus ``parent_span_id``) so
the caller can stitch the cross-process trace back together. A
``DISPATCHES_TPU_TRACEPARENT`` env var likewise parents this process's
journal manifest onto the spawning process.

The service (bucket size, solver options) is built from the CLI flags at
the FIRST solve request, using that problem's shapes; every later
problem must match them. With ``--shards N`` the back end is the sharded
fleet (`make_dense_fleet`: N crash-domain child processes with respawn
and per-tenant fairness — requests may carry a ``tenant`` id) instead of
the in-process engine. Unknown ops and malformed lines produce an
``{"error": ...}`` response instead of killing the loop.

``--exporter-port P`` serves the fleet telemetry plane over HTTP for
the lifetime of the loop: ``/metrics`` (Prometheus), ``/healthz``
(per-shard liveness, non-200 while any shard is down), ``/slo`` (burn
rates) and ``/snapshot`` (see docs/serving.md). In ``--shards`` mode it
implies ``--telemetry``, so the scrape carries ``shard``-labeled series
merged from every child next to the fleet aggregates.

``--warm-model warm.npz`` seeds freshly admitted lanes from a learned
warm-start artifact (tools/torch_train_warmstart.py, or the JAX package's
tools/train_warmstart.py) through the solver's clip + per-lane rejection
safeguard: a bad prediction degrades to the cold path, never to a wrong
answer. ``--timeseries`` retains sampled metrics history and runs the
fleet alert pack (``/query``, ``/alerts``); ``--lanes`` attaches the lane
observatory (``/lanes``), and ``--lane-policy advice`` (``--shards``
mode) lets the router consult its damped route advice.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)



def _parse_problem(spec: dict):
    """One request's LP as host f64 arrays (the engine copies it to its
    device)."""
    import numpy as np

    from dispatches_tpu_torch.core.program import LPData

    try:
        return LPData(
            np.asarray(spec["A"], float), np.asarray(spec["b"], float),
            np.asarray(spec["c"], float), np.asarray(spec["l"], float),
            np.asarray(spec["u"], float), np.asarray(spec.get("c0", 0.0), float),
        )
    except KeyError as e:
        raise ValueError(f"problem spec missing field {e}") from None


def _response(ticket) -> dict:
    result = ticket.result(0)
    out = {
        "id": result.request_id,
        "verdict": result.verdict,
        "from_cache": bool(result.from_cache),
        "latency_s": result.latency,
        "iterations": result.iterations,
    }
    journey = getattr(ticket.request, "journey", None)
    if journey is not None:
        out["traceparent"] = journey.ctx.to_traceparent()
        out["parent_span_id"] = journey.ctx.parent_span_id
    sol = result.solution
    if sol is not None:
        out["objective"] = float(sol.obj)
        out["x"] = [float(v) for v in sol.x]
        out["converged"] = bool(sol.converged)
    return out


class _Reaper:
    """Prints ticket results as they resolve, preserving one-line-per-
    response framing under concurrent completions."""

    def __init__(self, out):
        self._out = out
        self._lock = threading.Lock()
        self._pending = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def watch(self, ticket) -> None:
        with self._lock:
            self._pending.append(ticket)

    def emit(self, obj: dict) -> None:
        with self._lock:
            print(json.dumps(obj, default=str), file=self._out, flush=True)

    def _run(self) -> None:
        while not self._stop.wait(0.002):
            self._sweep()

    def _sweep(self) -> None:
        with self._lock:
            done = [t for t in self._pending if t.done()]
            self._pending = [t for t in self._pending if not t.done()]
        for t in done:
            self.emit(_response(t))

    def close(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    break
            self._sweep()
        self._stop.set()
        self._thread.join()


def main(argv=None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_serve_dispatch",
        description="stdin/JSONL request loop over the dispatch service.",
    )
    ap.add_argument("--input", default="-", help="request file (default stdin)")
    ap.add_argument("--bucket", type=int, default=8)
    ap.add_argument("--chunk-iters", type=int, default=8)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--queue-limit", type=int, default=256)
    ap.add_argument("--cache-size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default: the card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve through a fleet of N crash-domain shard "
                    "processes (0 = in-process engine)")
    ap.add_argument("--journal", default=None,
                    help="write a JSONL run journal here")
    ap.add_argument("--reqtrace", action="store_true",
                    help="record per-request journeys in the journal")
    ap.add_argument("--telemetry", action="store_true",
                    help="--shards mode: children ship metrics-registry "
                    "and journal deltas into the parent on the heartbeat")
    ap.add_argument("--timeseries", action="store_true",
                    help="retain sampled metrics history and run the "
                    "fleet alert pack (obs.timeseries / obs.alerts); "
                    "adds /query and /alerts to the exporter")
    ap.add_argument("--exporter-port", type=int, default=None,
                    help="serve /metrics /healthz /slo /snapshot on this "
                    "port (0 = ephemeral, printed to stderr; implies "
                    "--telemetry when --shards > 0)")
    ap.add_argument("--warm-model", default=None,
                    help="learned warm-start artifact (.npz); seeds fresh "
                    "lanes through the solver safeguard")
    ap.add_argument("--conformance", action="store_true",
                    help="compute per-solve KKT certificates at harvest, "
                    "escalate failures to the `inaccurate` verdict, and "
                    "add /conformance to the exporter")
    ap.add_argument("--canary", default=None,
                    help="--shards mode: goldens .npz (a certified golden "
                    "artifact, either package's format) injected through "
                    "the full router->shard path on a cadence")
    ap.add_argument("--lanes", action="store_true",
                    help="attach the lane observatory: journal every "
                    "routing decision, shadow-probe a sampled fraction on "
                    "the alternate IPM<->PDHG lane, and serve the "
                    "per-family scoreboards at the exporter's /lanes")
    ap.add_argument("--lane-policy", default=None, choices=["advice"],
                    help="--shards mode, with --lanes: let the router "
                    "consult the observatory's damped route_advice")
    args = ap.parse_args(argv)

    from dispatches_tpu_torch.obs.journal import Tracer, set_tracer
    from dispatches_tpu_torch.serve import make_dense_fleet, make_dense_service

    tracer = None
    if args.journal:
        tracer = Tracer(args.journal, manifest_extra={"run": "torch_serve_dispatch"})
        set_tracer(tracer)

    svc = None
    exporter = None
    if args.exporter_port is not None:
        from dispatches_tpu_torch.obs.exporter import TelemetryExporter

        def _health():
            # closure over `svc`: the service is built lazily at the
            # first solve, so the prober sees "idle but ok" until then
            if svc is None:
                return {"ok": True, "idle": True}
            if args.shards > 0:
                return svc.health()
            return {"ok": True}

        exporter = TelemetryExporter(
            args.exporter_port, health_fn=_health
        ).start()
        print(f"exporter: {exporter.url('/metrics')}", file=sys.stderr)

    reaper = _Reaper(out)
    fh = sys.stdin if args.input == "-" else open(args.input, "r")
    try:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                op = req.get("op", "solve")
                if op == "solve":
                    lp = _parse_problem(req["problem"])
                    if svc is None:
                        if args.shards > 0:
                            svc = make_dense_fleet(
                                args.shards, args.bucket,
                                chunk_iters=args.chunk_iters,
                                queue_limit=args.queue_limit,
                                cache_size=args.cache_size or None,
                                reqtrace=args.reqtrace,
                                telemetry=args.telemetry or (
                                    args.exporter_port is not None
                                ),
                                conformance=args.conformance or None,
                                canary=args.canary,
                                warm_model=args.warm_model,
                                timeseries=args.timeseries,
                                lanes=args.lanes or None,
                                lane_policy=args.lane_policy,
                                solver_kw={"max_iter": args.max_iter},
                                device=args.device,
                            )
                        else:
                            svc = make_dense_service(
                                args.bucket, chunk_iters=args.chunk_iters,
                                max_iter=args.max_iter,
                                queue_limit=args.queue_limit,
                                cache_size=args.cache_size or None,
                                reqtrace=args.reqtrace,
                                conformance=args.conformance or None,
                                warm_model=args.warm_model,
                                timeseries=args.timeseries,
                                lanes=args.lanes or None,
                                device=args.device,
                            )
                        svc.start()
                        # late-bind: the exporter predates the lazily
                        # built service; its paths read these per request
                        if exporter is not None and args.timeseries:
                            exporter.store = svc.store
                            exporter.alerts = getattr(svc, "alerts", None)
                        if exporter is not None and args.conformance:
                            exporter.conformance_fn = getattr(
                                svc, "conformance_report", None
                            )
                        if exporter is not None and args.lanes:
                            exporter.lanes_fn = getattr(svc, "lane_report", None)
                    kw = {}
                    if args.shards > 0:
                        kw["tenant"] = req.get("tenant", "default")
                    reaper.watch(svc.submit(
                        lp,
                        priority=req.get("priority", "normal"),
                        timeout=req.get("timeout"),
                        request_id=req.get("id"),
                        trace_ctx=req.get("traceparent"),
                        **kw,
                    ))
                elif op == "stats":
                    reaper.emit(
                        {"stats": svc.stats() if svc else {"idle": True}}
                    )
                elif op == "drain":
                    if svc is not None:
                        svc.stop(drain=True)
                        svc.start()
                    reaper.emit({"drained": True})
                else:
                    reaper.emit({"error": f"unknown op {op!r}"})
            except Exception as e:
                reaper.emit({"error": f"{type(e).__name__}: {e}"})
    finally:
        if fh is not sys.stdin:
            fh.close()
        if exporter is not None:
            exporter.stop()
        if svc is not None:
            svc.stop(drain=True)
            if args.shards > 0:
                svc.close()  # reap the shard children
        reaper.close()
        if tracer is not None:
            set_tracer(None)
            tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
