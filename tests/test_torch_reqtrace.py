"""The port's serving observability against the JAX package's, on the CPU:
the metrics registry's fleet merge and exposition, request traceparents
and journeys, SLO burn rates, the journal's request records, and the
telemetry exporter on a real local socket.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from dispatches_tpu.obs import journal as jjournal
from dispatches_tpu.obs import metrics as jmetrics
from dispatches_tpu.obs import reqtrace as jreqtrace
from dispatches_tpu.obs import slo as jslo
from dispatches_tpu_torch.obs import journal, metrics, reqtrace, slo
from dispatches_tpu_torch.obs.exporter import TelemetryExporter


def _registry_ops(reg):
    """The same operations on a fresh registry of either package."""
    reg.describe("serve_latency_seconds", 'latency "help"\\with\nlines')
    reg.inc("serve_requests_total", status="ok")
    reg.inc("serve_requests_total", 2, status="cached")
    reg.inc("odd_total", label='quote " back \\ nl \n')
    reg.set_gauge("serve_queue_depth", 3)
    reg.set_gauge("serve_shard_inflight", 2, shard="0")
    reg.set_gauge("serve_shard_inflight", 5, shard="1")
    for v in (0.0004, 0.003, 0.02, 0.2, 7.0, 40.0):
        reg.observe("serve_latency_seconds", v, buckets=(0.001, 0.01, 0.1, 1.0, 10.0),
                    status="ok")
    reg.observe("plain_seconds", 0.3)


def _both(fn):
    """`fn(registry)` on a fresh registry of each package: (port, JAX)."""
    a, b = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    return fn(a), fn(b)


def test_registry_merge_delta_and_exposition_match_jax():
    def run(reg):
        mod = metrics if isinstance(reg, metrics.MetricsRegistry) else jmetrics
        _registry_ops(reg)
        s0 = reg.snapshot()
        reg.inc("serve_requests_total", status="ok")
        reg.observe("serve_latency_seconds", 0.05, status="ok")
        reg.set_gauge("serve_queue_depth", 1)
        delta = mod.snapshot_delta(s0, reg.snapshot())
        fleet = type(reg)()
        fleet.merge(reg.snapshot(), shard="3")
        fleet.merge(delta, shard="4")
        return dict(
            delta=delta, snap=fleet.snapshot(), text=fleet.render_prometheus(),
            own_text=reg.render_prometheus(),
            q=[fleet.histogram_quantile("serve_latency_seconds", q, status="ok")
               for q in (0.0, 0.5, 0.95, 1.0)],
            gauges=(fleet.sum_gauges("serve_shard_inflight"),
                    fleet.sum_gauges("serve_shard_inflight", shard="1"),
                    fleet.sum_gauges("missing")),
            series=[mod.parse_series(k) for k in reg.snapshot()["counters"]],
        )

    port, jax_ = _both(run)
    assert port == jax_
    # the label-free aggregate is the sum of the shard series
    c = port["snap"]["counters"]
    assert c['serve_requests_total{status="ok"}'] == (
        c['serve_requests_total{shard="3",status="ok"}']
        + c['serve_requests_total{shard="4",status="ok"}'])
    # gauges merge last-write-wins under the merge's own shard label
    assert port["gauges"] == (10.0, None, None)
    # a snapshot from either package merges into the other's registry
    mixed = metrics.MetricsRegistry()
    mixed.merge(port["delta"], shard="9")
    ref = jmetrics.MetricsRegistry()
    ref.merge(jax_["delta"], shard="9")
    assert mixed.snapshot() == ref.snapshot()


def test_traceparents_round_trip_between_packages(monkeypatch):
    jctx = jreqtrace.TraceContext.new()
    ctx = reqtrace.coerce_context(jctx.to_traceparent())
    assert (ctx.trace_id, ctx.span_id) == (jctx.trace_id, jctx.span_id)
    child = ctx.child()
    back = jreqtrace.TraceContext.from_traceparent(child.to_traceparent())
    assert back.trace_id == jctx.trace_id and back.span_id == child.span_id
    for bad in ("", "00-zz", "00-" + "0" * 32 + "-" + "1" * 16 + "-01", None, 7):
        assert reqtrace.TraceContext.from_traceparent(bad) is None
        assert jreqtrace.TraceContext.from_traceparent(bad) is None
    # a journey started from the other package's header parents onto it
    j = reqtrace.start_journey(jctx.to_traceparent(), clock=lambda: 0.0, t0=0.0)
    assert j.ctx.trace_id == jctx.trace_id and j.ctx.parent_span_id == jctx.span_id
    # the environment hands a traceparent to a child process's manifest
    monkeypatch.setenv(reqtrace.TRACEPARENT_ENV, jctx.to_traceparent())
    assert reqtrace.TRACEPARENT_ENV == jreqtrace.TRACEPARENT_ENV
    m, jm = journal.build_manifest(), jjournal.build_manifest()
    assert (m["trace_id"], m["parent_span_id"]) == (jm["trace_id"], jm["parent_span_id"]) \
        == (jctx.trace_id, jctx.span_id)


def _journey(mod):
    """One journey through every boundary, on a fake clock, into a Tracer
    of the same package; the record without its ids and stamp."""
    tracer = (journal if mod is reqtrace else jjournal).Tracer()
    with (journal if mod is reqtrace else jjournal).use_tracer(tracer):
        t = [10.0]
        j = mod.Journey(mod.TraceContext.new(), clock=lambda: t[0], t0=10.0,
                        request_id="r1", priority="interactive", seq=4)
        for name, at in (("enqueued", 10.001), ("slot", 10.25), ("first_chunk", 10.3)):
            j.mark(name, at)
        j.note_chunk(10.3, 10.5, 0, 8, 2)
        j.note_chunk(10.5, 10.7, 8, 14, 2, shard=1)
        j.marks["compute_end"] = 10.7
        j.mark("harvest_end", 10.71)
        rec = j.finish("complete", verdict="healthy", iterations=14, now=10.75)
        assert j.finish("complete") is None  # first finish wins
    (got,) = [r for r in tracer.events if r.get("kind") == "journey"]
    for k in ("trace_id", "span_id", "parent_span_id", "ts"):
        got.pop(k)
        rec.pop(k, None)
    return got, rec


def test_journey_records_match_jax():
    (port, prec), (jax_, _) = _journey(reqtrace), _journey(jreqtrace)
    assert port == jax_
    assert sum(port["phases"].values()) == pytest.approx(port["latency_s"], abs=1e-12)
    assert {k: v for k, v in prec.items() if k != "kind"} == \
        {k: v for k, v in port.items() if k != "kind"}


def test_slo_burn_rates_match_jax():
    r = np.random.default_rng(0)
    recs = [{"kind": "manifest"}]
    for i in range(300):
        recs.append({
            "kind": "journey", "t0": float(i) * 7.0, "latency_s": float(r.exponential(0.2)),
            "terminal": ["complete", "complete", "complete", "shed",
                         "deadline_exceeded", "cache_hit"][i % 6],
            "priority": ["interactive", "normal", "batch"][i % 3],
        })
    recs.append({"kind": "journey", "t0": "bad"})
    slos = [slo.SLO("all", 0.3, 0.9)] + list(slo.DEFAULT_SLOS)
    jslos = [jslo.SLO("all", 0.3, 0.9)] + list(jslo.DEFAULT_SLOS)
    rep, jrep = slo.evaluate(recs, slos), jslo.evaluate(recs, jslos)
    assert rep == jrep
    assert slo.breaches(rep, 1.5) == jslo.breaches(jrep, 1.5)
    assert slo.worst_burn_rate(rep) == jslo.worst_burn_rate(jrep) > 0
    out = slo.journey_outcomes(recs)
    assert slo.burn_rates(out, slos[0], now=1000.0) == \
        jslo.burn_rates(jslo.journey_outcomes(recs), jslos[0], now=1000.0)


def test_exporter_serves_a_local_socket():
    reg = metrics.MetricsRegistry()
    _registry_ops(reg)
    health = {"ok": False, "shards": {"0": {"up": False}}}
    with TelemetryExporter(0, registry=reg, health_fn=lambda: health) as ex:
        with urllib.request.urlopen(ex.url("/metrics"), timeout=10) as r:
            body = r.read().decode()
        assert r.status == 200 and body == reg.render_prometheus()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(ex.url("/healthz"), timeout=10)
        assert e.value.code == 503 and json.loads(e.value.read())["shards"]
        assert "worst_burn_rate" in json.loads(ex.handle_path("/slo")[2])
        assert ex.handle_path("/snapshot")[0] == 200
        assert ex.handle_path("/query?name=x")[0] == 404  # no store attached
        assert ex.handle_path("/conformance")[0] == 404
    from dispatches_tpu_torch.obs.timeseries import SeriesStore

    store = SeriesStore(reg, clock=lambda: 0.0)
    store.sample(0.0)
    ex = TelemetryExporter(0, registry=reg, store=store)
    status, _, body = ex.handle_path("/query?name=serve_queue_depth&window=10")
    assert status == 200 and json.loads(body)["series"][0]["v"] == [3.0]
    # the capacity route answers with whatever report is attached
    ex = TelemetryExporter(0, registry=reg, capacity_fn=dict)
    assert ex.handle_path("/capacity")[:2] == (200, "application/json")


def test_service_journeys_in_the_journal(tmp_path, capsys):
    """A service with journeys on writes one `journey` record per request
    (phases summing to the ticket's latency), and `tools/trace_summary.py`
    reads the port's journal unchanged."""
    import importlib

    from dispatches_tpu_torch.serve import make_dense_service
    from tools.torch_loadgen import make_problem

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        path = tmp_path / "serve.jsonl"
        t = [0.0]
        with journal.use_tracer(journal.Tracer(str(path))) as tracer:
            svc = make_dense_service(2, chunk_iters=4, max_iter=40, queue_limit=2,
                                     clock=lambda: t[0], reqtrace=True, device="cpu")
            tix = [svc.submit(make_problem(s), request_id=f"q{s}",
                              trace_ctx=reqtrace.TraceContext.new()) for s in range(3)]
            t[0] += 0.5
            svc.drain()
            tix.append(svc.submit(make_problem(0), request_id="hit"))
            tracer.close()
    finally:
        torch.set_num_threads(n)
    recs = journal.read_journal(str(path))
    js = {r["request_id"]: r for r in recs if r.get("kind") == "journey"}
    assert set(js) == {"q0", "q1", "q2", "hit"} and js["hit"]["terminal"] == "cache_hit"
    for tk in tix:
        res, j = tk.result(0), js[tk.request.request_id]
        assert sum(j["phases"].values()) == pytest.approx(res.latency, abs=1e-9)
        assert j["parent_span_id"] is not None or tk.request.request_id == "hit"
    ts = importlib.import_module("tools.trace_summary")
    assert ts.main([str(path)]) == 0
    assert "journeys: 4" in capsys.readouterr().out
