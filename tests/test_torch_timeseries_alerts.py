"""Port parity: the time-series store and the alert manager
(`dispatches_tpu_torch/obs/{timeseries,alerts}.py`) against the JAX
package's, on the CPU.

The same samples under a fake clock give equal `SeriesStore` queries,
reductions, downsampled tiers and `snapshot_quantile` readings, and equal
alert firings, resolutions and context captures, in both packages; the
default rule packs (`default_fleet_rules`, `default_conformance_rules`,
`default_lane_rules`) are equal as dicts. Each scenario is one script run
against either package's modules, and the two transcripts must match.
"""
import json

import pytest

from dispatches_tpu.obs import alerts as JAl
from dispatches_tpu.obs import conformance as JCo
from dispatches_tpu.obs import lanes as JLa
from dispatches_tpu.obs import metrics as JMe
from dispatches_tpu.obs import timeseries as JTs
from dispatches_tpu_torch.obs import alerts as TAl
from dispatches_tpu_torch.obs import conformance as TCo
from dispatches_tpu_torch.obs import lanes as TLa
from dispatches_tpu_torch.obs import metrics as TMe
from dispatches_tpu_torch.obs import timeseries as TTs
from dispatches_tpu_torch.obs.exporter import TelemetryExporter

JAX = (JMe, JTs, JAl)
PORT = (TMe, TTs, TAl)


class Clk:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _store_script(me, ts, al):
    reg, clk = me.MetricsRegistry(), Clk()
    store = ts.SeriesStore(reg, tiers=((1.0, 16), (4.0, 8)), clock=clk)
    out = []
    for t in range(40):
        clk.t = float(t)
        reg.inc("req_total", 1.0 + (t % 3), shard=str(t % 2))
        reg.set_gauge("depth", float((t * 7) % 11), shard=str(t % 2))
        reg.observe("lat", 0.01 * (1 + t % 5), buckets=(0.01, 0.02, 0.05, 0.1))
        if t == 25:
            reg.reset()  # a counter reset the rate must clamp
        out.append(store.maybe_sample(clk.t))
    for name, labels, agg in (("req_total", {"shard": "0"}, "rate"),
                              ("req_total", None, "delta"),
                              ("depth", None, "raw"), ("lat_p95", None, "raw"),
                              ("lat_count", None, "rate")):
        for window in (5.0, 30.0):
            out.append(store.query(name, labels, window=window, agg=agg, now=clk.t))
    for agg in ("last", "avg", "max", "min", "sum", "rate"):
        out.append(store.reduce("depth", None, window=12.0, agg=agg, now=clk.t))
    out.append(store.last_seen("depth", {"shard": "1"}))
    out.append(store.stats())
    return json.loads(json.dumps(out, default=str))


def _quantile_script(me, ts, al):
    reg = me.MetricsRegistry()
    for k, v in enumerate((0.003, 0.02, 0.02, 0.07, 0.4, 2.0, 9.0)):
        reg.observe("h", v, buckets=(0.01, 0.05, 0.1, 1.0), part=str(k % 2))
    snap = reg.snapshot()["histograms"]
    return [[k, q, ts.snapshot_quantile(h, q)] for k, h in sorted(snap.items())
            for q in (0.0, 0.5, 0.9, 0.99, 1.0)] + [ts.snapshot_quantile({}, 0.5)]


def _alerts_script(me, ts, al):
    reg, clk = me.MetricsRegistry(), Clk()
    store = ts.SeriesStore(reg, tiers=((1.0, 64),), clock=clk)
    rules = [
        al.AlertRule(name="deep", series="depth", op=">", bound=5.0, clear_bound=3.0,
                     window=4.0, severity="page"),
        al.AlertRule(name="held", series="depth", op=">", bound=5.0, window=4.0,
                     for_=3.0, agg="avg"),
        al.AlertRule(name="errs", series="errs_total", kind="rate", op=">",
                     bound=0.0, window=5.0),
        al.AlertRule(name="gone", series="beat", kind="absence", window=3.0),
        al.AlertRule(name="burn", series="slo_worst_burn_rate", kind="slo_burn",
                     op=">", bound=14.4, clear_bound=1.0),
    ]
    burn = {"worst_burn_rate": 0.0}
    mgr = al.AlertManager(store, rules, clock=clk, slo_fn=lambda: dict(burn))
    reg.inc("errs_total", 0.0)
    trans = []
    depth = [1, 2, 9, 9, 9, 9, 4, 4, 2, 2, 1, 8, 8, 8, 8, 8, 1, 1, 1, 1]
    for t, d in enumerate(depth):
        clk.t = float(t)
        reg.set_gauge("depth", float(d), shard=str(t % 2))
        if t < 8:
            reg.set_gauge("beat", 1.0)
        if t in (6, 7, 12):
            reg.inc("errs_total", 3.0)
        burn["worst_burn_rate"] = 20.0 if 9 <= t <= 11 else 0.5
        store.sample(clk.t)
        trans.append(mgr.evaluate(clk.t))
    rep = mgr.report()
    caps = [{k: c[k] for k in ("rule", "series", "t", "window")} for c in mgr.captures]
    return json.loads(json.dumps({"trans": trans, "firing": mgr.firing(),
                                  "history": rep["history"], "rules": rep["rules"],
                                  "caps": caps, "snap": reg.snapshot()["counters"]},
                                 default=str))


@pytest.mark.parametrize("script", [_store_script, _quantile_script, _alerts_script],
                         ids=["store", "quantile", "alerts"])
def test_fake_clock_transcripts_equal(script):
    assert script(*PORT) == script(*JAX)


def test_default_rule_packs_equal():
    for kw in ({}, {"queue_limit": 16, "heartbeat_timeout": 2.0}):
        assert [r.to_dict() for r in TAl.default_fleet_rules(**kw)] == \
            [r.to_dict() for r in JAl.default_fleet_rules(**kw)]
    for window in (60.0, 15.0):
        assert [r.to_dict() for r in TCo.default_conformance_rules(window=window)] == \
            [r.to_dict() for r in JCo.default_conformance_rules(window=window)]
        assert [r.to_dict() for r in TLa.default_lane_rules(window=window)] == \
            [r.to_dict() for r in JLa.default_lane_rules(window=window)]
    d = JAl.default_fleet_rules()[0].to_dict()
    assert TAl.rule_from_dict(d).to_dict() == d
    with pytest.raises(Exception):
        TAl.rule_from_dict({**d, "bogus": 1})


def test_exporter_query_and_alerts_routes():
    reg, clk = TMe.MetricsRegistry(), Clk()
    store = TTs.SeriesStore(reg, tiers=((1.0, 8),), clock=clk)
    mgr = TAl.AlertManager(store, [TAl.AlertRule(name="deep", series="depth", op=">",
                                                bound=1.0, window=2.0)], clock=clk)
    reg.set_gauge("depth", 3.0, shard="0")
    store.sample(0.0)
    mgr.evaluate(0.0)
    ex = TelemetryExporter(0, registry=reg, store=store, alerts=mgr,
                           lanes_fn=lambda: {"probes_run": 0})
    status, _, body = ex.handle_path("/query?name=depth&window=5&shard=0")
    got = json.loads(body)
    assert status == 200 and got["series"][0]["v"] == [3.0] and got["labels"] == {"shard": "0"}
    assert ex.handle_path("/query")[0] == 400
    status, _, body = ex.handle_path("/alerts")
    assert status == 200 and json.loads(body)["firing"][0]["rule"] == "deep"
    assert ex.handle_path("/lanes")[0] == 200
    # /capacity: 404 until a capacity plane is attached, then its report
    assert ex.handle_path("/capacity")[0] == 404
    ex = TelemetryExporter(0, registry=reg, capacity_fn=lambda: {"config": {"shards": 1}})
    status, ctype, body = ex.handle_path("/capacity")
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body) == {"config": {"shards": 1}}
