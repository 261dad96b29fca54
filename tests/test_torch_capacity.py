"""Port parity: the control signals, the capacity observatory and the bench
history (`dispatches_tpu_torch/obs/{signals,capacity,benchstore}.py`)
against the JAX package's modules.

All three are host arithmetic over retained telemetry, so the same inputs
on the same injected clock give exactly the JAX package's values: signal
values and trends, the estimator's laws, the fleet twin's seeded replay
and knee, the observatory's report, and the trend gate's verdicts. No
solve runs here."""
import json

import pytest

from dispatches_tpu.obs import benchstore as JB
from dispatches_tpu.obs import capacity as JC
from dispatches_tpu.obs import metrics as JMe
from dispatches_tpu.obs import signals as JS
from dispatches_tpu.obs import timeseries as JTs
from dispatches_tpu.serve.service import LATENCY_BUCKETS
from dispatches_tpu_torch.obs import benchstore as TB
from dispatches_tpu_torch.obs import capacity as TC
from dispatches_tpu_torch.obs import metrics as TMe
from dispatches_tpu_torch.obs import signals as TS
from dispatches_tpu_torch.obs import timeseries as TTs
from dispatches_tpu_torch.obs.exporter import TelemetryExporter

PKGS = {"jax": (JMe, JTs, JS, JC), "port": (TMe, TTs, TS, TC)}
# tests/test_obs_capacity.py's known-law fixture: lambda = 20 req/s, mean
# sojourn 0.25 s, queue 1, 4 busy lanes over 2 shards of 4
_LAT_PATTERN = (0.15, 0.20, 0.25, 0.30, 0.35)
_SVC_QUANTILES = ((0.0, 0.1), (0.5, 0.2), (0.95, 0.3), (1.0, 0.32))


class Clk:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _steady_store(pkg, seconds=61, lam=20, queue=1.0, shards=2, inflight=2.0,
                  lam_ramp=0.0, wobble=False):
    Me, Ts, _, _ = PKGS[pkg]
    reg = Me.MetricsRegistry()
    clk = Clk()
    store = Ts.SeriesStore(reg, tiers=((1.0, 128), (10.0, 32)), clock=clk)
    for t in range(seconds):
        clk.t = float(t)
        n = int(round(lam + lam_ramp * t))
        for i in range(n):
            reg.observe("serve_latency_seconds", _LAT_PATTERN[i % 5],
                        buckets=LATENCY_BUCKETS, status="ok")
            reg.inc("serve_requests_total", status="ok")
        # `wobble`: noisy gauges and cache counters for the signals (off:
        # tests/test_obs_capacity.py's exact fixture)
        w = 1.0 if wobble else 0.0
        if wobble:
            reg.inc("compile_cache_hit_total", 3 + t % 4, entry="serve_dense")
            reg.inc("compile_cache_miss_total", t % 2, entry="serve_dense")
        reg.set_gauge("serve_queue_depth", queue + w * (t % 3) * 0.5)
        reg.set_gauge("slo_worst_burn_rate", 0.1 * (t % 7))
        for s in range(shards):
            reg.set_gauge("serve_shard_inflight", inflight + w * 0.25 * ((t + s) % 2),
                          shard=str(s))
            reg.set_gauge("serve_shard_up", 0.0 if (s == 1 and 40 <= t < 50) else 1.0,
                          shard=str(s))
        store.sample(float(t))
    return reg, clk, store


def _both(**kw):
    return {pkg: _steady_store(pkg, **kw) for pkg in PKGS}


# ---------------------------------------------------------------------
# signals


@pytest.mark.parametrize("now", [30.0, 45.0, 60.0])
def test_control_signals_equal_jax(now):
    out = {}
    for pkg, (reg, clk, store) in _both(lam_ramp=0.1, wobble=True).items():
        sig = PKGS[pkg][2].ControlSignals(store, capacity=8, window=30.0, half_life=4.0,
                                          clock=clk)
        out[pkg] = (sig.snapshot(now), sig.arrival_rate.describe())
    assert out["port"] == out["jax"]
    snap = out["port"][0]
    assert snap["arrival_rate"]["trend"] > 0  # the ramp rises
    assert 0.0 < snap["compile_cache_hit_rate"]["value"] < 1.0


def test_signal_holds_without_data():
    for pkg in PKGS:
        Me, Ts, S, _ = PKGS[pkg]
        store = Ts.SeriesStore(Me.MetricsRegistry(), clock=Clk())
        sig = S.Signal(store, "nothing")
        assert sig.value(0.0) is None and sig.trend(0.0) is None


# ---------------------------------------------------------------------
# the fleet twin: the same seeded draws, the same replay


@pytest.mark.parametrize("rate, shards, seed", [(4.0, 2, 0), (15.0, 2, 3), (80.0, 2, 7),
                                                (30.0, 1, 11)])
def test_twin_replay_equals_jax(rate, shards, seed):
    sims = {pkg: PKGS[pkg][3].FleetTwin(_SVC_QUANTILES, lanes_per_shard=4, queue_limit=64,
                                        seed=seed).simulate(rate, shards, requests=1500)
            for pkg in PKGS}
    assert sims["port"] == sims["jax"]


def test_twin_knee_equals_jax_and_rejects_bad_input():
    knees = {pkg: [PKGS[pkg][3].FleetTwin(_SVC_QUANTILES, lanes_per_shard=4).knee(
        s, p95_limit=1.0) for s in (1, 2)] for pkg in PKGS}
    assert knees["port"] == knees["jax"]
    assert knees["port"][1]["knee_rate_per_sec"] > 1.5 * knees["port"][0]["knee_rate_per_sec"]
    with pytest.raises(ValueError):
        TC.FleetTwin([(0.5, 0.1)], lanes_per_shard=4)
    with pytest.raises(ValueError):
        TC.FleetTwin(_SVC_QUANTILES, lanes_per_shard=4).simulate(0.0, 2)


# ---------------------------------------------------------------------
# the observatory


@pytest.mark.parametrize("case", ["steady", "ramp", "broken"])
def test_observatory_equals_jax(case):
    kw = {"steady": {}, "ramp": dict(seconds=121, lam=5, lam_ramp=0.25, wobble=True),
          "broken": dict(inflight=0.5)}[case]
    now = 120.0 if case == "ramp" else 60.0
    out = {}
    for pkg, (reg, clk, store) in _both(**kw).items():
        obs = PKGS[pkg][3].CapacityObservatory(store, lanes_per_shard=4, shards=2,
                                               p95_target=1.0, clock=clk,
                                               up_shards_fn=lambda: 2)
        est = obs.estimate(now).to_dict()
        assert obs.tick(now, force=True)
        out[pkg] = (est, obs.report(), reg.snapshot()["gauges"], obs.what_if(30.0))
    assert out["port"] == out["jax"]
    est, rep, gauges, what_if = out["port"]
    json.dumps(rep)  # JSON-safe for /capacity
    assert rep["twin"]["ready"] and est["ok"]
    assert 'capacity_headroom_ratio{shard="0"}' in gauges
    if case == "steady":
        assert est["littles_residual"] < 0.1  # tests/test_obs_capacity.py's bound
    if case == "broken":
        assert max(est["littles_residual"], est["utilization_residual"]) > 0.3
    if case == "ramp":
        assert rep["forecast"]["time_to_breach_s"] is not None


def test_hysteresis_and_coercion_equal_jax():
    script = [(2, 0.0), (3, 1.0), (1, 2.0), (1, 30.0), (2, 40.0), (2, 50.0), (1, 55.0),
              (1, 120.0)]
    trail = {}
    for pkg, (reg, clk, store) in _both(seconds=3).items():
        C = PKGS[pkg][3]
        obs = C.CapacityObservatory(store, lanes_per_shard=4, shards=2, clock=clk,
                                    up_hold=0.0, down_hold=60.0)
        seen = []
        for raw, t in script:
            obs._damp(raw, t)
            seen.append(obs._desired)
        trail[pkg] = seen
        assert C.as_capacity(obs, store=store) is obs
        built = C.as_capacity({"p95_target": 0.1}, store=store, lanes_per_shard=4,
                              shards=2, clock=clk)
        assert built.p95_target == 0.1
        with pytest.raises(TypeError):
            C.as_capacity(42, store=store, lanes_per_shard=4, shards=2)
    assert trail["port"] == trail["jax"] == [2, 3, 3, 3, 3, 3, 3, 1]


def test_exporter_serves_the_capacity_report():
    reg, clk, store = _steady_store("port")
    obs = TC.CapacityObservatory(store, lanes_per_shard=4, shards=2, p95_target=1.0,
                                 clock=clk)
    obs.tick(60.0, force=True)
    assert TelemetryExporter(registry=reg).handle_path("/capacity")[0] == 404
    status, ctype, body = TelemetryExporter(registry=reg,
                                            capacity_fn=obs.report).handle_path("/capacity")
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body)["recommendation"]["desired_shards"] >= 1


# ---------------------------------------------------------------------
# the bench history


def _row(label, ts, device, **metrics):
    return {"ts": ts, "label": label, "fingerprint": {"device_kind": device},
            "metrics": dict(metrics)}


_HIST = [_row("bench", float(i), "TPU v4", wall_s=1.0 + 0.02 * (i % 3 - 1),
              goodput_rps=120.0 + (i % 2)) for i in range(8)]
_HIST += [_row("bench", 10.0 + i, "NVIDIA H100 80GB HBM3", wall_s=0.5 + 0.01 * (i % 2),
               goodput_rps=300.0) for i in range(5)]


@pytest.mark.parametrize("entry", [
    _row("bench", 99.0, "TPU v4", wall_s=1.01, goodput_rps=120.5),
    _row("bench", 99.0, "TPU v4", wall_s=1.60, goodput_rps=120.0),
    _row("bench", 99.0, "NVIDIA H100 80GB HBM3", wall_s=0.9, goodput_rps=150.0),
    _row("bench", 99.0, "NVIDIA H100 80GB HBM3", wall_s=0.3, goodput_rps=600.0, new=1.0),
    _row("bench", 99.0, None, wall_s=9.0),
    _row("other", 99.0, "TPU v4", wall_s=9.0),
])
def test_trend_gate_verdicts_equal_jax(entry):
    got = TB.trend_gate(_HIST, entry)
    assert got == JB.trend_gate(_HIST, entry)
    h100 = entry["fingerprint"]["device_kind"] == "NVIDIA H100 80GB HBM3"
    if h100 or entry["fingerprint"]["device_kind"] is None:
        # the device-kind fence: an H100 entry gates against H100 entries only
        assert got["baseline_n"] == (5 if h100 else 0)


def test_history_crosses_both_packages(tmp_path):
    nested = {"serve": {"p95_s": 0.2, "lanes": [1, 2.5]}, "ok": True, "name": "x"}
    assert TB.flatten_metrics(nested) == JB.flatten_metrics(nested) == {
        "serve/p95_s": 0.2, "serve/lanes/0": 1.0, "serve/lanes/1": 2.5}
    path = str(tmp_path / "hist.jsonl")
    JB.append_entry(path, _HIST[0])
    TB.append_entry(path, _HIST[1])
    with open(path, "a") as fh:
        fh.write('{"torn": ')  # a killed run's partial last line
    assert TB.read_history(path) == JB.read_history(path) == _HIST[:2]
    entry = TB.make_entry("bench", nested, ts=5.0)
    fp = entry["fingerprint"]
    from dispatches_tpu_torch.obs.journal import _device_info

    assert fp["device_kind"] == _device_info()["device_kind"]
    assert set(JB.make_entry("bench", nested, ts=5.0)) == set(entry)
    assert TB.comparable(entry, entry) and not TB.comparable(entry, _HIST[0])
