"""Port parity: the run journal, flight recorder, watchdog and solve
telemetry (`dispatches_tpu_torch/obs/{journal,recorder,watchdog,profile,
memory}.py`, `runtime/telemetry.py`, the remedy ladder's give-up, and
their wiring into the runners and the CLI) against the JAX package's, on
the CPU.

The journal's records are compared on one scripted run of both packages'
Tracers over the same solution arrays (built from numpy, so no solver
compiles): the same kinds in the same order with the same keys, and
equal `batch_stats` and health summaries. The runner cases run the port
alone at 24-48 h.
"""
import importlib
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.obs import journal as JJ
from dispatches_tpu.obs import recorder as JRec
from dispatches_tpu.runtime import telemetry as JTel
from dispatches_tpu.solvers.ipm import IPMSolution as JIPMSolution
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.obs import journal as TJ
from dispatches_tpu_torch.obs import memory as TM
from dispatches_tpu_torch.obs import recorder as TRec
from dispatches_tpu_torch.obs import watchdog as TW
from dispatches_tpu_torch.runtime import remedy as TR
from dispatches_tpu_torch.runtime import telemetry as TTel
from dispatches_tpu_torch.solvers.ipm import IPMSolution, solve_lp
from dispatches_tpu_torch.workflow import runners as TRun

trace_summary = importlib.import_module("tools.trace_summary")
replay_tool = importlib.import_module("tools.torch_replay_solve")

# three lanes: converged, converged late, out of budget
SOL = dict(
    x=np.array([[1.0, 2.0], [0.5, 0.25], [3.0, np.nan]]),
    y=np.array([[0.1], [0.2], [0.3]]),
    zl=np.zeros((3, 2)),
    zu=np.zeros((3, 2)),
    obj=np.array([-1.0, -0.5, 2.0]),
    converged=np.array([True, True, False]),
    iterations=np.array([12, 58, 60], dtype=np.int32),
    res_primal=np.array([1e-10, 3e-9, 2e-3]),
    res_dual=np.array([2e-11, 5e-9, 1e-4]),
    gap=np.array([1e-9, 4e-9, 7e-2]),
    status=np.array([0, 0, 1], dtype=np.int32),
)
# `tests/test_remedy.py`'s patient: rank deficient, and unregularized
SICK = ([[1.0, 1.0], [1.0, 1.0]], [1.0, 1.0], [1.0, 2.0], [0.0, 0.0], [10.0, 10.0], 0.0)
SICK_KW = dict(tol=1e-8, max_iter=60, reg_p=0.0, reg_d=0.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jsol():
    return JIPMSolution(**SOL)


def _tsol():
    return IPMSolution(**{k: torch.as_tensor(v) for k, v in SOL.items()})


def _tlp(rows):
    return LPData(*(torch.as_tensor(np.asarray(f, np.float64)) for f in rows))


def _script(tracer, sol):
    with tracer.span("outer", a=1):
        with tracer.span("inner", b="x"):
            tracer.event("e", k=1)
            tracer.metric("m", 2.0, unit="s")
            tracer.solve_event("s", sol, tag=3)
    tracer.close()
    return tracer.events


def _unbounded_capture(directory):
    """A port capture of a failing solve (min -(x1 + x2), x1 = x2, x >= 0)
    with its solution: (capture path, solution)."""
    from dispatches_tpu_torch.obs.health import classify_trace

    lp = _tlp([[[1.0, -1.0]], [0.0], [-1.0, -1.0], [0.0, 0.0], [np.inf, np.inf], 0.0])
    kw = dict(tol=1e-8, max_iter=30)
    sol, tr = solve_lp(lp, trace=True, **kw)
    verdict = classify_trace(tr, sol=sol)[0]
    assert verdict.verdict != "healthy"
    return TRec.FlightRecorder(directory).capture(
        "solve_lp", problem=lp, options=kw, verdict=verdict, solution=sol), sol


def test_journal_records_match_jax():
    want = _script(JJ.Tracer(), _jsol())
    got = _script(TJ.Tracer(), _tsol())
    assert [e["kind"] for e in got] == [e["kind"] for e in want] == [
        "manifest", "span_start", "span_start", "event", "metric", "solve",
        "span_end", "span_end", "close"]
    for w, g in zip(want, got):
        # the JAX manifest names a platform once its backend is up
        assert set(g) - {"platform"} == set(w) - {"platform", "trace_id", "parent_span_id"}, (
            g["kind"])
        if g["kind"] in ("span_start", "span_end", "event", "metric", "solve"):
            assert g["span"] == w["span"]
    man = got[0]
    assert man["schema_version"] == want[0]["schema_version"]
    assert {"python", "torch", "cuda", "numpy"} <= set(man["versions"])
    assert man["precision"]["float32_matmul_precision"] == torch.get_float32_matmul_precision()
    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    assert man["device_kind"] == card
    ends = [e for e in got if e["kind"] == "span_end"]
    assert [e["span"] for e in ends] == ["outer/inner", "outer"]
    assert all(e["retraces"] == {} and e["ok"] for e in ends)
    assert got[-1]["retrace_totals"] == {}
    solve_w, solve_g = want[5], got[5]
    assert solve_g["stats"] == solve_w["stats"]
    assert solve_g["health"] == solve_w["health"]
    assert solve_g["health"]["counts"] == {"healthy": 2, "stalled": 1}
    assert ends[0]["metrics"] == {'solve_verdict_total{solve="s",verdict="healthy"}': 2.0,
                                  'solve_verdict_total{solve="s",verdict="stalled"}': 1.0}
    if not torch.cuda.is_initialized():
        assert TM.memory_watermark_bytes() is None and TM.device_memory_stats() is None


def test_span_nesting_and_read_journal_round_trip(tmp_path):
    path = tmp_path / "run.jsonl"
    with TJ.Tracer(path, manifest_extra={"cmd": "test"}) as tr:
        with tr.span("a"):
            with pytest.raises(ValueError):
                with tr.span("b", n=np.int64(2)):
                    raise ValueError("inside b")
            tr.event("after", arr=np.arange(3), t=torch.tensor([1.5]))
    events = json.loads(json.dumps(tr.events, default=TJ._json_default))
    assert TJ.read_journal(path) == events == JJ.read_journal(str(path))
    b_end = next(e for e in events if e["kind"] == "span_end" and e["span"] == "a/b")
    assert b_end["ok"] is False and events[2]["n"] == 2
    assert events[-2]["span"] == "a" and events[-3]["arr"] == [0, 1, 2]
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"kind": "event", "na')  # a killed run's torn last line
    assert TJ.read_journal(path) == events
    out = io.StringIO()
    assert trace_summary.main([str(path)], out=out) == 0
    assert "a/b" in out.getvalue() or "b" in out.getvalue()


def test_capture_round_trips_between_packages(tmp_path):
    lp = _tlp(SICK)
    warm = tuple(torch.full(s, 0.5, dtype=torch.float64) for s in ((2,), (2,), (2,), (2,)))
    port_cap = TRec.FlightRecorder(tmp_path / "port").capture(
        "solve_lp", problem=lp, options=dict(SICK_KW, chol_dtype=torch.float32),
        verdict="stalled", warm_start=TRec.warm_bundle(lp, warm), solution=_tsol())
    got = JRec.load_capture(port_cap)
    assert type(got["problem"]).__name__ == "LPData"
    for f in lp._fields:
        assert np.array_equal(np.asarray(getattr(got["problem"], f)), getattr(lp, f).numpy())
    for k, v in SOL.items():
        assert np.array_equal(got["solution"][k], v, equal_nan=True), k
    assert set(got["warm_start"]) >= {"x", "y", "zl", "zu", "accepted"}
    assert got["meta"]["options"]["chol_dtype"] == "torch.float32"
    assert got["meta"]["replayable"] and got["meta"]["manifest"]["tool"] == "flight_recorder"
    assert got["meta"]["device"] == "cpu"  # where the solve ran: the replay's default

    jlp = JLPData(*(np.asarray(f, np.float64) for f in SICK))
    jax_cap = JRec.FlightRecorder(str(tmp_path / "jax")).capture(
        "solve_lp", problem=jlp, options=SICK_KW, verdict="stalled", solution=_jsol())
    back = TRec.load_capture(jax_cap)
    assert isinstance(back["problem"], LPData)
    for a, b in zip(jlp, back["problem"]):
        assert np.array_equal(np.asarray(a), b)
    assert set(back["solution"]) == set(SOL)

    cap, sol = _unbounded_capture(tmp_path / "replay")
    rc, report = replay_tool.replay(cap)
    assert rc == replay_tool.RC_OK and report["bitwise"]
    assert report["fields"] and all(report["fields"].values())
    assert report["device"] == report["captured_on"] == "cpu"


def test_recorder_caps_and_switch(tmp_path):
    rec = TRec.FlightRecorder(tmp_path / "n", max_captures=3)
    paths = [rec.capture("solve_lp", arrays={"v": np.full(4, i)}) for i in range(5)]
    left = sorted(os.listdir(rec.directory))
    assert left == [os.path.basename(p) for p in paths[2:]]
    small = TRec.FlightRecorder(tmp_path / "b", max_bytes=1)
    for i in range(3):
        last = small.capture("solve_lp", arrays={"v": np.zeros(100)})
    assert os.listdir(small.directory) == [os.path.basename(last)]  # the newest stays
    assert TRec.maybe_capture("solve_lp", verdict="stalled") is None  # no recorder
    prev = TRec.set_recorder(rec)
    try:
        assert TRec.maybe_capture("solve_lp", verdict="healthy") is None
        assert TRec.maybe_capture("solve_lp", verdict="stalled", arrays={"v": np.ones(1)})
    finally:
        TRec.set_recorder(prev)
    assert TRec.get_recorder() is prev


def test_watchdog_raises_on_a_hung_thunk():
    tracer = TJ.Tracer()
    with TJ.use_tracer(tracer):
        assert TW.with_watchdog(lambda: 7, timeout_s=5.0) == 7
        with pytest.raises(KeyError):
            TW.with_watchdog(lambda: {}["missing"], timeout_s=5.0)
        t0 = time.perf_counter()
        with pytest.raises(TW.WatchdogTimeout, match="stage 'nap'"):
            TW.with_watchdog(lambda: time.sleep(10.0), timeout_s=0.2, stage="nap")
        assert time.perf_counter() - t0 < 5.0  # raised without waiting for the thunk
    assert TJ.get_tracer() is not tracer
    hang = [e for e in tracer.events if e.get("name") == "hang"]
    assert len(hang) == 1 and hang[0]["stage"] == "nap" and hang[0]["verdict"] == "hang"
    assert "with_watchdog" in hang[0]["stacks"] or hang[0]["stacks"] == ""


def test_solve_telemetry_matches_jax():
    jt, tt = JTel.SolveTelemetry(), TTel.SolveTelemetry()
    jt.observe("batch", lambda: _jsol())
    tt.observe("batch", lambda: _tsol())
    for tel in (jt, tt):
        with pytest.raises(ValueError):
            tel.observe("boom", lambda: (_ for _ in ()).throw(ValueError("x")))
    assert len(tt.records) == len(jt.records) == 2
    for w, g in zip(jt.records, tt.records):
        w, g = w.__dict__, g.__dict__
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "wall_s"} == pytest.approx(
            {k: v for k, v in w.items() if k != "wall_s"}, nan_ok=True)
    assert tt.records[0].verdict == "stalled" and tt.records[1].error == "ValueError"
    assert tt.summary().keys() == jt.summary().keys()
    # check_finite names the same leaves
    tree = {"sol": _jsol(), "ok": [np.ones(2)]}
    with pytest.raises(FloatingPointError) as jerr:
        JTel.check_finite(tree, "result")
    with pytest.raises(FloatingPointError) as terr:
        TTel.check_finite({"sol": _tsol(), "ok": [torch.ones(2)]}, "result")
    assert str(terr.value) == str(jerr.value)
    assert TTel.check_finite([torch.ones(2)]) is not None


def test_report_unit_matches_jax():
    from dispatches_tpu.case_studies.renewables.pricetaker import (
        HybridDesign as JHybridDesign, build_pricetaker as j_build)
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker)

    design = dict(T=24, with_battery=True, with_pem=True, design_opt=True,
                  h2_price_per_kg=2.5, initial_soc_fixed=None)
    jprog, tprog = j_build(JHybridDesign(**design))[0], build_pricetaker(HybridDesign(**design))[0]
    x = np.random.default_rng(0).normal(size=tprog.N)
    jout, tout = io.StringIO(), io.StringIO()
    want = JTel.report_unit(jprog, x, "battery", stream=jout)
    got = TTel.report_unit(tprog, x, "battery", stream=tout)
    assert tout.getvalue() == jout.getvalue()
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(KeyError):
        TTel.report_unit(tprog, x, "nothing")


def test_remedy_give_up_captures_and_journals(tmp_path):
    """An exhausted ladder (only the cold rung fits the budget) journals
    its `remediation` event and captures the problem with the cold rung's
    re-solve, which the replay tool reproduces bitwise."""
    from dispatches_tpu_torch.obs import health

    lp = _tlp(SICK)
    verdict = health.classify_solution(solve_lp(lp, **SICK_KW), budget=60)[0]
    eng = TR.RemedyEngine(TR.RemedyPolicy(max_attempts=1, allow_f64=False,
                                          allow_lane_switch=False), solver_kw=SICK_KW)
    tracer, rec = TJ.Tracer(), TRec.FlightRecorder(tmp_path)
    prev = TRec.set_recorder(rec)
    try:
        with TJ.use_tracer(tracer):
            out = eng.remediate(lp, verdict)
    finally:
        TRec.set_recorder(prev)
    assert out.verdict.verdict == "unrecoverable" and out.attempts == 1
    names = [e["name"] for e in tracer.events if e["kind"] == "event"]
    assert names == ["capture", "remediation"]
    rem = tracer.events[-1]
    assert rem["recovered"] is False and rem["rung"] is None and rem["entry"] == "solve_lp"
    assert rem["rungs"][0] == f"cold:{verdict.verdict}" and rem["original"] == verdict.verdict
    (cap,) = os.listdir(rec.directory)
    loaded = TRec.load_capture(os.path.join(rec.directory, cap))
    assert loaded["meta"]["verdict"]["verdict"] == "unrecoverable"
    assert loaded["meta"]["extra"]["remediation"][0][0] == "cold"
    rc, report = replay_tool.replay(os.path.join(rec.directory, cap))
    assert rc == replay_tool.RC_OK and report["fields"]


def test_runners_journal_trace_and_record_failures(tmp_path):
    """`--journal`, `--record-failures` and `--profile-dir` on the CLI, and
    `tracer=` / `trace=` on the runners, are taken (no longer refused);
    and so is `cost=` (the executed-work record in the solve event)."""
    journal, record, prof = tmp_path / "j.jsonl", tmp_path / "rec", tmp_path / "prof"
    assert TRun.main(["--device", "cpu", "--journal", str(journal), "--record-failures",
                      str(record), "--profile-dir", str(prof), "yearsweep", "--scenarios",
                      "2", "--batch", "2", "--hours", "48"]) == 0
    assert TRec.get_recorder() is None and isinstance(TJ.get_tracer(), TJ.NullTracer)
    ev = TJ.read_journal(journal)
    assert ev[0]["kind"] == "manifest" and ev[0]["cmd"] == "yearsweep"
    spans = [e["span"] for e in ev if e["kind"] == "span_end"]
    assert spans == ["year_sweep/batch_0", "year_sweep"]
    (solve,) = [e for e in ev if e["kind"] == "solve"]
    assert solve["name"] == "year_batch" and solve["span"] == "year_sweep/batch_0"
    assert solve["stats"]["batch"] == 2 and solve["health"]["counts"] == {"healthy": 2}
    assert os.listdir(record) == []  # every lane healthy: nothing captured
    (trace_file,) = os.listdir(prof)
    assert "year_sweep/batch_0" in (prof / trace_file).read_text()
    assert trace_summary.main([str(journal)], out=io.StringIO()) == 0

    tracer = TJ.Tracer()
    TRun.run_year_sweep(scenarios=1, batch=1, hours=48, verbose=False, device="cpu",
                        tracer=tracer, trace=True)
    TRun.run_pricetaker(hours=24, h2_prices=[2.5], verbose=False, device="cpu", tracer=tracer)
    TRun.run_battery_ratio_sweep(ratios=(0.1,), durations=(2,), hours=24, verbose=False,
                                 device="cpu", tracer=tracer)
    solve = next(e for e in tracer.events if e["kind"] == "solve")
    assert solve["trace"]["recorded_iterations"] == [solve["stats"]["iterations"]["max"]]
    ends = [e["span"] for e in tracer.events if e["kind"] == "span_end"]
    assert ends[-4:] == ["pricetaker/point_0", "pricetaker",
                         "battery_ratio_sweep/point_0", "battery_ratio_sweep"]
    results = [e for e in tracer.events if e.get("name") == "point_result"]
    assert [r["verdict"] for r in results] == ["healthy", "healthy"]
    costed = TJ.Tracer()
    TRun.run_year_sweep(scenarios=1, batch=1, hours=48, verbose=False, device="cpu",
                        tracer=costed, cost=True)
    (solve,) = [e for e in costed.events if e["kind"] == "solve"]
    assert solve["cost"]["flops"] > 0 and solve["cost"]["flops_basis"] == "executed"
    assert solve["cost"]["roofline"]["achieved_tflops"] > 0
