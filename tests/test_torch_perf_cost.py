"""The port's performance probe and cost records (`dispatches_tpu_torch/obs/
{perf,cost}.py`) and the planes they wire in, on the CPU.

- The probe's exact-sum contract (``sum(phases) == wall_s`` bitwise, under
  a clock whose steps are not binary fractions) on the serving engine and
  the adaptive loop, its first-call (cold / hit) telemetry and journal
  records, and its counted FLOPs with ``capture_sizes=True``.
- Neutrality: probe-on, capacity-on and cost-on answers bitwise off.
- The cost counter: the FLOPs of one dense IPM solve equal an analytic
  count from the shapes times the loop's iterations; its `chain_sweep`
  count equals the card smoke check's bound formulas; the year sweep's
  ``cost=True`` record (its roofline over the counted wall).
- Nothing is refused any more (the port's list of refused options is
  gone)."""
import json

import numpy as np
import pytest
import torch

from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.obs import cost as TCost
from dispatches_tpu_torch.obs import metrics as TMe
from dispatches_tpu_torch.obs import perf as TPerf
from dispatches_tpu_torch.obs.exporter import TelemetryExporter
from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
from dispatches_tpu_torch.runtime.adaptive import make_dense_engine, solve_lp_adaptive
from dispatches_tpu_torch.serve import make_dense_service
from dispatches_tpu_torch.solvers import ipm as TIpm


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lp(seed, n=6, m=3):
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n))
    x0 = r.uniform(0.5, 1.5, size=n)
    return LPData(*(torch.as_tensor(a, dtype=torch.float64) for a in (
        A, A @ x0, r.normal(size=n), np.zeros(n), np.full(n, 4.0), 0.0)))


def _batch(rows):
    return LPData(*(torch.stack(f) for f in zip(*rows)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


class TickClock:
    """Increments of 0.1 k are not binary fractions, so ``t_end - t0`` and
    the telescoped phase sum differ by association: the exact-sum check
    is not vacuous."""

    def __init__(self):
        self.t, self.k = 0.0, 0

    def __call__(self):
        self.k += 1
        self.t += 0.1 * self.k
        return self.t


def _serve(rows, **kw):
    svc = make_dense_service(2, chunk_iters=4, cache_size=None, max_iter=40, device="cpu",
                             **kw)
    tickets = [svc.submit(r) for r in rows]
    svc.drain()
    return svc, [t.result(0) for t in tickets]


# ---------------------------------------------------------------------
# the probe


def test_engine_chunks_keep_the_exact_sum_and_first_call_telemetry(monkeypatch, tmp_path):
    monkeypatch.setattr(TPerf, "_SEEN", set())
    eng = make_dense_engine(2, chunk_iters=4, max_iter=40, device="cpu")
    eng.perf = TPerf.PerfProbe(clock=TickClock())
    journal = tmp_path / "j.jsonl"
    with use_tracer(Tracer(str(journal))):
        for i in range(2):
            eng.admit(i, _lp(i))
        out, refilled = [], False
        while eng.active():
            out += eng.step()
            if out and not refilled:
                eng.admit(9, _lp(9))  # a refill: a second cold dispatch
                refilled = True
    assert len(out) == 3
    recs = eng.perf.records
    assert len(recs) == eng.chunks
    for rec in recs:
        assert sum(rec["phases"].values()) == rec["wall_s"]  # bitwise
        order = [p for p in ("transfer", "cold", "compute", "harvest", "host")
                 if p in rec["phases"]]
        assert list(rec["phases"]) == order
    assert list(recs[0]["phases"])[:3] == ["transfer", "cold", "compute"]
    # one cold call a key (the zero-stop cold start, the resume), hits after
    assert eng.perf.compiles["cold"] == 2 and eng.perf.compiles["hit"] >= 2
    events = [json.loads(line) for line in journal.read_text().splitlines()]
    cold = [e for e in events if e["kind"] == "compile_event"]
    assert sorted(e["compile_kind"] for e in cold) == ["cold", "resume"]
    assert all(e["cache"] == "cold" and e["bucket"] == 2 for e in cold)
    hist = TMe.snapshot()["histograms"]
    assert any('cache="hit"' in k and k.startswith("compile_seconds") for k in hist)
    # the unchanged tools/trace_summary.py reads the port's compile records
    import io

    from tools import trace_summary

    buf = io.StringIO()
    assert trace_summary.main([str(journal)], out=buf) == 0
    assert "compiles serve_dense: 2 cold" in buf.getvalue()


def test_adaptive_chunks_and_counted_flops(monkeypatch):
    monkeypatch.setattr(TPerf, "_SEEN", set())
    lp = _batch([_lp(s) for s in range(5)])
    probe = TPerf.PerfProbe(clock=TickClock(), capture_sizes=True)
    stats = {}
    got = solve_lp_adaptive(lp, perf=probe, chunk_iters=4, ladder_base=2, stats=stats)
    ref = solve_lp_adaptive(lp, chunk_iters=4, ladder_base=2)
    for name, a, b in zip(ref._fields, ref, got):
        assert _same(a, b), name
    assert probe.chunks == stats["chunks"] and probe.peak_tflops is None  # no peak on the CPU
    for rec in probe.records:
        assert sum(rec["phases"].values()) == rec["wall_s"]
        assert list(rec["phases"]) == ["dispatch", "compute", "harvest", "host"]
        assert rec["flops"] > 0 and rec["achieved_tflops"] > 0  # counted on a cold call
        assert "utilization" not in rec
    costed = [r for r in probe.compile_records if r["cache"] == "cold"]
    assert costed and all(r["flops"] > 0 and r["flops_basis"] == "executed" for r in costed)
    # the first chunk ran its key's counted call: credited what was counted
    first = probe.records[0]
    assert first["wall_basis"] == "counted"
    assert first["flops"] == pytest.approx(costed[0]["flops"], rel=1e-12)
    gauges = TMe.snapshot()["gauges"]
    assert 'perf_achieved_tflops{entry="solve_lp"}' in gauges


def test_chunk_flops_scale_with_the_iterations_run():
    """A key's counted call sets its FLOPs an iteration; every chunk of the
    key is credited that rate times the loop iterations it ran itself."""
    probe = TPerf.PerfProbe(clock=TickClock(), capture_sizes=True)
    key = ("solve_lp", 2, "resume")
    a = torch.ones(4, 4, dtype=torch.float64)
    with probe.capture(key, hit=False):
        a @ a  # 2 * 4^3 = 128 FLOPs, in a call that ran 4 loop iterations
    counted, later, anchor = (probe.chunk("solve_lp") for _ in range(3))
    probe.credit(counted, key, 4)
    probe.credit(later, key, 1)
    probe.credit(anchor, ("solve_lp", 1, "resume"), 3, "solve_lp")  # nothing counted, no anchor
    assert counted.flops == 128.0 and later.flops == 32.0 and anchor.flops is None
    recs = [c.done() for c in (counted, later, anchor)]
    assert recs[0]["wall_basis"] == "counted" and "wall_basis" not in recs[1]
    assert "flops" not in recs[2]
    probe.set_model_flops("solve_lp", 10.0)  # an anchor a segment run, not an iteration
    anchored = probe.chunk("solve_lp")
    probe.credit(anchored, ("solve_lp", 1, "resume"), 3, "solve_lp")
    assert anchored.flops == 10.0


def test_probe_and_capacity_planes_are_bitwise_neutral():
    rows = [_lp(s) for s in range(5)]
    _, ref = _serve(rows)
    for kw in ({"perf": True}, {"capacity": True}, {"perf": True, "capacity": True}):
        svc, got = _serve(rows, **kw)
        for g, r in zip(got, ref):
            assert g.verdict == r.verdict and g.iterations == r.iterations
            assert all(_same(a, b) for a, b in zip(g.solution, r.solution))
        if "capacity" in kw:
            assert svc.store.stats()["samples"] >= 1
            status, _, body = TelemetryExporter(
                0, capacity_fn=svc.capacity.report).handle_path("/capacity")
            assert status == 200 and json.loads(body)["config"]["lanes_per_shard"] == 2
        if "perf" in kw:
            assert all(sum(rec["phases"].values()) == rec["wall_s"]
                       for rec in svc.engine.perf.records)


# ---------------------------------------------------------------------
# the cost counter


def test_dense_ipm_flops_equal_the_analytic_count():
    """Per loop iteration the dense IPM builds and factors A W A^T (2 B M^2 N
    + B M^3 / 3), runs 16 products with A or A^T (2 B M N each: the
    residuals twice, each of the predictor's and corrector's KKT solves 3
    times with 2 refinement steps) and 6 Cholesky solves (2 B M^2 each);
    the start and the end evaluate the residuals once each (2 products)."""
    B, M, N = 3, 5, 9
    lp = _batch([_lp(s, n=N, m=M) for s in range(B)])
    sol, rec = TCost.call_cost(TIpm.solve_lp_batch, lp, max_iter=40)
    loops = int(sol.iterations.max())
    per_iter = 16 * 2 * B * M * N + 2 * B * M * M * N + (B * M ** 3) // 3 + 6 * 2 * B * M * M
    assert rec["flops"] == loops * per_iter + 4 * 2 * B * M * N
    assert rec["flops_basis"] == "executed" and rec["bytes_accessed"] > 0
    by_op = {r["op"]: r for r in rec["ledger"]["by_op"]}
    assert by_op["aten.linalg_cholesky_ex"]["count"] == loops
    assert by_op["aten.cholesky_solve"]["count"] == 6 * loops
    # the counted solve is bitwise the plain one
    plain = TIpm.solve_lp_batch(lp, max_iter=40)
    assert all(_same(a, b) for a, b in zip(plain, sol))


def test_cost_counts_chain_sweep_as_the_kernel_bound_does():
    """`obs.cost` adds each `chain_sweep` launch's work from its shapes
    (`chain_sweep.sweep_work`); the card's smoke check bounds the kernel
    with formulas of its own (`chip_smoke.sweep_flops` / `sweep_bytes`).
    They agree at every shape the smoke check runs the kernel at."""
    import chip_smoke
    from dispatches_tpu_torch.solvers.chain_sweep import sweep_work

    for shape in chip_smoke.KERNEL_SHAPES:
        assert sweep_work(*shape) == (chip_smoke.sweep_flops(*shape),
                                      chip_smoke.sweep_bytes(*shape)), shape


def test_year_sweep_cost_record_is_neutral():
    from dispatches_tpu_torch.workflow import runners as TRun

    kw = dict(scenarios=3, batch=2, hours=48, verbose=False, device="cpu")
    plain = TRun.run_year_sweep(**kw)
    tracer = Tracer()
    costed = TRun.run_year_sweep(tracer=tracer, cost=True, **kw)
    assert [r["NPV"] for r in plain] == [r["NPV"] for r in costed]
    assert [r["iterations"] for r in plain] == [r["iterations"] for r in costed]
    # the first batch is counted, as the JAX package costs its first batch
    first, second = [e for e in tracer.events if e["kind"] == "solve"]
    assert "cost" not in second
    cost = first["cost"]
    assert cost["flops"] > 0 and cost["flops_basis"] == "executed"
    top = [r["op"] for r in cost["ledger"]["by_op"][:4]]
    assert "aten.bmm" in top and "aten.linalg_cholesky_ex" in top
    assert cost["roofline"]["achieved_tflops"] > 0 and "utilization" not in cost["roofline"]
    assert cost["roofline"]["wall_basis"] == "counted"


def test_nothing_is_refused_and_no_peak_on_the_cpu():
    # the list of the JAX package's options the port refused is gone: the
    # adaptive entry and the service take the planes (cost= is taken in
    # the tests above)
    assert not hasattr(TIpm, "_DEFERRED")
    lp = _batch([_lp(s) for s in range(2)])
    assert solve_lp_adaptive(lp, perf=TPerf.PerfProbe(), chunk_iters=4).converged.all()
    svc = make_dense_service(2, device="cpu", perf=True, capacity=True)
    assert svc.engine.perf is not None and svc.capacity is not None
    peak, source = TCost.chip_peak_tflops("cpu")
    assert peak is None and "not measured" in source
