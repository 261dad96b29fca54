"""The port's serving tier against the JAX package's, on the CPU: the
continuous-batching `SlotEngine`, `DispatchService` under a fake clock, the
admission queues and the router, and the options that wait for later
modules. Problems are `tools/loadgen.py::make_problem`'s 8 x 4 box LPs
(the port's `tools/torch_loadgen.py` builds the same arrays).
"""
import numpy as np
import pytest
import torch

import jax

from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.runtime.adaptive import make_dense_engine as jax_make_dense_engine
from dispatches_tpu.serve import FairQueue as JFairQueue
from dispatches_tpu.serve import Router as JRouter
from dispatches_tpu.serve import SolveRequest as JSolveRequest
from dispatches_tpu.serve import TenantConfig as JTenantConfig
from dispatches_tpu.serve import make_dense_service as jax_make_dense_service
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.runtime.adaptive import make_dense_engine
from dispatches_tpu_torch.serve import (
    FairQueue, Router, SolveRequest, TenantConfig, make_dense_fleet, make_dense_service,
)
from dispatches_tpu_torch.solvers.ipm import solve_lp_batch
from tools.torch_loadgen import make_problem

FLAGS = ("converged", "iterations", "status")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_lp(seed):
    return JLPData(*make_problem(seed))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _biteq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _drive(engine, problems):
    """Admit `problems` (token -> row) as slots free up; every harvest."""
    todo, out = list(problems), {}
    while todo or engine.active():
        while todo and engine.free_slots():
            tok = todo.pop(0)
            engine.admit(tok, problems[tok])
        for tok, row, stats in engine.step():
            out[tok] = (row, stats)
    return out


# ---------------------------------------------------------------------
# the engine


def test_engine_refill_is_bitwise_the_batch_at_its_bucket():
    """Lanes admitted into freed slots mid-flight come out bitwise the same
    lane of a one-shot `solve_lp_batch` of `bucket` lanes."""
    B = 4
    eng = make_dense_engine(B, chunk_iters=3, max_iter=40, device="cpu")
    problems = {i: make_problem(i) for i in range(7)}
    out = _drive(eng, problems)
    assert sorted(out) == list(range(7)) and eng.refills > 0
    for tok, p in problems.items():
        ref = solve_lp_batch(LPData(*(torch.as_tensor(np.stack([a] * B)) for a in p)),
                             max_iter=40)
        row, stats = out[tok]
        for name, a, b in zip(ref._fields, ref, row):
            assert _biteq(a[0].numpy(), b), (tok, name)
        assert stats["iterations"] == int(row.iterations)


def test_engine_evict_and_admit_bounds():
    eng = make_dense_engine(2, chunk_iters=2, max_iter=40, device="cpu")
    eng.admit("a", make_problem(0))
    eng.admit("b", make_problem(1))
    with pytest.raises(RuntimeError):
        eng.admit("c", make_problem(2))
    eng.step()
    row = eng.evict("b")  # the best iterate after one chunk
    assert row is not None and np.isfinite(row.x).all() and int(row.iterations) >= 1
    eng.admit("c", make_problem(2))  # the freed slot takes a new lane
    assert eng.evict("c") is None  # no chunk ran for it yet
    with pytest.raises(ValueError):  # another shape does not fit the bucket
        eng.admit("d", make_problem(3, n=6))


def test_engine_matches_jax():
    """The same 16 problems through both packages' dense engines: the same
    iterations and verdicts, x within 1e-9 of max|x|."""
    problems = {i: make_problem(100 + i) for i in range(16)}
    jeng = jax_make_dense_engine(4, chunk_iters=4, max_iter=40)
    jout = _drive(jeng, {k: JLPData(*p) for k, p in problems.items()})
    jax.block_until_ready(jout[15][0].x)  # finish JAX before torch starts
    out = _drive(make_dense_engine(4, chunk_iters=4, max_iter=40, device="cpu"), problems)
    for k in problems:
        (jrow, jst), (row, st) = jout[k], out[k]
        assert jst["iterations"] == st["iterations"]
        for f in FLAGS:
            assert np.asarray(getattr(jrow, f)) == np.asarray(getattr(row, f)), (k, f)
        scale = np.max(np.abs(np.asarray(jrow.x)))
        np.testing.assert_allclose(row.x, np.asarray(jrow.x), rtol=0, atol=1e-9 * scale)


# ---------------------------------------------------------------------
# the service under a fake clock


def _script(make_service, lp_of, **kw):
    """One scripted schedule: priorities, backpressure (a door rejection
    and a displacement), a queued and an in-flight deadline, cache hits.
    Returns the completion sequence ``(request_id, verdict, iterations,
    from_cache, objective)``, polled in submission order after every step."""
    clock = FakeClock()
    svc = make_service(2, chunk_iters=2, queue_limit=4, cache_size=8, clock=clock,
                       max_iter=40, **kw)
    tickets, seq = {}, []

    def poll():
        for rid, t in tickets.items():
            if t.done() and rid not in {s[0] for s in seq}:
                r = t.result(0)
                obj = None if r.solution is None else float(np.asarray(r.solution.obj))
                seq.append((rid, r.verdict, r.iterations, r.from_cache, obj))

    def submit(rid, seed, **skw):
        tickets[rid] = svc.submit(lp_of(seed), request_id=rid, **skw)
        poll()

    submit("b0", 1, priority="batch")
    submit("i0", 2, priority="interactive")
    submit("n0", 3)
    submit("late", 4, timeout=1.0)  # the queue is full now
    submit("b1", 5, priority="batch")  # not more urgent than the worst: rejected
    submit("i1", 6, priority="interactive")  # displaces b0
    clock.advance(2.0)
    svc.pump()  # `late` expires in the queue; i0, i1 take the slots
    poll()
    submit("mid", 7, timeout=0.5)
    while not any(r is tickets["mid"].request for r in svc.engine.active()):
        svc.pump()
        poll()
    clock.advance(1.0)
    svc.pump()  # `mid` ran a chunk: evicted with its best iterate
    poll()
    svc.drain()
    poll()
    submit("hit_n0", 3)
    submit("hit_i0", 2, priority="batch")
    svc.drain()
    poll()
    return seq


def test_service_script_matches_jax():
    jseq = _script(jax_make_dense_service, _jax_lp)
    seq = _script(make_dense_service, make_problem, device="cpu")
    assert [s[:4] for s in seq] == [s[:4] for s in jseq]
    verdicts = {s[0]: s[1] for s in seq}
    assert verdicts["b1"] == verdicts["b0"] == "shed"
    assert verdicts["late"] == verdicts["mid"] == "deadline_exceeded"
    assert [s[3] for s in seq if s[0].startswith("hit")] == [True, True]
    for (rid, *_, obj), jobj in zip(seq, (s[4] for s in jseq)):
        assert (obj is None) == (jobj is None), rid
        if obj is not None:
            assert obj == pytest.approx(jobj, rel=1e-9, abs=1e-12), rid
    mid = next(s for s in seq if s[0] == "mid")
    assert mid[2] is not None and mid[4] is not None  # a finite best iterate


def test_service_cache_hit_is_bitwise_its_first_solve():
    svc = make_dense_service(2, chunk_iters=4, max_iter=40, device="cpu")
    first = svc.submit(make_problem(11))
    svc.drain()
    chunks = svc.engine.chunks
    again = svc.submit(make_problem(11))
    assert again.done() and again.result(0).from_cache and svc.engine.chunks == chunks
    for a, b in zip(first.result(0).solution, again.result(0).solution):
        assert _biteq(a, b)
    # the device is part of the key: a card's bits may differ from the CPU's
    assert svc._fp_options(None)["_serve"][-1] == "cpu"


# ---------------------------------------------------------------------
# the queue and the router


def _queue_script(FQ, TC, Req):
    """FairQueue + TokenBucket decisions on one scripted sequence."""
    q = FQ(6, tenants={"a": TC(weight=2.0), "b": TC(weight=1.0),
                       "lim": TC(rate=0.5, burst=1.0)})
    out = []
    for i, (tenant, pri, now) in enumerate([
        ("a", 1, 0.0), ("b", 1, 0.0), ("a", 1, 0.1), ("b", 2, 0.1), ("lim", 1, 0.2),
        ("lim", 1, 0.3), ("a", 0, 0.4), ("b", 1, 0.5), ("lim", 1, 3.0), ("a", 2, 3.1),
    ]):
        r = Req(None, priority=pri, tenant=tenant)
        r.seq = i
        ok, shed, reason = q.push(r, now=now)
        out.append(("push", i, ok, None if shed is None else shed.seq, reason))
    while len(q):
        r = q.pop()
        out.append(("pop", r.seq, r.tenant))
    return out


class _Shard:
    def __init__(self, shard_id, inflight, bucket=4):
        self.shard_id, self._n, self.bucket = shard_id, inflight, bucket

    def inflight(self):
        return self._n


def _router_script(R, Req):
    """Router placements: least-loaded, interactive, affinity with slack,
    a forgotten shard, full shards."""
    clock = FakeClock()
    router = R(affinity_slack=1, affinity_ttl=5.0, clock=clock)
    shards = [_Shard(0, 1), _Shard(1, 0), _Shard(2, 2)]
    out = []
    for i, (fp, pri, dt) in enumerate([
        ("x", 1, 0), ("y", 1, 0), ("x", 1, 1), ("x", 0, 0), ("z", 2, 0), ("y", 1, 6),
        ("x", 1, 0), ("w", 1, 0), ("x", 1, 0),
    ]):
        clock.advance(dt)
        r = Req(None, priority=pri, fingerprint=fp)
        r.seq = i
        s = router.pick(r, shards)
        out.append((i, None if s is None else s.shard_id))
        if s is not None:
            router.note_dispatch(r, s)
            s._n += 1
        if i == 5:
            router.forget_shard(1)
            shards[0]._n = 4  # full
    return out


def test_queue_and_router_decide_as_jax():
    assert _queue_script(FairQueue, TenantConfig, SolveRequest) == \
        _queue_script(JFairQueue, JTenantConfig, JSolveRequest)
    assert _router_script(Router, SolveRequest) == _router_script(JRouter, JSolveRequest)


# ---------------------------------------------------------------------
# refused options, and no CPU unless asked


@pytest.mark.parametrize("kw, item", [({"perf": True}, "perf"), ({"capacity": True}, "capacity")])
def test_service_refuses_unported_options(kw, item):
    """The JAX package's options are all taken now: the probe rides the
    engine, the observatory the service (with the store it reads)."""
    svc = make_dense_service(2, device="cpu", **kw)
    if item == "perf":
        assert svc.engine.perf is not None and svc.capacity is None
    else:
        assert svc.capacity is not None and svc.store is not None
        assert "capacity" in svc.stats()


@pytest.mark.parametrize("kw, item", [({"capacity": True}, "capacity")])
def test_fleet_refuses_unported_options(kw, item):
    fleet = make_dense_fleet(1, 2, device="cpu", spawn=False, **kw)
    assert fleet.capacity is not None and fleet.store is not None
    assert fleet.capacity_report()["config"]["shards"] == 1


def _fam(seed, n=8, m=4):
    """One LP family (the loadgen draws a new A per request): a fixed A and
    bounds, per-seed feasible b and objective c, host arrays."""
    A = np.random.default_rng(7).standard_normal((m, n))
    r = np.random.default_rng(seed)
    return LPData(A, A @ r.uniform(0.5, 3.5, n), r.standard_normal(n), np.zeros(n),
                  np.full(n, 4.0), np.float64(0.0))


@pytest.fixture(scope="module")
def warm_artifact(tmp_path_factory):
    """A small warm-start artifact over `_fam`'s LP family."""
    from dispatches_tpu_torch.learn import DatasetWriter, load_dataset, train_warmstart_model
    from dispatches_tpu_torch.solvers.ipm import solve_lp

    tmp = tmp_path_factory.mktemp("warm")
    w = DatasetWriter(str(tmp / "ds"))
    for s in range(16):
        p = LPData(*(torch.as_tensor(a) for a in _fam(s)))
        sol = solve_lp(p)
        w.add(p, sol, iterations=int(sol.iterations))
    w.close()
    model, _ = train_warmstart_model(load_dataset([str(tmp / "ds")]), hidden=(8, 8),
                                     epochs=100, device="cpu")
    return model.save(str(tmp / "warm.npz"))


def _serve(svc, rows):
    tickets = [svc.submit(r) for r in rows]
    svc.drain()
    return [t.result(0) for t in tickets]


@pytest.mark.parametrize("opt", ["timeseries", "lanes", "warm_model"])
def test_service_live_options(opt, warm_artifact):
    """The options the refusals above used to name, live: the store and the
    observatory only read (answers bitwise as without them); a learned seed
    lands on the cold answer within the IPM's tolerance."""
    rows = [_fam(100 + s) for s in range(6)]
    cold = _serve(make_dense_service(4, cache_size=None, device="cpu"), rows)
    kw = {"timeseries": {"timeseries": True}, "lanes": {"lanes": {"probe_fraction": 1.0}},
          "warm_model": {"warm_model": warm_artifact}}[opt]
    svc = make_dense_service(4, cache_size=None, device="cpu", **kw)
    got = _serve(svc, rows)
    assert all(r.verdict == "healthy" for r in got)
    for a, b in zip(cold, got):
        if opt == "warm_model":
            assert np.max(np.abs(np.asarray(a.solution.x) - np.asarray(b.solution.x))) < 1e-6
            assert b.from_cache is False
        else:
            assert all(_biteq(x, y) for x, y in zip(a.solution, b.solution))
    st = svc.stats()
    if opt == "timeseries":
        assert st["timeseries"]["series"] > 0
        assert svc.store.query("serve_requests_total", window=60.0)
    elif opt == "lanes":
        assert st["lanes"]["decisions"] == len(rows) and st["lanes"]["probes_run"] > 0
        assert svc.lane_report()["scoreboard"]


@pytest.mark.parametrize("opt", ["timeseries", "lanes", "lane_policy", "warm_model",
                                 "lane_model"])
def test_fleet_live_options(opt, warm_artifact, tmp_path):
    """The fleet's options, wired without spawning a child: the store and
    its alert packs, the observatory, the router's advice source, the
    children's warm model and the lane router."""
    from dispatches_tpu_torch.learn import LaneRouter

    kw = {"timeseries": {"timeseries": True, "conformance": True},
          "lanes": {"lanes": True, "timeseries": True},
          "lane_policy": {"lanes": True, "lane_policy": "advice"},
          "warm_model": {"warm_model": warm_artifact},
          "lane_model": {"lane_policy": "model", "lane_model": LaneRouter()}}[opt]
    fleet = make_dense_fleet(1, 2, device="cpu", spawn=False, **kw)
    if opt == "timeseries":
        names = {r.name for r in fleet.alerts.rules}
        assert "accuracy_burn" in names and "shard_down" in names
        fleet.pump()
        assert fleet.stats()["timeseries"]["series"] > 0
    elif opt == "lanes":
        assert "lane_regret_burn" in {r.name for r in fleet.alerts.rules}
        assert fleet.lane_report()["decisions"] == 0
    elif opt == "lane_policy":
        assert fleet.router.advice_fn == fleet.lanes.advice
        with pytest.raises(ValueError, match="lane_policy"):
            make_dense_fleet(1, 2, device="cpu", spawn=False, lane_policy="fastest")
    elif opt == "warm_model":
        assert fleet._slots[0].shard.warm_model == warm_artifact
    else:
        assert fleet.router.advice_fn == fleet.lane_model.advice
        assert fleet.lane_model.advice("0" * 64) is None


def test_refusals_elsewhere_and_no_silent_cpu():
    from dispatches_tpu_torch.serve import DispatchService
    from tools import torch_loadgen

    eng = make_dense_engine(2, device="cpu")
    sentinel = object()
    assert DispatchService(eng, capacity=sentinel).capacity is sentinel
    # the loadgen's ramp takes LO:HI:STEPS and nothing else
    with pytest.raises(SystemExit):
        torch_loadgen.main(["--ramp", "1:2", "--device", "cpu"])
    if not torch.cuda.is_available():
        # the entry points default to the card and never fall back
        with pytest.raises(RuntimeError, match="CUDA"):
            make_dense_service(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_dense_fleet(1, 2)


@pytest.mark.parametrize("where", ["engine", "service_store", "service_lanes", "cli"])
def test_live_options_elsewhere(where, warm_artifact, tmp_path):
    """The refusals `test_refusals_elsewhere_and_no_silent_cpu` used to
    hold, live: the engine's learned seeds, `DispatchService(store=,
    lanes=)`, and the request loop's ``--warm-model`` / ``--timeseries`` /
    ``--lanes``."""
    import io
    import json

    from dispatches_tpu_torch.obs.timeseries import SeriesStore
    from dispatches_tpu_torch.serve import DispatchService

    rows = {k: LPData(*(torch.as_tensor(a) for a in _fam(200 + k))) for k in range(3)}
    if where == "engine":
        out = _drive(make_dense_engine(2, device="cpu", warm_predictor=warm_artifact), rows)
        assert all(st["warm_source"] == "learned" for _, st in out.values())
        assert any(st["warm_accepted"] for _, st in out.values())
    elif where in ("service_store", "service_lanes"):
        kw = ({"store": SeriesStore()} if where == "service_store"
              else {"lanes": {"probe_fraction": 0.0}})
        svc = DispatchService(make_dense_engine(2, device="cpu"), **kw)
        got = _serve(svc, list(rows.values()))
        assert all(r.verdict == "healthy" for r in got)
        if where == "service_store":
            assert svc.stats()["timeseries"]["series"] > 0
        else:
            assert svc.lane_report()["decisions"] == 3
    else:
        from tools import torch_serve_dispatch

        req = {"op": "solve", "id": "r0",
               "problem": {k: np.asarray(v).tolist()
                           for k, v in zip(LPData._fields, _fam(300))}}
        path = tmp_path / "req.jsonl"
        path.write_text(json.dumps(req) + "\n" + json.dumps({"op": "stats"}) + "\n")
        buf = io.StringIO()
        rc = torch_serve_dispatch.main(["--input", str(path), "--device", "cpu",
                                        "--warm-model", warm_artifact, "--timeseries",
                                        "--lanes"], out=buf)
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        assert rc == 0 and any(r.get("verdict") == "healthy" for r in lines)
        st = next(r["stats"] for r in lines if "stats" in r)
        assert "timeseries" in st and "lanes" in st


# ---------------------------------------------------------------------
# the remedy hook, compiled submissions, the drain timeout, the canary


def test_remedy_row_hook_and_its_deadline():
    """A nonfinite harvested row re-solves healthy at the cold rung; with
    the request's deadline already past the ladder does not climb and the
    verdict stays the deadline machinery's."""
    from dispatches_tpu_torch.runtime.remedy import RemedyEngine

    p = LPData(*(torch.as_tensor(a) for a in make_problem(5)))
    good, _ = _drive(make_dense_engine(1, max_iter=40, device="cpu"), {"a": p})["a"]
    bad = type(good)(*(np.full_like(f, np.nan) if np.asarray(f).dtype.kind == "f" else f
                       for f in good))
    t = [0.0]
    eng = RemedyEngine(solver_kw=dict(max_iter=40), entry="serve_dense", clock=lambda: t[0])
    fixed, info = eng.remediate_solution_row(p, bad, budget=40, deadline=1.0)
    assert info["original"] == "nonfinite" and info["rung"] == "cold" and info["recovered"]
    assert np.isfinite(np.asarray(fixed.x)).all()
    t[0] = 2.0
    same, info = eng.remediate_solution_row(p, bad, budget=40, deadline=1.0)
    assert same is bad and not info["recovered"] and info["verdict"] == "nonfinite"
    assert eng.remediate_solution_row(p, good, budget=40) == (good, None)


def test_submit_compiled_and_drain_timeout():
    from dispatches_tpu_torch.core.model import Model

    m = Model("serve-toy")
    g = m.var("g", 3, lb=0.0, ub=5.0)
    lmp = m.param("lmp", 3)
    m.add_le(g.sum() - 7.0)
    m.maximize((lmp * g).sum())
    prog = m.build()
    ticks = iter(range(10**6))  # every reading of the clock is a second later
    svc = make_dense_service(1, chunk_iters=1, max_iter=40, clock=lambda: float(next(ticks)),
                             device="cpu")
    t1 = svc.submit_compiled(prog, {"lmp": np.array([1.0, 3.0, 2.0])})
    svc.drain()
    t2 = svc.submit_compiled(prog, {"lmp": np.array([1.0, 3.0, 2.0])})
    assert t1.result(0).ok and t2.done() and t2.result(0).from_cache
    # a drain that runs out of time sheds what is queued and evicts what
    # is in flight
    late = [svc.submit_compiled(prog, {"lmp": np.array([s, 1.0, 2.0])}) for s in (4.0, 5.0)]
    svc.pump()  # the first one runs a chunk
    assert svc.drain(timeout=0.5) == 2
    verdicts = {t.result(0).verdict: t.result(0) for t in late}
    assert sorted(verdicts) == ["deadline_exceeded", "shed"]
    assert verdicts["deadline_exceeded"].solution is not None


def test_canary_through_the_service(tmp_path):
    """Goldens certified by the port load in the JAX package (one artifact
    format) and score against the service's answers."""
    from dispatches_tpu.serve.canary import load_goldens as jax_load_goldens
    from dispatches_tpu_torch.serve.canary import (
        CanaryScheduler, certify_golden, load_goldens, save_goldens,
    )

    goldens = [certify_golden(f"g{s}", LPData(*make_problem(s)), device="cpu")
               for s in (1, 2)]
    path = save_goldens(str(tmp_path / "goldens.npz"), goldens)
    assert [g.fingerprint for g in jax_load_goldens(path)] == \
        [g.fingerprint for g in load_goldens(path)]
    svc = make_dense_service(2, chunk_iters=4, max_iter=60, device="cpu")
    canary = CanaryScheduler(path, service=svc)
    canary.tick()
    svc.drain()
    scored = canary.collect()
    assert {r["outcome"] for r in scored} <= {"exact", "tolerance"} and len(scored) == 2
    assert canary.report()["mismatches"] == 0
