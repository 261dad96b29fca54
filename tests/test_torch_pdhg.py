"""Port parity: the PDHG/PDLP lane (`dispatches_tpu_torch/core/program.py`
`SparseLP` / `instantiate_coo`, `solvers/pdhg.py`, `runtime/adaptive.py`
`solve_lp_pdhg_adaptive`, the lane switch of `runtime/remedy.py`) against
the JAX package, in float64 on the CPU, on the same numpy-made inputs.

Two families: `tests/test_pdlp.py`'s random 12 x 24 LP and the weekly
design LP cut to T = 24 (241 rows, 339 columns). The two packages' PDHG
sequences agree iteration for iteration only while no near-tie decides a
branch: with the controls off they are held to each other over two check
periods; with the controls on (the line search's accept test compares
nearly equal numbers) only the converged results are. The JAX package
compiles its PDHG solver four times here, each computation finished
(`jax.block_until_ready`) before the port's starts.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.case_studies.renewables.pricetaker import (
    HybridDesign as JHybridDesign,
    build_pricetaker as j_build,
)
from dispatches_tpu.core.program import SparseLP as JSparseLP
from dispatches_tpu.core.program import lp_fingerprint as j_fingerprint
from dispatches_tpu.obs import health as j_health
from dispatches_tpu.runtime import remedy as JR
from dispatches_tpu.runtime.telemetry import batch_stats as j_batch_stats
from dispatches_tpu.solvers.ipm import IPMSolution as JIPMSolution
from dispatches_tpu.solvers.pdhg import PDHGSolution as JPDHGSolution
from dispatches_tpu.solvers.pdhg import solve_lp_pdhg as j_pdhg
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu_torch.convert import sparse_lp_from_numpy
from dispatches_tpu_torch.core.program import LPData, SparseLP, lp_fingerprint
from dispatches_tpu_torch.obs import health
from dispatches_tpu_torch.runtime import adaptive as TA
from dispatches_tpu_torch.runtime import remedy as TR
from dispatches_tpu_torch.runtime.telemetry import batch_stats
from dispatches_tpu_torch.solvers import pdhg as TP
from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

DATA = JP.load_rts303()
T = 24
DESIGN = dict(T=T, with_battery=True, with_pem=True, design_opt=True,
              h2_price_per_kg=2.5, initial_soc_fixed=None)
CTL = dict(adaptive_restarts=True, primal_weight=True, linesearch=True)
# tests/test_pdlp.py's chunk boundaries
BOUNDARIES = [(200, 6000), (1000, 1400, 6000), (200, 1000, 1400, 4200, 6000)]


def _same(a, b):
    """Bitwise equality of two tensors, NaN equal to NaN (trace padding)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_bitwise(ref, got):
    for name, a, b in zip(ref._fields, ref, got):
        if isinstance(a, tuple):
            _assert_bitwise(a, b)
        else:
            assert _same(a, b), f"{type(ref).__name__}.{name} differs"


def _rel(want, got):
    want = np.asarray(want)
    return float(np.max(np.abs(want - got.numpy())) / np.max(np.abs(want)))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mk_sparse(seed=0, m=12, n=24, density=0.35):
    """tests/test_pdlp.py::_mk_sparse's LP, as numpy fields."""
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n)) * (r.random((m, n)) < density)
    A[np.arange(m), r.integers(0, n, m)] += 1.0  # no empty rows
    x0 = r.uniform(0.5, 2.5, n)
    rows, cols = np.nonzero(A)
    return [rows.astype(np.int32), cols.astype(np.int32), A[rows, cols], A @ x0,
            r.normal(size=n), np.zeros(n), np.full(n, 4.0), np.float64(0.0)]


def _mk_batch(seeds, base=3):
    """Lanes over ONE pattern (`_mk_sparse(base)`'s): per-lane values,
    costs and feasible right-hand sides."""
    rows, cols, vals = _mk_sparse(base)[:3]
    m, n = 12, 24
    lanes = []
    for s in seeds:
        r = np.random.default_rng(100 + s)
        v = vals * r.uniform(0.8, 1.2, vals.shape)
        A = np.zeros((m, n))
        A[rows, cols] = v
        x0 = r.uniform(0.5, 2.5, n)
        lanes.append((v, A @ x0, r.normal(size=n)))
    v, b, c = (np.stack(f) for f in zip(*lanes))
    return [rows, cols, v, b, c, np.zeros(n), np.full(n, 4.0), np.zeros(len(seeds))]


@pytest.fixture(scope="module")
def design():
    """(JAX SparseLP, numpy fields) of the T = 24 weekly design LP."""
    prog, _ = j_build(JHybridDesign(**DESIGN))
    p = {"lmp": DATA["da_lmp"][:T], "wind_cf": DATA["da_wind_cf"][:T]}
    jlp = prog.instantiate_coo(p)
    return jlp, [np.asarray(a) for a in jlp]


def _jlp(fields):
    return JSparseLP(*(jnp.asarray(a) for a in fields))


def _tlp(fields):
    return sparse_lp_from_numpy(fields, device="cpu")


# ---------------------------------------------------------------------
# 1. SparseLP / instantiate_coo / convert
# ---------------------------------------------------------------------
def test_instantiate_coo_matches_jax(design):
    jlp, fields = design
    prog, _ = build_pricetaker(HybridDesign(**DESIGN))
    p = {"lmp": DATA["da_lmp"][:T], "wind_cf": DATA["da_wind_cf"][:T]}
    got = prog.instantiate_coo(p, device="cpu")
    assert got._fields == jlp._fields
    for name, a, b in zip(got._fields, fields, got):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), name
    assert got.rows.dtype == torch.int32 and got.cols.dtype == torch.int32
    assert lp_fingerprint(got) == j_fingerprint(jlp)
    assert lp_fingerprint(_tlp(fields)) == j_fingerprint(jlp)


def test_instantiate_coo_batches_only_what_varies():
    prog, _ = build_pricetaker(HybridDesign(**DESIGN))
    scales = np.array([0.7, 1.0, 1.6])
    lmp = scales[:, None] * DATA["da_lmp"][:T][None]
    got = prog.instantiate_coo({"lmp": lmp, "wind_cf": DATA["da_wind_cf"][:T]}, device="cpu")
    assert [tuple(a.shape) for a in got] == [
        (745,), (745,), (745,), (3, 241), (3, 339), (339,), (339,), (3,)]
    for i, s in enumerate(scales):
        one = prog.instantiate_coo({"lmp": lmp[i], "wind_cf": DATA["da_wind_cf"][:T]},
                                   device="cpu")
        assert torch.equal(one.c, got.c[i]) and torch.equal(one.b, got.b[i])
        assert torch.equal(one.c0, got.c0[i]) and torch.equal(one.vals, got.vals)


# ---------------------------------------------------------------------
# 2. solve_lp_pdhg against the JAX package
# ---------------------------------------------------------------------
@pytest.mark.parametrize("family", ["random", "design"])
def test_pdhg_controls_off_two_periods_match_jax(family, design):
    fields = _mk_sparse(3) if family == "random" else design[1]
    kw = dict(tol=1e-12, max_iter=400)
    want = jax.block_until_ready(j_pdhg(_jlp(fields), **kw))
    got = TP.solve_lp_pdhg(_tlp(fields), **kw)
    assert int(got.iterations) == int(want.iterations) == 400
    assert _rel(want.x, got.x) <= 1e-9
    assert _rel(want.y, got.y) <= 1e-9
    assert float(got.res_primal) == pytest.approx(float(want.res_primal), rel=1e-9)


def test_pdhg_linesearch_alone_matches_jax_before_rounding_grows(design):
    """The Malitsky–Pock line search alone, three check periods of 10 on
    the design LP: x and y within 1e-12 of JAX's (of max|x|, max|y|). The
    formula is the JAX package's; only later do the accept tests amplify
    last-bit rounding (week 5 at T = 168 on the CPU: 4.8e-16 of max|x|
    after 10 iterations, 1.6e-11 after 100, 3.8e-2 after 200)."""
    kw = dict(tol=1e-12, max_iter=30, check_every=10, linesearch=True)
    want = jax.block_until_ready(j_pdhg(_jlp(design[1]), **kw))
    got = TP.solve_lp_pdhg(_tlp(design[1]), **kw)
    assert int(got.iterations) == int(want.iterations) == 30
    assert _rel(want.x, got.x) <= 1e-12
    assert _rel(want.y, got.y) <= 1e-12


@pytest.mark.parametrize("family", ["random", "design"])
def test_pdhg_controls_on_converged_match_jax(family, design):
    fields = _mk_sparse(6) if family == "random" else design[1]
    kw = dict(tol=1e-9 if family == "random" else 1e-8, max_iter=60_000, **CTL)
    want = jax.block_until_ready(j_pdhg(_jlp(fields), **kw))
    got = TP.solve_lp_pdhg(_tlp(fields), **kw)
    assert bool(got.converged) and bool(want.converged)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-8)
    assert abs(int(got.iterations) - int(want.iterations)) <= 200
    assert int(got.restarts) >= 1


# ---------------------------------------------------------------------
# 3. within the port: resume, polish, trace, warm starts, batches
# ---------------------------------------------------------------------
@pytest.mark.parametrize("boundaries", BOUNDARIES)
def test_pdlp_controls_resume_bitwise(boundaries):
    lp = _tlp(_mk_sparse(3))
    one, st_one = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=6000, return_state=True, **CTL)
    st = None
    for stop in boundaries:
        seg, st = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=6000, state=st, it_stop=stop,
                                   return_state=True, **CTL)
    _assert_bitwise(one, seg)
    _assert_bitwise(st_one, st)


def test_pdlp_resume_bitwise_traced_and_polished():
    lp = _tlp(_mk_sparse(4))
    kw = dict(tol=1e-9, max_iter=4000, trace=True, polish=True, **CTL)
    one, tr_one = TP.solve_lp_pdhg(lp, **kw)
    st = None
    for stop in (1000, 2200, 4000):
        seg, tr, st = TP.solve_lp_pdhg(lp, state=st, it_stop=stop, return_state=True, **kw)
    _assert_bitwise(one, seg)
    _assert_bitwise(tr_one, tr)
    assert tr.res_primal.shape == (20,)


def test_historical_defaults_resume_bitwise():
    lp = _tlp(_mk_sparse(5))
    one = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=4000)
    st = None
    for stop in (600, 2000, 4000):
        seg, st = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=4000, state=st, it_stop=stop,
                                   return_state=True)
    _assert_bitwise(one, seg)
    assert int(seg.restarts) == 0 and float(st.score_r) == float("inf")


def test_polish_never_worsens_the_residuals():
    lp = _tlp(_mk_sparse(8))
    rough = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=400)
    pol = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=400, polish=True)
    assert float(pol.res_primal) <= float(rough.res_primal)
    assert (float(pol.res_primal) + float(pol.res_dual)
            <= float(rough.res_primal) + float(rough.res_dual))
    assert torch.equal(pol.y, rough.y) and torch.equal(pol.iterations, rough.iterations)


def test_linesearch_moves_the_step():
    _, tr = TP.solve_lp_pdhg(_tlp(_mk_sparse(7)), tol=1e-9, max_iter=2000, trace=True,
                             linesearch=True)
    steps = tr.step_primal[torch.isfinite(tr.step_primal)]
    assert steps.numel() >= 2 and torch.unique(steps).numel() >= 2


def test_warm_starts_match_the_cold_start():
    lp = _tlp(_mk_sparse(6))
    kw = dict(tol=1e-9, max_iter=60_000, **CTL)
    cold = TP.solve_lp_pdhg(lp, **kw)
    warm = TP.solve_lp_pdhg(lp, warm_start=(cold.x, cold.y), **kw)
    assert bool(warm.converged)
    assert int(warm.iterations) < int(cold.iterations)
    assert float(warm.obj) == pytest.approx(float(cold.obj), rel=1e-8)
    bad = cold.x.clone()
    bad[3] = float("nan")
    _assert_bitwise(cold, TP.solve_lp_pdhg(lp, warm_start=(bad, cold.y), **kw))


@pytest.mark.parametrize("shared_vals", [True, False])
def test_batch_matches_lanes_one_by_one(shared_vals):
    fields = _mk_batch((0, 1, 2))
    if shared_vals:
        fields[2] = fields[2][0]
    warm = (np.full((3, 24), 1.0), np.zeros((3, 12)))
    warm[0][1] = np.inf  # lane 1 starts cold
    kw = dict(tol=1e-9, max_iter=1600, **CTL)
    batch = TP.solve_lp_pdhg(_tlp(fields), warm_start=warm, **kw)
    assert batch.x.shape == (3, 24) and batch.iterations.shape == (3,)
    for i in range(3):
        lane = list(fields)
        for k in (3, 4, 7) if shared_vals else (2, 3, 4, 7):
            lane[k] = fields[k][i]
        one = TP.solve_lp_pdhg(_tlp(lane), warm_start=(warm[0][i], warm[1][i]), **kw)
        _assert_bitwise(one, type(batch)(*(a[i] for a in batch)))


def test_pattern_tables_cover_every_entry():
    rows, cols = _mk_sparse(3)[:2]
    rng = np.random.default_rng(0)
    # a dense column of 40 entries (its own bucket) beside the light ones
    rows = np.concatenate([rows, np.arange(40)]).astype(np.int32)
    cols = np.concatenate([cols, np.full(40, 24)]).astype(np.int32)
    vals = torch.as_tensor(rng.normal(size=rows.shape[0]))[None]
    pat = TP._Pattern(rows, cols, 40, 25, "cpu")
    assert len(pat.c_ent) == 2 and pat.c_ent[1].shape == (1, 64)
    A = np.zeros((40, 25))
    np.add.at(A, (rows, cols), vals[0].numpy())
    x, y = torch.as_tensor(rng.normal(size=(2, 25))), torch.as_tensor(rng.normal(size=(2, 40)))
    op = TP._Op(pat, vals)
    np.testing.assert_allclose(op.mv(x).numpy(), x.numpy() @ A.T, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op.rmv(y).numpy(), y.numpy() @ A, rtol=1e-13, atol=1e-13)
    # the same lane gives the same bits in any batch
    assert torch.equal(op.rmv(y)[1], op.rmv(y[1:])[0])


# ---------------------------------------------------------------------
# 4. solve_lp_pdhg_adaptive
# ---------------------------------------------------------------------
def test_pdhg_adaptive_matches_the_one_shot_batch():
    lp = _tlp(_mk_batch((0, 1, 2, 3)))
    kw = dict(tol=1e-8, max_iter=20_000, **CTL)
    one, tr_one = TP.solve_lp_pdhg(lp, trace=True, **kw)
    stats = {}
    got, tr = TA.solve_lp_pdhg_adaptive(lp, chunk_iters=300, ladder_base=2, trace=True,
                                        stats=stats, **kw)
    _assert_bitwise(one, got)  # bitwise through compaction: fixed-order products
    _assert_bitwise(tr_one, tr)
    assert stats["chunk_iters"] == 400 and stats["adaptive_entry"] == "solve_lp_pdhg"
    assert stats["buckets"][0] == 4 and stats["buckets"][-1] < 4
    assert bool(got.converged.all())


def test_pdhg_adaptive_conformance_is_neutral():
    lp = _tlp(_mk_batch((4, 5, 6)))
    kw = dict(tol=1e-8, max_iter=20_000, chunk_iters=1000, ladder_base=2, **CTL)
    stats = {}
    on = TA.solve_lp_pdhg_adaptive(lp, conformance=True, stats=stats, **kw)
    _assert_bitwise(TA.solve_lp_pdhg_adaptive(lp, **kw), on)
    conf = stats["conformance"]
    assert conf["entry"] == "solve_lp_pdhg" and conf["ok"] and len(conf["lanes"]) == 3
    for i, ln in enumerate(conf["lanes"]):
        assert ln["res_primal"] == float(on.res_primal[i])
        assert ln["res_dual"] == float(on.res_dual[i])
    # one LP: the plain solve, certified
    one = SparseLP(*(a[0] if k in (2, 3, 4, 7) else a for k, a in enumerate(lp)))
    stats = {}
    got = TA.solve_lp_pdhg_adaptive(one, conformance=True, stats=stats, **kw)
    _assert_bitwise(TP.solve_lp_pdhg(one, tol=1e-8, max_iter=20_000, **CTL), got)
    assert stats["conformance"]["lanes"][0]["ok"]


def test_pdhg_adaptive_refusals():
    lp = _tlp(_mk_batch((0, 1)))
    # the performance probe is taken: every chunk measured, the answer
    # bitwise the one without it
    from dispatches_tpu_torch.obs.perf import PerfProbe

    kw = dict(tol=1e-6, max_iter=600, chunk_iters=200)
    probe = PerfProbe()
    _assert_bitwise(TA.solve_lp_pdhg_adaptive(lp, **kw),
                    TA.solve_lp_pdhg_adaptive(lp, perf=probe, **kw))
    assert probe.chunks >= 1
    assert all(sum(r["phases"].values()) == r["wall_s"] for r in probe.records)
    bad = lp._replace(rows=lp.rows.expand(2, -1))
    with pytest.raises(ValueError, match="shared sparsity pattern"):
        TA.solve_lp_pdhg_adaptive(bad)


@pytest.mark.parametrize("opt", ["lanes", "lane_policy", "warm_predictor", "lane_model"])
def test_pdhg_adaptive_live_options(opt):
    """The options the refusal test used to name, live on the PDHG entry:
    the observatory, a static policy and a rejected (NaN) learned seed leave
    the lanes bitwise as they are; advice and a lane model re-lane an
    unbatched solve onto the dense IPM."""
    from dispatches_tpu_torch import learn as TL
    from dispatches_tpu_torch.obs.lanes import as_lanes

    kw = dict(tol=1e-6, max_iter=4000)
    lp = _tlp(_mk_batch((0, 1)))
    one = SparseLP(*(a[0] if k in (2, 3, 4, 7) else a for k, a in enumerate(lp)))
    cold = TA.solve_lp_pdhg_adaptive(lp, **kw)
    if opt == "lanes":
        obs = as_lanes({"probe_fraction": 0.0})
        _assert_bitwise(cold, TA.solve_lp_pdhg_adaptive(lp, lanes=obs, **kw))
        assert obs.report()["decisions"] == 2
    elif opt == "lane_policy":
        obs = as_lanes(True)
        _assert_bitwise(cold, TA.solve_lp_pdhg_adaptive(lp, lanes=obs, lane_policy="advice", **kw))
        obs.force_advice(TL.family_fingerprint(one), "dense")
        stats = {}
        sol = TA.solve_lp_pdhg_adaptive(one, lanes=obs, lane_policy="advice", stats=stats, **kw)
        assert stats["relaned"] == "dense" and bool(sol.converged)
        assert abs(float(sol.obj) - float(cold.obj[0])) < 1e-4 * max(1.0, abs(float(sol.obj)))
    elif opt == "warm_predictor":
        fam = TL.family_fingerprint(one)
        n, m = one.c.shape[-1], one.b.shape[-1]
        X = np.stack([TL.features_of(SparseLP(*(a[k] if k2 in (2, 3, 4, 7) else a
                                                 for k2, a in enumerate(lp))))
                      for k in range(2)])
        ds = TL.WarmStartDataset(X, np.zeros((2, n + m)), family=fam, varying=("b", "c"),
                                 targets=[("x", n), ("y", m)], problem_type="SparseLP")
        model, _ = TL.train_warmstart_model(ds, hidden=(4,), epochs=2, device="cpu",
                                            holdout_frac=0.0)
        model.predict_parts = lambda X: {p: np.full((X.shape[0], d), np.nan)
                                         for p, d in model.targets}
        _assert_bitwise(cold, TA.solve_lp_pdhg_adaptive(lp, warm_predictor=model, **kw))
    else:
        X = np.stack([TL.features_of(one)] * 4)
        Y = np.c_[np.full(4, 0.01), np.full(4, 1.0), np.full(4, 9.0), np.full(4, 900.0),
                  np.ones(4)]
        ds = TL.WarmStartDataset(X, Y, family=TL.family_fingerprint(one), varying=("b", "c"),
                                 targets=[("wall_dense", 1), ("wall_pdhg", 1), ("iters_dense", 1),
                                          ("iters_pdhg", 1), ("chosen", 1)],
                                 problem_type="SparseLP")
        model, _ = TL.train_laneroute_model(ds, hidden=(4,), epochs=20, device="cpu")
        stats = {}
        sol = TA.solve_lp_pdhg_adaptive(one, lane_policy="model",
                                        lane_model=TL.LaneRouter([model]), stats=stats, **kw)
        assert stats["relaned"] == "dense" and bool(sol.converged)


# ---------------------------------------------------------------------
# 5. the lane switch, both ways
# ---------------------------------------------------------------------
def _random_dense(seed, m=12, n=24, density=0.35):
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n)) * (r.random((m, n)) < density)
    A[np.arange(m), r.integers(0, n, m)] += 1.0
    x0 = r.uniform(0.5, 2.5, n)
    return (A, A @ x0, r.normal(size=n), np.zeros(n), np.full(n, 4.0), 0.0)


def _dense_batch(seeds):
    fields = [np.asarray(f, np.float64) for f in zip(*(_random_dense(s) for s in seeds))]
    return LPData(*(torch.as_tensor(f) for f in fields))


def test_default_policy_recovers_a_dense_lane_at_the_lane_switch():
    """IPM iterations (6, 9, 6) on these LPs: capped at 6, the middle lane
    stalls through cold and regularize and recovers through PDHG."""
    lp = _dense_batch((12, 19, 15))
    assert solve_lp_batch(lp, tol=1e-8, max_iter=60).iterations.tolist() == [6, 9, 6]
    kw = dict(tol=1e-8, max_iter=6)
    stats = {}
    got = TA.solve_lp_adaptive(lp, stats=stats, remedy=True, **kw)
    off = TA.solve_lp_adaptive(lp, **kw)
    assert list(stats["remediated"]) == [1]
    assert stats["remediated"][1]["rung"] == "lane_switch"
    assert stats["remediated"][1]["attempts"] == 3
    assert bool(got.converged.all()) and not bool(off.converged[1])
    for a, b in zip(off, got):  # the healthy lanes untouched
        assert _same(a[0], b[0]) and _same(a[2], b[2])
    ref = solve_lp_batch(lp, tol=1e-8, max_iter=60)
    assert float(got.obj[1]) == pytest.approx(float(ref.obj[1]), rel=1e-5)


def test_sparse_engine_switches_to_the_ipm():
    lp = _tlp(_mk_sparse(6))
    stuck = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=200)
    v = health.classify_solution(stuck, budget=200)[0]
    assert v.verdict == "stalled"
    eng = TR.RemedyEngine(solver_kw=dict(tol=1e-9, max_iter=200), entry="solve_lp_pdhg")
    out = eng.remediate(lp, v)
    assert out.rung == "lane_switch" and [h[0] for h in out.history] == list(TR.RUNGS)
    assert out.history[1] == ("regularize", "no_reg_knob")
    assert out.history[2] == ("float64", "already_f64")
    assert isinstance(out.solution, TP.PDHGSolution) and bool(out.solution.converged)
    cold = TP.solve_lp_pdhg(lp, tol=1e-9, max_iter=60_000, **CTL)
    assert float(out.solution.obj) == pytest.approx(float(cold.obj), rel=1e-7)


def test_lane_switch_mappings_match_jax():
    lp = LPData(*(torch.as_tensor(np.asarray(f, np.float64)) for f in _random_dense(3)))
    lp = lp._replace(u=torch.where(torch.arange(24) % 5 == 0, torch.inf, lp.u))
    jlp = [np.asarray(a) for a in lp]
    slp = TR.dense_to_sparse(lp)
    jslp = JR.dense_to_sparse(SimpleNamespace(**dict(zip(LPData._fields, jlp))))
    for a, b in zip(jslp, slp):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert slp.rows.dtype == torch.int32
    back = TR.sparse_to_dense(slp)
    assert torch.equal(back.A, lp.A)
    psol = TP.solve_lp_pdhg(slp, tol=1e-8, **CTL)
    jp = JPDHGSolution(*(np.asarray(a) for a in psol))
    want = JR._ipm_row_from_pdhg(jp, SimpleNamespace(**dict(zip(LPData._fields, jlp))))
    got = TR._ipm_row_from_pdhg(psol, lp)
    assert isinstance(got, type(solve_lp_batch(lp)))
    for name, a, b in zip(JIPMSolution._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-13,
                                   err_msg=name)
    isol = solve_lp_batch(lp, tol=1e-9)
    row = TR._pdhg_row_from_ipm(isol, slp)
    jrow = JR._pdhg_row_from_ipm(JIPMSolution(*(np.asarray(a) for a in isol)),
                                 SimpleNamespace(b=jlp[1]))
    for name, a, b in zip(JPDHGSolution._fields, jrow, row):
        assert np.array_equal(np.asarray(a), b.numpy()), name


# ---------------------------------------------------------------------
# 6. health, telemetry
# ---------------------------------------------------------------------
def test_health_and_batch_stats_of_a_pdhg_solution():
    lp = _tlp(_mk_batch((0, 1, 2)))
    sol = TP.solve_lp_pdhg(lp, tol=1e-8, max_iter=1400, **CTL)
    assert sol.converged.tolist() != [True] * 3  # some lanes out of budget
    jsol = JPDHGSolution(*(np.asarray(a) for a in sol))
    for budget in (100_000, 1400):
        want = [tuple(v) for v in j_health.classify_solution(jsol, budget=budget)]
        got = [tuple(v) for v in health.classify_solution(sol, budget=budget)]
        assert got == want
    assert batch_stats(sol) == j_batch_stats(jsol)
    assert batch_stats(sol)["restarts"]["total"] == int(sol.restarts.sum())
