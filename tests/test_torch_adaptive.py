"""Port parity: resumable IPM state, warm starts, adaptive lane retirement
and the remedy ladder (`dispatches_tpu_torch/solvers/{ipm,structured}.py`,
`runtime/{adaptive,remedy}.py`, `obs/{health,metrics}.py`) against the JAX
package, in float64 on the CPU, on the same numpy-made inputs.

Sizes are cut for the time the file may take: the dense cases are the
weekly design LP over 24 h, one lane per H2 price; the banded ones the
design LP at T = 120 (5 day-blocks), one lane per LMP scale; the year
tiers' chunked resume two 96-h year LPs; the runner two 24-h scenarios.
Every JAX computation finishes (`jax.block_until_ready`) before the
port's starts, and the port's CPU solves here use two threads.
"""
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
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.obs import health as j_health
from dispatches_tpu.runtime import adaptive as JA
from dispatches_tpu.runtime import remedy as JR
from dispatches_tpu.solvers import ipm as JI
from dispatches_tpu.solvers import structured as JS
from dispatches_tpu.workflow import runners as JW
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.obs import health
from dispatches_tpu_torch.obs import metrics
from dispatches_tpu_torch.runtime import adaptive as TA
from dispatches_tpu_torch.runtime import remedy as TR
from dispatches_tpu_torch.runtime.native import ResultStore
from dispatches_tpu_torch.solvers import ipm as TI
from dispatches_tpu_torch.solvers import structured as TS
from dispatches_tpu_torch.workflow import runners as TW

DATA = JP.load_rts303()
DESIGN = dict(with_battery=True, with_pem=True, design_opt=True, initial_soc_fixed=None)
T_DENSE = 24
H2_PRICES = (1.0, 2.0, 3.0, 4.0)
T_BAND = 120
# LMP scales of the banded lanes. Not 0.6: there the f64 endgame is so
# ill-conditioned that the JAX package's own batched and unbatched solves
# of that lane stop one iteration apart
LMP_SCALES = np.array([0.7, 1.0, 1.2, 1.8])
WARM = ("x", "y", "zl", "zu")


def _same(a, b):
    """Bitwise equality of two tensors, NaN equal to NaN (trace padding)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_bitwise(ref, got):
    for name, a, b in zip(ref._fields, ref, got):
        assert _same(a, b), f"{type(ref).__name__}.{name} differs"


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves here: the suite runs
    in several worker processes at once, and eight threads each only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense():
    """The dense design LPs, one lane per H2 price, as numpy fields."""
    p = {"lmp": DATA["da_lmp"][:T_DENSE], "wind_cf": DATA["da_wind_cf"][:T_DENSE]}
    lanes = []
    for h2 in H2_PRICES:
        prog, _ = build_pricetaker(HybridDesign(T=T_DENSE, h2_price_per_kg=h2, **DESIGN))
        lanes.append([a.numpy() for a in prog.instantiate(p, device="cpu")])
    return [np.stack(f) for f in zip(*lanes)]


def _jlp(fields):
    return JLPData(*(jnp.asarray(a) for a in fields))


def _tlp(fields):
    return LPData(*(torch.as_tensor(a) for a in fields))


@pytest.fixture(scope="module")
def dense_cold(dense):
    return TI.solve_lp_batch(_tlp(dense), trace=True)


@pytest.fixture(scope="module")
def dense_warm(dense_cold):
    """Per-lane seeds from the neighbouring lane's solution; the last lane's
    x mirrored below its lower bounds, a seed the safeguard must reject."""
    sol = dense_cold[0]
    seeds = [getattr(sol, f).numpy()[[1, 0, 3, 2]].copy() for f in WARM]
    seeds[0][-1] = -seeds[0][-1] - 1.0
    return tuple(seeds)


@pytest.fixture(scope="module")
def band():
    """(port meta, port BandedLP, JAX meta, JAX BandedLP) at T_BAND, one
    lane per LMP scale; the JAX data is the port's, carried across."""
    p = {"lmp": LMP_SCALES[:, None] * DATA["da_lmp"][:T_BAND],
         "wind_cf": DATA["da_wind_cf"][:T_BAND]}
    prog, _ = build_pricetaker(HybridDesign(T=T_BAND, h2_price_per_kg=2.5, **DESIGN))
    meta = TS.extract_time_structure(prog, T_BAND, 24)
    blp = meta.instantiate(p, device="cpu")
    jprog, _ = j_build(JHybridDesign(T=T_BAND, h2_price_per_kg=2.5, **DESIGN))
    jmeta = JS.extract_time_structure(jprog, T_BAND, 24)
    jblp = JS.BandedLP(*(jnp.asarray(a.numpy()) for a in blp))
    return meta, blp, jmeta, jblp


@pytest.fixture(scope="module")
def band_warm(band):
    """Per-lane seeds from the neighbouring lane's cold solution."""
    meta, blp = band[:2]
    cold = TS.solve_lp_banded_batch(meta, blp)
    return tuple(getattr(cold, f).numpy()[[1, 0, 3, 2]] for f in WARM)


@pytest.fixture(scope="module")
def band_adaptive(band, band_warm):
    """The JAX package's and the port's warm-started banded adaptive solves
    (ladder_base=2, chunk_iters=4: buckets 4 then 2), with their stats."""
    meta, blp, jmeta, jblp = band
    kw = dict(chunk_iters=4, ladder_base=2)
    jstats, tstats = {}, {}
    want = jax.block_until_ready(JA.solve_lp_banded_adaptive(
        jmeta, jblp, warm_start=tuple(jnp.asarray(w) for w in band_warm),
        stats=jstats, **kw))
    got = TA.solve_lp_banded_adaptive(meta, blp, warm_start=band_warm, stats=tstats, **kw)
    return want, jstats, got, tstats


# ---------------------------------------------------------------------
# 1-2. dense warm starts
# ---------------------------------------------------------------------
def test_warm_safeguard_matches_jax(dense, dense_warm):
    jlp, jw = _jlp(dense), tuple(jnp.asarray(w) for w in dense_warm)
    want_ok = np.asarray(jax.vmap(JI.warm_start_accept)(jlp, jw))
    want_seed, _ = jax.block_until_ready(jax.vmap(JI.apply_warm_safeguard)(jlp, jw))
    tlp = _tlp(dense)
    got_ok = TI.warm_start_accept(tlp, dense_warm)
    got_seed, got_ok2 = TI.apply_warm_safeguard(tlp, dense_warm)
    assert want_ok.tolist() == got_ok.tolist() == got_ok2.tolist() == [True] * 3 + [False]
    for w, g in zip(want_seed, got_seed):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    # one LP gives lane 0 of the batch
    lp0 = LPData(*(a[0] for a in tlp))
    assert bool(TI.warm_start_accept(lp0, tuple(w[0] for w in dense_warm)))


def test_dense_warm_batch_matches_jax(dense, dense_cold, dense_warm):
    want = jax.block_until_ready(JI.solve_lp_batch(
        _jlp(dense), warm_start=tuple(jnp.asarray(w) for w in dense_warm)))
    tlp = _tlp(dense)
    got = TI.solve_lp_batch(tlp, warm_start=dense_warm)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=1e-8)
    # the rejected lane, and a seed of NaNs on every lane, give the cold
    # solve bit for bit
    cold = dense_cold[0]
    for name, a, b in zip(cold._fields, cold, got):
        assert _same(a[3], b[3]), name
    nan = tuple(np.full_like(w, np.nan) for w in dense_warm)
    _assert_bitwise(cold, TI.solve_lp_batch(tlp, warm_start=nan))
    # an unbatched warm solve is its lane of the batch
    one = TI.solve_lp(LPData(*(a[0] for a in tlp)), warm_start=tuple(w[0] for w in dense_warm))
    assert int(one.iterations) == int(got.iterations[0])


# ---------------------------------------------------------------------
# 3. chunked resume is the one-shot solve, bit for bit
# ---------------------------------------------------------------------
def _year_tier_case(factor_dtype):
    """Two 96-h year LPs (4 day-blocks) with the year sweep's options at a
    precision tier: "float64" is the port's (f64 factorization in 2 SPIKE
    slabs, f32 factors through the fused sweep's plain version, f64
    refinement), "float32" the JAX package's."""
    prog, _ = build_pricetaker(HybridDesign(T=96, h2_price_per_kg=2.5, **DESIGN))
    meta = TS.extract_time_structure(prog, 96, 24)
    blp = meta.instantiate({"lmp": np.array([[0.8], [1.6]]) * np.resize(DATA["da_lmp"], 96),
                            "wind_cf": np.resize(DATA["da_wind_cf"], 96)}, device="cpu")
    kw = TW.year_sweep_solver_kw(torch.float64, factor_dtype=factor_dtype, Tb=meta.Tb)
    assert kw["sweep_backend"] == "fused" and kw.get("slabs") == (
        2 if factor_dtype == "float64" else None)
    return meta, blp, kw


@pytest.mark.parametrize("kind", ["dense", "year_tier", "jax_year_tier"])
def test_chunked_resume_is_bitwise(kind, request):
    """Chunks of 3 iterations against the one-shot solve: the dense IPM,
    and the banded one at both precision tiers of the year sweep."""
    if kind == "dense":
        lp = _tlp(request.getfixturevalue("dense"))
        ref, ref_tr = request.getfixturevalue("dense_cold")
        max_iter = 60

        def segment(state, stop):
            return TI.solve_lp_partial(lp, trace=True, state=state, it_stop=stop)
    else:
        meta, blp, kw = _year_tier_case("float64" if kind == "year_tier" else "float32")
        ref, ref_tr = TS.solve_lp_banded_batch(meta, blp, trace=True, **kw)
        max_iter = kw["max_iter"]

        def segment(state, stop):
            sol, _, st = TS.solve_lp_banded_batch(
                meta, blp, trace=True, state=state, it_stop=stop, return_state=True, **kw)
            return sol, st
    state, stop = None, 0
    while state is None or not bool((state.done | (state.it >= max_iter)).all()):
        stop += 3
        sol, state = segment(state, stop)
        # a lane stopped by it_stop is not done
        assert bool(((state.it < stop) | ~state.done | (state.it == ref.iterations)).all())
    _assert_bitwise(ref, sol)
    _assert_bitwise(ref_tr, state.trace)
    assert len(set(ref.iterations.tolist())) > 1 and bool(ref.converged.all())


# ---------------------------------------------------------------------
# 4. dense adaptive
# ---------------------------------------------------------------------
def test_dense_adaptive_matches_jax(dense, dense_cold):
    kw = dict(chunk_iters=4, ladder_base=2)
    jstats, tstats = {}, {}
    want = jax.block_until_ready(JA.solve_lp_adaptive(_jlp(dense), stats=jstats, **kw))
    before = metrics.snapshot()["counters"].get(
        'adaptive_lanes_retired_total{entry="solve_lp"}', 0.0)
    got = TA.solve_lp_adaptive(_tlp(dense), stats=tstats, **kw)
    for name in ("iterations", "converged", "status"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=1e-8)
    for key in ("adaptive_entry", "batch", "chunk_iters", "chunks", "buckets",
                "lanes_retired", "total_iterations"):
        assert tstats[key] == jstats[key], key
    assert tstats["buckets"][-1] < tstats["buckets"][0]  # it compacted
    after = metrics.snapshot()["counters"]['adaptive_lanes_retired_total{entry="solve_lp"}']
    assert after - before == tstats["lanes_retired"]
    # against the port's own one-shot batch: the same iterations, and the
    # same answer (to the last bits where batched LAPACK rounds by batch size)
    cold = dense_cold[0]
    np.testing.assert_array_equal(got.iterations.numpy(), cold.iterations.numpy())
    np.testing.assert_allclose(got.x.numpy(), cold.x.numpy(), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------
# 5-6. banded adaptive and banded warm starts
# ---------------------------------------------------------------------
def test_banded_adaptive_matches_jax(band_adaptive):
    want, jstats, got, tstats = band_adaptive
    for name in ("iterations", "converged", "status"):
        np.testing.assert_array_equal(_np(getattr(got, name)), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=1e-8)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-6)
    for key in ("chunks", "buckets", "lanes_retired", "total_iterations"):
        assert tstats[key] == jstats[key], key
    assert tstats["buckets"] == [4, 4, 4, 4, 2, 2]


def test_banded_warm_batch_matches_jax_and_adaptive(band, band_warm, band_adaptive):
    """The port's warm-started batch against the JAX package's warm-started
    lanes (its adaptive solve, which its own tests hold to its batch), and
    against the port's adaptive solve: bitwise for the lanes harvested
    before the bucket shrank, the rest within the printed difference."""
    meta, blp, jmeta, jblp = band
    want, _, adaptive, tstats = band_adaptive
    got = TS.solve_lp_banded_batch(meta, blp, warm_start=band_warm)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=1e-8)
    full = tstats["buckets"].count(tstats["buckets"][0]) * tstats["chunk_iters"]
    early = got.iterations <= full
    assert 0 < int(early.sum()) < len(early)
    for i in range(len(early)):
        if early[i]:
            for name, a, b in zip(got._fields, got, adaptive):
                assert _same(a[i], b[i]), (i, name)
    late = ~early
    rel = ((adaptive.x[late] - got.x[late]).abs().max() / got.x[late].abs().max()).item()
    print(f"banded lanes after compaction: max |dx| / max |x| = {rel:.3e}")
    assert rel <= 1e-9


# ---------------------------------------------------------------------
# 7. remedy
# ---------------------------------------------------------------------
# An unregularized IPM stalls on this rank-deficient system (a copy of the
# JAX package's tests/test_remedy.py patient)
_SICK_KW = dict(tol=1e-8, max_iter=60, reg_p=0.0, reg_d=0.0)
_SICK = ([[1.0, 1.0], [1.0, 1.0]], [1.0, 1.0], [1.0, 2.0], [0.0, 0.0], [10.0, 10.0], 0.0)
_HEALTHY = ([[1.0, 0.0], [0.0, 1.0]], [1.0, 1.0], [1.0, 1.0], [0.0, 0.0], [10.0, 10.0], 0.0)
_NO_SWITCH = dict(max_attempts=4, allow_lane_switch=False)


def _small(*lps):
    fields = [np.asarray(f, np.float64) for f in zip(*lps)]
    return fields if len(lps) > 1 else [f[0] for f in fields]


def test_remedy_ladder_matches_jax():
    sick = _small(_SICK)
    jsol = jax.block_until_ready(JI.solve_lp(_jlp(sick), **_SICK_KW))
    jv = j_health.classify_solution(jsol, budget=60)[0]
    jout = JR.RemedyEngine(JR.RemedyPolicy(**_NO_SWITCH), solver_kw=_SICK_KW).remediate(_jlp(sick), jv)
    tsol = TI.solve_lp(_tlp(sick), **_SICK_KW)
    tv = health.classify_solution(tsol, budget=60)[0]
    assert tv.verdict == jv.verdict == "stalled"
    assert tv.verdict in TR.REMEDIABLE
    before = metrics.snapshot()["counters"]
    tout = TR.RemedyEngine(TR.RemedyPolicy(**_NO_SWITCH), solver_kw=_SICK_KW).remediate(_tlp(sick), tv)
    assert tout.recovered and tout.rung == jout.rung == "regularize"
    assert tout.history == jout.history and tout.attempts == jout.attempts == 2
    assert tout.verdict.verdict == "healthy"
    np.testing.assert_allclose(tout.solution.x.numpy(), np.asarray(jout.solution.x), atol=1e-8)
    key = 'remediation_recovered_total{rung="regularize",verdict="stalled"}'
    assert metrics.snapshot()["counters"][key] == before.get(key, 0.0) + 1


def test_adaptive_remedy_substitutes_the_sick_row():
    batch = _small(_HEALTHY, _SICK, _HEALTHY)
    jstats, tstats = {}, {}
    want = jax.block_until_ready(JA.solve_lp_adaptive(
        _jlp(batch), stats=jstats, remedy=JR.RemedyPolicy(**_NO_SWITCH), **_SICK_KW))
    got = TA.solve_lp_adaptive(_tlp(batch), stats=tstats,
                               remedy=TR.RemedyPolicy(**_NO_SWITCH), **_SICK_KW)
    assert tstats["remediated"] == jstats["remediated"]
    assert list(tstats["remediated"]) == [1]
    assert [v.verdict for v in health.classify_solution(got, budget=60)] == ["healthy"] * 3
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-8)
    # the healthy lanes are the remedy-off solve's, bit for bit
    off = TA.solve_lp_adaptive(_tlp(batch), **_SICK_KW)
    for a, b in zip(off, got):
        assert _same(a[0], b[0]) and _same(a[2], b[2])


def test_remedy_coercions_and_refusals():
    # the default policy builds for a dense engine: its lane switch re-solves
    # through PDHG (tests/test_torch_pdhg.py), so a batch of two sick lanes
    # recovers at "regularize" with every rung allowed
    assert TR.RemedyEngine().policy == TR.RemedyPolicy()
    assert isinstance(TR.as_remedy(True, entry="solve_lp"), TR.RemedyEngine)
    stats = {}
    TA.solve_lp_adaptive(_tlp(_small(_SICK, _SICK)), remedy=True, stats=stats, **_SICK_KW)
    assert [r["rung"] for r in stats["remediated"].values()] == ["regularize"] * 2
    eng = TR.as_remedy(True, entry="solve_lp_banded")
    assert isinstance(eng, TR.RemedyEngine) and TR.as_remedy(eng) is eng
    assert eng._rung_lane_switch("BandedLP", None, None) == "no_paired_lane"
    assert TR.as_remedy(None) is None
    got = TR.as_remedy({"max_attempts": 2, "allow_lane_switch": False})
    assert got.policy.max_attempts == 2
    assert got._rung_lane_switch("LPData", None, None) == "disabled"
    assert got._rung_float64("LPData", _tlp(_small(_SICK)), None) == "already_f64"
    assert got._rung_regularize("SparseLP", None, None) == "no_reg_knob"


# ---------------------------------------------------------------------
# 8. runner and CLI
# ---------------------------------------------------------------------
def test_year_sweep_flags_match_jax(tmp_path):
    """Two 24-h scenarios in batches of one with warm starts, adaptive
    batching and the remedy ladder, at the JAX package's precision tier:
    the second batch starts from the first's solution in both."""
    kw = dict(scenarios=2, batch=1, hours=24, verbose=False, warm_starts=True,
              adaptive=True, remedy=True)
    want = JW.run_year_sweep(store_path=str(tmp_path / "jax.bin"), **kw)
    got = TW.run_year_sweep(store_path=str(tmp_path / "port.bin"), device="cpu",
                            factor_dtype="float32", **kw)
    assert [g["scenario"] for g in got] == [w["scenario"] for w in want]
    assert [g["warm_started"] for g in got] == [False, True]
    for g, w in zip(got, want):
        assert g["converged"] == w["converged"] is True
        assert g["iterations"] == w["iterations"]
        assert g["NPV"] == pytest.approx(w["NPV"], rel=1e-6)
        assert g["adaptive_stats"]["adaptive_entry"] == "solve_lp_banded"
    # warm starts, adaptive batching and the ladder leave the keys alone
    keys = set(ResultStore(str(tmp_path / "port.bin")).keys())
    assert keys == set(ResultStore(str(tmp_path / "jax.bin")).keys())
    assert len(keys) == 2
    plain = TW.run_year_sweep(scenarios=2, batch=1, hours=24, verbose=False, device="cpu",
                              factor_dtype="float32",
                              store_path=str(tmp_path / "port.bin"))
    assert plain == []  # every scenario is in the store already


def test_cli_refusals_match_jax(tmp_path):
    args = ["yearsweep", "--scenarios", "1", "--batch", "1", "--hours", "48", "--remedy"]
    for main in (JW.main, TW.main):
        with pytest.raises(SystemExit):
            main(args)
    with pytest.raises(ValueError, match="adaptive"):
        TW.run_year_sweep(scenarios=1, batch=1, hours=48, remedy=True, device="cpu")
    # both CLIs take --cost (the port counts executed work, obs.cost) and
    # still refuse --remedy without --adaptive beside it
    for main in (JW.main, TW.main):
        with pytest.raises(SystemExit):
            main(args + ["--cost"])


@pytest.mark.parametrize("opt", ["perf"])
def test_unported_adaptive_options_are_refused(opt, band, band_cold_adaptive):
    """No option is refused any more: with the performance probe on, the
    dense and banded adaptive entries give bitwise the answers without it,
    and every chunk record keeps the exact-sum contract."""
    from dispatches_tpu_torch.obs.perf import PerfProbe

    lp = _tlp(_small(_HEALTHY, _HEALTHY))
    probe = PerfProbe()
    _assert_bitwise(TA.solve_lp_adaptive(lp), TA.solve_lp_adaptive(lp, **{opt: probe}))
    meta, blp = band[:2]
    _assert_bitwise(band_cold_adaptive, TA.solve_lp_banded_adaptive(meta, blp, **{opt: probe}))
    assert probe.chunks >= 2
    for rec in probe.records:
        assert sum(rec["phases"].values()) == rec["wall_s"]
        assert list(rec["phases"])[:2] == ["dispatch", "compute"]


@pytest.fixture(scope="module")
def band_cold_adaptive(band):
    meta, blp = band[:2]
    return TA.solve_lp_banded_adaptive(meta, blp)


def _lane_router(lp, prefer):
    """A lane-route model trained on a few instances of `lp`'s family whose
    pinned walls favour `prefer`."""
    from dispatches_tpu_torch import learn as TL

    rng = np.random.default_rng(0)
    rows = [lp._replace(c=lp.c * float(rng.uniform(0.5, 1.5))) for _ in range(8)]
    X = np.stack([TL.features_of(r) for r in rows])
    fast, slow = np.full(8, 0.01), np.full(8, 1.0)
    walls = (slow, fast) if prefer == "pdhg" else (fast, slow)
    Y = np.c_[walls[0], walls[1], np.full(8, 9.0), np.full(8, 300.0), np.zeros(8)]
    ds = TL.WarmStartDataset(
        X, Y, family=TL.family_fingerprint(lp), varying=("b", "c"),
        targets=[("wall_dense", 1), ("wall_pdhg", 1), ("iters_dense", 1),
                 ("iters_pdhg", 1), ("chosen", 1)], problem_type="LPData")
    model, _ = TL.train_laneroute_model(ds, hidden=(4, 4), epochs=40, device="cpu")
    return TL.LaneRouter([model])


@pytest.mark.parametrize("opt", ["lanes", "lane_policy", "warm_predictor", "lane_model"])
def test_adaptive_live_options(opt, band, band_cold_adaptive):
    """The options the refusals above used to name, live: the observatory
    and the static / advice policies leave the answers bitwise as they are
    (the banded lane never re-lanes), advice and a lane model re-lane an
    unbatched dense solve onto PDHG, and a rejected learned seed is the
    banded cold path bitwise while a trained one converges to the cold
    answer."""
    from dispatches_tpu_torch import learn as TL
    from dispatches_tpu_torch.obs.lanes import as_lanes

    meta, blp = band[:2]
    lp = _tlp(_small(_HEALTHY, _HEALTHY))
    one = _tlp(_small(_HEALTHY))
    if opt == "lanes":
        obs = as_lanes({"probe_fraction": 0.0})
        _assert_bitwise(TA.solve_lp_adaptive(lp), TA.solve_lp_adaptive(lp, lanes=obs))
        _assert_bitwise(band_cold_adaptive, TA.solve_lp_banded_adaptive(meta, blp, lanes=obs))
        assert obs.report()["decisions"] == 2 + blp.c.shape[0]
    elif opt == "lane_policy":
        obs = as_lanes(True)
        obs.force_advice(TL.family_fingerprint(one), "pdhg")
        stats = {}
        sol = TA.solve_lp_adaptive(one, lanes=obs, lane_policy="advice", stats=stats)
        assert stats["relaned"] == "pdhg" and bool(sol.converged)
        assert abs(float(sol.obj) - float(TA.solve_lp_adaptive(one).obj)) < 1e-5
        _assert_bitwise(TA.solve_lp_adaptive(one),
                        TA.solve_lp_adaptive(one, lanes=obs, lane_policy="static"))
        _assert_bitwise(band_cold_adaptive, TA.solve_lp_banded_adaptive(
            meta, blp, lanes=obs, lane_policy="advice"))
        with pytest.raises(ValueError, match="lane_policy"):
            TA.solve_lp_adaptive(one, lane_policy="fastest")
    elif opt == "warm_predictor":
        cold = band_cold_adaptive
        ds = TL.WarmStartDataset(
            np.stack([TL.features_of(TS.BandedLP(*(a[k] if a.dim() > d else a
                                                   for a, d in zip(blp, TS._BASE_NDIM.values()))))
                      for k in range(blp.c.shape[0])]),
            np.concatenate([getattr(cold, f).numpy() for f in WARM], axis=1),
            family=TL.family_fingerprints(blp, TA._batch_axes(TS.BandedLP, TS._BASE_NDIM, blp)[0],
                                          blp.c.shape[0])[0],
            varying=("b", "c"), problem_type="BandedLP",
            targets=[(f, getattr(cold, f).shape[1]) for f in WARM])
        model, _ = TL.train_warmstart_model(ds, hidden=(8, 8), epochs=300, device="cpu",
                                            holdout_frac=0.0)
        warm = TA.solve_lp_banded_adaptive(meta, blp, warm_predictor=model)
        assert bool(warm.converged.all())
        # both ends within the IPM's tolerance of one optimum (5.7e-7 here)
        np.testing.assert_allclose(warm.obj.numpy(), cold.obj.numpy(), rtol=2e-6)
        nan = TL.WarmStartModel(model.surrogate, model.manifest)
        nan.predict_parts = lambda X: {f: np.full((X.shape[0], d), np.nan)
                                       for f, d in model.targets}
        _assert_bitwise(cold, TA.solve_lp_banded_adaptive(meta, blp, warm_predictor=nan))
    else:
        stats = {}
        sol = TA.solve_lp_adaptive(one, lane_policy="model",
                                   lane_model=_lane_router(one, "pdhg"), stats=stats)
        assert stats["relaned"] == "pdhg" and stats["lane_prediction"]["lane"] == "pdhg"
        assert bool(sol.converged)
        stats = {}
        _assert_bitwise(TA.solve_lp_adaptive(one), TA.solve_lp_adaptive(
            one, lane_policy="model", lane_model=_lane_router(one, "dense"), stats=stats))
        assert "relaned" not in stats and stats["lane_prediction"]["lane"] == "dense"


def test_ladder_helpers_match_jax():
    for batch, base in ((16, 4), (16, 16), (5, 2), (8, 2), (1, 8)):
        assert TA.bucket_ladder(batch, base) == JA.bucket_ladder(batch, base)
        ladder = TA.bucket_ladder(batch, base)
        for n in range(1, batch + 1):
            assert TA.next_bucket(n, ladder) == JA.next_bucket(n, ladder)
    with pytest.raises(ValueError):
        TA.bucket_ladder(0)


def test_banded_warm_verdicts_are_the_solvers(band, band_cold_adaptive):
    """`structured.banded_warm_accept` is the banded solver's own safeguard
    verdict: a lane whose seed it rejects (non-finite, or clipped far into
    its box) solves bitwise as the cold lane, one it accepts does not; and
    `WarmStartPredictor.seed_batch(meta=)` counts that verdict."""
    from dispatches_tpu_torch import learn as TL
    from dispatches_tpu_torch.obs import metrics as obs_metrics

    meta, blp = band[:2]
    cold = band_cold_adaptive
    B = blp.c.shape[0]
    seed = [getattr(cold, f).clone() for f in WARM]
    seed[0][0, 0] = float("nan")
    seed[0][1] = -1e12 * (1.0 + seed[0][1].abs())
    ok = TS.banded_warm_accept(meta, blp, tuple(seed))
    assert ok.tolist() == [False, False] + [True] * (B - 2)
    plain = TS.solve_lp_banded_batch(meta, blp)
    warm = TS.solve_lp_banded_batch(meta, blp, warm_start=tuple(seed))
    for k in range(B):
        same = all(_same(a[k], b[k]) for a, b in zip(plain, warm))
        assert same == (not ok[k]), k
    # a predictor that returns the cold answers: every seed accepted
    axes = TA._batch_axes(TS.BandedLP, TS._BASE_NDIM, blp)[0]
    ds = TL.WarmStartDataset(
        np.stack(TL.features_batch(blp, axes, B)),
        np.concatenate([getattr(cold, f).numpy() for f in WARM], axis=1),
        family=TL.family_fingerprints(blp, axes, B)[0], varying=("b", "c"),
        problem_type="BandedLP", targets=[(f, getattr(cold, f).shape[1]) for f in WARM])
    model, _ = TL.train_warmstart_model(ds, hidden=(2,), epochs=1, device="cpu",
                                        holdout_frac=0.0)
    model.predict_parts = lambda X: {f: getattr(cold, f).numpy() for f in WARM}
    pred = TL.WarmStartPredictor(model, device="cpu")
    assert pred.seed_batch(blp, axes, B) == (None, None)  # no meta: no banded seeds
    before = obs_metrics.flat_values()
    seeds, acc = pred.seed_batch(blp, axes, B, entry="test", meta=meta)
    after = obs_metrics.flat_values()
    want = TS.banded_warm_accept(meta, blp, tuple(
        torch.as_tensor(np.stack([s[j] for s in seeds])) for j in range(4)))
    assert acc == want.tolist() == [True] * B
    assert sum(after.get(k, 0.0) - before.get(k, 0.0) for k in after
               if k.startswith("learned_warm_accept_total")) == B
