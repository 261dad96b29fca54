"""Port parity: the conformance plane (`dispatches_tpu_torch/obs/
conformance.py`), the histograms and gauges of `obs/metrics.py`, and the
``conformance=`` option of the dense and banded adaptive entry points
against the JAX package, in float64 on the CPU.

The certificates of both packages are computed on the SAME solution
vectors (the port's solves, or seeded random ones) and held to 1e-12
(absolute, or relative where a random point makes them large); the
cases are `tests/test_obs_conformance.py`'s, infinite bounds included. The PDHG entry point's ``conformance=`` is in
`test_torch_pdhg.py`.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.core.program import SparseLP as JSparseLP
from dispatches_tpu.obs import conformance as JC
from dispatches_tpu.obs import metrics as j_metrics
from dispatches_tpu.solvers.structured import BandedLP as JBandedLP
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu_torch.core.program import LPData, SparseLP
from dispatches_tpu_torch.obs import conformance as TC
from dispatches_tpu_torch.obs import metrics
from dispatches_tpu_torch.runtime import adaptive as TA
from dispatches_tpu_torch.solvers import ipm as TI
from dispatches_tpu_torch.solvers import structured as TS

DATA = JP.load_rts303()
CLEAN = {"res_primal": 1e-9, "res_dual": 1e-9, "comp": 1e-9, "gap": 1e-9}
TOL = dict(rtol=1e-12, atol=1e-12)


def _same(a, b):
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_bitwise(ref, got):
    for name, a, b in zip(ref._fields, ref, got):
        assert _same(a, b), f"{type(ref).__name__}.{name} differs"


def _lp(seed, n=8, m=4):
    """tests/test_obs_conformance.py::_lp, as a port LPData."""
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n))
    x0 = r.uniform(0.5, 1.5, size=n)
    return LPData(*(torch.as_tensor(np.asarray(a, np.float64)) for a in (
        A, A @ x0, r.normal(size=n), np.zeros(n), np.full(n, 4.0), 0.0)))


def _stack(lps):
    return type(lps[0])(*(torch.stack([lp[i] for lp in lps]) for i in range(len(lps[0]))))


def _row(sol, i=None, parts=("x", "y", "zl", "zu")):
    return SimpleNamespace(**{k: np.asarray(getattr(sol, k) if i is None
                                            else getattr(sol, k)[i]) for k in parts})


# ---------------------------------------------------------------------
# 1. certificates against the JAX package
# ---------------------------------------------------------------------
def test_dense_certificates_match_jax():
    lp = _lp(3)
    sol = TI.solve_lp(lp, tol=1e-9, max_iter=200)
    got = TC.kkt_certificates(lp, sol)
    want = JC.kkt_certificates(JLPData(*(jnp.asarray(a) for a in lp)), _row(sol))
    assert got.shape == (4,) and np.all(got < 1e-6)
    np.testing.assert_allclose(got, want, **TOL)
    bad = sol._replace(x=sol.x + 0.1)
    fields = dict(zip(TC.FIELDS, (float(v) for v in TC.kkt_certificates(lp, bad))))
    assert fields["res_primal"] > 1e-3
    assert TC.ConformanceChecker().score(fields) == "inaccurate"


def test_dense_batch_matches_lanes_and_jax():
    lps = [_lp(s) for s in (10, 11, 12)]
    batch = _stack(lps)
    sol = TI.solve_lp_batch(batch, tol=1e-9, max_iter=200)
    certs = TC.kkt_certificates(batch, sol, axes=(0,) * 6)
    assert certs.shape == (3, 4)
    jb = JLPData(*(jnp.asarray(a) for a in batch))
    want = JC.kkt_certificates(jb, _row(sol), axes=(0,) * 6)
    np.testing.assert_allclose(certs, want, **TOL)
    for i, lp in enumerate(lps):
        row = SimpleNamespace(x=sol.x[i], y=sol.y[i], zl=sol.zl[i], zu=sol.zu[i])
        np.testing.assert_allclose(certs[i], TC.kkt_certificates(lp, row),
                                   rtol=1e-9, atol=1e-15)
    # a shared A (axes None) against the same A stacked
    shared = batch._replace(A=batch.A[0])
    rows = _stack([lps[0]._replace(b=b) for b in batch.b])
    np.testing.assert_allclose(
        TC.kkt_certificates(shared, sol, axes=(None, 0, 0, 0, 0, 0)),
        TC.kkt_certificates(rows._replace(c=batch.c, c0=batch.c0), sol, axes=(0,) * 6),
        rtol=0, atol=0)


def test_infinite_bounds_stay_finite():
    lp = LPData(*(torch.tensor(v, dtype=torch.float64) for v in (
        [[1.0]], [1.0], [1.0], [0.0], [float("inf")], 0.0)))
    row = SimpleNamespace(**{k: torch.tensor([v], dtype=torch.float64) for k, v in
                             (("x", 1.0), ("y", 1.0), ("zl", 0.0), ("zu", 0.0))})
    got = TC.kkt_certificates(lp, row)
    assert np.all(np.isfinite(got)) and np.all(got < 1e-12)
    want = JC.kkt_certificates(JLPData(*(jnp.asarray(a) for a in lp)), _row(row))
    np.testing.assert_allclose(got, want, **TOL)


def test_pdhg_certificates_match_jax():
    # the trivial optimum, then a random LP with infinite bounds at a
    # random point (the masked products must stay finite)
    triv = SparseLP(torch.tensor([0], dtype=torch.int32), torch.tensor([0], dtype=torch.int32),
                    *(torch.tensor(v, dtype=torch.float64) for v in
                      ([1.0], [1.0], [1.0], [0.0], [2.0], 0.0)))
    row = SimpleNamespace(x=torch.tensor([1.0], dtype=torch.float64),
                          y=torch.tensor([1.0], dtype=torch.float64))
    assert np.all(TC.kkt_certificates(triv, row) < 1e-12)
    r = np.random.default_rng(4)
    A = r.normal(size=(6, 10)) * (r.random((6, 10)) < 0.5)
    A[np.arange(6), np.arange(6)] += 1.0
    rows, cols = np.nonzero(A)
    l = np.where(np.arange(10) % 3 == 0, -np.inf, 0.0)
    u = np.where(np.arange(10) % 4 == 0, np.inf, 3.0)
    fields = [rows.astype(np.int32), cols.astype(np.int32), A[rows, cols],
              r.normal(size=(2, 6)), r.normal(size=(2, 10)), l, u, np.array([0.5, -1.0])]
    slp = SparseLP(*(torch.as_tensor(f) for f in fields))
    sol = SimpleNamespace(x=torch.as_tensor(r.normal(size=(2, 10))),
                          y=torch.as_tensor(r.normal(size=(2, 6))))
    axes = (None, None, None, 0, 0, None, None, 0)
    got = TC.kkt_certificates(slp, sol, axes=axes)
    want = JC.kkt_certificates(JSparseLP(*(jnp.asarray(f) for f in fields)),
                               _row(sol, parts=("x", "y")), axes=axes)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def band():
    """(meta, two-lane BandedLP) of the design LP at T = 48 (2 day-blocks)."""
    prog, _ = build_pricetaker(HybridDesign(T=48, with_battery=True, with_pem=True,
                                            design_opt=True, h2_price_per_kg=2.5,
                                            initial_soc_fixed=None))
    meta = TS.extract_time_structure(prog, 48, block_hours=24)
    lmp = np.array([0.8, 1.4])[:, None] * DATA["da_lmp"][:48][None]
    blp = meta.instantiate({"lmp": lmp, "wind_cf": DATA["da_wind_cf"][:48]}, device="cpu")
    return meta, blp


def test_banded_certificates_match_jax(band):
    meta, blp = band
    r = np.random.default_rng(0)
    N, M = meta.prog.N, meta.Tb * meta.mB
    sol = SimpleNamespace(**{k: torch.as_tensor(r.uniform(0, 2, (2, n))) for k, n in
                             (("x", N), ("y", M), ("zl", N), ("zu", N))})
    axes = tuple(0 if a.dim() == TS._BASE_NDIM[n] + 1 else None
                 for n, a in zip(blp._fields, blp))
    got = TC.kkt_certificates(blp, sol, axes=axes, meta=meta)
    want = JC.kkt_certificates(JBandedLP(*(jnp.asarray(a) for a in blp)), _row(sol),
                               axes=axes, meta=SimpleNamespace(col_pos=meta.col_pos))
    assert got.shape == (2, 4) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="meta"):
        TC.kkt_certificates(blp, sol, axes=axes)


def test_unknown_family_raises():
    with pytest.raises(TypeError, match="no conformance kernel"):
        TC.kkt_certificates(("not", "a", "problem"), None)


# ---------------------------------------------------------------------
# 2. conformance= is neutral on the dense and banded adaptive entries
# ---------------------------------------------------------------------
def test_dense_adaptive_conformance_is_neutral():
    batch = _stack([_lp(s) for s in (10, 11, 12, 13)])
    kw = dict(tol=1e-9, max_iter=60, chunk_iters=4, ladder_base=2)
    stats = {}
    on = TA.solve_lp_adaptive(batch, conformance=True, stats=stats, **kw)
    _assert_bitwise(TA.solve_lp_adaptive(batch, **kw), on)
    conf = stats["conformance"]
    assert conf["entry"] == "solve_lp" and conf["ok"] and len(conf["lanes"]) == 4
    certs = TC.kkt_certificates(batch, on, axes=(0,) * 6)
    for ln, c in zip(conf["lanes"], certs):
        assert [ln[f] for f in TC.FIELDS] == c.tolist()
    # one LP, a policy as a mapping: the plain solve, certified
    stats = {}
    one = TA.solve_lp_adaptive(_lp(3), conformance={"gap": 1e-30}, stats=stats, tol=1e-9)
    _assert_bitwise(TI.solve_lp(_lp(3), tol=1e-9), one)
    assert stats["conformance"]["lanes"][0]["outcome"] == "inaccurate"


def test_banded_adaptive_conformance_is_neutral(band):
    meta, blp = band
    kw = dict(tol=1e-8, chunk_iters=8, ladder_base=1)
    stats = {}
    on = TA.solve_lp_banded_adaptive(meta, blp, conformance=True, stats=stats, **kw)
    _assert_bitwise(TA.solve_lp_banded_adaptive(meta, blp, **kw), on)
    conf = stats["conformance"]
    assert conf["entry"] == "solve_lp_banded" and conf["ok"] and len(conf["lanes"]) == 2
    assert conf["worst"]["res_primal"] < 1e-6 and conf["worst"]["gap"] < 1e-6


# ---------------------------------------------------------------------
# 3. checker, coercions, verdicts, metrics
# ---------------------------------------------------------------------
@pytest.mark.parametrize("fields", [
    CLEAN, dict(CLEAN, gap=1.0), dict(CLEAN, comp=float("nan")), dict(CLEAN, res_dual=None),
    dict(CLEAN, res_primal=5e-2, gap=1e-3), dict(CLEAN, comp=float("inf")),
])
def test_checker_scores_and_verdicts_match_jax(fields):
    pol = {"res_primal": 1e-2, "gap": 1e-6}
    for p in (None, pol):
        want, got = JC.ConformanceChecker(p), TC.ConformanceChecker(p)
        assert got.score(fields) == want.score(fields)
        if fields.get("res_dual") is not None:
            wv, gv = want.verdict(fields), got.verdict(fields)
            assert (gv is None and wv is None) or tuple(gv) == tuple(wv)


def test_note_feeds_metrics_and_report():
    metrics.reset_metrics()
    j_metrics.reset_metrics()
    reports = []
    for mod, reg in ((TC, metrics), (JC, j_metrics)):
        ch = mod.ConformanceChecker()
        ch.seed_metrics("t")
        assert ch.note(CLEAN, entry="t")["ok"]
        bad = ch.note(dict(CLEAN, gap=0.5), entry="t")
        assert not bad["ok"] and bad["outcome"] == "inaccurate"
        reports.append((ch.report(), reg.snapshot()))
    (got, gsnap), (want, wsnap) = reports
    assert got == want
    assert gsnap["counters"] == wsnap["counters"]
    assert gsnap["histograms"] == wsnap["histograms"]
    assert gsnap["histograms"]['solve_residual_gap{entry="t"}']["count"] == 2


def test_coercions_and_escalation_match_jax():
    assert TC.as_policy(None) == TC.ConformancePolicy()
    p = TC.as_policy({"gap": 1e-2})
    assert p.to_dict() == JC.as_policy({"gap": 1e-2}).to_dict() and TC.as_policy(p) is p
    with pytest.raises(TypeError):
        TC.as_policy(42)
    assert TC.as_conformance(None) is None and TC.as_conformance(False) is None
    ch = TC.as_conformance(True, meta="m")
    assert isinstance(ch, TC.ConformanceChecker) and ch.meta == "m"
    assert TC.as_conformance(ch) is ch
    assert TC.as_conformance({"gap": 1.0}).policy.gap == 1.0
    assert TC.FIELDS == JC.FIELDS and TC.RESIDUAL_BUCKETS == JC.RESIDUAL_BUCKETS
    for verdict in ("healthy", "slow", "cycling", "stalled", "nonfinite", "unrecoverable"):
        for conf in (None, {"ok": True}, {"ok": False}):
            assert TC.escalate_verdict(verdict, conf) == JC.escalate_verdict(verdict, conf)
    assert [r.to_dict() for r in TC.default_conformance_rules()] == \
        [r.to_dict() for r in JC.default_conformance_rules()]


def test_gauges_and_histograms_match_jax():
    got, want = metrics.MetricsRegistry(), j_metrics.MetricsRegistry()
    for reg in (got, want):
        reg.set_gauge("g", 3.5, shard="1")
        reg.set_gauge("g", 4.5, shard="1")
        for v in (0.0005, 0.02, 7.0, 1e9):
            reg.observe("wall", v, entry="a")
        reg.observe("res", 1e-7, buckets=(1e-8, 1e-6), entry="a")
        reg.observe("res", 1.0, buckets=(1.0,), entry="a")  # first ladder stays
        reg.inc("n", 2, entry="a")
    assert got.snapshot() == want.snapshot()
    got.reset()
    assert got.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
