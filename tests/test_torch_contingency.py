"""Port parity: the N-1 contingency SCED (`dispatches_tpu_torch/market/
contingency.py`) against the JAX package's, on the CPU in float64.

PTDF / LODF within 1e-12; the K-lane stack (one batched `instantiate`)
against the JAX package's `instantiate` within 1e-12; the batched screen's
per-lane shed and objective within 1e-7 relative; the serving-tier engine
path bitwise the port's own one-shot batches; `secure_dispatch` with the
JAX package's rounds and cuts and no escaped violation; `screener=` refused
until `learn/screener.py` is ported (ROADMAP A6).
"""
import dataclasses

import numpy as np
import pytest
import torch

from dispatches_tpu.market import contingency as JC
from dispatches_tpu.market import network as JN
from dispatches_tpu_torch.market import contingency as C
from dispatches_tpu_torch.market import network as N
from dispatches_tpu_torch.obs import metrics as obs_metrics

KW = dict(max_iter=60)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grid12():
    """A 12-bus ring with chords (16 branches, 10 units): K = 26 outages, of
    which one (branch 0 at hour 0) no dispatch survives."""
    return (JN.synthesize_network(n_buses=12, n_units=10, days=1, seed=0),
            N.synthesize_network(n_buses=12, n_units=10, days=1, seed=0))


def _soften(u, k=0.15):
    """`test_contingency.py`'s must-run floor relief, segment widths rescaled."""
    pmin = k * u.p_min
    scale = (u.p_max - pmin) / max(u.p_max - u.p_min, 1e-9)
    return dataclasses.replace(u, p_min=pmin, seg_mw=np.asarray(u.seg_mw, float) * scale)


def _tight8(net):
    """`test_contingency.py::tight8`: N-1 insecure at the merit-order base
    dispatch, so the constraint-generation loop adds cuts."""
    g = net.synthesize_network(n_buses=8, n_units=6, days=1, seed=0)
    g = dataclasses.replace(g, thermal=[_soften(u) for u in g.thermal],
                            branch_limit=np.asarray(g.branch_limit, float) * 0.75)
    params = (JC if net is JN else C).base_operating_point(g, hour=0)
    rng = np.random.default_rng(7)
    params["load"] = params["load"] * rng.uniform(1.0, 1.1, size=params["load"].shape)
    return g, params


def test_ptdf_lodf_and_contingency_set(grid12):
    gj, gp = grid12
    np.testing.assert_allclose(C.ptdf_matrix(gp), JC.ptdf_matrix(gj), rtol=0, atol=1e-12)
    lj, ij = JC.lodf_matrix(gj)
    lp, ip = C.lodf_matrix(gp)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ip, ij)
    cj, cp = JC.ContingencySet.n_minus_1(gj), C.ContingencySet.n_minus_1(gp)
    assert [(c.kind, c.index, c.label) for c in cp] == [(c.kind, c.index, c.label) for c in cj]
    bj, bp = JC.base_operating_point(gj, 3), C.base_operating_point(gp, 3)
    pj, pp = JC.contingency_params(gj, bj, cj, rate_factor=1.2), C.contingency_params(gp, bp, cp, rate_factor=1.2)
    for k in pj:
        assert pp[k].tobytes() == pj[k].tobytes(), k
    f0 = np.linspace(-50.0, 50.0, len(gp.branch_b))
    idx = np.asarray(cp.branch_indices())
    np.testing.assert_allclose(C.post_contingency_flows(f0, lp, idx),
                               JC.post_contingency_flows(f0, lj, idx), rtol=0, atol=1e-9)
    assert C._cut_for(2, 5, -3.0, lp, 40.0)[1] == JC._cut_for(2, 5, -3.0, lj, 40.0)[1]


def test_screen_matches_jax(grid12):
    """All K = 26 lanes through `solve_lp_adaptive` (one bucket, one chunk, as
    in `test_contingency.py`'s bitwise test): each converged lane's shed
    and objective are JAX's within 1e-7 relative; the port's stack (one
    batched `instantiate`) equals the JAX package's `instantiate` of a
    branch- and a generator-outage lane (A, b, c within 1e-12 of max|.|).

    The outage of branch 0 strands must-run generation (the contingency
    program has no over-generation slack): both packages end that lane
    suspected_primal_infeasible at the same iteration, and HiGHS finds its
    LP infeasible (ROADMAP C, a reference caveat)."""
    gj, gp = grid12
    cj, cp = JC.ContingencySet.n_minus_1(gj), C.ContingencySet.n_minus_1(gp)
    base = C.base_operating_point(gp)
    prog_j, prog_p = JC.contingency_dcopf_program(gj), C.contingency_dcopf_program(gp)
    kw = dict(ladder_base=cp.K, chunk_iters=64, **KW)
    want = JC.screen_contingencies(prog_j, gj, cj, base, **kw)
    got = C.screen_contingencies(prog_p, gp, cp, base, device="cpu", **kw)
    params = C.contingency_params(gp, base, cp)
    stack = C.stack_contingency_lp(prog_p, params, device="cpu")
    assert (cp[0].kind, cp[cp.K - 1].kind) == ("branch", "gen")
    for k in (0, cp.K - 1):
        lane = prog_j.instantiate({n: v[k] for n, v in params.items()})
        for name in ("A", "b", "c", "l", "u", "c0"):
            a, b = np.asarray(getattr(lane, name)), getattr(stack, name)[k].numpy()
            fin = np.isfinite(a)
            np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=name)
            np.testing.assert_allclose(b[fin], a[fin], rtol=0,
                                       atol=1e-12 * max(np.abs(a[fin]).max(initial=0), 1.0))
    from dispatches_tpu_torch.solvers.ipm import STATUS_PRIMAL_INFEASIBLE
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    np.testing.assert_array_equal(got.converged, want.converged)
    stuck = np.nonzero(~got.converged)[0]
    assert [cp[k].label for k in stuck] == ["branch:0"]
    np.testing.assert_array_equal(got.sol.status[stuck].numpy(), np.asarray(want.sol.status)[stuck])
    np.testing.assert_array_equal(got.sol.iterations[stuck].numpy(),
                                  np.asarray(want.sol.iterations)[stuck])
    assert (got.sol.status[stuck] == STATUS_PRIMAL_INFEASIBLE).all()
    with pytest.raises(RuntimeError, match="infeasible"):
        solve_lp_scipy_sparse(prog_p, {n: v[stuck[0]] for n, v in params.items()})
    assert got.stats["buckets"] == [cp.K] and got.stats["chunks"] == 1
    ok = got.converged
    np.testing.assert_allclose(got.objective[ok], want.objective[ok], rtol=1e-7)
    np.testing.assert_allclose(got.shed_mw[ok], want.shed_mw[ok], rtol=1e-7,
                               atol=1e-7 * np.abs(want.shed_mw[ok]).max())
    assert (got.shed_mw > C.ABS_TOL).sum() == (want.shed_mw > JC.ABS_TOL).sum() >= 1
    np.testing.assert_array_equal(got.binding[ok], want.binding[ok])
    np.testing.assert_array_equal(got.critical[ok], want.critical[ok])


def test_engine_screen_bitwise_own_batches(grid12):
    """The serving-tier path: the K lanes admitted to a dense `SlotEngine` of
    8 slots are each bitwise their lane of a one-shot `solve_lp_batch` of 8
    (the last group padded with earlier lanes), the engine's contract, the
    infeasible lane included."""
    from dispatches_tpu_torch.runtime.adaptive import make_dense_engine
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

    _, gp = grid12
    cset = C.ContingencySet.n_minus_1(gp)
    base = C.base_operating_point(gp)
    prog = C.contingency_dcopf_program(gp)
    engine = make_dense_engine(8, device="cpu", **KW)
    got = C.screen_contingencies(prog, gp, cset, base, engine=engine, device="cpu")
    assert got.stats["engine"]
    assert [cset[k].label for k in np.nonzero(~got.converged)[0]] == ["branch:0"]
    lp = C.stack_contingency_lp(prog, C.contingency_params(gp, base, cset), device="cpu")
    K = cset.K
    for g0 in range(0, K, 8):
        idx = [(g0 + i) if g0 + i < K else i for i in range(8)]
        ref = solve_lp_batch(type(lp)(*(leaf[idx] for leaf in lp)), **KW)
        for j, k in enumerate(idx[: min(8, K - g0)]):
            for name in ("x", "y", "obj", "iterations"):
                a = getattr(ref, name)[j].numpy()
                b = getattr(got.sol, name)[g0 + j].numpy()
                assert a.tobytes() == b.tobytes(), (k, name)


def test_secure_dispatch_matches_jax():
    """`test_contingency.py::tight8`: the same rounds and cuts as the JAX
    package's loop (cut coefficients and limits within 1e-9), no escaped
    violation, the same violated outages, passing KKT certificates, the
    base flows and LMPs within 1e-7 of max|.|; the contingency metrics
    count the loop."""
    gj, pj = _tight8(JN)
    gp, pp = _tight8(N)
    cj, cp = JC.ContingencySet.n_minus_1(gj, gens=False), C.ContingencySet.n_minus_1(gp, gens=False)
    want = JC.secure_dispatch(gj, pj, cj, **KW)
    obs_metrics.reset_metrics()
    got = C.secure_dispatch(gp, pp, cp, conformance=True, device="cpu", **KW)
    assert got.rounds == want.rounds >= 2
    assert len(got.cuts) == len(want.cuts) >= 1
    for (cg, rg), (cw, rw) in zip(got.cuts, want.cuts):
        assert cg.keys() == cw.keys()
        assert rg == pytest.approx(rw, rel=1e-9)
        for m in cw:
            assert cg[m] == pytest.approx(cw[m], rel=1e-9, abs=1e-12)
    assert got.feasible and want.feasible and got.escaped_violations == 0
    assert got.violated_outages == want.violated_outages
    assert not got.screened and not got.screen_fallback and got.shrink_ratio == 1.0
    assert got.conformance is not None and got.conformance["ok"]
    np.testing.assert_allclose(got.flows, want.flows, rtol=0, atol=1e-7 * np.abs(want.flows).max())
    np.testing.assert_allclose(got.lmp, want.lmp, rtol=0, atol=1e-7 * np.abs(want.lmp).max())
    vals = obs_metrics.flat_values()
    assert vals["contingency_rounds_total"] == got.rounds
    assert vals["contingency_cuts_total"] == len(got.cuts)
    assert vals["contingency_escaped_violations_total"] == 0


def test_screened_secure_dispatch_as_jax(grid12):
    """`secure_dispatch(screener=)` (refused until the screener was ported):
    the same recording screener's mask gives the JAX package's rounds,
    screened / fallback flags, evaluated set and objective."""
    gj, gp = grid12
    out = []
    for net, g in ((JC, gj), (C, gp)):
        cset = net.ContingencySet.n_minus_1(g, gens=False)
        nb = len(cset.branch_indices())
        mask = np.zeros(nb, bool)
        mask[::3] = True

        class Screen:
            caught = accepts = 0

            def screen(self, problem, cs):
                return mask

            def note_accept(self):
                Screen.accepts += 1

            def note_violation_fallback(self, n=1):
                Screen.caught += n

        kw = dict(KW, device="cpu") if net is C else KW
        sd = net.secure_dispatch(g, net.base_operating_point(g, 3), cset, screener=Screen(), **kw)
        out.append((sd.rounds, sd.screened, sd.screen_fallback, sd.evaluated, sd.feasible,
                    sd.escaped_violations, Screen.accepts, Screen.caught, float(sd.sol.obj)))
    (*jrest, jobj), (*trest, tobj) = out
    assert trest == jrest and trest[1]
    assert abs(tobj - jobj) <= 1e-7 * max(1.0, abs(jobj))
