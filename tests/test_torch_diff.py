"""Port parity: design gradients through the LP solves
(`dispatches_tpu_torch/solvers/diff.py`, `structured.optimal_value_banded`)
against the JAX package's `jax.grad` / `jax.vmap` of the same functions,
on the same inputs, in f64 on the CPU.

Each JAX computation is jitted whole (one compile instead of one per
eager op, several times cheaper here) and finished
(`jax.block_until_ready`) before the torch side starts; the JAX results
the tests share are module fixtures.
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
    build_pricetaker_design as j_build_design,
)
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.solvers import diff as JD
from dispatches_tpu.solvers import structured as JS
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
    build_pricetaker_design,
)
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.solvers import diff as TD
from dispatches_tpu_torch.solvers import structured as TS
from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

DATA = JP.load_rts303()
T = 48
DESIGN = dict(with_battery=True, with_pem=True, h2_price_per_kg=2.5, initial_soc_fixed=None)
BASE = {
    "lmp": DATA["da_lmp"][:T], "wind_cf": DATA["da_wind_cf"][:T],
    "batt_kw": 5000.0, "pem_kw": 100000.0, "h2_price": 2.5,
}
SIZES = ("batt_kw", "pem_kw", "h2_price")
KW = dict(tol=1e-9, max_iter=60)
BANDED_KW = dict(tol=1e-10, max_iter=80)
# the base week, then four LMP scenarios as in the JAX package's batched test
LMP_SCALES = np.concatenate([[1.0], np.random.default_rng(3).uniform(0.8, 1.2, 4)])[:, None]
BANDED_SCALES = np.array([1.0, 0.9, 1.2])


def _t(params, grad=()):
    """Port parameters as f64 tensors, those named in `grad` requiring grad."""
    return {k: torch.tensor(np.asarray(v, np.float64), requires_grad=k in grad)
            for k, v in params.items()}


# ---------------------------------------------------------------- dense
@pytest.fixture(scope="module")
def design():
    jprog, _ = j_build_design(JHybridDesign(T=T, **DESIGN))
    tprog, _ = build_pricetaker_design(HybridDesign(T=T, **DESIGN))
    return jprog, tprog


@pytest.fixture(scope="module")
def jax_envelope(design):
    """JAX value and gradients of the weekly NPV in the three design
    parameters and the LMPs, over LMP_SCALES in one vmap(value_and_grad):
    lane 0 is the base week, lanes 1-4 the scenarios of the batched test
    (a finished lane of JAX's vmapped while_loop is frozen, so each lane
    is its unbatched solve)."""
    jprog, _ = design

    def npv(batt, pem, h2p, lmp):
        p = dict(BASE, batt_kw=batt, pem_kw=pem, h2_price=h2p, lmp=lmp)
        return JD.optimal_value(jprog, p, **KW) * 1e5

    args = [jnp.asarray(BASE[k]) for k in SIZES] + [jnp.asarray(LMP_SCALES * BASE["lmp"][None])]
    vg = jax.jit(jax.vmap(jax.value_and_grad(npv, argnums=(0, 1, 2, 3)),
                          in_axes=(None, None, None, 0)))(*args)
    v, g = jax.block_until_ready(vg)
    return np.asarray(v), [np.asarray(a) for a in g]


def _port_npv(tprog, p):
    return TD.optimal_value(tprog, p, device="cpu", **KW) * 1e5


def test_solve_lp_diff_small_lp_matches_jax_and_differences():
    """The raw autograd.Function on a hand-built LP (M=5, N=9): gradients
    in A, b and c against `jax.grad` of the custom VJP (rel 1e-6) and
    against central differences of re-solves (rel 5e-4, abs 1e-6, the JAX
    package's own test tolerances)."""
    rng = np.random.default_rng(0)
    M, N = 5, 9
    A = rng.normal(size=(M, N))
    b = A @ rng.uniform(0.5, 1.5, N)
    c = rng.uniform(0.5, 2.0, N)
    l, u = np.zeros(N), np.full(N, 3.0)

    def jval(A_, b_, c_):
        lp = JLPData(A_, b_, c_, jnp.asarray(l), jnp.asarray(u), jnp.asarray(0.0))
        return JD.solve_lp_diff(lp, 1e-10, 60).obj

    want = jax.block_until_ready(
        jax.jit(jax.grad(jval, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (A, b, c)))
    )

    def tval(A_, b_, c_):
        lp = LPData(A_, b_, c_, torch.tensor(l), torch.tensor(u), torch.tensor(0.0, dtype=torch.float64))
        return TD.solve_lp_diff(lp, 1e-10, 60).obj

    args = [torch.tensor(a, requires_grad=True) for a in (A, b, c)]
    got = torch.autograd.grad(tval(*args), args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-12)
    h = 1e-6
    for k, idx in ((0, (1, 0)), (0, (3, 7)), (1, (2,)), (2, (4,))):
        ap = [a.copy() for a in (A, b, c)]
        am = [a.copy() for a in (A, b, c)]
        ap[k][idx] += h
        am[k][idx] -= h
        fd = (float(tval(*map(torch.tensor, ap))) - float(tval(*map(torch.tensor, am)))) / (2 * h)
        assert float(got[k][idx]) == pytest.approx(fd, rel=5e-4, abs=1e-6), (k, idx)


def test_solve_lp_diff_shared_A_sums_lane_gradients():
    """Three lanes with their own b and a shared A (M=5, N=9), with
    cotangents on obj and x: the gradient in the shared A is the sum of
    the lanes' unbatched gradients, and each lane's b gradient is its
    unbatched one (rel 1e-9)."""
    rng = np.random.default_rng(1)
    M, N = 5, 9
    A = rng.normal(size=(M, N))
    bs = np.stack([A @ rng.uniform(0.5, 1.5, N) for _ in range(3)])
    c = rng.uniform(0.5, 2.0, N)
    l, u = torch.zeros(N, dtype=torch.float64), torch.full((N,), 3.0, dtype=torch.float64)

    def grads(b_):
        A_ = torch.tensor(A, requires_grad=True)
        b_ = torch.tensor(b_, requires_grad=True)
        lp = LPData(A_, b_, torch.tensor(c), l, u, torch.tensor(0.0, dtype=torch.float64))
        sol = TD.solve_lp_diff(lp, 1e-10, 60)
        return torch.autograd.grad((sol.obj + sol.x.sum(-1)).sum(), (A_, b_))

    gA, gb = grads(bs)
    assert gA.shape == (M, N) and gb.shape == bs.shape
    lane = [grads(b_) for b_ in bs]
    np.testing.assert_allclose(gA.numpy(), sum(g[0] for g in lane).numpy(), rtol=1e-9, atol=1e-12)
    for i, g in enumerate(lane):
        np.testing.assert_allclose(gb[i].numpy(), g[1].numpy(), rtol=1e-9, atol=1e-12)


def test_envelope_design_gradients_match_jax(design, jax_envelope):
    """Weekly design (T=48): value and gradients in batt_kw, pem_kw and
    h2_price against JAX's (value rel 1e-8, gradients rel 1e-4)."""
    _, tprog = design
    jv, jg = jax_envelope
    p = _t(BASE, grad=SIZES)
    v = _port_npv(tprog, p)
    g = torch.autograd.grad(v, [p[k] for k in SIZES])
    assert v.item() == pytest.approx(jv[0], rel=1e-8)
    for name, gi, wi in zip(SIZES, g, jg):
        assert float(gi) == pytest.approx(wi[0], rel=1e-4), name


def test_lmp_gradient_is_scaled_dispatch(design, jax_envelope):
    """Envelope: dNPV/dlmp[t] = PA * (52/weeks) * 1e-3 * elec_sales[t], the
    scaled optimal sales profile (rtol 1e-4, atol 1e-2, as the JAX
    package's test), and JAX's LMP gradient (same tolerances)."""
    from dispatches_tpu_torch.case_studies.renewables import params as P

    _, tprog = design
    p = _t(BASE, grad=("lmp",))
    g, = torch.autograd.grad(_port_npv(tprog, p), p["lmp"])
    with torch.no_grad():
        sol = TD.optimal_solution(tprog, _t(BASE), device="cpu", **KW)
    sales = tprog.extract("splitter.grid_elec", sol.x) + tprog.extract("battery.elec_out", sol.x)
    expected = P.PA * (52.0 / (T / 168.0)) * 1e-3 * sales.numpy()
    np.testing.assert_allclose(g.numpy(), expected, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(g.numpy(), jax_envelope[1][3][0], rtol=1e-4, atol=1e-2)


def test_adjoint_path_matches_envelope_and_jax(design, jax_envelope):
    """Implicit-function path: the gradient of eval_expr('NPV', x*(h2_price))
    through the adjoint-KKT backward agrees with the envelope gradient
    (rel 1e-3, the JAX package's test) and with JAX's adjoint gradient
    (rel 1e-4)."""
    jprog, tprog = design

    def j_via_solution(h2p):
        p = dict(BASE, h2_price=h2p)
        return jprog.eval_expr("NPV", JD.optimal_solution(jprog, p, **KW).x, p)

    want = float(jax.block_until_ready(jax.jit(jax.grad(j_via_solution))(jnp.asarray(2.5))))
    p = _t(BASE, grad=("h2_price",))
    sol = TD.optimal_solution(tprog, p, device="cpu", **KW)
    g_sol, = torch.autograd.grad(tprog.eval_expr("NPV", sol.x, p), p["h2_price"])
    assert float(g_sol) == pytest.approx(jax_envelope[1][2][0], rel=1e-3)
    assert float(g_sol) == pytest.approx(want, rel=1e-4)


def test_batched_lmp_scenarios_give_per_lane_gradients(design, jax_envelope):
    """Four LMP scenarios in one batched call: each lane's design
    gradients against JAX's vmap(grad) (rel 1e-4) and lane 0 against the
    port's unbatched call (rel 1e-6)."""
    _, tprog = design
    lmps = LMP_SCALES[1:] * BASE["lmp"][None]
    per_lane = {k: np.full(4, BASE[k]) for k in SIZES}  # one gradient per lane
    p = _t(dict(BASE, lmp=lmps, **per_lane), grad=SIZES)
    v = _port_npv(tprog, p)
    assert v.shape == (4,)
    g = torch.autograd.grad(v.sum(), [p[k] for k in SIZES])
    for name, gi, wi in zip(SIZES, g, jax_envelope[1]):
        np.testing.assert_allclose(gi.numpy(), wi[1:], rtol=1e-4, err_msg=name)
    p0 = _t(dict(BASE, lmp=lmps[0]), grad=SIZES)
    g0 = torch.autograd.grad(_port_npv(tprog, p0), [p0[k] for k in SIZES])
    for name, gi, g0i in zip(SIZES, g, g0):
        assert float(gi[0]) == pytest.approx(float(g0i), rel=1e-6), name


def test_unsupported_cotangents_raise_and_value_path_skips_the_adjoint(design, monkeypatch):
    """A cotangent on zl/zu raises; the obj-only backward never calls
    torch.linalg.cholesky (patched only after the forward), while an x
    cotangent does."""
    _, tprog = design
    p = _t(BASE, grad=("h2_price",))
    sol = TD.optimal_solution(tprog, p, device="cpu", **KW)
    for name in ("zl", "zu"):
        with pytest.raises(NotImplementedError, match=name):
            torch.autograd.grad(getattr(sol, name).sum(), p["h2_price"], retain_graph=True)

    def no_cholesky(*a, **k):
        raise AssertionError("the obj-only backward factored the KKT matrix")

    monkeypatch.setattr(torch.linalg, "cholesky", no_cholesky)
    g, = torch.autograd.grad(sol.obj, p["h2_price"], retain_graph=True)
    assert torch.isfinite(g)
    with pytest.raises(AssertionError, match="factored"):
        torch.autograd.grad(sol.x.sum(), p["h2_price"])


# --------------------------------------------------------------- banded
def _banded_case(T_):
    design = dict(DESIGN, design_opt=True)
    jprog, _ = j_build(JHybridDesign(T=T_, **design))
    tprog, _ = build_pricetaker(HybridDesign(T=T_, **design))
    jmeta = JS.extract_time_structure(jprog, T_, block_hours=24)
    tmeta = TS.extract_time_structure(tprog, T_, block_hours=24)
    return jmeta, tmeta, DATA["da_lmp"][:T_], DATA["da_wind_cf"][:T_]


@pytest.fixture(scope="module")
def banded96():
    """JAX's `optimal_value_banded` values and LMP gradients at T=96 over
    BANDED_SCALES, one vmap(value_and_grad); lane 0 is the base week."""
    jmeta, tmeta, lmp, cf = _banded_case(96)
    lmps = BANDED_SCALES[:, None] * lmp[None]
    vg = jax.jit(jax.vmap(jax.value_and_grad(lambda lm: JS.optimal_value_banded(
        jmeta, {"lmp": lm, "wind_cf": jnp.asarray(cf)}, **BANDED_KW))))(jnp.asarray(lmps))
    v, g = jax.block_until_ready(vg)
    return tmeta, lmps, cf, np.asarray(v), np.asarray(g)


def _port_banded(tmeta, lmp, cf, **kw):
    lm = torch.tensor(lmp, requires_grad=True)
    v = TS.optimal_value_banded(tmeta, {"lmp": lm, "wind_cf": cf}, device="cpu", **kw)
    g, = torch.autograd.grad(v.sum(), lm)
    return v.detach().numpy(), g.numpy()


def test_optimal_value_banded_matches_jax(banded96):
    """T=96 (4 day-blocks), all-f64 banded solve of the base week: value
    rel 1e-6, LMP gradient atol 1e-4 (the JAX package's banded-vs-dense
    tolerance)."""
    tmeta, lmps, cf, jv, jg = banded96
    v, g = _port_banded(tmeta, lmps[0], cf, **BANDED_KW)
    assert float(v) == pytest.approx(jv[0], rel=1e-6)
    np.testing.assert_allclose(g, jg[0], atol=1e-4)


def test_optimal_value_banded_year_tier_matches_jax(banded96):
    """The port's year tier at T=96: f64 factorization in 2 SPIKE slabs,
    f32 factors swept by the fused backend (its plain version on the
    CPU), one f64 refinement, tol 1e-8; the solve `return_solution`
    hands back converged. Against JAX's all-f64 tol-1e-10 value: rel 1e-6, as the f64-factor tier's solve test holds it; the
    gradient (the scaled sales profile, entries up to 3.4) atol 2e-3: the
    tol-1e-8 iterate moves it by up to 5e-4 from the tol-1e-10 one."""
    tmeta, lmps, cf, jv, jg = banded96
    kw = year_sweep_solver_kw(torch.float64, Tb=tmeta.Tb)
    assert kw["slabs"] == 2 and kw["sweep_backend"] == "fused"
    lm = torch.tensor(lmps[0], requires_grad=True)
    v, sol = TS.optimal_value_banded(tmeta, {"lmp": lm, "wind_cf": cf}, device="cpu",
                                     return_solution=True, **kw)
    g = torch.autograd.grad(v, lm)[0].numpy()
    assert bool(sol.converged)
    assert float(v) == pytest.approx(jv[0], rel=1e-6)
    np.testing.assert_allclose(g, jg[0], atol=2e-3)


def test_banded_scenario_batch_matches_jax_vmap(banded96):
    """Three LMP scales in one batched call: values (rel 1e-6) and per-lane
    gradients (atol 1e-4) against JAX's vmap(value_and_grad)."""
    tmeta, lmps, cf, jv, jg = banded96
    v, g = _port_banded(tmeta, lmps, cf, **BANDED_KW)
    assert v.shape == (3,) and g.shape == lmps.shape
    np.testing.assert_allclose(v, jv, rtol=1e-6)
    np.testing.assert_allclose(g, jg, atol=1e-4)
    assert v[2] >= v[1] - 1e-6  # higher LMPs cannot make the optimum worse


def test_optimal_value_banded_records_no_solver_iterations():
    """Autograd saves, for one `optimal_value_banded` call, at most twice
    the bytes of one BandedLP: the solve runs on detached tensors, so none
    of its iterations is recorded."""
    _, tmeta, lmp, cf = _banded_case(48)
    blp = tmeta.instantiate({"lmp": lmp, "wind_cf": cf}, device="cpu")
    blp_bytes = sum(a.numel() * a.element_size() for a in blp)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    lm = torch.tensor(lmp, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        v = TS.optimal_value_banded(tmeta, {"lmp": lm, "wind_cf": cf}, device="cpu", **KW)
    assert torch.isfinite(torch.autograd.grad(v, lm)[0]).all()
    assert 0 < sum(saved) <= 2 * blp_bytes, (sum(saved), blp_bytes)

