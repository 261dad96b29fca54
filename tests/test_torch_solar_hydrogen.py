"""Port parity: the PV + battery + PEM + tank + blended-turbine
load-following design (`dispatches_tpu_torch/case_studies/renewables/
solar_hydrogen.py`) against the JAX package's, on the CPU in float64.

At T = 48 (the reference's example-day inputs, `tests/test_solar_hydrogen.py`,
over two days): the lowered LP equals the JAX package's entry for entry,
and the NPV, revenues and sizes of the blend ratios 1.0 and 0.3 agree with
the JAX package's solves (rel 1e-9: the same LP on the same IPM recipe);
all three (1.0, 0.3, 0.0) with HiGHS (rel 1e-4). The physics invariants (load balance,
firm capacity, reserve, no H2 draw in pure-NG mode). Then the banded form:
the cyclic ramp rows make the LP not time-banded beyond two blocks (in both
packages), and `ramp_wrap_border=True` routes them through one border
column with the same optimum (HiGHS on both forms, rel 1e-9). With
``h2_blend_ratio=None`` the blend is a parameter: each lane's optimum is its
fixed-ratio model's (rel 1e-9), and the three blends solve as one banded
batch in 12-h blocks (rel 1e-6 of HiGHS), in f64 and through
`solve_lp_banded_escalated` (the year sweep's mixed precision, then f64
factors).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies.renewables import solar_hydrogen as JS
from dispatches_tpu_torch.case_studies.renewables import solar_hydrogen as TS
from dispatches_tpu_torch.solvers import structured
from dispatches_tpu_torch.solvers.reference import solve_lp_scipy
from dispatches_tpu_torch.solvers.structured import (
    extract_time_structure,
    solve_horizon,
    solve_lp_banded_escalated,
)
from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

T = 48
LP_RTOL = 1e-9
BLENDS = (1.0, 0.3, 0.0)


def _series(T):
    day = np.arange(T) % 24
    pv = np.clip(np.sin(np.pi * (day - 6) / 12), 0.0, None)
    loads = np.ones(T) * 100.0
    reserves = np.ones(T) * 100.0
    lmps = 25.0 + 15.0 * np.sin(np.linspace(0, 4 * np.pi, T))
    ng = np.ones(T) * 3.0
    return pv, loads, reserves, lmps, ng


SERIES = _series(T)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_blend(r):
    res = JS.pv_battery_hydrogen_optimize(T, *SERIES, design=JS.SolarHydrogenDesign(
        T=T, h2_blend_ratio=r))
    jax.block_until_ready(res["solution"].x)
    keys = ("NPV", "annual_revenue", "annual_rev_h2", "pv_kw", "batt_kw", "batt_kwh",
            "pem_kw", "turb_kw")
    return {k: res[k] for k in keys if k in res} | {"converged": res["converged"]}


JAX_BLENDS = (1.0, 0.3)  # the pure-NG LP is held to HiGHS (a JAX compile saved)


@pytest.fixture(scope="module")
def jax_refs():
    with ThreadPoolExecutor(2) as pool:
        futures = {r: pool.submit(_jax_blend, r) for r in JAX_BLENDS}
        return {r: f.result() for r, f in futures.items()}


@pytest.fixture(scope="module")
def port_runs():
    return {r: TS.pv_battery_hydrogen_optimize(
        T, *SERIES, design=TS.SolarHydrogenDesign(T=T, h2_blend_ratio=r), device="cpu")
        for r in BLENDS}


def _params(T):
    return TS.solar_hydrogen_params(T, *_series(T))


@pytest.mark.parametrize("r", BLENDS)
def test_lp_equals_jax(r):
    """The lowered LP, entry for entry (the same model code on both
    sides: any difference is a port fault)."""
    prog, _ = TS.build_pricetaker(TS.SolarHydrogenDesign(T=T, h2_blend_ratio=r))
    jprog, _ = JS.build_pricetaker(JS.SolarHydrogenDesign(T=T, h2_blend_ratio=r))
    p = _params(T)
    lp = prog.instantiate(p, device="cpu")
    jlp = jprog.instantiate({k: jnp.asarray(v) for k, v in p.items()})
    for name, a, b in zip(lp._fields, lp, jlp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("r", BLENDS)
def test_blend_matches_jax_and_highs(jax_refs, port_runs, r):
    res = port_runs[r]
    assert res["converged"]
    if r in jax_refs:
        want = jax_refs[r]
        assert want["converged"]
        for k, v in want.items():
            if k != "converged":
                assert res[k] == pytest.approx(v, rel=LP_RTOL, abs=1e-6), k
    prog = res["program"]
    ref = solve_lp_scipy(prog.instantiate(_params(T), device="cpu"))
    assert res["NPV"] == pytest.approx(-ref.obj_with_offset / 1e-3, rel=1e-4)


def test_physics_invariants(port_runs):
    res = port_runs[1.0]
    prog, x = res["program"], res["solution"].x
    grid = prog.extract("splitter.grid_elec", x).numpy()
    batt_out = prog.extract("battery.elec_out", x).numpy()
    lhs = grid + batt_out + res["turb_elec_kw"] + res["grid_purchase_kw"] - res["grid_sales_kw"]
    np.testing.assert_allclose(lhs, SERIES[1] * 1e3, rtol=1e-4, atol=50.0)
    assert 0.33 * res["batt_kw"] + res["turb_kw"] >= 100e3 * (1 - 1e-4)
    total = (prog.extract("battery_reserve", x) + prog.extract("turbine_reserve", x)
             + float(prog.extract("pv.system_capacity", x)) * torch.as_tensor(SERIES[0])
             - prog.extract("pv.electricity", x) + prog.extract("pem.electricity", x)).numpy()
    req = TS.reserve_over_1hr(SERIES[2] * 1e3)
    assert np.all(total >= req * (1 - 1e-3) - 100.0)
    ng = port_runs[0.0]
    to_turb = ng["program"].extract("h2_tank.outlet_to_turbine", ng["solution"].x).numpy()
    np.testing.assert_allclose(to_turb, 0.0, atol=1e-6)


def test_ramp_wrap_border_makes_the_lp_banded(port_runs):
    prog = port_runs[1.0]["program"]
    with pytest.raises(ValueError, match="non-adjacent"):
        extract_time_structure(prog, T, 12)
    wprog, _ = TS.build_pricetaker(TS.SolarHydrogenDesign(T=T, ramp_wrap_border=True))
    meta = extract_time_structure(wprog, T, 12)
    # 9 scalar design columns and the slacks of the 4 rows on them alone
    # (battery energy/power ratio, firm capacity, existing PV)
    assert (meta.p, int(meta.border_rows.sum())) == (13, 4)
    # the same optimum: HiGHS on both forms
    p = _params(T)
    exact = solve_lp_scipy(prog.instantiate(p, device="cpu")).obj_with_offset
    wexact = solve_lp_scipy(wprog.instantiate(p, device="cpu")).obj_with_offset
    assert wexact == pytest.approx(exact, rel=1e-9)


def test_blend_parameter_lanes_in_one_banded_batch(monkeypatch):
    """`h2_blend_ratio=None`: the blend is a parameter, each lane's optimum
    that of its fixed-ratio model (HiGHS, rel 1e-9), and the three blends
    solve as one banded batch (rel 1e-6 of HiGHS)."""
    gprog, _ = TS.build_pricetaker(TS.SolarHydrogenDesign(T=T, h2_blend_ratio=None,
                                                          ramp_wrap_border=True))
    p = _params(T)
    exact = []
    for r in BLENDS:
        fprog, _ = TS.build_pricetaker(TS.SolarHydrogenDesign(T=T, h2_blend_ratio=r))
        want = solve_lp_scipy(fprog.instantiate(p, device="cpu")).obj_with_offset
        got = solve_lp_scipy(gprog.instantiate(p | {"h2_blend": np.asarray(r)},
                                               device="cpu")).obj_with_offset
        assert got == pytest.approx(want, rel=1e-9), r
        exact.append(want)
    meta = extract_time_structure(gprog, T, 12)
    assert (meta.Tb, meta.p) == (4, 13)
    lanes = {k: np.stack([v] * len(BLENDS)) for k, v in p.items()}
    lanes["h2_blend"] = np.asarray(BLENDS)
    sol = solve_horizon(gprog, lanes, T, block_hours=12, device="cpu")
    assert bool(sol.converged.all())
    np.testing.assert_allclose(sol.obj.numpy(), exact, rtol=1e-6)
    # the year sweep's mixed precision for 8 iterations, then f64 factors
    # (the LP converges in fewer than the year's 16)
    monkeypatch.setattr(structured, "ESCALATE_AT_ITER", 8)
    esc = solve_lp_banded_escalated(meta, meta.instantiate(lanes, device="cpu"),
                                    **year_sweep_solver_kw(torch.float64, Tb=meta.Tb))
    assert bool(esc.converged.all()) and bool((esc.iterations > 8).all())
    np.testing.assert_allclose(esc.obj.numpy(), exact, rtol=1e-6)
