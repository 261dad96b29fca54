"""Port parity: the fossil case study (`dispatches_tpu_torch/case_studies/
fossil/`) against the JAX package's, on the CPU in float64.

The USC and SCPC cycles: `_cycle_residuals` and its `jacfwd` Jacobian at
the JAX package's start point and at a seeded perturbation of it, rel
1e-10 of each array's scale (one jitted JAX `jvp` per cycle; no JAX
cycle solve, whose compile alone takes about a minute here), and the
port's own solves held to the reference goldens (USC 436.466 MW rel 2e-4,
SCPC 692 +- 1 MW). The SCPC + concrete-TES golden runs on the card only
(`chip_smoke.py --phases plants`): on the CPU the plain tube-side chain
takes minutes for a reference-size hour. Then the dispatch layer: the plant
map, the T = 24 price-taker, the batched tank scenarios, the
superstructure leaves and one `MultiPeriodUsc` tracking step, against the
JAX package's (objectives rel 1e-9: the same LPs on the same IPM recipe).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies import fossil as JF
from dispatches_tpu.case_studies.fossil import scpc_nlp as JS
from dispatches_tpu.case_studies.fossil import usc_nlp as JU
from dispatches_tpu.market.tracker import Tracker as JTracker
from dispatches_tpu_torch.case_studies import fossil as TF
from dispatches_tpu_torch.case_studies.fossil import scpc_nlp as TS
from dispatches_tpu_torch.case_studies.fossil import usc_nlp as TU
from dispatches_tpu_torch.market import Tracker

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _points(mod, n_frac):
    x0 = np.concatenate([mod.INIT_FRACS, [mod.INIT_BFPT], np.linspace(0.2, 1.2, n_frac)])
    rng = np.random.default_rng(7)
    return np.stack([x0, x0 * (1.0 + 0.05 * rng.standard_normal(x0.shape))])


CYCLES = {
    "usc": (JU, TU, _points(JU, 9), {}),
    "scpc": (JS, TS, _points(JS, 7), {"tes_split": 0.1, "h_tes": 1.5e6}),
}


def _jax_cycle(jmod, xs, extra):
    """Residuals and Jacobian of a JAX cycle at each point, from one jitted
    `jvp` called a column at a time (cheaper to trace than `jacfwd`'s
    batched one, and the same columns)."""
    params = {"P_main": jnp.asarray(jmod.MAIN_STEAM_P),
              "flow_mol": jnp.asarray(jmod.MAIN_FLOW_MOL),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    jvp = jax.jit(lambda x, v: jax.jvp(lambda y: jmod._residual_fn(y, params), (x,), (v,)))
    out = []
    for x in xs:
        cols = [jax.block_until_ready(jvp(jnp.asarray(x), e)) for e in jnp.eye(len(x))]
        out.append((np.stack([np.asarray(c[1]) for c in cols], 1), np.asarray(cols[0][0])))
    return out


def _jax_tracking():
    jt = JTracker(JF.MultiPeriodUsc(), tracking_horizon=4, n_tracking_hour=1)
    jt.track_market_dispatch(DISPATCH, 0, 0)
    return np.asarray(jt.get_implemented_profile()), dict(jt.tracking_model_object.state)


DISPATCH = [360.0, 400.0, 436.0, 400.0]  # `tests/test_fossil.py:80-90`


def _threaded(jobs, workers):
    """Run the JAX reference jobs once, in threads: tracing holds the GIL,
    but XLA's compiles do not, so their compiles overlap. Every result is
    in hand before the tests' port calls start."""
    with ThreadPoolExecutor(workers) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def jax_dispatch():
    """The dispatch layer's JAX references."""
    return _threaded({
        "pricetaker": lambda: JF.run_pricetaker_analysis(ndays=1),
        "tank": lambda: JF.run_all_tank_scenarios(ndays=1),
        "charge": lambda: JF.solve_superstructure("charge"),
        "discharge": lambda: JF.solve_superstructure("discharge"),
        "tracking": _jax_tracking,
    }, 3)


@pytest.fixture(scope="module")
def jax_cycles():
    """Both JAX cycles' residuals and Jacobians at both points."""
    return _threaded({name: (lambda c=c: _jax_cycle(c[0], c[2], c[3]))
                      for name, c in CYCLES.items()}, 2)


# The port-only tests come first: they need no JAX reference, so a run
# cut at its time limit counts them before the references are built.
def test_usc_design_solve_golden():
    s = TU.solve_usc_cycle(device="cpu")
    assert float(s.residual) < 1e-8
    assert float(s.power_mw) == pytest.approx(436.466, rel=2e-4)
    np.testing.assert_allclose(s.fracs.numpy(), TU.INIT_FRACS, atol=1.5e-3)


def test_scpc_design_solve_golden():
    s = TS.solve_scpc_cycle(device="cpu")
    assert float(s.residual) < 1e-8
    assert float(s.power_mw) == pytest.approx(692.0, abs=1.0)
    assert 0.42 < float(s.power_mw) / float(s.heat_duty_mw) < 0.48


def test_plant_map_and_salt_loop():
    for p in (283.0, 359.5, 436.0):
        for fn in ("plant_heat_duty_mw", "coal_heat_duty_mw", "cycle_efficiency_pct",
                   "fuel_cost_per_hr", "plant_capital_cost_per_yr", "plant_fixed_om_per_yr",
                   "plant_variable_om_per_yr"):
            want = float(getattr(JF.usc_plant, fn)(p))
            assert float(getattr(TF.usc_plant, fn)(p)) == pytest.approx(want, rel=1e-14)
    assert TF.salt_flow_per_mw() == pytest.approx(JF.salt_flow_per_mw(), rel=1e-14)


def test_pricetaker_day_matches_jax(jax_dispatch):
    want = jax_dispatch["pricetaker"]
    got = TF.run_pricetaker_analysis(ndays=1, device="cpu")
    assert got["converged"] and want["converged"]
    for k in ("profit", "revenue", "operating_cost"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-9)
    np.testing.assert_allclose(got["net_power"], want["net_power"], rtol=0, atol=1e-4)


def test_tank_scenarios_batch_matches_jax(jax_dispatch):
    want = jax_dispatch["tank"]
    got = TF.run_all_tank_scenarios(ndays=1, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k]["converged"] and want[k]["converged"]
        assert float(got[k]["profit"]) == pytest.approx(float(want[k]["profit"]), rel=1e-9)


@pytest.mark.parametrize("mode", ["charge", "discharge"])
def test_superstructure_leaves_match_jax(mode, jax_dispatch):
    want = jax_dispatch[mode]
    got = TF.solve_superstructure(mode, device="cpu")
    assert (got["best"].fluid, got["best"].steam_leg) == (want["best"].fluid, want["best"].steam_leg)
    for g, w in zip(got["leaves"], want["leaves"]):
        assert (g.fluid, g.steam_leg) == (w.fluid, w.steam_leg)
        assert g.hx_area_m2 == pytest.approx(w.hx_area_m2, rel=1e-12)
        assert g.net_annual_value == pytest.approx(w.net_annual_value, rel=1e-9)


def test_multiperiod_usc_tracking_step_matches_jax(jax_dispatch):
    profile, state = jax_dispatch["tracking"]
    mp = TF.MultiPeriodUsc()
    tt = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device="cpu")
    tt.track_market_dispatch(DISPATCH, 0, 0)
    np.testing.assert_allclose(tt.power_output, DISPATCH, atol=0.5)
    np.testing.assert_allclose(tt.get_implemented_profile(), profile, rtol=1e-9)
    for k in ("hot0", "power0"):
        assert mp.state[k] == pytest.approx(state[k], rel=1e-9)
    assert mp.state["power0"] == pytest.approx(float(tt.extract("plant_power")[0]), abs=1e-6)


@pytest.mark.parametrize("point", [0, 1])
@pytest.mark.parametrize("name", sorted(CYCLES))
def test_cycle_residuals_and_jacobian(name, point, jax_cycles):
    jmod, tmod, xs, extra = CYCLES[name]
    J_want, r_want = jax_cycles[name][point]
    params = {"P_main": torch.tensor(jmod.MAIN_STEAM_P, dtype=F64),
              "flow_mol": torch.tensor(jmod.MAIN_FLOW_MOL, dtype=F64),
              **{k: torch.tensor(v, dtype=F64) for k, v in extra.items()}}
    x = torch.tensor(xs[point])
    r = tmod._residual_fn(x, params)  # the train evaluated inside
    params["train"] = tmod._train(params["P_main"])
    J = torch.func.jacfwd(tmod._residual_fn)(x, params)
    np.testing.assert_allclose(r.numpy(), r_want, rtol=0, atol=1e-10 * np.abs(r_want).max())
    np.testing.assert_array_equal(tmod._residual_fn(x, params).numpy(), r.numpy())
    np.testing.assert_allclose(J.numpy(), J_want, rtol=0, atol=1e-10 * np.abs(J_want).max())
