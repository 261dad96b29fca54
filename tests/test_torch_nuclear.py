"""Port parity: the nuclear case study (`dispatches_tpu_torch/case_studies/
nuclear/`) and `mp/multiperiod.py` against the JAX package's, on the CPU in
float64.

The flowsheet's reference goldens (`tests/test_nuclear.py:26-68`) through
the port, and its turbine chain against the JAX package's (rel 1e-12). The
price-taker LP at T = 48: the DA and two-step DA-RT variants and a 2 x 2
grid of the report's enumeration against the JAX package's solves
(objectives and `eval_expr` reads rel 1e-9: the same LPs on the same IPM
recipe), and the port's banded solve against the JAX package's
`solve_horizon` (rel 1e-7); the grid's pinned lanes banded against the
dense batch (rel 1e-9). The traditional TEA (rel 1e-12), the
surrogate conceptual design (rel 1e-6), and the tracking adapter through
one `Tracker` step, with its results CSV written without pandas.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies import nuclear as JN
from dispatches_tpu.case_studies.nuclear import conceptual_design as JCD
from dispatches_tpu.case_studies.nuclear import tea as JT
from dispatches_tpu.market.tracker import Tracker as JTracker
from dispatches_tpu.solvers.structured import solve_horizon as j_solve_horizon
from dispatches_tpu_torch.case_studies import nuclear as TN
from dispatches_tpu_torch.case_studies.nuclear import conceptual_design as TCD
from dispatches_tpu_torch.case_studies.nuclear import tea as TT
from dispatches_tpu_torch.market import Tracker
from dispatches_tpu_torch.mp.multiperiod import MultiPeriodModel
from dispatches_tpu_torch.solvers.structured import solve_horizon

T = 48
LP_RTOL = 1e-9
BANDED_RTOL = 1e-7
DISPATCH = [480.0, 450.0, 400.0, 500.0]


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lmps(T, seed=0):
    rng = np.random.default_rng(seed)
    da = 20.0 + 15.0 * rng.random(T)
    rt = da + rng.normal(0, 5.0, T)
    return da, np.maximum(rt, 0.0)


DA, RT = _lmps(T)
CFG = dict(T=T, pem_capacity_mw=100.0)


def _analytic():
    def revenue_fn(x):
        return 2.0e8 * (1.0 - 0.8 * x[1])

    def cf_fn(x):
        return 0.98 - 0.5 * x[1]

    return revenue_fn, cf_fn


def _reads(prog, x, p, names=("annualized_npv", "electricity_revenue", "net_power",
                              "np_to_electrolyzer", "tank_holdup")):
    return {k: np.asarray(prog.eval_expr(k, x, p)) for k in names}


def _jax_variant(market):
    prog, sol, p = JN.run_price_taker(JN.NuclearPricetakerConfig(**CFG), DA, RT, 2.0, market)
    jax.block_until_ready(sol.x)
    return float(sol.obj), _reads(prog, sol.x, p), p


def _jax_banded():
    prog, _, p = JN.run_price_taker(JN.NuclearPricetakerConfig(**CFG), DA, RT, 2.0, "DA")
    s = j_solve_horizon(prog, p, T, block_hours=24, tol=1e-10)
    return float(s.obj), bool(s.converged)


def _jax_tracking():
    mp = JN.MultiPeriodNuclear(np_capacity_mw=500.0, pem_capacity_mw=100.0,
                               tank_capacity_kg=5000.0)
    jt = JTracker(mp, tracking_horizon=4, n_tracking_hour=1)
    jt.track_market_dispatch(DISPATCH, 0, 0)
    return np.asarray(jt.power_output), dict(mp.state), list(mp.result_list)


def _jax_design():
    rev, cf = _analytic()
    r = JCD.conceptual_design_ss_NE(rev, cf, h2_price=2.0)
    e = JCD.run_exhaustive_enumeration(rev, cf, h2_prices=(0.75, 1.25, 1.75, 2.25))
    return float(r.pem_np_cap_ratio), float(r.objective), {k: np.asarray(v) for k, v in e.items()}


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference once, in threads (tracing holds the GIL, XLA's
    compiles do not), before the port's calls of the tests that use them."""
    jobs = {
        "DA": lambda: _jax_variant("DA"),
        "DA-RT": lambda: _jax_variant("DA-RT"),
        "enum": lambda: JN.run_exhaustive_enumeration(
            DA, RT, h2_prices=(1.0, 2.0), pem_fracs=(0.1, 0.3), T=T),
        "banded": _jax_banded,
        "tracking": _jax_tracking,
        "design": _jax_design,
    }
    with ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


# The port-only tests come first: a run cut at its time limit counts them
# before the references are built.
@pytest.mark.parametrize("kw,holdup", [
    (dict(include_tank=False, include_turbine=False), None),
    (dict(include_turbine=False, flow_mol_to_pipeline=10.0, flow_mol_to_turbine=0.0),
     1747732.3199 + 36000),
    (dict(flow_mol_to_pipeline=10.0, flow_mol_to_turbine=10.0), 1747732.3199),
])
def test_flowsheet_goldens(kw, holdup):
    """`tests/test_nuclear.py:26-68`'s goldens at that file's tolerances."""
    res = TN.solve_ne_flowsheet(np_capacity_mw=500.0, split_frac_grid=0.6, device="cpu", **kw)
    assert float(res.np_to_grid_kw) == pytest.approx(300e3)
    if holdup is None:
        assert float(res.pem_out_mol) == pytest.approx(505.481, rel=1e-4)
        return
    assert float(res.tank_holdup_mol) == pytest.approx(holdup, rel=1e-4)
    if res.turbine is not None:
        assert float(res.turbine.T_comp_out) == pytest.approx(793.42, rel=2e-2)
        y = (res.turbine.n_out / res.turbine.n_out.sum()).numpy()
        assert y[0] == pytest.approx(0.00088043, abs=5e-4)
        assert y[2] == pytest.approx(0.73278, rel=2e-2)
        assert y[1] == pytest.approx(0.15276, rel=5e-2)


def test_flowsheet_matches_jax_and_differentiates():
    kw = dict(np_capacity_mw=500.0, split_frac_grid=0.6, flow_mol_to_pipeline=10.0,
              flow_mol_to_turbine=10.0)
    jr = JN.solve_ne_flowsheet(**kw)
    jax.block_until_ready(jr.turbine.net_power)
    tr = TN.solve_ne_flowsheet(device="cpu", **kw)
    for name in ("T_comp_out", "T_reactor_out", "T_turb_out", "net_power", "n_out"):
        np.testing.assert_allclose(getattr(tr.turbine, name).numpy(),
                                   np.asarray(getattr(jr.turbine, name)), rtol=1e-12)
    s = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    h = TN.solve_ne_flowsheet(split_frac_grid=s, include_turbine=False, device="cpu")
    (g,) = torch.autograd.grad(h.tank_holdup_mol, s)
    assert float(g) < 0.0  # more grid share -> less PEM -> less holdup


def test_traditional_tea_matches_jax():
    for args in [(0.5, 0.75, 0.75, 1200.0, 2.3), (0.05, 0.75, 2.0, 400.0, 2.3),
                 (0.5, 0.9, 1.25, 800.0, 1.0)]:
        got = TT.ne_traditional_tea(*args, device="cpu")
        want = JT.ne_traditional_tea(*args)
        for a, b in zip(got, want):
            assert float(a) == pytest.approx(float(b), rel=1e-12)
    got = TT.traditional_tea_enumeration(device="cpu")
    want = JT.traditional_tea_enumeration()
    for k in ("net_npv", "elec_rev", "h2_rev"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)


def test_multiperiod_model_periodic_pair():
    """`MultiPeriodModel` applies a periodic pair as one equality row."""
    def build(m, T):
        return {"soc": m.var("soc", T, ub=10.0)}

    mp = MultiPeriodModel(6, build, periodic_pairs=["soc"])
    prog = mp.build()
    assert prog.M == 1 and prog.N == 6
    assert mp.pyomo_model is mp.model


@pytest.mark.parametrize("market", ["DA", "DA-RT"])
def test_price_taker_matches_jax(jax_refs, market):
    obj_j, reads_j, p_j = jax_refs[market]
    prog, sol, p = TN.run_price_taker(TN.NuclearPricetakerConfig(**CFG), DA, RT, 2.0,
                                      market, device="cpu")
    assert bool(sol.converged)
    assert float(p["da_settlement_offset"]) == pytest.approx(
        float(p_j["da_settlement_offset"]), rel=1e-9, abs=1e-6)
    assert float(sol.obj) == pytest.approx(obj_j, rel=LP_RTOL)
    for k, want in reads_j.items():
        got = prog.eval_expr(k, sol.x, p).numpy()
        np.testing.assert_allclose(got, want, rtol=LP_RTOL,
                                   atol=LP_RTOL * max(np.abs(want).max(), 1.0), err_msg=k)


def test_enumeration_matches_jax(jax_refs):
    want = jax_refs["enum"]
    got = TN.run_exhaustive_enumeration(DA, RT, h2_prices=(1.0, 2.0), pem_fracs=(0.1, 0.3),
                                        T=T, device="cpu")
    for k in ("net_npv", "elec_rev", "h2_rev", "net_profit"):
        for key, v in want[k].items():
            assert got[k][key] == pytest.approx(v, rel=LP_RTOL), (k, key)
    for key, v in want["pem_cap_factor"].items():
        assert got["pem_cap_factor"][key] == pytest.approx(v, abs=LP_RTOL)
    assert got["pem_cap_factor"]["10"] == pytest.approx(1.0, abs=1e-3)
    assert got["pem_cap_factor"]["00"] == pytest.approx(0.0, abs=1e-3)


def test_banded_solve_matches_jax_solve_horizon(jax_refs):
    obj_j, conv_j = jax_refs["banded"]
    prog = TN.build_nuclear_pricetaker(TN.NuclearPricetakerConfig(**CFG))
    from dispatches_tpu_torch.case_studies.nuclear.pricetaker import _params

    s = solve_horizon(prog, _params(None, DA, 2.0), T, block_hours=24, tol=1e-10,
                      device="cpu")
    assert conv_j and bool(s.converged)
    assert float(s.obj) == pytest.approx(obj_j, rel=BANDED_RTOL)


def test_banded_grid_lanes_match_the_dense_solve():
    """The report grid pins the PEM capacity with an equality row on the
    border column alone; the banded KKT solve takes such rows through the
    border's capacitance (the JAX package's banded solve stalls on them)
    and its lanes agree with the dense batch (rel 1e-9), at its iteration
    counts, in the year sweep's mixed precision and with SPIKE slabs."""
    from dispatches_tpu_torch.case_studies.nuclear.pricetaker import enumeration_params
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, solve_lp_banded_batch,
    )
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    T2 = 96
    cfg, grid = enumeration_params(np.resize(DA, T2), h2_prices=(1.0, 2.0),
                                   pem_fracs=(0.1, 0.3), T=T2)
    prog = TN.build_nuclear_pricetaker(cfg)
    meta = extract_time_structure(prog, T2, 24)
    assert int(meta.border_rows.sum()) == 1 and meta.mB == 121
    dense = solve_lp_batch(prog.instantiate(grid, device="cpu"))
    banded = solve_lp_banded_batch(meta, meta.instantiate(grid, device="cpu"),
                                   **year_sweep_solver_kw(torch.float64, Tb=meta.Tb))
    assert bool(dense.converged.all()) and bool(banded.converged.all())
    np.testing.assert_allclose(banded.obj.numpy(), dense.obj.numpy(), rtol=LP_RTOL)
    assert banded.iterations.tolist() == dense.iterations.tolist()


def test_tracking_matches_jax(jax_refs, tmp_path):
    power_j, state_j, records_j = jax_refs["tracking"]
    mp = TN.MultiPeriodNuclear(np_capacity_mw=500.0, pem_capacity_mw=100.0,
                               tank_capacity_kg=5000.0)
    tracker = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device="cpu")
    tracker.track_market_dispatch(DISPATCH, 0, 0)
    np.testing.assert_allclose(tracker.power_output, power_j, rtol=LP_RTOL, atol=1e-9)
    np.testing.assert_allclose(tracker.power_output, DISPATCH, atol=1e-2)
    # the holdup sits at its lower bound (everything sells to the pipeline):
    # a variable at a bound agrees to the IPM's tolerance on its scale, the
    # tank's 5,000 kg
    assert mp.state["holdup0"] == pytest.approx(state_j["holdup0"], abs=1e-5 * 5000.0)
    mp.write_results(str(tmp_path))
    import csv

    with open(tmp_path / "nuclear_tracker_detail.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == list(records_j[0])
    assert len(rows) == len(records_j) == 4
    for row, rec in zip(rows, records_j):
        assert float(row["Power Output [MW]"]) == pytest.approx(
            float(rec["Power Output [MW]"]), rel=LP_RTOL, abs=1e-9)
        assert row["Generator"] == rec["Generator"]


def test_conceptual_design_matches_jax(jax_refs):
    ratio_j, obj_j, enum_j = jax_refs["design"]
    rev, cf = _analytic()
    obj, terms = TCD.ne_objective(0.25, 2.0, 10.0, 500.0, rev, cf)
    obj_jt, terms_j = JCD.ne_objective(0.25, 2.0, 10.0, 500.0, rev, cf)
    assert float(obj) == pytest.approx(float(obj_jt), rel=1e-12)
    for k in terms:
        assert float(terms[k]) == pytest.approx(float(terms_j[k]), rel=1e-12), k
    r = TCD.conceptual_design_ss_NE(rev, cf, h2_price=2.0, device="cpu")
    assert float(r.pem_np_cap_ratio) == pytest.approx(ratio_j, rel=1e-6)
    assert float(r.objective) == pytest.approx(obj_j, rel=1e-6)
    e = TCD.run_exhaustive_enumeration(rev, cf, h2_prices=(0.75, 1.25, 1.75, 2.25),
                                       device="cpu")
    for k in ("best_ratio", "best_objective", "objective_grid"):
        np.testing.assert_allclose(e[k], enum_j[k], rtol=1e-6, err_msg=k)
