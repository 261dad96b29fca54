"""Port parity: the market participant's side (`dispatches_tpu_torch/market/
{tracker,bidder,forecaster,coordinator,simulator,stochastic,double_loop}.py`
and `workflow/postprocess.py`) against the JAX package's, on the CPU in
float64.

The tracker golden (`test_market.py:36-65`) at the reference's numbers; one
day of the `SimpleMarket` double loop (`test_market.py:119-152`) against the
JAX package's, row by row; the stochastic bidder's day-ahead curves; the
coordinator's Prescient plugin hooks on the vendored Egret model dicts; the
post-processing helpers. The JAX package runs once per test, at one day.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from dispatches_tpu.market import (
    Backcaster as JBackcaster,
    DoubleLoopCoordinator as JCoordinator,
    PEMParametrizedBidder as JPEMBidder,
    PerfectForecaster as JPerfect,
    RenewableGeneratorModelData as JModelData,
    SimpleMarket as JSimpleMarket,
    StaticGenerator as JStatic,
    Tracker as JTracker,
)
from dispatches_tpu.market.double_loop import MultiPeriodWindPEM as JWindPEM
from dispatches_tpu.market.stochastic import StochasticBidder as JStochastic
from dispatches_tpu.workflow import postprocess as JPost
from dispatches_tpu_torch.market import (
    Backcaster,
    DoubleLoopCoordinator,
    PEMParametrizedBidder,
    PerfectForecaster,
    RenewableGeneratorModelData,
    SimpleMarket,
    StaticGenerator,
    Tracker,
    convert_marginal_costs_to_actual_costs,
)
from dispatches_tpu_torch.market.double_loop import MultiPeriodWindBattery, MultiPeriodWindPEM
from dispatches_tpu_torch.market.stochastic import StochasticBidder
from dispatches_tpu_torch.workflow import postprocess as Post

GEN = "309_WIND_1"
DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
CFS = np.random.default_rng(3).uniform(0.0, 1.0, 8736)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _coordinator(pkg, cfs, *, wind=100.0, pem=25.0, pem_cost=25.0, horizon=24):
    """The same wind + PEM participant in either package ("jax" or "port")."""
    md = (JModelData if pkg == "jax" else RenewableGeneratorModelData)(
        gen_name=GEN, bus="Carter", p_min=0, p_max=wind, p_cost=0)
    mp = (JWindPEM if pkg == "jax" else MultiPeriodWindPEM)(
        model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=wind, pem_pmax_mw=pem)
    fc = (JPerfect if pkg == "jax" else PerfectForecaster)(
        {f"{GEN}-DACF": cfs, f"{GEN}-RTCF": cfs})
    bidder = (JPEMBidder if pkg == "jax" else PEMParametrizedBidder)(
        mp, day_ahead_horizon=horizon, real_time_horizon=4, forecaster=fc,
        pem_marginal_cost=pem_cost, pem_mw=pem)
    if pkg == "jax":
        tracker = JTracker(mp, tracking_horizon=4, n_tracking_hour=1)
        return JCoordinator(bidder, tracker), mp
    tracker = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device="cpu")
    return DoubleLoopCoordinator(bidder, tracker), mp


def test_tracker_follows_dispatch_golden():
    """`test_market.py:36-65` on the port: delivered power equals the
    market dispatch, wind runs at full availability, the surplus charges
    the battery; then the state advances."""
    cfs = CFS.copy()
    cfs[:4] = np.array([1123.8, 1573.4, 20510.2, 25938.4]) / 200e3
    md = RenewableGeneratorModelData(gen_name=GEN, bus="Carter", p_min=0, p_max=200, p_cost=0)
    mp = MultiPeriodWindBattery(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=200,
                                battery_pmax_mw=25, battery_energy_capacity_mwh=100)
    tracker = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device="cpu")
    assert tracker.solver_kw["tol"] == 1e-10
    dispatch = [0, 1.5, 15.0, 24.5]
    sol = tracker.track_market_dispatch(dispatch, 0, 0)
    assert bool(sol.converged)
    np.testing.assert_allclose(tracker.power_output, dispatch, atol=1e-3)
    wind_kw = tracker.extract("wind.electricity")
    np.testing.assert_allclose(wind_kw, [1123.8, 1573.4, 20510.2, 25938.4], rtol=1e-3)
    batt_in = tracker.extract("battery.elec_in")
    np.testing.assert_allclose(batt_in, wind_kw - np.array(dispatch) * 1e3, rtol=1e-3, atol=1.0)
    soc = mp.state["soc0"]
    assert soc > 0
    tracker.track_market_dispatch([120.0] * 4, 0, 1)
    assert mp.state["soc0"] < soc + 1e-6


def test_simple_market_double_loop_matches_jax():
    """One day of `SimpleMarket` clearing the participant's DA / RT bids,
    each hour tracked: the port's rows equal the JAX package's within 1e-6
    MW / $ (measured ~1e-9), delivered = dispatched within 1e-2 MW, and
    the bidders' and trackers' records agree."""
    fleet = [(80.0, 20.0), (60.0, 40.0)]
    out = {}
    for pkg in ("jax", "port"):
        coord, mp = _coordinator(pkg, CFS)
        Market, Static = (JSimpleMarket, JStatic) if pkg == "jax" else (SimpleMarket, StaticGenerator)
        market = Market(demand_mw=np.full(48, 120.0),
                        fleet=[Static(f"g{i}", p, c) for i, (p, c) in enumerate(fleet)])
        out[pkg] = (market.simulate(coord, n_days=1, tracking_horizon=4), coord, mp)
    (want, jc, jmp), (got, pc, pmp) = out["jax"], out["port"]
    assert len(got) == len(want) == 24
    for key in want[0]:
        a = np.array([r[key] for r in want], float)
        b = np.array([r[key] for r in got], float)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(1.0, np.abs(a).max()), err_msg=key)
    np.testing.assert_allclose([r["Delivered [MW]"] for r in got],
                               [r["Dispatch [MW]"] for r in got], atol=1e-2)
    assert pc.bidder.bids_result_list == jc.bidder.bids_result_list
    assert len(pmp.result_list) == len(jmp.result_list) == 24 * 4
    for a, b in zip(jmp.result_list, pmp.result_list):
        assert a.keys() == b.keys()
        assert b["H2 Production [kg/hr]"] == pytest.approx(a["H2 Production [kg/hr]"], abs=1e-8)
        assert b["Power Output [MW]"] == pytest.approx(a["Power Output [MW]"], abs=1e-8)


DAILY_CF = np.array([0.7, 0.8, 0.9, 0.8, 0.6, 0.5, 0.4, 0.5] * 3)
DAILY_LMP = np.array([5.0, 10.0, 15.0, 28.0, 40.0, 35.0, 12.0, 8.0] * 3)


def test_stochastic_bidder_matches_jax():
    """`test_stochastic_bidder.py`'s participant (50 MW wind, 20 MW PEM,
    H2 at $1.25/kg) over three jittered history days: the day-ahead curves
    agree point by point within 1e-5 MW / $ (IPM tol 1e-9) and are
    monotone."""
    cfs = np.tile(DAILY_CF, 10)
    rng = np.random.default_rng(0)
    hist = np.concatenate([DAILY_LMP + rng.normal(0, 1.0, 24) for _ in range(3)])
    bids = {}
    for pkg in ("jax", "port"):
        md = (JModelData if pkg == "jax" else RenewableGeneratorModelData)(
            gen_name=GEN, bus="Carter", p_min=0.0, p_max=50.0, generator_type="renewable")
        mo = (JWindPEM if pkg == "jax" else MultiPeriodWindPEM)(
            model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=50.0, pem_pmax_mw=20.0,
            h2_price_per_kg=1.25)
        fc = (JBackcaster if pkg == "jax" else Backcaster)(hist, n_historical_days=3)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        bidder = (JStochastic if pkg == "jax" else StochasticBidder)(
            mo, day_ahead_horizon=24, real_time_horizon=4, forecaster=fc, n_scenario=3, **kw)
        bids[pkg] = bidder.compute_day_ahead_bids(0)
    assert bids["port"].keys() == bids["jax"].keys()
    for t, hour in bids["jax"].items():
        want, got = hour[GEN], bids["port"][t][GEN]
        assert got["p_max"] == pytest.approx(want["p_max"], abs=1e-5)
        assert len(got["p_cost"]) == len(want["p_cost"]), t
        np.testing.assert_allclose(np.array(got["p_cost"]), np.array(want["p_cost"]),
                                   rtol=0, atol=1e-5)
        pws = [p for p, _ in got["p_cost"]]
        assert all(b >= a - 1e-9 for a, b in zip(pws, pws[1:]))


def _load_md(name):
    with open(os.path.join(DATA_DIR, name)) as f:
        d = json.load(f)
    d.pop("__comment__", None)

    class MD:  # duck-types egret.data.model_data.ModelData
        def __init__(self, data):
            self.data = data

    return MD(d)


class _Context:
    def __init__(self):
        self.callbacks = {}

    def __getattr__(self, name):
        if name.startswith("register_") and name.endswith("_callback"):
            key = name[len("register_"):-len("_callback")]
            return lambda cb: self.callbacks.__setitem__(key, cb)
        raise AttributeError(name)


def test_coordinator_plugin_hooks_match_jax():
    """The four Prescient plugin hooks, in the order Prescient calls them,
    on the vendored Egret RUC / SCED model dicts: the mutated dicts are the
    JAX package's (equal JSON), the captured
    day-ahead results equal, and the tracked profile within 1e-6 MW."""
    cfs = np.full(8736, 0.5)
    seen = {}
    for pkg in ("jax", "port"):
        coord, _ = _coordinator(pkg, cfs[:48], pem_cost=30.0)
        ctx = _Context()
        mod = coord.prescient_plugin_module
        assert mod.__name__ == "dispatches_tpu_doubleloop_plugin"
        mod.register_plugins(ctx, None, None)
        ruc, sced = _load_md("egret_ruc_md.json"), _load_md("egret_sced_md.json")
        ctx.callbacks["before_ruc_solve"](None, (0, 0), ruc, 0, 0)
        ctx.callbacks["after_ruc_generation"](None, (0, 0), ruc, 0, 0)
        ctx.callbacks["before_operations_solve"](None, (0, 3), sced)
        ctx.callbacks["after_operations"](None, (0, 3), sced)
        gen_dict = {"p_max": 1.0}
        coord.update_static_params(gen_dict)
        seen[pkg] = (json.dumps(ruc.data, sort_keys=True), json.dumps(sced.data, sort_keys=True),
                     copy.deepcopy(coord._da_results), coord.tracker.get_implemented_profile(),
                     gen_dict)
    want, got = seen["jax"], seen["port"]
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3], want[3], atol=1e-6)
    assert got[4] == want[4]


def test_bids_forecasts_and_postprocess_equal(tmp_path):
    """Bid curves, `convert_marginal_costs_to_actual_costs`, the Backcaster,
    the results CSV round trip, `summarize_revenue` and `calculate_npv`:
    equal to the JAX package's."""
    from dispatches_tpu.market.bidder import convert_marginal_costs_to_actual_costs as j_conv

    pts = [(0, 0), (10, 0), (20, 5.0)]
    assert convert_marginal_costs_to_actual_costs(pts) == j_conv(pts) == [(0, 0.0), (10, 0.0), (20, 50.0)]
    hist = np.tile(np.arange(24.0), 3)
    np.testing.assert_array_equal(Backcaster(hist).forecast(4), JBackcaster(hist).forecast(4))
    jc, _ = _coordinator("jax", np.full(48, 0.5), wind=200.0, pem=50.0, pem_cost=30.0, horizon=48)
    pc, _ = _coordinator("port", np.full(48, 0.5), wind=200.0, pem=50.0, pem_cost=30.0, horizon=48)
    assert pc.bidder.compute_day_ahead_bids(0) == jc.bidder.compute_day_ahead_bids(0)
    rows = [{"Day": 0, "Hour": h, "LMP bus1": 10.0 + h, "Participant [MW]": 0.5 * h}
            for h in range(24)]
    Post.results_to_csv(rows, str(tmp_path / "p.csv"))
    JPost.results_to_csv(rows, str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert Post.read_results_csv(str(tmp_path / "p.csv")) == JPost.read_results_csv(str(tmp_path / "j.csv"))
    kw = dict(lmp_key="LMP bus1", dispatch_key="Participant [MW]")
    assert Post.summarize_revenue(rows, **kw) == JPost.summarize_revenue(rows, **kw)
    for npv in (dict(annual_revenue=2.5e6, wind_size_mw=50.0, battery_size_mw=10.0),
                dict(annual_revenue=1e6, wind_size_mw=20.0, battery_size_mw=5.0,
                     duration=2.0, extant_wind=False, om_cost=False)):
        assert Post.calculate_npv(**npv) == JPost.calculate_npv(**npv)
