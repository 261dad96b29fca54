"""Scenario-stochastic bidding: the IDAES `Bidder`/`SelfScheduler` analogue.

The reference's double loop supports a stochastic bidding program — one copy
of the operating model per LMP scenario, maximizing expected profit, with
bid-curve (monotonicity) constraints linking scenario power to prices — via
IDAES grid_integration's `Bidder` and `SelfScheduler`
(`test_multiperiod_wind_battery_doubleloop.py:113+` drives it with a
`Backcaster`). The round-1 build only had parametrized bidders; this module
adds the stochastic program as one parametric LP:

* The scenario-coupled LP is lowered ONCE (scenario copies are prefixed unit
  blocks inside one `Model`); every bid computation is a parameter swap +
  one IPM solve. The reference rebuilds and re-solves a Pyomo program
  per bidding hour.
* Bid-curve monotonicity ("deliver more when the price is higher") depends
  on the price *ordering*, which changes with the forecast — a structural
  problem for a fixed compiled LP. Solved parametrically: a per-hour
  permutation matrix parameter sorts scenario powers into price order, and
  static constraints enforce monotonicity of the sorted sequence:
      sum_s perm[t,k+1,s] P_s[t]  >=  sum_s perm[t,k,s] P_s[t]
  The permutation entries are data (0/1), so the LP structure never changes.
* `SelfScheduler` replaces monotonicity with non-anticipativity
  (P_s[t] == P_0[t] for all s) and bids the resulting schedule at its
  marginal value.

Port of the JAX package's `market/stochastic.py`: each bid computation is
one scenario LP solved on ``device`` (default ``"cuda"``) in ``dtype``
(default float64), its solution read on the host once.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.model import Model
from ..solvers.ipm import solve_lp
from ..units.battery import BatteryStorage
from ..units.pem import PEMElectrolyzer, h2_value_per_kwh
from ..units.splitter import ElectricalSplitter
from ..units.wind import WindPower
from .bidder import ParametrizedBidder, convert_marginal_costs_to_actual_costs


def _scenario_wind_pem(m: Model, T: int, s: int, wind_mw, pem_mw, h2_price):
    """One scenario copy of the wind+PEM operating model; returns (power_out
    MW expr, profit-credit expr $/hr)."""
    wind = WindPower(
        m, T, name=f"s{s}.wind", capacity=wind_mw * 1e3, cf_param="wind_cf"
    )
    split = ElectricalSplitter(
        m, T, inlet=wind.electricity_out, outlet_list=["grid", "pem"],
        name=f"s{s}.splitter",
    )
    pem = PEMElectrolyzer(m, T, name=f"s{s}.pem", max_capacity=pem_mw * 1e3)
    m.add_eq(pem.electricity - split.outlets["pem"])
    power_mw = 1e-3 * (split.outlets["grid"] + 0.0)
    credit = h2_value_per_kwh(h2_price, pem.electricity_to_mol) * pem.electricity
    return power_mw, credit


def _scenario_wind_battery(m: Model, T: int, s: int, wind_mw, batt_mw,
                           batt_mwh, soc0, tp0):
    """One scenario copy of the wind+battery operating model."""
    wind = WindPower(
        m, T, name=f"s{s}.wind", capacity=wind_mw * 1e3, cf_param="wind_cf"
    )
    split = ElectricalSplitter(
        m, T, inlet=wind.electricity_out, outlet_list=["grid", "battery"],
        name=f"s{s}.splitter",
    )
    batt = BatteryStorage(
        m,
        T,
        name=f"s{s}.battery",
        power_capacity=batt_mw * 1e3,
        duration=None,
        energy_capacity=batt_mwh * 1e3,
        initial_soc=None,
        initial_throughput=None,
        periodic_soc=False,
    )
    # pin free initial states to the rolling-state params
    m.add_eq(batt.initial_soc - soc0)
    m.add_eq(batt.initial_throughput - tp0)
    m.add_eq(batt.elec_in - split.outlets["battery"])
    power_mw = 1e-3 * (split.outlets["grid"] + batt.elec_out)
    credit = 0.0 * (split.outlets["grid"] + 0.0)
    return power_mw, credit


class StochasticBidder(ParametrizedBidder):
    """Scenario-stochastic bid-curve bidder (IDAES `Bidder` analogue).

    maximize  (1/S) sum_s [ sum_t lmp[s,t] * P_s[t] + credit_s[t] ]
    s.t.      operating physics per scenario (one prefixed copy each)
              sorted-by-price monotonicity across scenarios (bid validity)

    The per-hour bid curve is read off the optimal (price, power) pairs.
    `self_schedule=True` turns it into the `SelfScheduler`: one
    non-anticipative schedule across scenarios, bid at near-zero price.
    """

    def __init__(
        self,
        bidding_model_object,
        day_ahead_horizon: int,
        real_time_horizon: int,
        forecaster,
        n_scenario: int = 10,
        self_schedule: bool = False,
        solver_kw: Optional[dict] = None,
        device="cuda",
        dtype=torch.float64,
    ):
        super().__init__(
            bidding_model_object, day_ahead_horizon, real_time_horizon, forecaster
        )
        self.device = torch.device(device)
        self.dtype = dtype
        self.n_scenario = n_scenario
        self.self_schedule = self_schedule
        self.solver_kw = {"tol": 1e-9, "max_iter": 60, **(solver_kw or {})}
        self._progs = {}
        for T in {day_ahead_horizon, real_time_horizon}:
            self._progs[T] = self._build(T)

    # ------------------------------------------------------------------
    def _scenario_copy(self, m, T, s):
        mo = self.bidding_model_object
        from .double_loop import MultiPeriodWindBattery, MultiPeriodWindPEM

        if isinstance(mo, MultiPeriodWindPEM):
            return _scenario_wind_pem(
                m, T, s, mo.wind_pmax_mw, mo.pem_pmax_mw, mo.h2_price_per_kg
            )
        if isinstance(mo, MultiPeriodWindBattery):
            soc0 = m.param("soc0")
            tp0 = m.param("tp0")
            return _scenario_wind_battery(
                m, T, s, mo.wind_pmax_mw, mo.batt_pmax_mw,
                mo.batt_energy_mwh, soc0, tp0,
            )
        raise TypeError(f"no scenario builder for {type(mo).__name__}")

    def _build(self, T: int):
        S = self.n_scenario
        m = Model(f"stochastic_bid_T{T}")
        lmp = m.param("lmp", (S, T))  # $/MWh scenarios
        powers, credits = [], []
        for s in range(S):
            p_mw, credit = self._scenario_copy(m, T, s)
            powers.append(p_mw)
            credits.append(credit)

        profit = None
        for s in range(S):
            lam = lmp[s, :]  # (T,) view
            term = (lam * powers[s]).sum() + credits[s].sum()
            profit = term if profit is None else profit + term

        if self.self_schedule:
            for s in range(1, S):
                m.add_eq(powers[s] - powers[0])
        else:
            # monotone-in-price coupling via the sorted-order permutation
            # parameter: perm[t, k, s] = 1 iff scenario s has the k-th
            # smallest price at hour t
            perm = m.param("bid_perm", (T, S, S))
            sorted_pows = []
            for k in range(S):
                e = None
                for s in range(S):
                    term = perm[:, k, s] * powers[s]
                    e = term if e is None else e + term
                sorted_pows.append(e)
            for k in range(S - 1):
                m.add_ge(sorted_pows[k + 1] - sorted_pows[k], 0.0)

        m.maximize(profit * (1e-3 / S))
        for s in range(S):
            m.expression(f"power_{s}", powers[s])
        return m.build()

    # ------------------------------------------------------------------
    def _solve_bidding(self, T: int, lmp_scen: np.ndarray, cf: np.ndarray):
        prog = self._progs[T]
        S = self.n_scenario
        params: Dict[str, np.ndarray] = {
            "lmp": np.asarray(lmp_scen, dtype=float),
            "wind_cf": np.asarray(cf, dtype=float),
        }
        if not self.self_schedule:
            order = np.argsort(lmp_scen, axis=0, kind="stable")  # (S, T)
            perm = np.zeros((T, S, S))
            for k in range(S):
                perm[np.arange(T), k, order[k]] = 1.0
            params["bid_perm"] = perm
        mo = self.bidding_model_object
        state = getattr(mo, "state", None) or {}
        if "soc0" in prog.param_shapes:
            params["soc0"] = np.asarray(state.get("soc0", 0.0))
            params["tp0"] = np.asarray(state.get("tp0", 0.0))
        lp = prog.instantiate(params, dtype=self.dtype, device=self.device)
        sol = solve_lp(lp, **self.solver_kw)
        if not bool(sol.converged):
            raise RuntimeError(
                f"stochastic bidding LP did not converge (T={T}, "
                f"iters={int(sol.iterations)}, "
                f"gap={float(sol.gap):.2e}) — refusing to emit "
                "bid curves from an unconverged iterate"
            )
        x = sol.x.cpu()  # one device read; the powers are read on the host
        hp = {k: torch.as_tensor(np.asarray(v), dtype=self.dtype)
              for k, v in params.items()}
        pows = np.stack(
            [prog.eval_expr(f"power_{s}", x, hp).numpy() for s in range(S)]
        )  # (S, T)
        return pows, sol

    def _curves_from_solution(self, lmp_scen, pows, hour: int):
        """Per-hour Egret bid curves from optimal (price, power) pairs."""
        gen = self.generator
        S, T = lmp_scen.shape
        full_bids = {}
        for t in range(T):
            order = np.argsort(lmp_scen[:, t], kind="stable")
            lam = lmp_scen[order, t]
            pw = np.maximum.accumulate(pows[order, t])  # clean tiny dips
            segs = [(0.0, 0.0)]
            for k in range(S):
                if pw[k] > segs[-1][0] + 1e-6:
                    segs.append((float(pw[k]), float(max(lam[k], 0.0))))
            if len(segs) == 1:
                segs.append((0.0, 0.0))
            pts = convert_marginal_costs_to_actual_costs(segs)
            p_max = max(float(pw[-1]), 0.0)
            full_bids[t + hour] = {gen: self._format_bid(gen, pts, p_max)}
        return full_bids

    def _self_schedule_bids(self, pows, hour: int):
        gen = self.generator
        sched = pows[0]
        full_bids = {}
        for t in range(len(sched)):
            p = float(max(sched[t], 0.0))
            pts = convert_marginal_costs_to_actual_costs([(0.0, 0.0), (p, 0.0)])
            full_bids[t + hour] = {gen: self._format_bid(gen, pts, p)}
        return full_bids

    # ------------------------------------------------------------------
    def _scenarios_for(self, date, hour, horizon, market: str):
        f = self.forecaster
        if hasattr(f, "forecast_scenarios"):
            # anchor the scenarios to the bidding hour-of-day so RT bids at
            # hour h price hours h..h+T-1 (matching the CF window from
            # get_params), not wherever the history happens to end
            scen = np.asarray(
                f.forecast_scenarios(horizon, hour_of_day=int(hour) % 24)
            )
        else:
            bus = getattr(self.bidding_model_object.model_data, "bus", "bus")
            fn = (
                f.forecast_day_ahead_prices
                if market == "Day-ahead"
                else f.forecast_real_time_prices
            )
            scen = np.asarray(fn(date, hour, bus, horizon))[None, :]
        S = self.n_scenario
        if scen.shape[0] >= S:
            scen = scen[-S:]
        else:
            reps = int(np.ceil(S / scen.shape[0]))
            scen = np.tile(scen, (reps, 1))[:S]
        return scen

    def _compute_bids(self, date, hour, T, market):
        scen = self._scenarios_for(date, hour, T, market)
        cf = self.bidding_model_object.get_params(date, hour, T)["wind_cf"]
        pows, _ = self._solve_bidding(T, scen, cf)
        if self.self_schedule:
            bids = self._self_schedule_bids(pows, hour)
        else:
            bids = self._curves_from_solution(scen, pows, hour)
        self._record_bids(bids, date, hour, Market=market)
        return bids

    def compute_day_ahead_bids(self, date, hour=0):
        return self._compute_bids(date, hour, self.day_ahead_horizon, "Day-ahead")

    def compute_real_time_bids(
        self, date, hour, realized_day_ahead_prices=None,
        realized_day_ahead_dispatches=None,
    ):
        return self._compute_bids(date, hour, self.real_time_horizon, "Real-time")


class SelfScheduler(StochasticBidder):
    """Non-anticipative self-schedule over LMP scenarios (IDAES
    `SelfScheduler` analogue): one schedule maximizing expected profit,
    offered at zero price (price-taker self-commitment)."""

    def __init__(self, *a, **kw):
        kw["self_schedule"] = True
        super().__init__(*a, **kw)
