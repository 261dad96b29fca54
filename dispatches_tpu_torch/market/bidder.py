"""Parametrized bidders: bid-curve construction from design parameters.

Parity with reference `dispatches/workflow/parametrized_bidder.py:73-213`
(`ParametrizedBidder` base: no stochastic program, bids built from parameters,
recorded to tabular results) and the per-technology subclasses
`PEM_parametrized_bidder.py:18-122` and `battery_parametrized_bidder.py`.

Bid format matches the Prescient/Egret convention the reference emits: a
piecewise (power, cumulative-cost) curve per hour per generator plus
p_min/p_max/startup/shutdown capacities.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def convert_marginal_costs_to_actual_costs(
    bids: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """Marginal (power, $/MWh) segments -> cumulative (power, $) curve points,
    the Egret cost-curve convention."""
    out = []
    total = 0.0
    prev_p = 0.0
    for p, mc in bids:
        total += (p - prev_p) * mc
        out.append((p, total))
        prev_p = p
    return out


class ParametrizedBidder:
    """Base bidder: subclasses implement compute_day_ahead_bids /
    compute_real_time_bids from parameters + forecasts."""

    def __init__(
        self,
        bidding_model_object,
        day_ahead_horizon: int,
        real_time_horizon: int,
        forecaster,
    ):
        self.bidding_model_object = bidding_model_object
        self.day_ahead_horizon = day_ahead_horizon
        self.real_time_horizon = real_time_horizon
        self.n_scenario = 1
        self.forecaster = forecaster
        self.real_time_underbid_penalty = 500  # `parametrized_bidder.py:90`
        self.generator = bidding_model_object.model_data.gen_name
        self.bids_result_list: List[dict] = []

    def compute_day_ahead_bids(self, date, hour=0):
        raise NotImplementedError

    def compute_real_time_bids(
        self, date, hour, realized_day_ahead_prices, realized_day_ahead_dispatches
    ):
        raise NotImplementedError

    def update_real_time_model(self, **kw):
        pass

    def update_day_ahead_model(self, **kw):
        pass

    def _record_bids(self, bids, date, hour, **kw):
        for t in bids:
            for gen in bids[t]:
                row = {"Generator": gen, "Date": date, "Hour": t, **kw}
                for idx, (power, cost) in enumerate(bids[t][gen]["p_cost"]):
                    row[f"Power {idx} [MW]"] = power
                    row[f"Cost {idx} [$]"] = cost
                self.bids_result_list.append(row)

    def write_results(self, path):
        import os

        import pandas as pd

        pd.DataFrame(self.bids_result_list).to_csv(
            os.path.join(path, "bidder_detail.csv"), index=False
        )

    def _format_bid(self, gen, curve_pts, p_max):
        return {
            "p_cost": curve_pts,
            "p_min": 0,
            "p_max": p_max,
            "startup_capacity": p_max,
            "shutdown_capacity": p_max,
        }


class PEMParametrizedBidder(ParametrizedBidder):
    """Wind+PEM: energy below (wind - pem_mw) bid at $0, the top `pem_mw` of
    wind bid at the PEM's marginal value of hydrogen
    (`PEM_parametrized_bidder.py:49-91`)."""

    def __init__(
        self,
        bidding_model_object,
        day_ahead_horizon,
        real_time_horizon,
        forecaster,
        pem_marginal_cost,
        pem_mw,
    ):
        super().__init__(
            bidding_model_object, day_ahead_horizon, real_time_horizon, forecaster
        )
        self.wind_marginal_cost = 0
        self.wind_mw = bidding_model_object.wind_pmax_mw
        self.pem_marginal_cost = pem_marginal_cost
        self.pem_mw = pem_mw

    def _bids_from_cf(self, forecast_cf, horizon, hour):
        gen = self.generator
        full_bids = {}
        for t_idx in range(horizon):
            wind = float(forecast_cf[t_idx]) * self.wind_mw
            grid_wind = max(0.0, wind - self.pem_mw)
            pts = convert_marginal_costs_to_actual_costs(
                [(0, 0), (grid_wind, 0), (wind, self.pem_marginal_cost)]
            )
            full_bids[t_idx + hour] = {gen: self._format_bid(gen, pts, wind)}
        return full_bids

    def compute_day_ahead_bids(self, date, hour=0):
        cf = self.forecaster.forecast_day_ahead_capacity_factor(
            date, hour, self.generator, self.day_ahead_horizon
        )
        bids = self._bids_from_cf(cf, self.day_ahead_horizon, hour)
        self._record_bids(bids, date, hour, Market="Day-ahead")
        return bids

    def compute_real_time_bids(
        self, date, hour, realized_day_ahead_prices=None, realized_day_ahead_dispatches=None
    ):
        cf = self.forecaster.forecast_real_time_capacity_factor(
            date, hour, self.generator, self.real_time_horizon
        )
        bids = self._bids_from_cf(cf, self.real_time_horizon, hour)
        self._record_bids(bids, date, hour, Market="Real-time")
        return bids


class BatteryParametrizedBidder(ParametrizedBidder):
    """Wind+battery: wind bid at $0 up to (wind - P_batt*ratio); the battery
    tranche bid at `battery_marginal_cost` (cf.
    `battery_parametrized_bidder.py` / `parametrized_bidder.py:91-92`)."""

    def __init__(
        self,
        bidding_model_object,
        day_ahead_horizon,
        real_time_horizon,
        forecaster,
        battery_marginal_cost: float = 25.0,
        battery_capacity_ratio: float = 0.4,
    ):
        super().__init__(
            bidding_model_object, day_ahead_horizon, real_time_horizon, forecaster
        )
        self.wind_mw = bidding_model_object.wind_pmax_mw
        self.batt_mw = bidding_model_object.batt_pmax_mw
        self.battery_marginal_cost = battery_marginal_cost
        self.battery_capacity_ratio = battery_capacity_ratio

    def _bids_from_cf(self, forecast_cf, horizon, hour):
        gen = self.generator
        full_bids = {}
        batt_avail = self.batt_mw * self.battery_capacity_ratio
        for t_idx in range(horizon):
            wind = float(forecast_cf[t_idx]) * self.wind_mw
            p_max = wind + batt_avail
            pts = convert_marginal_costs_to_actual_costs(
                [(0, 0), (wind, 0), (p_max, self.battery_marginal_cost)]
            )
            full_bids[t_idx + hour] = {gen: self._format_bid(gen, pts, p_max)}
        return full_bids

    def compute_day_ahead_bids(self, date, hour=0):
        cf = self.forecaster.forecast_day_ahead_capacity_factor(
            date, hour, self.generator, self.day_ahead_horizon
        )
        bids = self._bids_from_cf(cf, self.day_ahead_horizon, hour)
        self._record_bids(bids, date, hour, Market="Day-ahead")
        return bids

    def compute_real_time_bids(
        self, date, hour, realized_day_ahead_prices=None, realized_day_ahead_dispatches=None
    ):
        cf = self.forecaster.forecast_real_time_capacity_factor(
            date, hour, self.generator, self.real_time_horizon
        )
        bids = self._bids_from_cf(cf, self.real_time_horizon, hour)
        self._record_bids(bids, date, hour, Market="Real-time")
        return bids
