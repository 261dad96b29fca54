"""In-framework deterministic market world for double-loop testing.

The reference tests its double loop two ways (SURVEY.md §4): scripted
dispatch signals fed straight to a Tracker, and a checked-in 5-bus Prescient
dataset run for 2 simulated days (`tests/test_prescient.py:55-101`). This
module is the equivalent self-contained market host: an hourly uniform-price
single-bus clearing (`SimpleMarket`) driving the DoubleLoopCoordinator's
DA-bid -> RT-bid -> SCED-dispatch -> track cycle without any external
production-cost simulator.

Clearing model: merit-order stack of piecewise bid segments vs inelastic
demand; LMP = marginal segment price (demand shortfall priced at
`shortfall_price`, the analogue of Prescient's `price_threshold`,
`prescient_options.py:63-70`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StaticGenerator:
    """A background fleet unit bidding (capacity, marginal cost) constantly."""

    name: str
    p_max: float  # MW
    marginal_cost: float  # $/MWh


def _curve_to_segments(p_cost: List[Tuple[float, float]]):
    """Cumulative (power, $) curve points -> [(width_mw, marginal_$)] list."""
    segs = []
    for (p0, c0), (p1, c1) in zip(p_cost[:-1], p_cost[1:]):
        w = p1 - p0
        if w > 1e-9:
            segs.append((w, (c1 - c0) / w))
    return segs


class SimpleMarket:
    def __init__(
        self,
        demand_mw: np.ndarray,  # hourly demand
        fleet: List[StaticGenerator],
        shortfall_price: float = 500.0,
        day_ahead_horizon: int = 48,
    ):
        self.demand = np.asarray(demand_mw, dtype=float)
        self.fleet = fleet
        self.shortfall_price = shortfall_price
        self.day_ahead_horizon = day_ahead_horizon
        self.results: List[dict] = []

    def _clear_hour(self, demand: float, participant_segments):
        """Merit-order clearing; returns (lmp, participant_dispatch)."""
        segs = []
        for g in self.fleet:
            segs.append((g.marginal_cost, g.p_max, "fleet"))
        for w, mc in participant_segments:
            segs.append((mc, w, "participant"))
        segs.sort(key=lambda s: s[0])
        remaining = demand
        lmp = 0.0
        part_dispatch = 0.0
        for mc, w, kind in segs:
            if remaining <= 1e-9:
                break
            take = min(w, remaining)
            remaining -= take
            lmp = mc
            if kind == "participant":
                part_dispatch += take
        if remaining > 1e-9:
            lmp = self.shortfall_price
        return lmp, part_dispatch

    def simulate(self, coordinator, n_days: int, tracking_horizon: int = 4):
        """Run the double loop: per day one DA bid pass, then 24 hourly RT
        clearings each followed by tracking (RUC + SCED cadence,
        BASELINE.md "365 days x (1 RUC + 24 SCED)")."""
        gen = coordinator.bidder.generator
        for day in range(n_days):
            da_bids = coordinator.compute_day_ahead_bids(day)
            da_prices = []
            da_dispatch = []
            for t in sorted(da_bids):
                segs = _curve_to_segments(da_bids[t][gen]["p_cost"])
                demand = self.demand[(day * 24 + (t % 24)) % len(self.demand)]
                lmp, disp = self._clear_hour(demand, segs)
                da_prices.append(lmp)
                da_dispatch.append(disp)

            for hour in range(24):
                rt_bids = coordinator.compute_real_time_bids(
                    day, hour, da_prices, da_dispatch
                )
                t0 = sorted(rt_bids)[0]
                segs = _curve_to_segments(rt_bids[t0][gen]["p_cost"])
                demand = self.demand[(day * 24 + hour) % len(self.demand)]
                lmp, disp = self._clear_hour(demand, segs)

                # dispatch signal over the tracking horizon: hold cleared MW
                dispatch_signal = [disp] * tracking_horizon
                coordinator.track_sced_dispatch(dispatch_signal, day, hour)
                delivered = coordinator.tracker.get_last_delivered_power()
                self.results.append(
                    {
                        "Day": day,
                        "Hour": hour,
                        "LMP": lmp,
                        "Dispatch [MW]": disp,
                        "Delivered [MW]": delivered,
                        "Revenue [$]": lmp * delivered,
                    }
                )
        return self.results
