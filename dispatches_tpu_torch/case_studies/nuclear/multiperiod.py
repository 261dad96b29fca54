"""`MultiPeriodNuclear`: the nuclear hybrid's double-loop adapter (port of
`dispatches_tpu/case_studies/nuclear/multiperiod.py`).

Counterpart of the reference's `nuclear_flowsheet_multiperiod_class.py:
158-342`: an object implementing the tracking/bidding "model object"
protocol (`build_program` for `populate_model`, the rolling state through
`get_params` / `advance_state` for `update_model`, `record_results` /
`write_results`), served by `market.tracker.Tracker`. The multiperiod model
is the baseload NPP + flexible PEM + linear H2 tank (turbine off by
default, like the reference's `include_turbine=False` options, `:99-101`),
lowered once; each tracking call swaps parameters (the tank holdup carried
over, the dispatch signal).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from ...core.model import Model
from .pricetaker import H2_PROD_RATE, TURBINE_MWH_PER_KG


class MultiPeriodNuclear:
    """Tracking/bidding model object for the NPP + PEM + tank hybrid."""

    def __init__(
        self,
        gen_name: str = "121_NUCLEAR_1",
        np_capacity_mw: float = 500.0,
        pem_capacity_mw: float = 100.0,
        tank_capacity_kg: float = 5000.0,
        include_turbine: bool = False,
        turbine_capacity_mw: float = 0.0,
        h2_price_per_kg: float = 4.0,
        npp_vom: float = 2.3,  # $/MWh (`nuclear_flowsheet_multiperiod_class.py:128-137`)
        pem_vom: float = 1.3,
        tank_vom: float = 0.01,
    ):
        self.gen_name = gen_name
        self.np_capacity_mw = np_capacity_mw
        self.pem_capacity_mw = pem_capacity_mw
        self.tank_capacity_kg = tank_capacity_kg
        self.include_turbine = include_turbine
        self.turbine_capacity_mw = turbine_capacity_mw
        self.h2_price_per_kg = h2_price_per_kg
        self.npp_vom = npp_vom
        self.pem_vom = pem_vom
        self.tank_vom = tank_vom
        # rolling tank holdup [kg] carried between tracking calls, the
        # reference's `update_model(b, implemented_tank_holdup)` (`:218-239`)
        self.state = {"holdup0": 0.0}
        self.result_list: List[dict] = []

    # -- tracking program -------------------------------------------------
    def build_program(self, T: int):
        m = Model("nuclear_tracking")
        holdup0 = m.param("holdup0")

        to_grid = m.var("np_to_grid", T, ub=self.np_capacity_mw)
        to_pem = m.var("np_to_electrolyzer", T, ub=self.pem_capacity_mw)
        holdup = m.var("tank_holdup", T, ub=self.tank_capacity_kg)
        h2_pipe = m.var("h2_to_pipeline", T)
        h2_turb = m.var(
            "h2_to_turbine",
            T,
            ub=(1e9 if self.include_turbine else 0.0),
        )

        # NPP power balance at a fixed baseload output
        m.add_eq(to_grid + to_pem - self.np_capacity_mw)

        h2_prod = H2_PROD_RATE * to_pem  # kg/hr
        m.add_eq(holdup[0:1] - holdup0 - (h2_prod[0:1] - h2_pipe[0:1] - h2_turb[0:1]))
        if T > 1:
            m.add_eq(
                holdup[1:] - holdup[:-1] - (h2_prod[1:] - h2_pipe[1:] - h2_turb[1:])
            )

        turb_power = TURBINE_MWH_PER_KG * h2_turb
        if self.include_turbine:
            m.add_le(turb_power - self.turbine_capacity_mw)

        power_out_mw = to_grid + turb_power
        m.expression("power_output", power_out_mw)
        m.expression("tank_holdup", holdup + 0.0)
        m.expression("h2_to_pipeline", h2_pipe + 0.0)
        m.expression("np_to_electrolyzer", to_pem + 0.0)
        m.expression(
            "total_cost",
            self.npp_vom * (to_grid + to_pem)
            + self.pem_vom * to_pem
            + self.tank_vom * holdup
            - self.h2_price_per_kg * h2_pipe,
        )
        self._handles: Dict = {}
        return m, power_out_mw

    def get_params(self, date, hour, T: int) -> Dict[str, np.ndarray]:
        return {"holdup0": np.asarray(self.state["holdup0"])}

    def advance_state(self, prog, x, params, n_implement: int):
        holdup = np.asarray(prog.eval_expr("tank_holdup", x, params))
        self.state["holdup0"] = float(holdup[n_implement - 1])

    def record_results(self, prog, x, params, date, hour, **kw):
        power = np.asarray(prog.eval_expr("power_output", x, params))
        holdup = np.asarray(prog.eval_expr("tank_holdup", x, params))
        h2_pipe = np.asarray(prog.eval_expr("h2_to_pipeline", x, params))
        to_pem = np.asarray(prog.eval_expr("np_to_electrolyzer", x, params))
        for t in range(len(power)):
            self.result_list.append(
                {
                    "Generator": self.gen_name,
                    "Date": date,
                    "Hour": hour,
                    "Horizon [hr]": t,
                    "Power Output [MW]": power[t],
                    "Tank Holdup [kg]": holdup[t],
                    "H2 to Pipeline [kg/hr]": h2_pipe[t],
                    "Power to PEM [MW]": to_pem[t],
                    **kw,
                }
            )

    def write_results(self, path):
        """`nuclear_tracker_detail.csv` in `path`: one row a record, the
        columns in the order the records first name them (the layout of a
        pandas frame of the records, without the index), written with the
        `csv` module."""
        columns: Dict[str, None] = {}
        for row in self.result_list:
            columns.update(dict.fromkeys(row))
        with open(os.path.join(path, "nuclear_tracker_detail.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(columns), restval="")
            w.writeheader()
            w.writerows(
                {k: (float(v) if isinstance(v, np.floating) else v) for k, v in row.items()}
                for row in self.result_list
            )
