"""Double-loop multiperiod adapters: the tracking/bidding model objects.

Parity with the reference's adapter classes implementing the IDAES
bidder/tracker "model object" protocol
(`wind_battery_double_loop.py:101-352`, `wind_PEM_double_loop.py:103-337`:
`populate_model` / `update_model` / `get_last_delivered_power` /
`get_implemented_profile` / `record_results` / `power_output` / `total_cost`).
Here the protocol is array-native: each adapter lowers its rolling-horizon LP
once (`build_program`), exposes named expressions for power output and cost,
and carries its own state (battery SoC / throughput / tank holdup) between
rolling solves — the state advance that the reference does by rewriting
mutable Params on cloned Pyomo blocks (`wind_PEM_double_loop.py:185-204`).

Port of the JAX package's `market/double_loop.py` on the port's units.
The state advance and the records read a solution on whatever device it
lies (the Tracker hands them its host copy).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.model import Model
from ..units.battery import BatteryStorage
from ..units.pem import PEMElectrolyzer
from ..units.splitter import ElectricalSplitter
from ..units.wind import WindPower
from .model_data import RenewableGeneratorModelData


def _host(t) -> np.ndarray:
    """An expression's value as a numpy array."""
    return t.detach().cpu().numpy()


class MultiPeriodWindBattery:
    """Wind + battery tracking/bidding model
    (reference `wind_battery_double_loop.py:101-352`)."""

    def __init__(
        self,
        model_data: RenewableGeneratorModelData,
        wind_capacity_factors: np.ndarray,
        wind_pmax_mw: float,
        battery_pmax_mw: float,
        battery_energy_capacity_mwh: float,
    ):
        self.model_data = model_data
        self._cfs = np.asarray(wind_capacity_factors, dtype=float)
        self.wind_pmax_mw = wind_pmax_mw
        self.batt_pmax_mw = battery_pmax_mw
        self.batt_energy_mwh = battery_energy_capacity_mwh
        # rolling state (kWh), advanced by the Tracker
        self.state = {"soc0": 0.0, "tp0": 0.0}
        self.result_list: List[dict] = []

    # -- program ---------------------------------------------------------
    def build_program(self, T: int):
        m = Model("wind_battery_tracking")
        wind = WindPower(m, T, capacity=self.wind_pmax_mw * 1e3, cf_param="wind_cf")
        split = ElectricalSplitter(m, T, inlet=wind.electricity_out, outlet_list=["grid", "battery"])
        soc0 = m.param("soc0")
        tp0 = m.param("tp0")
        batt = _battery_with_param_initial(
            m,
            T,
            power_kw=self.batt_pmax_mw * 1e3,
            energy_kwh=self.batt_energy_mwh * 1e3,
            soc0=soc0,
            tp0=tp0,
        )
        m.add_eq(batt.elec_in - split.outlets["battery"])
        power_out_mw = 1e-3 * (split.outlets["grid"] + batt.elec_out)
        m.expression("power_output", power_out_mw)
        m.expression("soc", batt.soc + 0.0)
        m.expression("throughput", batt.throughput + 0.0)
        # wind is free, battery has no variable cost in the reference adapter
        m.expression("total_cost", 0.0 * (split.outlets["grid"] + 0.0))
        self._handles = {"batt": batt, "wind": wind, "split": split}
        return m, power_out_mw

    def get_params(self, date, hour, T: int) -> Dict[str, np.ndarray]:
        i0 = (int(date) * 24 + int(hour)) % len(self._cfs)
        idx = (i0 + np.arange(T)) % len(self._cfs)
        return {
            "wind_cf": self._cfs[idx],
            "soc0": np.asarray(self.state["soc0"]),
            "tp0": np.asarray(self.state["tp0"]),
        }

    def advance_state(self, prog, x, params, n_implement: int):
        soc = _host(prog.eval_expr("soc", x, params))
        tp = _host(prog.eval_expr("throughput", x, params))
        self.state["soc0"] = float(soc[n_implement - 1])
        self.state["tp0"] = float(tp[n_implement - 1])

    def record_results(self, prog, x, params, date, hour, **kw):
        power = _host(prog.eval_expr("power_output", x, params))
        soc = _host(prog.eval_expr("soc", x, params))
        for t in range(len(power)):
            self.result_list.append(
                {
                    "Generator": self.model_data.gen_name,
                    "Date": date,
                    "Hour": hour,
                    "Horizon [hr]": t,
                    "Power Output [MW]": power[t],
                    "State of Charge [kWh]": soc[t],
                    **kw,
                }
            )

    def write_results(self, path):
        import os

        import pandas as pd

        pd.DataFrame(self.result_list).to_csv(
            os.path.join(path, "tracker_detail.csv"), index=False
        )


class MultiPeriodWindPEM:
    """Wind + PEM tracking/bidding model
    (reference `wind_PEM_double_loop.py:103-337`)."""

    def __init__(
        self,
        model_data: RenewableGeneratorModelData,
        wind_capacity_factors: np.ndarray,
        wind_pmax_mw: float,
        pem_pmax_mw: float,
        h2_price_per_kg: float = 2.0,
    ):
        self.model_data = model_data
        self._cfs = np.asarray(wind_capacity_factors, dtype=float)
        self.wind_pmax_mw = wind_pmax_mw
        self.pem_pmax_mw = pem_pmax_mw
        self.h2_price_per_kg = h2_price_per_kg
        self.state: Dict[str, float] = {}
        self.result_list: List[dict] = []

    def build_program(self, T: int):
        from ..units.pem import h2_value_per_kwh

        m = Model("wind_pem_tracking")
        wind = WindPower(m, T, capacity=self.wind_pmax_mw * 1e3, cf_param="wind_cf")
        split = ElectricalSplitter(m, T, inlet=wind.electricity_out, outlet_list=["grid", "pem"])
        pem = PEMElectrolyzer(m, T, max_capacity=self.pem_pmax_mw * 1e3)
        m.add_eq(pem.electricity - split.outlets["pem"])
        power_out_mw = 1e-3 * (split.outlets["grid"] + 0.0)
        m.expression("power_output", power_out_mw)
        # negative cost = H2 revenue credit, so the tracker routes surplus
        # wind to the PEM (`wind_PEM_double_loop.py` prices H2 into tracking)
        h2_val = h2_value_per_kwh(self.h2_price_per_kg, pem.electricity_to_mol)
        m.expression("total_cost", (-h2_val) * pem.electricity)
        m.expression("h2_kg", pem.h2_kg_per_hr)
        self._handles = {"wind": wind, "split": split, "pem": pem}
        return m, power_out_mw

    def get_params(self, date, hour, T: int) -> Dict[str, np.ndarray]:
        i0 = (int(date) * 24 + int(hour)) % len(self._cfs)
        idx = (i0 + np.arange(T)) % len(self._cfs)
        return {"wind_cf": self._cfs[idx]}

    def advance_state(self, prog, x, params, n_implement: int):
        pass  # PEM is stateless

    def record_results(self, prog, x, params, date, hour, **kw):
        power = _host(prog.eval_expr("power_output", x, params))
        h2 = _host(prog.eval_expr("h2_kg", x, params))
        for t in range(len(power)):
            self.result_list.append(
                {
                    "Generator": self.model_data.gen_name,
                    "Date": date,
                    "Hour": hour,
                    "Horizon [hr]": t,
                    "Power Output [MW]": power[t],
                    "H2 Production [kg/hr]": h2[t],
                    **kw,
                }
            )

    def write_results(self, path):
        import os

        import pandas as pd

        pd.DataFrame(self.result_list).to_csv(
            os.path.join(path, "tracker_detail.csv"), index=False
        )


def _battery_with_param_initial(m: Model, T: int, power_kw, energy_kwh, soc0, tp0):
    """Battery whose initial SoC/throughput are solve-time parameters (the
    rolling-horizon state), with fixed nameplate power and energy."""
    batt = BatteryStorage.__new__(BatteryStorage)
    from ..units.base import Unit

    Unit.__init__(batt, m, "battery")
    batt.T = T
    ec = ed = 0.95
    dt = 1.0
    batt.elec_in = batt._v("elec_in", T, ub=power_kw)
    batt.elec_out = batt._v("elec_out", T, ub=power_kw)
    batt.soc = batt._v("soc", T, ub=energy_kwh)
    batt.throughput = batt._v("throughput", T)
    batt.nameplate_power = None
    m.add_eq(batt.soc[0:1] - soc0 - ec * dt * batt.elec_in[0:1] + (dt / ed) * batt.elec_out[0:1])
    if T > 1:
        m.add_eq(batt.soc[1:] - batt.soc[:-1] - ec * dt * batt.elec_in[1:] + (dt / ed) * batt.elec_out[1:])
    m.add_eq(batt.throughput[0:1] - tp0 - (dt / 2) * (batt.elec_in[0:1] + batt.elec_out[0:1]))
    if T > 1:
        m.add_eq(batt.throughput[1:] - batt.throughput[:-1] - (dt / 2) * (batt.elec_in[1:] + batt.elec_out[1:]))
    return batt
