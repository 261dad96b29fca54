"""Multiperiod USC + molten-salt storage: dispatch LP and double-loop
adapter (port of `dispatches_tpu/case_studies/fossil/multiperiod.py`).

The counterpart of `storage/multiperiod_integrated_storage_usc.py:40-380`
and `storage/multiperiod_double_loop_usc.py:68-403`: the per-hour
integrated flowsheet (436 MW USC plant + charge/discharge salt HXs) with

  - hot/cold salt inventory linking vars + balances (`:89-166`)
  - available-inventory flow limits (`constraint_salt_maxflow_*`)
  - plant ramp constraints +-60 MW/hr (`:126-135`)
  - net power = plant power + ES-turbine discharge power

lowered once over the whole horizon (time = array axis), with LMPs,
initial inventories and previous power as parameters. The model is built
on the host; `MultiPeriodUsc` plugs into the port's `market.Tracker`,
which instantiates and solves it on its device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...core.model import Model
from ...properties.salts import SolarSalt
from . import usc_plant as U


def salt_flow_per_mw(fluid=SolarSalt, T_hot=U.T_SALT_HOT, T_cold=U.T_SALT_COLD):
    """kg/s of salt per MW of HX duty across the hot/cold loop."""
    dh = float(fluid.enth_mass(T_hot) - fluid.enth_mass(T_cold))  # J/kg
    return 1e6 / dh


def build_usc_storage_model(
    T: int,
    pmin: float = U.MIN_POWER_MW + 1.0,
    pmax: float = U.MAX_POWER_MW,
    fluid=SolarSalt,
    tank_max_kg: float = U.TANK_MAX_KG,
    max_storage_mw: float = U.MAX_STORAGE_DUTY_MW,
    ramp_mw: float = U.RAMP_MW_PER_HR,
    periodic_inventory: bool = False,
    scale: float = 1e-3,
    es_turbine_eff: float = U.ES_TURBINE_EFF,
):
    """Lower the T-hour integrated-storage dispatch LP.

    Params: `lmp` (T,) [$/MWh], `hot0` [kg] initial hot inventory,
    `power0` [MW] previous power for the first ramp constraint. Storage
    duties use bounds [0, 200] MW: the reference's 10 MW lower bound models
    always-on HXs in its NLP; the LP's zero lower bound is the
    dispatch-feasible relaxation (duty 0 == HX bypassed)."""
    m = Model("usc_storage")
    lmp = m.param("lmp", T)
    hot0 = m.param("hot0")
    power0 = m.param("power0")

    p_plant = m.var("plant_power", T, lb=pmin, ub=pmax)
    q_c = m.var("q_charge", T, ub=max_storage_mw)
    q_d = m.var("q_discharge", T, ub=max_storage_mw)
    hot = m.var("salt_inventory_hot", T, ub=tank_max_kg)

    kg_per_mwh = salt_flow_per_mw(fluid) * 3600.0  # kg salt per MWh of duty
    f_c = kg_per_mwh  # * q_c [MW] -> kg transferred in the hour
    # hot inventory balance (`constraint_salt_inventory_hot`)
    m.add_eq(hot[0:1] - hot0 - f_c * q_c[0:1] + f_c * q_d[0:1])
    if T > 1:
        m.add_eq(hot[1:] - hot[:-1] - f_c * q_c[1:] + f_c * q_d[1:])

    # flow limited by the inventory available at the START of the hour
    # (`constraint_salt_maxflow_hot/cold`)
    m.add_le(f_c * q_d[0:1] - hot0)
    if T > 1:
        m.add_le(f_c * q_d[1:] - hot[:-1])
    # cold inventory = tank_max - hot (constraint_salt_inventory eliminates
    # the cold variable exactly)
    m.add_le(f_c * q_c[0:1] - (tank_max_kg - hot0))
    if T > 1:
        m.add_le(f_c * q_c[1:] - (tank_max_kg - hot[:-1]))

    # ramping on plant power (`constraint_ramp_down/up`)
    m.add_le(p_plant[0:1] - power0 - ramp_mw)
    m.add_le(power0 - p_plant[0:1] - ramp_mw)
    if T > 1:
        m.add_le(p_plant[1:] - p_plant[:-1] - ramp_mw)
        m.add_le(p_plant[:-1] - p_plant[1:] - ramp_mw)

    if periodic_inventory:
        m.add_eq(hot[T - 1 : T] - hot0)

    net = p_plant + es_turbine_eff * q_d  # MW

    # linearized coal cost: coal duty = (duty_map)/(eff at design band);
    # boiler_eff varies 0.906..0.95 over [283,436] MW, so the sensitivity
    # at the design point gives an LP-exact cost
    eff0 = float(U.boiler_eff(U.MAX_BOILER_DUTY_MW))
    duty_coef = U.MAX_BOILER_DUTY_MW / U.MAX_POWER_MW
    fuel_per_mwh = U.COAL_PRICE_PER_J * 1e6 * 3600.0 / eff0  # $ per MWth-h
    fuel_cost = fuel_per_mwh * (duty_coef * p_plant + q_c)

    fixed_om_hr = float(U.plant_fixed_om_per_yr(U.MAX_POWER_MW)) / 8760.0
    var_om_mwh = float(U.plant_variable_om_per_yr(1.0)) / 8760.0
    op_cost = fuel_cost + var_om_mwh * net + fixed_om_hr

    revenue = lmp * net
    profit = (revenue - op_cost).sum()

    m.expression("net_power", net)
    m.expression("plant_power", p_plant + 0.0)
    m.expression("q_charge", q_c + 0.0)
    m.expression("q_discharge", q_d + 0.0)
    m.expression("salt_inventory_hot", hot + 0.0)
    m.expression("salt_inventory_cold", tank_max_kg - hot)
    m.expression("revenue", revenue.sum())
    m.expression("operating_cost", op_cost.sum())
    m.expression("profit", profit)
    m.expression("power_output", net)
    m.expression("total_cost", op_cost)

    m.maximize(profit * scale)
    return m


class MultiPeriodUsc:
    """Double-loop adapter (reference `multiperiod_double_loop_usc.py:68-403`
    `MultiPeriodUsc`): tracking model object over the integrated-storage LP
    with rolling (hot inventory, previous power) state."""

    def __init__(
        self,
        gen_name: str = "102_STEAM_3",
        pmin: float = U.MIN_POWER_MW + 1.0,
        pmax: float = U.MAX_POWER_MW,
        initial_hot_kg: float = 1_103_053.48,
    ):
        self.gen_name = gen_name
        self.pmin = pmin
        self.pmax = pmax
        self.state = {"hot0": initial_hot_kg, "power0": (pmin + pmax) / 2}
        self.result_list: List[dict] = []

    def build_program(self, T: int):
        m = build_usc_storage_model(T, pmin=self.pmin, pmax=self.pmax)
        # the Tracker builds its own deviation+total_cost objective from the
        # returned power expression and the "total_cost" named expr
        power = m._exprs["power_output"]
        self._handles: Dict = {}
        return m, power

    def get_params(self, date, hour, T: int) -> Dict[str, np.ndarray]:
        return {
            "lmp": np.zeros(T),
            "hot0": np.asarray(self.state["hot0"]),
            "power0": np.asarray(self.state["power0"]),
        }

    def advance_state(self, prog, x, params, n_implement: int):
        hot = np.asarray(prog.eval_expr("salt_inventory_hot", x, params))
        p = np.asarray(prog.eval_expr("plant_power", x, params))
        self.state["hot0"] = float(hot[n_implement - 1])
        self.state["power0"] = float(p[n_implement - 1])

    def record_results(self, prog, x, params, date, hour, **kw):
        net = np.asarray(prog.eval_expr("net_power", x, params))
        hot = np.asarray(prog.eval_expr("salt_inventory_hot", x, params))
        qc = np.asarray(prog.eval_expr("q_charge", x, params))
        qd = np.asarray(prog.eval_expr("q_discharge", x, params))
        for t in range(len(net)):
            self.result_list.append(
                {
                    "Generator": self.gen_name,
                    "Date": date,
                    "Hour": hour,
                    "Horizon [hr]": t,
                    "Power Output [MW]": net[t],
                    "Hot Salt [kg]": hot[t],
                    "Charge [MW]": qc[t],
                    "Discharge [MW]": qd[t],
                    **kw,
                }
            )

    def write_results(self, path):
        import os

        import pandas as pd

        pd.DataFrame(self.result_list).to_csv(
            os.path.join(path, "usc_tracker_detail.csv"), index=False
        )
