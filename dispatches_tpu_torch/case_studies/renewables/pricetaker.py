"""Renewables price-taker design optimization — wind/PV + battery + PEM +
H2 tank + H2 turbine hybrids (port of
`dispatches_tpu/case_studies/renewables/pricetaker.py`).

The hybrid topology is lowered ONCE to a parametric LP over the whole
horizon; LMP scenarios and design sweeps become parameter batches for the
batched interior-point solve, instead of one Pyomo rebuild + CBC/IPOPT
subprocess per scenario (`wind_battery_LMP.py`, `wind_battery_PEM_LMP.py`,
`wind_battery_PEM_tank_turbine_LMP.py`).

Objective structure (parity with `wind_battery_LMP.py:222-264` and
`wind_battery_PEM_LMP.py:243-300`):
  profit[t] = lmp[t]*1e-3*(grid[t] + batt_out[t] [+ turb_elec[t]])
              + h2_price*(h2 sold net of purchased)  [PEM/tank cases]
              - sum(unit fixed O&M / 8760 * capacity) - var costs
  annual = sum(profit) * 52 / (T/168)
  NPV = -capex(design vars) + PA * annual
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ...core.model import Model
from ...solvers.ipm import solve_lp
from ...units.battery import BatteryStorage
from ...units.pem import PEMElectrolyzer, H2_MOLS_PER_KG
from ...units.splitter import ElectricalSplitter
from ...units.tank import SimpleHydrogenTank
from ...units.turbine import HydrogenTurbine
from ...units.wind import SolarPV, WindPower
from . import params as P


@dataclasses.dataclass
class HybridDesign:
    """Topology + design-optimization switches for one build."""

    T: int
    with_battery: bool = True
    with_pem: bool = False
    with_tank_turbine: bool = False
    re_type: str = "wind"  # "wind" | "pv"
    wind_mw: float = P.FIXED_WIND_MW
    wind_mw_ub: float = P.WIND_MW_UB
    extant_wind: bool = True
    design_opt: object = True  # True | False | "PEM"
    batt_mw: float = P.FIXED_BATT_MW
    pem_mw: float = P.FIXED_PEM_MW
    turb_mw: float = P.TURB_P_MW
    tank_size_mol: float = P.FIXED_TANK_SIZE * P.H2_MOLS_PER_KG
    h2_price_per_kg: float = P.H2_PRICE_PER_KG
    initial_soc_fixed: Optional[float] = None  # None -> free (periodic only)
    # battery energy/power ratio (the reference's `--duration` sweep axis,
    # `run_pricetaker_battery_ratio_size.py:41-46`); enters both the SoC
    # dynamics and the $/kWh leg of the battery capex
    battery_duration_hrs: float = P.BATTERY_DURATION_HRS


def build_hybrid(design: HybridDesign):
    """Build the LP for one hybrid topology. Returns (CompiledLP, handles)."""
    T = design.T
    m = Model("renewable_hybrid")

    fix_sizes = design.design_opt is False
    batt_fixed = fix_sizes or design.design_opt == "PEM"

    recls = WindPower if design.re_type == "wind" else SolarPV
    re = recls(
        m,
        T,
        capacity=(design.wind_mw * 1e3 if design.extant_wind else None),
        capacity_ub=design.wind_mw_ub * 1e3,
        cf_param="wind_cf",
    )

    dests = ["grid"]
    if design.with_pem:
        dests.append("pem")
    if design.with_battery:
        dests.append("battery")
    split = ElectricalSplitter(m, T, inlet=re.electricity_out, outlet_list=dests)

    units: Dict[str, object] = {"re": re, "splitter": split}

    battery = None
    if design.with_battery:
        battery = BatteryStorage(
            m,
            T,
            duration=design.battery_duration_hrs,
            charging_eta=P.BATTERY_EFF,
            discharging_eta=P.BATTERY_EFF,
            degradation_rate=P.BATTERY_DEGRADATION,
            power_capacity=(design.batt_mw * 1e3 if batt_fixed else None),
            initial_soc=design.initial_soc_fixed,
            initial_throughput=0.0,
            periodic_soc=True,
        )
        m.add_eq(battery.elec_in - split.outlets["battery"])
        units["battery"] = battery

    pem = None
    tank = None
    turb = None
    if design.with_pem:
        pem = PEMElectrolyzer(m, T)
        m.add_eq(pem.electricity - split.outlets["pem"])
        units["pem"] = pem
        if fix_sizes:
            pem_cap = m.var("pem_system_capacity", lb=design.pem_mw * 1e3, ub=design.pem_mw * 1e3)
        else:
            pem_cap = m.var("pem_system_capacity")
        m.add_le(pem.electricity - pem_cap)
        units["pem_cap"] = pem_cap

    if design.with_tank_turbine:
        tank = SimpleHydrogenTank(
            m,
            T,
            inlet_mol=pem.h2_flow_mol,
            capacity_mol=(design.tank_size_mol if fix_sizes else None),
            periodic_holdup=True,
        )
        units["tank"] = tank
        turb = HydrogenTurbine(
            m,
            T,
            h2_feed_mol=tank.outlet_to_turbine + 0.0,
            capacity=(design.turb_mw * 1e3 if fix_sizes else None),
            min_flow_mol=P.H2_TURB_MIN_FLOW,
        )
        units["turbine"] = turb

    return m, units


def _npv_objective(m: Model, units, design: HybridDesign, T: int, h2_price=None):
    """Attach profit/annual-revenue/NPV expressions and the objective.

    `h2_price` (optional Param) replaces the constant ``design.h2_price_per_kg``
    so the H2 price becomes a differentiable input (solvers/diff.py)."""
    lmp = m.param("lmp", T)  # $/MWh
    re = units["re"]
    split = units["splitter"]
    n_weeks = T / (7 * 24)

    grid_out = split.outlets["grid"] + 0.0
    elec_sales = grid_out
    if "battery" in units:
        elec_sales = elec_sales + units["battery"].elec_out
    if "turbine" in units:
        elec_sales = elec_sales + units["turbine"].electricity

    revenue = 1e-3 * (lmp * elec_sales)  # $/hr rows

    # hourly fixed O&M, $/hr (reference divides annual $/kW-yr by 8760)
    om = (P.WIND_OP_COST / 8760.0) * re.system_capacity
    if "battery" in units:
        om = om + (P.BATT_OP_COST / 8760.0) * units["battery"].nameplate_power
    if "pem" in units:
        om = om + (P.PEM_OP_COST / 8760.0) * units["pem_cap"]
    if "tank" in units:
        # NOTE: the reference applies its $/kg tank cost coefficients directly
        # to the mol-denominated size variable (`...tank_turbine_LMP.py:346,384,415`);
        # we replicate that exactly for parity
        tank_size = units["tank"].tank_size
        if tank_size is None:
            om = om + (P.TANK_OP_COST / 8760.0) * design.tank_size_mol
        else:
            om = om + (P.TANK_OP_COST / 8760.0) * tank_size
    if "turbine" in units:
        turb = units["turbine"]
        om = om + (P.TURBINE_OP_COST / 8760.0) * turb.system_capacity
        om = om + P.TURBINE_VAR_COST * turb.electricity

    h2_rev = None
    price = design.h2_price_per_kg if h2_price is None else h2_price
    if "tank" in units:
        # H2 sold = pipeline outlet minus purchased feed
        # (`wind_battery_PEM_tank_turbine_LMP.py:400-405`)
        net_mol = units["tank"].outlet_to_pipeline - units["turbine"].purchased_h2
        h2_rev = (3600.0 / P.H2_MOLS_PER_KG) * (price * net_mol)
    elif "pem" in units:
        # all H2 sold at the gate (`wind_battery_PEM_LMP.py:281-283`)
        h2_rev = (3600.0 / P.H2_MOLS_PER_KG) * (price * units["pem"].h2_flow_mol)

    profit = revenue - om
    if h2_rev is not None:
        profit = profit + h2_rev

    # the 5-unit reference uses 52.143 weeks/yr in the NPV, the others 52
    weeks_per_year = 52.143 if "tank" in units else 52.0
    annual = (weeks_per_year / n_weeks) * profit.sum()

    capex = 0.0
    if not design.extant_wind:
        capex = capex + P.WIND_CAP_COST * re.system_capacity
    if "battery" in units:
        capex = capex + (
            P.BATT_CAP_COST_KW
            + P.BATT_CAP_COST_KWH * design.battery_duration_hrs
        ) * units["battery"].nameplate_power
    if "pem" in units:
        capex = capex + P.PEM_CAP_COST * units["pem_cap"]
    if "tank" in units and units["tank"].tank_size is not None:
        capex = capex + P.TANK_CAP_COST_PER_KG * units["tank"].tank_size
    if "turbine" in units:
        capex = capex + P.TURBINE_CAP_COST * units["turbine"].system_capacity

    npv = P.PA * annual - capex
    m.expression("annual_revenue", annual)
    # reported revenue streams use the reference's 52-weeks/yr reporting
    # convention in ALL cases (`wind_battery_PEM_tank_turbine_LMP.py:514-515`
    # reports at 52 even though its NPV annualizes at 52.143); for the tank
    # case "annual_rev_E" is the reference's elec *income* = sum of profit
    # excluding H2 revenue (`:479,515`), elsewhere it is pure elec revenue
    if h2_rev is not None:
        m.expression("annual_rev_h2", (52.0 / n_weeks) * h2_rev.sum())
    if "tank" in units:
        m.expression("annual_rev_E", (52.0 / n_weeks) * (revenue - om).sum())
    else:
        m.expression("annual_rev_E", (52.0 / n_weeks) * revenue.sum())
    m.expression("NPV", npv)
    m.maximize(npv * 1e-5)
    return m


def build_pricetaker(design: HybridDesign):
    """Full build: flowsheet + objective -> CompiledLP ready to instantiate."""
    m, units = build_hybrid(design)
    _npv_objective(m, units, design, design.T)
    return m.build(), units


def build_pricetaker_design(design: HybridDesign):
    """Parametric-design build for gradient-based sizing (solvers/diff.py).

    Each design size stays an LP variable but is *tied* to a named parameter
    by an equality constraint, and the H2 price becomes a parameter, so
    autograd of the optimal NPV w.r.t. ``(h2_price, capacities)`` flows
    through `instantiate` and the differentiable solve, in place of the
    reference's gradient-free rebuild-and-resolve design sweep
    (`wind_battery_LMP.py:172-267`).

    Extra params (beyond lmp/wind_cf): ``batt_kw``, ``pem_kw``, ``tank_mol``,
    ``turb_kw``, ``wind_kw`` (only when not extant), ``h2_price``, present
    for the units the topology includes. Returns (CompiledLP, units).
    """
    d = dataclasses.replace(design, design_opt=True)
    m, units = build_hybrid(d)
    if "battery" in units:
        m.add_eq(units["battery"].nameplate_power - m.param("batt_kw"))
    if "pem" in units:
        m.add_eq(units["pem_cap"] - m.param("pem_kw"))
    if "tank" in units and units["tank"].tank_size is not None:
        m.add_eq(units["tank"].tank_size - m.param("tank_mol"))
    if "turbine" in units:
        m.add_eq(units["turbine"].system_capacity - m.param("turb_kw"))
    if not d.extant_wind:
        m.add_eq(units["re"].system_capacity - m.param("wind_kw"))
    h2p = m.param("h2_price") if "pem" in units else None
    _npv_objective(m, units, d, d.T, h2_price=h2p)
    return m.build(), units


def wind_battery_optimize(
    n_time_points: int,
    lmps: np.ndarray,
    wind_cfs: np.ndarray,
    batt_mw: float = P.FIXED_BATT_MW,
    wind_mw: float = P.FIXED_WIND_MW,
    design_opt: bool = True,
    extant_wind: bool = True,
    battery_duration_hrs: float = P.BATTERY_DURATION_HRS,
    device="cuda",
    **solver_kw,
):
    """Parity entry point for `wind_battery_optimize` (`wind_battery_LMP.py:172`)."""
    design = HybridDesign(
        T=n_time_points,
        with_battery=True,
        wind_mw=wind_mw,
        batt_mw=batt_mw,
        design_opt=design_opt,
        extant_wind=extant_wind,
        initial_soc_fixed=0.0,  # `wind_battery_LMP.py:206`
        battery_duration_hrs=battery_duration_hrs,
    )
    prog, units = build_pricetaker(design)
    p = {
        "lmp": np.asarray(lmps[:n_time_points], np.float64),
        "wind_cf": np.asarray(wind_cfs[:n_time_points], np.float64),
    }
    lp = prog.instantiate(p, device=device)
    sol = solve_lp(lp, **solver_kw)
    return _results(prog, sol, p, design)


def wind_battery_pem_optimize(
    time_points: int,
    lmps: np.ndarray,
    wind_cfs: np.ndarray,
    h2_price_per_kg: float = 2.5,
    design_opt: object = "PEM",
    batt_mw: float = 0.0,
    device="cuda",
    **solver_kw,
):
    """Parity entry point for `wind_battery_pem_optimize`
    (`wind_battery_PEM_LMP.py:182`)."""
    design = HybridDesign(
        T=time_points,
        with_battery=True,
        with_pem=True,
        design_opt=design_opt,
        batt_mw=batt_mw,
        h2_price_per_kg=h2_price_per_kg,
        initial_soc_fixed=None,  # PEM case leaves initial SoC free
    )
    prog, units = build_pricetaker(design)
    p = {
        "lmp": np.asarray(lmps[:time_points], np.float64),
        "wind_cf": np.asarray(wind_cfs[:time_points], np.float64),
    }
    lp = prog.instantiate(p, device=device)
    sol = solve_lp(lp, **solver_kw)
    return _results(prog, sol, p, design)


def wind_battery_pem_tank_turb_optimize(
    n_time_points: int,
    lmps: np.ndarray,
    wind_cfs: np.ndarray,
    h2_price_per_kg: float = 2.0,
    design_opt: bool = True,
    device="cuda",
    **solver_kw,
):
    """Parity entry point for `wind_battery_pem_tank_turb_optimize`
    (`wind_battery_PEM_tank_turbine_LMP.py:280`)."""
    design = HybridDesign(
        T=n_time_points,
        with_battery=True,
        with_pem=True,
        with_tank_turbine=True,
        design_opt=design_opt,
        h2_price_per_kg=h2_price_per_kg,
        initial_soc_fixed=None,
    )
    prog, units = build_pricetaker(design)
    p = {
        "lmp": np.asarray(lmps[:n_time_points], np.float64),
        "wind_cf": np.asarray(wind_cfs[:n_time_points], np.float64),
    }
    lp = prog.instantiate(p, device=device)
    sol = solve_lp(lp, **solver_kw)
    return _results(prog, sol, p, design)


def _results(prog, sol, p, design: HybridDesign):
    from ...runtime.telemetry import batch_stats

    out = {
        "converged": bool(sol.converged),
        "iterations": int(sol.iterations),
        "solver_stats": batch_stats(sol),
        "NPV": float(prog.eval_expr("NPV", sol.x, p)),
        "annual_revenue": float(prog.eval_expr("annual_revenue", sol.x, p)),
        "annual_rev_E": float(prog.eval_expr("annual_rev_E", sol.x, p)),
    }
    if "annual_rev_h2" in prog._exprs:
        out["annual_rev_h2"] = float(prog.eval_expr("annual_rev_h2", sol.x, p))
    for nm, key in [
        ("battery.nameplate_power", "batt_kw"),
        ("pem_system_capacity", "pem_kw"),
        ("h2_tank.tank_size", "tank_mol"),
        ("h2_turbine.system_capacity", "turb_kw"),
        ("wind.system_capacity", "wind_kw"),
        ("pv.system_capacity", "wind_kw"),
    ]:
        if nm in prog._vars:
            out[key] = float(prog.extract(nm, sol.x))
    out["solution"] = sol
    out["program"] = prog
    return out
