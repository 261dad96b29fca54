"""PV + battery + PEM + H2-tank + blended NG/H2-turbine load-following design
(port of `dispatches_tpu/case_studies/renewables/solar_hydrogen.py`).

Counterpart of the reference's
`case_studies/renewables_case/solar_battery_hydrogen.py` and its input
module `solar_battery_hydrogen_inputs.py`: a behind-the-meter hybrid that
must meet a load profile (with grid purchases and sales), carry an operating
reserve, satisfy a firm-capacity requirement, and maximise the NPV of H2
pipeline sales minus grid, NG and O&M costs. The turbine burns an H2/NG
blend set by ``h2_blend_ratio`` (`solar_battery_hydrogen.py:147-156`); with
``h2_blend_ratio=None`` the blend is a run-time parameter, so designs that
differ only in their blend are lanes of one batch (the same optimum as
each fixed-ratio model).

The reference builds one Pyomo block per hour (`MultiPeriodModel` +
`clone()`, `solar_battery_hydrogen.py:178-205`) and calls Xpress/CBC/IPOPT
(`:426-437`); here the whole horizon is one parametric LP lowered once, and
(load, reserve, LMP, NG price, PV CF) are parameter vectors, so scenario
sweeps are a leading parameter axis. Solves run on `device`.

The turbine's cyclic ramp limits link the horizon's last hour to its first
(`:314-319`). With ``SolarHydrogenDesign.ramp_wrap_border=True`` that link
goes through one scalar variable (the last hour's turbine output), so no
row spans the first and the last time block and the LP is time-banded for
`solvers.structured.extract_time_structure` at any horizon; the feasible
set and the optimum are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.model import Model
from ...solvers.ipm import solve_lp
from ...units.battery import BatteryStorage
from ...units.pem import PEMElectrolyzer
from ...units.splitter import ElectricalSplitter
from ...units.tank import SimpleHydrogenTank
from ...units.wind import SolarPV
from . import params as P

# --- constants from `solar_battery_hydrogen_inputs.py` (cited lines) -------
TAX_INCENTIVES = 0.50  # :29
PV_CAP_COST = 1420 * TAX_INCENTIVES  # $/kW-AC :31
PV_OP_COST = 21.0  # $/kW-AC-yr :32
BATT_CAP_COST_KW = 236.36 * TAX_INCENTIVES  # :33
BATT_CAP_COST_KWH = 254.83 * TAX_INCENTIVES  # :34
PEM_CAP_COST_KW = 1240.0  # :35
PEM_OP_COST = 47.9  # :36
PEM_VAR_COST = 1.3 / 1000  # $/kWh :37
TURBINE_CAP_COST = 1320.0  # :38
TURBINE_OP_COST = 11.65  # :39
TURBINE_VAR_COST = 3.0 / 1000  # :40
TANK_CAP_COST_PER_KG = 500.0  # :41
TANK_OP_COST = 0.17 * TANK_CAP_COST_PER_KG  # :42

H2_LHV = 33.391  # kWh/kg :57
NG_LHV = 13.09  # kWh/kg :58
H2_TURB_CONV = 0.39 * H2_LHV  # kWh/kg H2 :59
NG_TURB_CONV = 0.33 * NG_LHV  # kWh/kg NG :60
MMBTU_TO_NG_KG = 20.133  # kg NG per MMBtu :61

S_PER_TS = 3600.0  # :73 (timestep_hrs=1)
WEEKS_PER_YEAR = 52.143  # `solar_battery_hydrogen.py:370`


@dataclasses.dataclass
class SolarHydrogenDesign:
    """Sizing/operation switches — analogue of `re_h2_parameters`
    (`solar_battery_hydrogen_inputs.py:78+`)."""

    T: int
    pv_mw: float = 200.0  # existing PV; capex applies only to additions :64
    pv_mw_ub: float = 1e4
    batt_mw: float = 100.0
    batt_hr: float = 4.0
    pem_mw: float = 100.0
    tank_size_kg: float = 1e5
    turb_mw: float = 100.0
    # kg H2 per kg fuel (:26); None makes it the run-time parameter `h2_blend`
    h2_blend_ratio: Optional[float] = 1.0
    turbine_min_mw: float = 0.0  # :68
    turbine_ramp_mw_per_min: float = 100.0  # :69 ("unlimited")
    capacity_requirement_mw: float = 100.0  # :65
    capacity_credit_battery: float = 0.33  # :66
    h2_price_per_kg: float = 2.5  # :44
    design_opt: bool = True
    max_sales_mw: Optional[float] = None
    max_purchases_mw: Optional[float] = None
    # route the cyclic ramp rows through a border variable (time-banded LP)
    ramp_wrap_border: bool = False


def build_solar_hydrogen(design: SolarHydrogenDesign):
    """Lower the load-following hybrid to a parametric LP.

    Parameters: ``pv_cf`` (T,), ``load`` (kW, T,), ``reserve_1hr`` (kW, T,
    trailing-hour requirement precomputed on host, mirroring
    `solar_battery_hydrogen.py:346-348`), ``lmp`` ($/MWh, T,), ``ng_price``
    ($/MMBtu, T,).
    """
    T = design.T
    d = design
    m = Model("pv_battery_hydrogen")
    fixed = not d.design_opt

    pv = SolarPV(
        m,
        T,
        capacity=(d.pv_mw * 1e3 if fixed else None),
        capacity_ub=d.pv_mw_ub * 1e3,
        cf_param="pv_cf",
    )
    if not fixed:
        # capacity = existing + additions; capex only on additions
        # (`solar_battery_hydrogen.py:212-214,246-252`)
        m.add_ge(pv.system_capacity - d.pv_mw * 1e3)

    split = ElectricalSplitter(
        m, T, inlet=pv.electricity_out, outlet_list=["grid", "pem", "battery"]
    )

    battery = BatteryStorage(
        m,
        T,
        degradation_rate=0.0,  # `solar_battery_hydrogen.py:175`
        duration=None,  # independent energy rating (0.5-8 hr constraint below)
        power_capacity=(d.batt_mw * 1e3 if fixed else None),
        energy_capacity=(d.batt_mw * d.batt_hr * 1e3 if fixed else None),
        initial_soc=None,  # free cyclic SoC (periodic linking :52-62)
        periodic_soc=True,
    )
    m.add_eq(battery.elec_in - split.outlets["battery"])
    if not fixed:
        # 0.5 hr <= E/P <= 8 hr (`solar_battery_hydrogen.py:240-242`)
        m.add_ge(battery.nameplate_energy - 0.5 * battery.nameplate_power)
        m.add_le(battery.nameplate_energy - 8.0 * battery.nameplate_power)

    pem = PEMElectrolyzer(m, T)
    m.add_eq(pem.electricity - split.outlets["pem"])
    pem_cap = m.var(
        "pem_system_capacity",
        lb=(d.pem_mw * 1e3 if fixed else 0.0),
        ub=(d.pem_mw * 1e3 if fixed else 1e7),
    )
    m.add_le(pem.electricity - pem_cap)

    tank = SimpleHydrogenTank(
        m,
        T,
        inlet_mol=pem.h2_flow_mol,
        initial_holdup=None,  # free cyclic inventory
        periodic_holdup=True,
        capacity_mol=(d.tank_size_kg * P.H2_MOLS_PER_KG if fixed else None),
    )

    # --- blended NG/H2 turbine (`solar_battery_hydrogen.py:147-159`) -------
    r = d.h2_blend_ratio
    h2_kg = tank.outlet_to_turbine * (S_PER_TS / P.H2_MOLS_PER_KG)  # kg/step
    blend = None
    if r is None:
        # the blend is the run-time parameter `h2_blend` (lanes of one
        # batch may burn different blends): blend * ng = (1 - blend) * h2
        # is the fixed-ratio row for 0 < blend < 1, forbids NG at 1 and
        # the H2 draw at 0
        blend = m.param("h2_blend")
        ng_kg = m.var("ng_kg", T) + 0.0
        m.add_eq(blend * ng_kg - h2_kg + blend * h2_kg)
    elif r == 0.0:
        # pure NG: no H2 draw, NG burn is a free decision variable
        m.add_eq(tank.outlet_to_turbine + 0.0)
        ng_kg = m.var("ng_kg", T) + 0.0
    elif r == 1.0:
        ng_kg = None  # pure H2
    else:
        ng_kg = h2_kg * (1.0 / r - 1.0)

    turb_elec = m.var("turb_elec", T)  # kW
    fuel_elec = h2_kg * H2_TURB_CONV
    if ng_kg is not None:
        fuel_elec = fuel_elec + ng_kg * NG_TURB_CONV
    m.add_eq(turb_elec - fuel_elec)

    turb_cap = m.var(
        "turb_system_capacity",
        lb=d.turb_mw * 1e3,  # lb at existing size (`:223`)
        ub=(d.turb_mw * 1e3 if fixed else 1e8),
    )
    m.add_le(turb_elec - turb_cap)
    if d.turbine_min_mw > 0:
        m.add_ge(turb_elec - d.turbine_min_mw * 1e3)
    # cyclic ramp limits (`solar_battery_hydrogen.py:314-319`; prev of block 0
    # is the final block)
    ramp = d.turbine_ramp_mw_per_min * 1e3
    m.add_le(turb_elec[1:] - turb_elec[:-1] - ramp)
    m.add_le(turb_elec[:-1] - turb_elec[1:] - ramp)
    if d.ramp_wrap_border:
        wrap = m.var("turb_elec_wrap")  # = turb_elec[T - 1]
        m.add_eq(wrap - turb_elec[T - 1 : T])
        last = wrap + 0.0
    else:
        last = turb_elec[T - 1 : T]
    m.add_le(turb_elec[0:1] - last - ramp)
    m.add_le(last - turb_elec[0:1] - ramp)

    # --- load, grid exchange, reserves (`solar_battery_hydrogen.py:320-355`)
    load = m.param("load", T)  # kW
    reserve = m.param("reserve_1hr", T)  # kW
    lmp = m.param("lmp", T)  # $/MWh
    ng_price = m.param("ng_price", T)  # $/MMBtu

    purchase = m.var("grid_purchase", T)
    sales = m.var("grid_sales", T)
    if d.max_sales_mw is not None:
        m.add_le(sales - purchase - d.max_sales_mw * 1e3)
        m.add_le(sales - d.max_sales_mw * 1e3)
    if d.max_purchases_mw is not None:
        m.add_le(purchase - sales - d.max_purchases_mw * 1e3)
        m.add_le(purchase - d.max_purchases_mw * 1e3)

    output_power = split.outlets["grid"] + battery.elec_out + turb_elec
    m.add_eq(output_power + purchase - sales - load)

    # reserve components
    batt_res = m.var("battery_reserve", T)
    m.add_le(batt_res - battery.nameplate_power)
    m.add_le(batt_res - battery.soc)
    turb_res = m.var("turbine_reserve", T)
    m.add_le(turb_res - turb_cap + turb_elec)
    if r is None:
        # the stored-fuel row below times the blend: vacuous at blend 0,
        # where the fixed-ratio model has no such row
        m.add_le(blend * turb_res - (NG_TURB_CONV / P.H2_MOLS_PER_KG) * tank.holdup
                 - ((H2_TURB_CONV - NG_TURB_CONV) / P.H2_MOLS_PER_KG) * (blend * tank.holdup))
    elif r > 0:
        # stored-fuel energy limit on turbine reserve (`:336-341`)
        fuel_conv = (H2_TURB_CONV + (1.0 / r - 1.0) * NG_TURB_CONV) / P.H2_MOLS_PER_KG
        m.add_le(turb_res - tank.holdup * fuel_conv)
    excess_pv = pv.cf * pv.system_capacity - pv.electricity
    total_res = batt_res + turb_res + excess_pv + pem.electricity
    m.add_ge(total_res - reserve)

    # firm-capacity requirement (`:357-358`)
    m.add_ge(
        d.capacity_credit_battery * battery.nameplate_power
        + turb_cap
        - d.capacity_requirement_mw * 1e3
    )

    # --- economics (`solar_battery_hydrogen.py:245-290,360-373`) -----------
    h2_rev = (d.h2_price_per_kg * S_PER_TS / P.H2_MOLS_PER_KG) * tank.outlet_to_pipeline
    grid_cost = 1e-3 * (lmp * purchase) - 1e-3 * (lmp * sales)
    var_cost = PEM_VAR_COST * pem.electricity + TURBINE_VAR_COST * turb_elec
    if ng_kg is not None:
        ng_cost = (ng_price * ng_kg) * (1.0 / MMBTU_TO_NG_KG)
        var_cost = var_cost + ng_cost

    tank_kg = (
        (1.0 / P.H2_MOLS_PER_KG) * tank.tank_size
        if tank.tank_size is not None
        else d.tank_size_kg
    )
    fixed_cost = (
        PV_OP_COST * pv.system_capacity
        + PEM_OP_COST * pem_cap
        + TANK_OP_COST * tank_kg
        + TURBINE_OP_COST * turb_cap
    )

    n_weeks = T / (7 * 24)
    annual = (WEEKS_PER_YEAR / n_weeks) * (
        h2_rev.sum() - grid_cost.sum() - var_cost.sum()
    ) - fixed_cost

    capex = (
        PV_CAP_COST * (pv.system_capacity - d.pv_mw * 1e3)
        + BATT_CAP_COST_KW * battery.nameplate_power
        + BATT_CAP_COST_KWH * battery.nameplate_energy
        + PEM_CAP_COST_KW * pem_cap
        + TANK_CAP_COST_PER_KG * tank_kg
        + TURBINE_CAP_COST * (turb_cap - d.turb_mw * 1e3)
    ) if not fixed else 0.0

    npv = P.PA * annual - capex
    m.expression("annual_revenue", annual)
    m.expression("annual_rev_h2", (WEEKS_PER_YEAR / n_weeks) * h2_rev.sum())
    m.expression("NPV", npv)
    m.maximize(npv * 1e-3)  # `:372` scales the objective by 1e-3

    units = {
        "pv": pv,
        "splitter": split,
        "battery": battery,
        "pem": pem,
        "pem_cap": pem_cap,
        "tank": tank,
        "turb_elec": turb_elec,
        "turb_cap": turb_cap,
    }
    return m, units


def reserve_over_1hr(reserve_kw: np.ndarray, timestep_hrs: float = 1.0):
    """Trailing-hour reserve requirement (`solar_battery_hydrogen.py:346-348`):
    requirement at step i is the max requirement over the previous hour.

    NOTE: the window deliberately EXCLUDES the current step (slice ends at i),
    replicating the reference's ``max(reserve[max(i-k, 0):i])`` exactly — at
    hourly resolution the enforced requirement is the previous hour's. Pass
    the raw requirement directly as the ``reserve_1hr`` parameter to enforce
    the current hour instead.
    """
    res = np.asarray(reserve_kw, float)
    k = max(int(1 / timestep_hrs), 1)
    out = np.empty_like(res)
    out[0] = res[0]
    for i in range(1, len(res)):
        out[i] = res[max(i - k, 0) : i].max()
    return out


def solar_hydrogen_params(
    n_time_points: int,
    pv_cfs: np.ndarray,
    loads_mw: np.ndarray,
    reserves_mw: np.ndarray,
    lmps: np.ndarray,
    ng_prices: np.ndarray,
):
    """The LP's parameters from the reference's input series (loads and
    reserves in MW, converted to kW; the trailing-hour reserve computed on
    the host), as numpy arrays of length `n_time_points`."""
    T = n_time_points
    return {
        "pv_cf": np.asarray(pv_cfs, float)[:T],
        "load": np.asarray(loads_mw, float)[:T] * 1e3,
        "reserve_1hr": reserve_over_1hr(np.asarray(reserves_mw, float)[:T] * 1e3),
        "lmp": np.asarray(lmps, float)[:T],
        "ng_price": np.asarray(ng_prices, float)[:T],
    }


def pv_battery_hydrogen_optimize(
    n_time_points: int,
    pv_cfs: np.ndarray,
    loads_mw: np.ndarray,
    reserves_mw: np.ndarray,
    lmps: np.ndarray,
    ng_prices: np.ndarray,
    design: Optional[SolarHydrogenDesign] = None,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
):
    """Parity entry point for `pv_battery_hydrogen_optimize`
    (`solar_battery_hydrogen.py:375-465`): the dense LP on `device`; the
    solution is read on the host once."""
    T = n_time_points
    design = design or SolarHydrogenDesign(T=T)
    prog, units = build_pricetaker(design)
    p = solar_hydrogen_params(T, pv_cfs, loads_mw, reserves_mw, lmps, ng_prices)
    sol = solve_lp(prog.instantiate(p, dtype=dtype, device=device), **solver_kw)
    return solar_hydrogen_results(prog, sol, p)


def solar_hydrogen_results(prog, sol, p):
    """The entry point's result dict from one solved lane (`sol` an IPMSolution
    of the program's reduced columns, `p` its parameters)."""
    x = sol.x.detach().cpu()
    hp = {k: torch.as_tensor(v, dtype=x.dtype) for k, v in p.items()}
    out = {
        "converged": bool(sol.converged),
        "NPV": float(prog.eval_expr("NPV", x, hp)),
        "annual_revenue": float(prog.eval_expr("annual_revenue", x, hp)),
        "annual_rev_h2": float(prog.eval_expr("annual_rev_h2", x, hp)),
        "solution": sol,
        "program": prog,
    }
    for nm, key in [
        ("pv.system_capacity", "pv_kw"),
        ("battery.nameplate_power", "batt_kw"),
        ("battery.nameplate_energy", "batt_kwh"),
        ("pem_system_capacity", "pem_kw"),
        ("h2_tank.tank_size", "tank_mol"),
        ("turb_system_capacity", "turb_kw"),
    ]:
        if nm in prog._vars:
            out[key] = float(prog.extract(nm, x))
    out["turb_elec_kw"] = prog.extract("turb_elec", x).numpy()
    out["grid_purchase_kw"] = prog.extract("grid_purchase", x).numpy()
    out["grid_sales_kw"] = prog.extract("grid_sales", x).numpy()
    return out


def build_pricetaker(design: SolarHydrogenDesign):
    """Build + objective -> CompiledLP (same entry shape as the other
    renewables entry points)."""
    m, units = build_solar_hydrogen(design)
    return m.build(), units
