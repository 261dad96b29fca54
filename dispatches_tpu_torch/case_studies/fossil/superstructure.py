"""Charge/discharge storage design superstructure for the USC plant (port
of `dispatches_tpu/case_studies/fossil/superstructure.py`).

Counterpart of the reference's GDP superstructures
(`storage/charge_design_ultra_supercritical_power_plant.py`: storage-fluid
disjuncts `:140-146` + steam-source disjuncts `:148-151` combined through
a `Disjunction` `:434-455` and solved with GDPopt; `discharge_design_...py`
mirrors it). A GDP over a few discrete alternatives is an enumeration:
every (fluid x steam-leg) leaf is the same parametric dispatch LP plus an
algebraic sizing model, and the best leaf by net annual value is picked.

Per-leaf model:
  - storage fluid in {solar_salt, hitec_salt, thermal_oil} with property
    correlations from `properties/salts.py` (hot temperature capped at the
    fluid's stability limit)
  - steam source in {HP, IP} (charge) / steam sink in {BFW, Condensate}
    (discharge) changing the steam-side temperatures and the heat grade
  - HX area from Q = U A LMTD with a Dittus-Boelter-style fluid-side film
    scaling; Seider floating-head cost curve
  - salt inventory + storage-tank capital at the reference's unit prices
  - operating profit from the fossil multiperiod dispatch LP (solved on
    `device`) over a representative day, annualized
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ...properties.salts import FLUIDS, FluidProps, SolarSalt
from ...solvers.ipm import solve_lp
from . import usc_plant as U
from .multiperiod import build_usc_storage_model, salt_flow_per_mw
from .pricetaker import MOD_RTS_LMP_24

STEAM_SOURCES = {
    # (T_steam_in [K], P [Pa], heat-grade factor: extra boiler duty per MWh
    # of charge duty; IP/reheat steam is marginally cheaper heat)
    "HP": (866.0, 24.1e6, 1.00),
    "IP": (866.0, 7.8e6, 0.98),
}
STEAM_SINKS = {
    # discharge-side feedwater sink: (T_feedwater_in [K], es-turbine eff)
    "BFW": (513.0, U.ES_TURBINE_EFF),
    "Condensate": (350.0, 0.32),
}

H_STEAM_FILM = 4000.0  # W/m^2/K, condensing/boiling steam side
STORAGE_HOURS = 6.0  # tank sized for 6 h at max duty (reference design basis)


@dataclasses.dataclass
class DesignLeaf:
    fluid: str
    steam_leg: str  # source (charge) or sink (discharge)
    mode: str  # "charge" | "discharge"
    hx_area_m2: float
    hx_cost: float
    salt_inventory_kg: float
    salt_cost: float
    tank_cost: float
    capital_annualized: float
    annual_profit: float
    net_annual_value: float
    T_hot: float


def _film_coefficient(fluid: FluidProps, T_film: float) -> float:
    """Dittus-Boelter-grouped fluid-side film coefficient at a fixed
    reference geometry/velocity: h ~ k^0.6 cp^0.4 / mu^0.4, anchored so
    solar salt at 700 K gives ~1200 W/m^2/K."""
    k = float(fluid.therm_cond(T_film))
    cp = float(fluid.cp_mass(T_film))
    mu = float(fluid.visc_d(T_film))
    group = k**0.6 * cp**0.4 / mu**0.4
    g0 = (
        float(SolarSalt.therm_cond(700.0)) ** 0.6
        * float(SolarSalt.cp_mass(700.0)) ** 0.4
        / float(SolarSalt.visc_d(700.0)) ** 0.4
    )
    return 1200.0 * group / g0


def _lmtd(th_in, th_out, tc_in, tc_out) -> float:
    d1 = max(th_in - tc_out, 1.0)
    d2 = max(th_out - tc_in, 1.0)
    if abs(d1 - d2) < 1e-9:
        return d1
    return (d1 - d2) / math.log(d1 / d2)


def _seider_hx_cost(area_m2: float) -> float:
    """Seider floating-head HX purchase cost, CE-indexed."""
    a_ft2 = max(area_m2, 14.0) * 10.7639
    ln_a = math.log(a_ft2)
    base = math.exp(11.0545 - 0.9228 * ln_a + 0.09861 * ln_a**2)
    return base * U.CE_INDEX


def _tank_cost(fluid: FluidProps, inventory_kg: float, T_hot: float) -> float:
    """Storage tank: shell material + insulation + foundation at the
    reference unit prices (3.5 $/kg steel, 235 $/m^2, 1210 $/m^2)."""
    rho = float(fluid.dens_mass(T_hot))
    vol = inventory_kg / rho
    # cylinder with L/D = 0.325 (reference data_storage_tank)
    d = (4.0 * vol / (math.pi * 0.325)) ** (1.0 / 3.0)
    length = 0.325 * d
    a_side = math.pi * d * length
    a_roof = math.pi * d**2 / 4.0
    steel_kg = (a_side + 2 * a_roof) * 0.039 * 7800.0
    return 3.5 * steel_kg + 235.0 * (a_side + a_roof) + 1210.0 * a_roof


def evaluate_leaf(
    fluid_name: str,
    steam_leg: str,
    mode: str = "charge",
    q_max_mw: float = U.MAX_STORAGE_DUTY_MW,
    lmp_day: Optional[np.ndarray] = None,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
) -> DesignLeaf:
    fluid = FLUIDS[fluid_name]
    legs = STEAM_SOURCES if mode == "charge" else STEAM_SINKS

    T_hot = min(U.T_SALT_HOT, fluid.T_max - 5.0)
    T_cold = max(U.T_SALT_COLD, fluid.T_min + 5.0)

    eta_es = U.ES_TURBINE_EFF
    if mode == "charge":
        T_steam, _p, grade = legs[steam_leg]
        # condensing steam vs counter-current fluid heating T_cold -> T_hot
        lm = _lmtd(T_steam, T_steam - 180.0, T_cold, T_hot)
    else:
        # each discharge sink has its own ES-turbine efficiency (the
        # reference's disjunct-specific turbine models); it must reach the
        # dispatch LP's net-power term or all leaves score identically
        T_fw, eta_es = legs[steam_leg]
        lm = _lmtd(T_hot, T_cold, T_fw, min(T_hot - 10.0, 700.0))

    T_film = 0.5 * (T_hot + T_cold)
    h_fluid = _film_coefficient(fluid, T_film)
    u_overall = 1.0 / (1.0 / h_fluid + 1.0 / H_STEAM_FILM)
    area = q_max_mw * 1e6 / (u_overall * lm)

    kg_per_mwh = salt_flow_per_mw(fluid, T_hot, T_cold) * 3600.0
    inventory = STORAGE_HOURS * q_max_mw * kg_per_mwh

    hx_cost = _seider_hx_cost(area)
    salt_cost = U.SALT_PRICE[fluid_name] * inventory
    tank_cost = _tank_cost(fluid, inventory, T_hot)
    cap_yr = (hx_cost + salt_cost + tank_cost) / U.NUM_YEARS

    # representative-day dispatch profit with this fluid's transfer ratio
    lmp = MOD_RTS_LMP_24 if lmp_day is None else np.asarray(lmp_day, float)
    T = len(lmp)
    prog = build_usc_storage_model(
        T,
        fluid=fluid,
        tank_max_kg=inventory,
        max_storage_mw=q_max_mw,
        periodic_inventory=True,
        es_turbine_eff=eta_es,
    ).build()
    params = {
        "lmp": lmp,
        "hot0": np.asarray(inventory / 2.0),
        "power0": np.asarray(359.5),
    }
    sol = solve_lp(prog.instantiate(params, dtype=dtype, device=device), **solver_kw)
    x = sol.x.cpu()
    day_profit = float(prog.eval_expr("profit", x, params))
    annual_profit = day_profit * 365.0
    if mode == "charge":
        # heat-grade correction on the fuel side of charge duty
        qc = float(prog.eval_expr("q_charge", x, params).sum())
        eff0 = float(U.boiler_eff(U.MAX_BOILER_DUTY_MW))
        fuel_per_mwh = U.COAL_PRICE_PER_J * 1e6 * 3600.0 / eff0
        annual_profit += 365.0 * (1.0 - grade) * fuel_per_mwh * qc

    return DesignLeaf(
        fluid=fluid_name,
        steam_leg=steam_leg,
        mode=mode,
        hx_area_m2=area,
        hx_cost=hx_cost,
        salt_inventory_kg=inventory,
        salt_cost=salt_cost,
        tank_cost=tank_cost,
        capital_annualized=cap_yr,
        annual_profit=annual_profit,
        net_annual_value=annual_profit - cap_yr,
        T_hot=T_hot,
    )


def solve_superstructure(
    mode: str = "charge",
    fluids: Optional[List[str]] = None,
    legs: Optional[List[str]] = None,
    **kw,
) -> Dict:
    """Enumerate all (fluid x steam-leg) disjunct combinations and pick the
    best by net annual value: the deterministic equivalent of the
    reference's GDPopt solve over its Disjunction."""
    fluids = fluids or list(FLUIDS)
    legs = legs or list(STEAM_SOURCES if mode == "charge" else STEAM_SINKS)
    leaves = [evaluate_leaf(f, s, mode=mode, **kw) for f in fluids for s in legs]
    best = max(leaves, key=lambda leaf: leaf.net_annual_value)
    return {"best": best, "leaves": leaves}
