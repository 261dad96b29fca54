"""Simple Rankine cycle: boiler -> turbine -> condenser -> BFW pump (port of
`dispatches_tpu/case_studies/rankine/flowsheet.py`).

The reference's toy coal plant (`simple_rankine_cycle.py:64-360`): the
IDAES Heater/PressureChanger/Iapws95 flowsheet with fixed intensive
specifications collapses to a closed-form evaluation over the IF97 steam
properties (`properties/steam.py`). Every spec the reference fixes
(`set_inputs`, `:264-299`) is an argument; the returned state is
differentiable in the flow (and in any spec given as a tensor).

With intensive states fixed, turbine/pump work and boiler/condenser duties
are exactly linear in the boiler feed-water flow: the design/operation
coupling enters only through the capacity-factor-dependent boiler
efficiency (`create_model`, `:168-175`). The per-kg terms
(`specific_energies`) depend on the spec alone, so a spec of plain numbers
evaluates them once (memoized, float64 CPU scalars) and a solve that calls
`solve_rankine` inside its objective does the steam inversions once, not
on every evaluation.

Economics parity: coal (HHV 27,113 kJ/kg at $51.96/ton, `:491-520`) plus
condenser cooling water ($0.19/kgal across a 289.15 -> 300.15 K utility,
`:446-489`), heat rate `:525-533`; capital cost by power-law scaling on
the same cost drivers as `add_capital_cost` (`:348-432`).
"""
from __future__ import annotations

import dataclasses
import functools
import numbers
from typing import NamedTuple

import torch

from ...properties import steam

MW_WATER = 0.01801528  # kg/mol
GEN_LOSS = 0.95  # net = 0.95 * gross (`simple_rankine_cycle.py:150-153`)


@dataclasses.dataclass
class RankineSpec:
    """The fixed intensive specifications of `set_inputs` (`:264-299`)."""

    bfw_pressure: float = 24.23e6  # Pa
    boiler_inlet_T: float = 563.6  # K
    boiler_outlet_T: float = 866.5  # K
    turbine_outlet_P: float = 2e6  # Pa (ratioP = 2e6/24.23e6)
    eta_turbine: float = 0.85
    condenser_outlet_P: float = 1.05e6  # Pa
    condenser_outlet_T: float = 311.0  # K
    eta_pump: float = 0.80
    closed_loop: bool = True
    heat_recovery: bool = False
    coal_hhv_kj_kg: float = 27113.0
    coal_price_per_ton: float = 51.96
    include_cooling_cost: bool = True


class RankineState(NamedTuple):
    gross_power_w: torch.Tensor
    net_power_w: torch.Tensor
    boiler_duty_w: torch.Tensor
    condenser_duty_w: torch.Tensor  # negative (heat removed)
    turbine_work_w: torch.Tensor  # positive = produced
    pump_work_w: torch.Tensor  # positive = consumed
    boiler_eff: torch.Tensor
    cycle_efficiency_pct: torch.Tensor
    operating_cost_per_hr: torch.Tensor
    heat_rate_btu_kwh: torch.Tensor
    coal_flow_ton_hr: torch.Tensor


def _specific_energies(spec: RankineSpec):
    h_steam = steam.props_vapor(spec.bfw_pressure, spec.boiler_outlet_T).h
    exp = steam.turbine_expansion(
        spec.bfw_pressure, spec.boiler_outlet_T, spec.turbine_outlet_P, spec.eta_turbine
    )
    h_cond_out = steam.props_liquid(spec.condenser_outlet_P, spec.condenser_outlet_T).h
    w_pump = steam.pump_work(
        spec.condenser_outlet_P, spec.bfw_pressure, spec.condenser_outlet_T, spec.eta_pump
    )
    h_pump_out = h_cond_out + w_pump

    h_turb_out = exp.h_out
    if spec.heat_recovery:
        # pre-condenser drops turbine exhaust to saturated liquid at
        # P_turb_out - 0.5 MPa; that duty heats the feedwater (the
        # eq_heat_recovery coupling, `:96-110`)
        p_pre = spec.turbine_outlet_P - 0.5e6
        h_sat = steam.sat_liquid(p_pre).h
        q_pre = h_turb_out - h_sat  # >0, recovered per kg
        h_boiler_in = h_pump_out + q_pre
        q_condenser = h_cond_out - h_sat  # remaining rejection (negative)
    else:
        h_boiler_in = h_pump_out
        q_condenser = h_cond_out - h_turb_out  # negative

    if not spec.closed_loop:
        h_boiler_in = steam.props_liquid(spec.bfw_pressure, spec.boiler_inlet_T).h
        q_condenser = h_cond_out - h_turb_out

    return {
        "q_boiler": h_steam - h_boiler_in,
        "w_turbine": exp.work,
        "q_condenser": q_condenser,
        "w_pump": w_pump,
        "w_net_specific": GEN_LOSS * (exp.work - w_pump),
    }


@functools.lru_cache(maxsize=64)
def _specific_energies_of(key):
    return _specific_energies(RankineSpec(*key))


def _plain_key(spec: RankineSpec):
    """The spec's field values when all are plain numbers (memo key)."""
    key = dataclasses.astuple(spec)
    return key if all(isinstance(v, numbers.Number) for v in key) else None


def specific_energies(spec: RankineSpec):
    """Per-kg work/duty terms (flow-independent). Returns a dict of J/kg.

    `spec.closed_loop` mirrors the reference's `close_flowsheet_loop`
    (`:326-360`): the boiler inlet enthalpy is the pump outlet (plus the
    feed-water heater pickup when `spec.heat_recovery`), not the fixed
    563.6 K `set_inputs` value, so the first law closes exactly around the
    cycle. `closed_loop=False` reproduces the pre-closure square problem."""
    key = _plain_key(spec)
    return dict(_specific_energies_of(key)) if key is not None else _specific_energies(spec)


@functools.lru_cache(maxsize=1)
def _cooling_cp_dt():
    """Cooling-water enthalpy pickup across the 289.15 -> 300.15 K utility."""
    return steam.props_liquid(101325.0, 300.15).h - steam.props_liquid(101325.0, 289.15).h


def _tensor(x, like=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(x, dtype=torch.float64, device=dev)


def solve_rankine(
    flow_mol,
    spec: RankineSpec = RankineSpec(),
    net_power_max_w=None,  # design P_max for the capacity-factor boiler eff
    calc_boiler_eff: bool = False,
) -> RankineState:
    """Evaluate the cycle at boiler feed-water flow `flow_mol` [mol/s].

    `calc_boiler_eff=True` reproduces the reference's linear efficiency vs
    capacity factor: eff = 0.2143 * (P_net / P_max) + 0.7357 (`:168-175`);
    otherwise eff = 0.95 (`:155-160`)."""
    flow_mass = _tensor(flow_mol) * MW_WATER
    se = specific_energies(spec)

    W_turb = flow_mass * se["w_turbine"]
    W_pump = flow_mass * se["w_pump"]
    gross = W_turb - W_pump
    net = GEN_LOSS * gross
    Q_boiler = flow_mass * se["q_boiler"]
    Q_cond = flow_mass * se["q_condenser"]

    if calc_boiler_eff:
        if net_power_max_w is None:
            raise ValueError("net_power_max_w required when calc_boiler_eff")
        eff = 0.2143 * (net / _tensor(net_power_max_w, net)) + 0.7357
    else:
        eff = torch.full_like(net, 0.95)

    cycle_eff = net / Q_boiler * eff * 100.0

    # coal: Q_boiler/eff [W] / HHV [J/kg] -> kg/s -> ton/hr (1 ton=907.18 kg)
    coal_kg_s = Q_boiler / eff / (spec.coal_hhv_kj_kg * 1e3)
    coal_ton_hr = coal_kg_s * 3600.0 / 907.18474
    coal_cost = coal_ton_hr * spec.coal_price_per_ton

    # cooling water: condenser duty across the 289.15->300.15 K utility,
    # $0.19 per 1000 gal (`:446-489`)
    cw_kg_s = -Q_cond / _cooling_cp_dt()
    cw_gal_hr = cw_kg_s * 3600.0 / 1000.0 * 264.172
    cw_cost = cw_gal_hr * 0.19 / 1000.0

    op_cost = coal_cost + (cw_cost if spec.include_cooling_cost else 0.0)

    # heat rate [Btu/kWh]: coal energy rate [Btu/hr] per net power [kW]
    heat_rate = (coal_kg_s * spec.coal_hhv_kj_kg * 0.947817) / torch.clamp(
        net * 1e-3, min=1e-9) * 3600.0

    return RankineState(
        gross_power_w=gross,
        net_power_w=net,
        boiler_duty_w=Q_boiler,
        condenser_duty_w=Q_cond,
        turbine_work_w=W_turb,
        pump_work_w=W_pump,
        boiler_eff=eff,
        cycle_efficiency_pct=cycle_eff,
        operating_cost_per_hr=op_cost,
        heat_rate_btu_kwh=heat_rate,
        coal_flow_ton_hr=coal_ton_hr,
    )


# ---------------------------------------------------------------- costing
def capital_cost_musd(flow_mol, spec: RankineSpec = RankineSpec()):
    """Total plant capital cost [$M]: power-law stand-in for the QGESS
    account-table costing (`add_capital_cost`, `:348-432`), keeping the
    same scaled parameters: boiler + feedwater system on BFW mass flow,
    turbine on shaft MW, condenser on duty. Calibrated so a ~121 MW net
    plant (10,000 mol/s BFW) costs ~$300M total, the NETL-vintage scale."""
    st = solve_rankine(flow_mol, spec)
    bfw_lb_hr = _tensor(flow_mol) * MW_WATER * 3600.0 * 2.20462
    turb_mw = st.turbine_work_w * 1e-6
    # W -> Btu/hr (x 0.947817e-3 * 3600) -> MMBtu/hr (/1e6)
    cond_mmbtu_hr = -st.condenser_duty_w * 0.947817e-3 * 3600.0 / 1e6

    boiler_cost = 120.0 * (bfw_lb_hr / 1.43e6) ** 0.65
    turbine_cost = 100.0 * (turb_mw / 135.0) ** 0.70
    condenser_cost = 25.0 * (cond_mmbtu_hr / 600.0) ** 0.60
    feedwater_cost = 55.0 * (bfw_lb_hr / 1.43e6) ** 0.65
    return boiler_cost + turbine_cost + condenser_cost + feedwater_cost
