"""Ultra-supercritical plant model: performance map + cost correlations
(port of `dispatches_tpu/case_studies/fossil/usc_plant.py`).

The reference's USC plant is a 1,352-line IDAES flowsheet
(`ultra_supercritical_powerplant.py:71-1352`) whose solved operating map
is, at the multiperiod layer, collapsed to a few algebraic relations
(`integrated_storage_with_ultrasupercritical_power_plant.py:460-500`).
This module is that layer:

- design point 436 MW net / 940 MWth boiler duty (the reference's golden
  solve gives 436.466 MW; max_boiler_duty Param `:473-477`)
- boiler efficiency 0.2143*(duty/940) + 0.7357 (`:479-484`)
- coal duty, cycle efficiency (`:485-500`)
- operating cost 2.11e-9 $/J coal (`:836-843`)
- plant capital / fixed-OM / variable-OM correlations with the CE-index
  scaling (`:846-893`)
- charge/discharge storage coupling: the ES turbine (ratioP 0.0286, eta
  0.8, `:607-608`) converts discharge heat back to power.

Functions take tensors (device kept) or numbers (float64 on the CPU).
"""
from __future__ import annotations

import torch

# design point (`create_usc_model`, multiperiod_integrated_storage_usc.py:40-56);
# the dispatch layer keeps the reference's own map constants (940.4 MWth
# ceiling, proportional scaling) for golden parity, and `usc_nlp.py`'s
# `derive_performance_map` ties the physics tier to them within 5%
MAX_POWER_MW = 436.0
MIN_POWER_MW = int(0.65 * 436)  # 283
MAX_BOILER_DUTY_MW = 940.0
NLP_DESIGN_POWER_MW = 436.441  # usc_nlp design solve (golden 436.466)
NLP_DESIGN_DUTY_MW = 918.0
NLP_DUTY_SLOPE = 2.1602  # MWth per MWe, NLP-affine duty(power)
NLP_DUTY_INTERCEPT_MW = -25.2
RAMP_MW_PER_HR = 60.0
MIN_STORAGE_DUTY_MW = 10.0
MAX_STORAGE_DUTY_MW = 200.0

# storage salt loop temperatures (`usc_unfix_dof`,
# multiperiod_integrated_storage_usc.py:191-195)
T_SALT_HOT = 831.0  # K
T_SALT_COLD = 513.15  # K
HXC_AREA_M2 = 1904.0
HXD_AREA_M2 = 2830.0
TANK_MAX_KG = 6_739_292.0
INVENTORY_MIN_KG = 75_000.0

# ES (energy-storage) turbine heat->power conversion: ~36% of the discharge
# heat becomes shaft work at ratioP=0.0286, eta=0.8
ES_TURBINE_EFF = 0.36

# economics (`build_costing`, integrated_storage...py:741-757,846-893)
CE_INDEX = 607.5 / 575.4
COAL_PRICE_PER_J = 2.11e-9
COOLING_PRICE_PER_J = 3.3e-9
NUM_YEARS = 30.0
SALT_PRICE = {"solar_salt": 0.49, "hitec_salt": 0.93, "thermal_oil": 6.72}


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64)


def plant_heat_duty_mw(plant_power_mw, q_charge_mw=0.0):
    """Boiler thermal duty [MWth]: proportional map through the design point
    plus 1:1 diversion of charge heat."""
    return (MAX_BOILER_DUTY_MW / MAX_POWER_MW) * _t(plant_power_mw) + _t(q_charge_mw)


def boiler_eff(plant_heat_duty):
    """0.2143*(duty/940) + 0.7357 (`integrated_storage...py:479-484`)."""
    return 0.2143 * _t(plant_heat_duty) / MAX_BOILER_DUTY_MW + 0.7357


def coal_heat_duty_mw(plant_power_mw, q_charge_mw=0.0):
    duty = plant_heat_duty_mw(plant_power_mw, q_charge_mw)
    return duty / boiler_eff(duty)


def net_power_mw(plant_power_mw, q_discharge_mw=0.0):
    """net = plant power + ES-turbine output (`:467-471`)."""
    return _t(plant_power_mw) + ES_TURBINE_EFF * _t(q_discharge_mw)


def cycle_efficiency_pct(plant_power_mw, q_charge_mw=0.0, q_discharge_mw=0.0):
    return (
        net_power_mw(plant_power_mw, q_discharge_mw)
        / coal_heat_duty_mw(plant_power_mw, q_charge_mw)
        * 100.0
    )


# ------------------------------------------------------------------ costs
def fuel_cost_per_hr(plant_power_mw, q_charge_mw=0.0):
    """Coal cost [$/hr] at 2.11e-9 $/J (`op_cost_rule`, `:836-843`)."""
    return COAL_PRICE_PER_J * coal_heat_duty_mw(plant_power_mw, q_charge_mw) * 1e6 * 3600.0


def plant_capital_cost_per_yr(plant_power_mw):
    """(2688973*P + 618968072)/30 * CE ratio (`plant_cap_cost_rule`)."""
    return (2688973.0 * _t(plant_power_mw) + 618968072.0) / NUM_YEARS * CE_INDEX


def plant_fixed_om_per_yr(plant_power_mw):
    return (16657.5 * _t(plant_power_mw) + 6109833.3) / NUM_YEARS * CE_INDEX


def plant_variable_om_per_yr(plant_power_mw):
    return 31754.7 * _t(plant_power_mw) * CE_INDEX


def solve_usc_plant(boiler_flow_frac=1.0):
    """Golden-parity helper: the plant at design boiler flow produces
    436 MW net (reference square solve: 436.466 MW)."""
    P = MAX_POWER_MW * _t(boiler_flow_frac)
    return {
        "plant_power_mw": P,
        "plant_heat_duty_mw": plant_heat_duty_mw(P),
        "boiler_eff": boiler_eff(plant_heat_duty_mw(P)),
        "cycle_efficiency_pct": cycle_efficiency_pct(P),
    }
