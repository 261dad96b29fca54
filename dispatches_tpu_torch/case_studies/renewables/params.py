"""Renewables case-study parameters — values from the reference's
`dispatches/case_studies/renewables_case/load_parameters.py` and
`wind_battery_cost_parameter.json` (2023 / moderate / 4-hr battery scenario),
cited line-by-line so parity can be checked.

The bundled data files belong to the JAX package and are read by path
(``dispatches_tpu/data`` beside this package), never imported.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[3] / "dispatches_tpu" / "data"

TIMESTEP_HRS = 1.0  # `load_parameters.py:24`
H2_MOLS_PER_KG = 500.0  # `load_parameters.py:26`
H2_MASS_KG_PER_MOL = 2.016 / 1000  # `load_parameters.py:27`

# battery (4-hr, 2023, moderate) — `load_parameters.py:40-42` + cost JSON
BATT_OP_COST = 31.39  # $/kW-yr  fixed_om[moderate][2023][duration 4hr]
BATT_CAP_COST_KW = 236.365  # $/kW
BATT_CAP_COST_KWH = 254.835  # $/kWh
BATT_REP_COST_KWH = BATT_CAP_COST_KW * 0.5 / 4  # `load_parameters.py:48`

# wind (2023, moderate) — `load_parameters.py:44-45`
WIND_CAP_COST = 1308.0  # $/kW
WIND_OP_COST = 41.78  # $/kW-yr

# PEM — `load_parameters.py:49-51`
PEM_CAP_COST = 1200.0  # $/kW
PEM_OP_COST = 0.03 * PEM_CAP_COST  # $/kW-yr
PEM_VAR_COST = 0.0  # $/kWh

# H2 tank — `load_parameters.py:52-54`
TANK_CAP_COST_PER_M3 = 29 * 0.8 * 1000
TANK_CAP_COST_PER_KG = 29 * 33.5
TANK_OP_COST = 0.17 * TANK_CAP_COST_PER_KG

# H2 turbine — `load_parameters.py:55-57`
TURBINE_CAP_COST = 1320.0  # $/kW
TURBINE_OP_COST = 11.65  # $/kW-yr
TURBINE_VAR_COST = 4.27 / 1000  # $/kWh

H2_PRICE_PER_KG = 2.0  # `load_parameters.py:60`

# default sizes — `load_parameters.py:63-69`
FIXED_WIND_MW = 847.0
WIND_MW_UB = 10000.0
FIXED_BATT_MW = 0.0
FIXED_PEM_MW = 355.0
TURB_P_MW = 1.0
FIXED_TANK_SIZE = 0.5

# operating parameters — `load_parameters.py:72-79`
PEM_BAR = 1.01325
PEM_TEMP_K = 300.0
BATTERY_RAMP_RATE = 1e8  # kWh/hr (effectively inactive, `load_parameters.py:75`)
H2_TURB_MIN_FLOW = 1e-3
AIR_H2_RATIO = 10.76
COMPRESSOR_DP_BAR = 24.01
MAX_PRESSURE_BAR = 700.0

# financials — `load_parameters.py:119-121`
DISCOUNT_RATE = 0.08
N_YEARS = 30
PA = ((1 + DISCOUNT_RATE) ** N_YEARS - 1) / (
    DISCOUNT_RATE * (1 + DISCOUNT_RATE) ** N_YEARS
)

BATTERY_DURATION_HRS = 4.0  # `load_parameters.py:36`
BATTERY_EFF = 0.95  # `RE_flowsheet.py:151-152`
BATTERY_DEGRADATION = 1e-4  # `battery.py:91-95`


def load_rts303():
    """Bus-303 RTS-GMLC DA/RT LMPs and wind CFs (8736 h = 52 weeks).

    Extracted by tools/extract_rts_data.py from the reference's shipped
    Prescient output data (see that script's docstring on provenance).
    """
    z = np.load(DATA_DIR / "rts303.npz")
    return {k: z[k] for k in z.files}


def load_re_goldens(device="cuda"):
    """Inputs of the reference's golden-dollar tests, from vendored data
    (the JAX package's `load_re_goldens`).

    Mirrors the `input_params` fixture of
    `dispatches/case_studies/renewables_case/tests/test_RE_flowsheet.py:24-44`:
    DA LMPs are the *second* array in ``rts_results_all_prices.npy`` clipped
    at $200/MWh (8,736 h), and hourly wind capacity factors come from the
    Wind Toolkit SRW file's 80 m speed column through the PySAM-parity
    Weibull powercurve model (`units/powercurve.py::capacity_factor_pysam`,
    computed on `device` in float64), replacing the per-hour PySAM runs of
    `wind_power.py:170-183`. Both files are read by path from the JAX
    package's data directory; the arrays come back as numpy.
    """
    import torch

    from ...units.powercurve import capacity_factor_pysam, read_srw_wind_speeds

    with open(DATA_DIR / "rts_results_all_prices.npy", "rb") as f:
        _ = np.load(f)
        prices = np.load(f)
    prices = prices.copy()
    prices[prices > 200.0] = 200.0
    speeds = read_srw_wind_speeds(DATA_DIR / "windtoolkit_2012_60min_80m.srw")
    cfs = capacity_factor_pysam(torch.as_tensor(speeds, dtype=torch.float64, device=device))
    return {"da_lmp": prices, "wind_speed_m_s": speeds, "wind_cf": cfs.cpu().numpy()}


@dataclasses.dataclass
class RenewableInputParams:
    """The analogue of `default_input_params` (`load_parameters.py:123-140`)."""

    wind_mw: float = FIXED_WIND_MW
    wind_mw_ub: float = WIND_MW_UB
    batt_mw: float = FIXED_BATT_MW
    pem_mw: float = FIXED_PEM_MW
    tank_size_kg: float = FIXED_TANK_SIZE
    turb_mw: float = TURB_P_MW
    h2_price_per_kg: float = H2_PRICE_PER_KG
    design_opt: object = True  # True | False | "PEM"
    extant_wind: bool = True


def default_input_params() -> RenewableInputParams:
    return RenewableInputParams()
