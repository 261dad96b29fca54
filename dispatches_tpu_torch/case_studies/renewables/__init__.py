"""Renewables case study: the price-taker design LP, the solar-hydrogen
load-following design and the surrogate-based conceptual design.
(`renewables/horizon.py` of the JAX package waits for `parallel/`,
ROADMAP A7.)"""

from .conceptual_design import (
    ConceptualDesignInputs,
    conceptual_design_dynamic_RE,
    design_sweep,
)
from .pricetaker import (
    HybridDesign,
    build_pricetaker,
    wind_battery_optimize,
    wind_battery_pem_optimize,
    wind_battery_pem_tank_turb_optimize,
)
from .solar_hydrogen import (
    SolarHydrogenDesign,
    pv_battery_hydrogen_optimize,
    reserve_over_1hr,
)
