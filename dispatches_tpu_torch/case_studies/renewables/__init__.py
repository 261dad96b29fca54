"""Renewables case study: the price-taker design LP, the solar-hydrogen
load-following design, the surrogate-based conceptual design and the
wind + battery horizon by time-axis decomposition (`horizon`)."""

from .horizon import (
    WindBatteryChunk,
    build_chunk,
    coarse_boundary_states,
    wind_battery_horizon_solve,
)
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
