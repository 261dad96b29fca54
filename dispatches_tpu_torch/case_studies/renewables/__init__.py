"""Renewables case study: the price-taker design LP."""

from .pricetaker import (
    HybridDesign,
    build_pricetaker,
    wind_battery_optimize,
    wind_battery_pem_optimize,
    wind_battery_pem_tank_turb_optimize,
)
