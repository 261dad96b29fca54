"""Generator model-data records for the market layer.

Lightweight equivalents of IDAES grid_integration's
`RenewableGeneratorModelData` / `ThermalGeneratorModelData` used throughout
the reference's double-loop adapters (`wind_battery_double_loop.py:25-40`,
`test_multiperiod_wind_battery_doubleloop.py:49-58`): plain records whose
fields flow into the market simulator's generator dictionaries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RenewableGeneratorModelData:
    gen_name: str
    bus: str
    p_min: float = 0.0
    p_max: float = 0.0
    p_cost: float = 0.0
    fixed_commitment: Optional[int] = None
    generator_type: str = "renewable"

    def __iter__(self):
        for f in dataclasses.fields(self):
            yield f.name, getattr(self, f.name)


@dataclasses.dataclass
class ThermalGeneratorModelData:
    gen_name: str
    bus: str
    p_min: float
    p_max: float
    min_down_time: float = 0.0
    min_up_time: float = 0.0
    ramp_up_60min: float = 1e6
    ramp_down_60min: float = 1e6
    shutdown_capacity: float = 0.0
    startup_capacity: float = 0.0
    production_cost_bid_pairs: Optional[list] = None
    startup_cost_pairs: Optional[list] = None
    initial_status: int = 1
    initial_p_output: float = 0.0
    fixed_commitment: Optional[int] = None
    generator_type: str = "thermal"

    def __iter__(self):
        for f in dataclasses.fields(self):
            yield f.name, getattr(self, f.name)
