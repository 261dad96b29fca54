"""Unified run configuration — the analogue of the reference's three config
mechanisms (SURVEY.md §5 "Config/flag system"): `prescient_options.py:14-86`
(simulation options dict), `load_parameters.py` parameter modules, and the
per-script argparse blocks. One typed dataclass with dict round-tripping so
run scripts, tests, and sweep drivers share a single source of truth.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class SimulationOptions:
    """Double-loop / production-cost simulation options (field-by-field
    analogue of `default_prescient_options`, minus solver-subprocess knobs
    that have no meaning on-device)."""

    data_path: Optional[str] = None  # RTS-format dir; None -> bundled 5-bus
    sim_name: str = "sim"
    output_directory: Optional[str] = None
    start_day: int = 0
    num_days: int = 2  # reference default runs 365
    reserve_factor: float = 0.15  # `prescient_options.py:23`
    shortfall_price: float = 500.0  # `:22` price_threshold
    day_ahead_horizon: int = 36  # `:27`
    real_time_horizon: int = 4  # `:28`
    tracking_horizon: int = 4  # `:29`
    n_tracking_hour: int = 1  # `:30`
    bidding_generator: Optional[str] = None
    participant_bus: Optional[int] = None
    participant_segments: int = 2

    # price-taker / design-sweep options
    h2_price_per_kg: float = 2.0
    n_time_points: int = 7 * 24
    design_opt: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationOptions":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown option(s): {sorted(unknown)}")
        return cls(**d)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "SimulationOptions":
        with open(path) as f:
            return cls.from_dict(json.load(f))
