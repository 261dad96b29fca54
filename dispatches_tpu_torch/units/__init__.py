"""Unit models (ports of the JAX package's units): the price-taker design
LP's numpy-only units, and the concrete thermal store with its tube-side
chain kernel (`concrete_tes`). The power-curve unit is imported by path
(`units/powercurve.py`); the detailed hydrogen tank is not ported."""

from .base import Unit, connect
from .battery import BatteryStorage
from .concrete_tes import (
    ConcreteTES,
    FluidStream,
    TESDesign,
    stream_from_pt,
    tes_period,
    tube_side_profile,
    u_tes,
)
from .pem import PEMElectrolyzer
from .splitter import ElectricalSplitter
from .tank import SimpleHydrogenTank
from .turbine import HydrogenTurbine
from .wind import SolarPV, WindPower
