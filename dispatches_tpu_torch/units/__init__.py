"""Unit models of the price-taker design LP (numpy-only copies of the JAX
package's units; the power-curve and detailed-tank units are not ported)."""

from .base import Unit, connect
from .battery import BatteryStorage
from .pem import PEMElectrolyzer
from .splitter import ElectricalSplitter
from .tank import SimpleHydrogenTank
from .turbine import HydrogenTurbine
from .wind import SolarPV, WindPower
