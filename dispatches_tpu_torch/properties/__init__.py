"""Property packages (port of `dispatches_tpu/properties/`): `h2`, the
ideal-vapour H2 / turbine-mixture thermodynamics with the H2 combustion
data; `hturbine`, the hydrogen turbine's chain; `steam`, IAPWS-IF97
regions 1, 2 and 4; `salts`, the molten-salt and thermal-oil
heat-transfer-fluid correlations.
"""

from . import h2, steam
from .salts import FLUIDS, FluidProps, HitecSalt, SolarSalt, ThermalOil
