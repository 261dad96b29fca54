"""Hydrogen storage tanks.

`SimpleHydrogenTank` — parity with reference
`dispatches/unit_models/hydrogen_tank_simplified.py:34-254`: linear molar
holdup balance with two outlets,
``holdup[t] - holdup[t-1] = (in - out_turbine - out_pipeline) * dt``
(`hydrogen_tank_simplified.py:178-184`), flows in mol/s, dt in seconds
(3600 s per hourly step, `RE_flowsheet.py:209`), holdup in mol.

The detailed nonlinear compressed-gas tank (`hydrogen_tank.py:68-622`,
ControlVolume0D + adiabatic energy balance) is an NLP unit scheduled for the
nonlinear-solver tier; the simple tank is what the multiperiod LP case studies
use (`RE_flowsheet.py:202-205` with ``tank_type="simple"``).
"""
from __future__ import annotations

from typing import Optional

from ..core.model import Model
from .base import Unit


class SimpleHydrogenTank(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        inlet_mol,  # affine expr, mol/s (e.g. pem.h2_flow_mol)
        name: str = "h2_tank",
        dt_seconds: float = 3600.0,
        initial_holdup: Optional[float] = 0.0,  # None -> free initial var
        periodic_holdup: bool = True,
        capacity_mol: Optional[float] = None,  # None -> design var (mol)
    ):
        super().__init__(m, name)
        self.T = T
        self.outlet_to_turbine = self._v("outlet_to_turbine", T)  # mol/s
        self.outlet_to_pipeline = self._v("outlet_to_pipeline", T)  # mol/s
        self.holdup = self._v("holdup", T)  # mol

        # free initial holdup mirrors the reference's unfixed
        # `tank_holdup_previous` under periodic linking
        # (`solar_battery_hydrogen.py:43,60`): the optimizer picks the cyclic
        # starting inventory
        if initial_holdup is None:
            if not periodic_holdup:
                raise ValueError(
                    "initial_holdup=None requires periodic_holdup=True: a "
                    "free, unanchored starting inventory lets the LP conjure "
                    "hydrogen for free"
                )
            self.holdup_previous = self._v("holdup_previous")
            h0 = self.holdup_previous
        else:
            self.holdup_previous = None
            h0 = float(initial_holdup)

        net0 = (
            inlet_mol[0:1] - self.outlet_to_turbine[0:1] - self.outlet_to_pipeline[0:1]
        )
        m.add_eq(self.holdup[0:1] - h0 - dt_seconds * net0)
        if T > 1:
            net = (
                inlet_mol[1:]
                - self.outlet_to_turbine[1:]
                - self.outlet_to_pipeline[1:]
            )
            m.add_eq(self.holdup[1:] - self.holdup[:-1] - dt_seconds * net)

        if capacity_mol is None:
            self.tank_size = self._v("tank_size")  # mol, design var
            m.add_le(self.holdup - self.tank_size)
        else:
            self.tank_size = None
            m.add_le(self.holdup - capacity_mol)

        if periodic_holdup:
            # final holdup returns to the initial value
            # (`wind_battery_PEM_tank_turbine_LMP.py:60-66`)
            m.add_eq(self.holdup[T - 1 : T] - h0)
