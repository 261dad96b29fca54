"""Hydrogen turbine (compressor → H2 combustion → expander).

The reference composes IDAES Compressor + StoichiometricReactor + Turbine
units over a 5-component ideal-gas mixture
(`dispatches/unit_models/hydrogen_turbine_unit.py:97-167`) and exposes
``electricity = -(turbine work + compressor work)*1e-3``
(`RE_flowsheet.py:327-328`). In the multiperiod LP that whole thermodynamic
chain reduces, at the fixed operating point the case studies pin down
(inlet T=300 K, p=1.01325 bar, Δp=±24.01 bar, isentropic efficiencies
0.86/0.89, conversion 0.99, air/H2 ratio 10.76 — `RE_flowsheet.py:280-324`),
to a LINEAR map from H2 molar flow to net electric power. We precompute that
specific work from our own ideal-gas mixture thermodynamics
(`dispatches_tpu/properties/hturbine.py:net_specific_work`) once on the host
and use it as the LP coefficient; the full NLP unit remains available through
the properties package for square-solve validation.

A `purchased_hydrogen_feed` stream provides the reference's minimum-flow slack
(`RE_flowsheet.py:271-304`): purchased H2 adds to the turbine feed and is paid
for at the H2 market price (netted out of hydrogen revenue,
`wind_battery_PEM_tank_turbine_LMP.py:400-405`).
"""
from __future__ import annotations

from typing import Optional

from ..core.model import Model
from .base import Unit


class HydrogenTurbine(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        h2_feed_mol,  # affine expr, mol/s from tank outlet_to_turbine
        name: str = "h2_turbine",
        kwh_per_mol_h2: float = None,
        capacity: Optional[float] = None,  # kW; None -> design var
        min_flow_mol: float = 1e-3,
    ):
        super().__init__(m, name)
        self.T = T
        if kwh_per_mol_h2 is None:
            from ..properties.hturbine import net_specific_work_kwh_per_mol

            kwh_per_mol_h2 = net_specific_work_kwh_per_mol()
        self.kwh_per_mol_h2 = kwh_per_mol_h2

        # slack purchased H2 (mol/s) so the turbine can always meet min flow
        self.purchased_h2 = self._v(
            "purchased_h2", T, lb=min_flow_mol / 2.0
        )
        total_h2 = h2_feed_mol + self.purchased_h2
        # net electric power [kW] = specific work [kWh/mol] * flow [mol/s] * 3600 [s/hr]
        self.electricity_expr = (kwh_per_mol_h2 * 3600.0) * total_h2
        # materialize as a variable so capacity constraints/revenue reference it
        self.electricity = self._v("electricity", T)
        m.add_eq(self.electricity - self.electricity_expr)

        if capacity is None:
            self.system_capacity = self._v("system_capacity")
        else:
            self.system_capacity = self._v(
                "system_capacity", lb=capacity, ub=capacity
            )
        m.add_le(self.electricity - self.system_capacity)
