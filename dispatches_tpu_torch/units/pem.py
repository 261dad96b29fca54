"""PEM electrolyzer.

Parity with reference `dispatches/unit_models/pem_electrolyzer.py:70-179`: a
0-D linear electricity→H2 conversion ``flow_mol[t] = electricity[t] *
electricity_to_mol`` (the `efficiency_curve`, `pem_electrolyzer.py:111-114`).
The default conversion 0.00275984 mol/s per kW is the 50 kWh/kg NEL-M3000
figure fixed in the case studies (`RE_flowsheet.py:129-131`). Outlet
temperature/pressure are fixed operating parameters; the thermodynamic state
itself (h2_ideal_vap) only matters for the NLP tank/turbine path and lives in
`dispatches_tpu/properties/h2.py`.
"""
from __future__ import annotations

from typing import Optional

from ..core.model import Model
from .base import Unit

# mol H2 per s per kW at 50 kWh/kg (`RE_flowsheet.py:131`)
DEFAULT_ELECTRICITY_TO_MOL = 0.00275984
H2_MOLS_PER_KG = 500.0  # `load_parameters.py:26`


def h2_value_per_kwh(
    h2_price_per_kg: float,
    electricity_to_mol: float = DEFAULT_ELECTRICITY_TO_MOL,
) -> float:
    """$ of hydrogen produced per kWh routed to the PEM — the marginal value
    that sets the opportunity cost of selling electricity instead (used by
    tracking and bidding to value PEM consumption consistently)."""
    return h2_price_per_kg * 3600.0 * electricity_to_mol / H2_MOLS_PER_KG


class PEMElectrolyzer(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        name: str = "pem",
        electricity_to_mol: float = DEFAULT_ELECTRICITY_TO_MOL,
        max_capacity: Optional[float] = None,  # kW cap; None -> uncapped here
    ):
        super().__init__(m, name)
        self.T = T
        self.electricity_to_mol = electricity_to_mol
        self.electricity = self._v("electricity", T)
        if max_capacity is not None:
            m.add_le(self.electricity - max_capacity)

    @property
    def electricity_in(self):
        return self.electricity + 0.0

    @property
    def h2_flow_mol(self):
        """Outlet H2 molar flow [mol/s]."""
        return self.electricity_to_mol * self.electricity

    @property
    def h2_kg_per_hr(self):
        return (3600.0 / H2_MOLS_PER_KG * self.electricity_to_mol) * self.electricity
