"""Wind power unit.

Parity with reference `dispatches/unit_models/wind_power.py:54-189`:
``electricity[t] <= system_capacity * capacity_factor[t]`` with curtailment
allowed (`wind_power.py:120-122`). Capacity factors come either from direct
data (the `capacity_factor` config path, `wind_power.py:178-183`) or from the
powercurve model in `dispatches_tpu/units/powercurve.py` (the PySAM
replacement, `wind_power.py:129-177`).

The per-block ``system_capacity <= wind_system_capacity`` coupling of the
reference's multiperiod layer (`wind_battery_LMP.py:218`) collapses here to a
single capacity (variable or fixed): with hourly capacities only bounded above
by the system capacity and generation free to curtail, the LP optimum always
sets them equal.
"""
from __future__ import annotations

from typing import Optional

from ..core.model import Model
from .base import Unit


class WindPower(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        name: str = "wind",
        capacity: Optional[float] = None,  # kW; None -> design variable
        capacity_ub: float = 1e7,
        cf_param: Optional[str] = None,  # defaults to f"{name}.cf"
    ):
        super().__init__(m, name)
        self.T = T
        self.electricity = self._v("electricity", T)
        self.cf = m.param(cf_param or f"{name}.cf", T)
        if capacity is None:
            self.system_capacity = self._v("system_capacity", ub=capacity_ub)
        else:
            self.system_capacity = self._v(
                "system_capacity", lb=capacity, ub=capacity
            )
        # electricity[t] - cf[t]*capacity <= 0  (cf enters A as a param coeff)
        m.add_le(self.electricity - self.cf * self.system_capacity)

    @property
    def electricity_out(self):
        return self.electricity + 0.0


class SolarPV(WindPower):
    """Solar PV — same curtailable capacity-factor pattern as wind
    (reference `dispatches/unit_models/solar_pv.py:51-105`)."""

    def __init__(self, m: Model, T: int, name: str = "pv", **kw):
        super().__init__(m, T, name=name, **kw)
