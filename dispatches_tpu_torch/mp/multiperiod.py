"""MultiPeriodModel: API-parity wrapper over the native time-axis model
(port of `dispatches_tpu/mp/multiperiod.py`).

The reference builds multiperiod models by cloning a single-period Pyomo
block per hour and adding linking equality constraints between consecutive
clones (`idaes.apps.grid_integration.multiperiod.MultiPeriodModel`, used at
`wind_battery_LMP.py:195-202`). Here time is a native array axis, so this
class drives a user-supplied block-build function once over the whole
horizon and applies the linking and periodic pairs as vectorized equality
constraints. Pure Python over `core.model.Model`: nothing touches a device
until the built program is instantiated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..core.model import Model


@dataclasses.dataclass
class PeriodVar:
    """A time-indexed variable handle exposed to linking functions."""

    var: object  # core.expr.Var with shape (T,)

    def at_first(self):
        return self.var[0:1]

    def at_last(self):
        T = self.var.cols.size
        return self.var[T - 1 : T]

    def shifted_pair(self):
        """(current[t], next[t+1]) views for t = 0..T-2."""
        return self.var[:-1], self.var[1:]


class MultiPeriodModel:
    """Build a time-stacked model with linking and periodic constraints.

    `process_model_func(m, T) -> dict[str, PeriodVar|Var]` builds all units
    over the horizon and returns named state handles. `linking_pairs` lists
    (a, b) names whose period-t value equals b's period-(t+1) value (with a
    native time axis each unit's own dynamics usually guarantee this, so it
    is usually empty); `periodic_pairs` names states whose final value must
    equal their first (the analogue of `periodic_variable_func`,
    `wind_battery_LMP.py:40-50`).
    """

    def __init__(
        self,
        n_time_points: int,
        process_model_func: Callable[[Model, int], Dict[str, object]],
        linking_pairs: Optional[List[Tuple[str, str]]] = None,
        periodic_pairs: Optional[List[str]] = None,
        name: str = "multiperiod",
    ):
        self.n_time_points = n_time_points
        self.model = Model(name)
        self.blocks = process_model_func(self.model, n_time_points)
        for a, b in linking_pairs or []:
            va, vb = self.blocks[a], self.blocks[b]
            self.model.add_eq(va[:-1] - vb[1:])
        for nm in periodic_pairs or []:
            v = self.blocks[nm]
            T = n_time_points
            self.model.add_eq(v[T - 1 : T] - v[0:1])

    @property
    def pyomo_model(self):  # the reference's accessor name
        return self.model

    def build(self):
        return self.model.build()
