"""Battery storage unit — LP dynamics over the full horizon.

Physics parity with reference `dispatches/unit_models/battery.py:37-233`:
  state_of_charge[t] = soc[t-1] + eta_c*dt*elec_in[t] - dt/eta_d*elec_out[t]
  energy_throughput[t] = tp[t-1] + dt*(elec_in[t]+elec_out[t])/2
  soc[t] <= nameplate_energy - degradation_rate*throughput[t]
  elec_in[t], elec_out[t] <= nameplate_power
plus the case-study couplings: nameplate_energy = duration*nameplate_power
(`RE_flowsheet.py:155-156`), optional SoC ramp limits
(`wind_battery_LMP.py:139-142`), periodic SoC (`wind_battery_LMP.py:40-50`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.model import INF, Model
from .base import Unit


class BatteryStorage(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        name: str = "battery",
        dt: float = 1.0,
        charging_eta: float = 0.95,
        discharging_eta: float = 0.95,
        degradation_rate: float = 1e-4,
        duration: Optional[float] = 4.0,  # None -> independent energy capacity
        power_capacity: Optional[float] = None,  # kW; None -> design variable
        power_capacity_ub: float = 1e8,
        energy_capacity: Optional[float] = None,  # kWh; used when duration=None
        energy_capacity_ub: float = 1e8,
        initial_soc: Optional[float] = 0.0,  # None -> free initial SoC var
        initial_throughput: Optional[float] = 0.0,  # None -> free initial var
        periodic_soc: bool = True,
        ramp_rate: Optional[float] = None,  # kWh per step bound on |Δsoc|
    ):
        super().__init__(m, name)
        if duration is not None and energy_capacity is not None:
            raise ValueError(
                "energy_capacity requires duration=None (otherwise the energy "
                "rating is coupled to power via the fixed duration)"
            )
        self.T = T
        self.dt = dt
        self.duration = duration
        self.charging_eta = charging_eta
        self.discharging_eta = discharging_eta
        self.degradation_rate = degradation_rate

        self.elec_in = self._v("elec_in", T)
        self.elec_out = self._v("elec_out", T)
        self.soc = self._v("soc", T)
        self.throughput = self._v("throughput", T)
        if power_capacity is None:
            self.nameplate_power = self._v("nameplate_power", ub=power_capacity_ub)
            self._fixed_power = None
        else:
            # fixed design: emulate Pyomo's var.fix() with tight bounds
            self.nameplate_power = self._v(
                "nameplate_power", lb=power_capacity, ub=power_capacity
            )
            self._fixed_power = power_capacity

        # initial conditions: reference fixes initial SoC/throughput at block 0
        # (`wind_battery_LMP.py:206-207`); PEM case leaves initial SoC free
        # (`wind_battery_PEM_LMP.py:222` only fixes throughput)
        if initial_soc is None:
            self.initial_soc = self._v("initial_soc")
            soc0 = self.initial_soc
        else:
            self.initial_soc = None
            soc0 = float(initial_soc)

        ec, ed = charging_eta, discharging_eta
        # SoC evolution
        m.add_eq(
            self.soc[0:1] - soc0 - ec * dt * self.elec_in[0:1] + (dt / ed) * self.elec_out[0:1]
        )
        if T > 1:
            m.add_eq(
                self.soc[1:]
                - self.soc[:-1]
                - ec * dt * self.elec_in[1:]
                + (dt / ed) * self.elec_out[1:]
            )
        # throughput accumulation; free initial throughput supports horizon
        # decomposition (chunk-boundary consensus, parallel/time_axis.py)
        if initial_throughput is None:
            self.initial_throughput = self._v("initial_throughput")
            tp0 = self.initial_throughput
        else:
            self.initial_throughput = None
            tp0 = float(initial_throughput)
        m.add_eq(
            self.throughput[0:1]
            - tp0
            - (dt / 2) * (self.elec_in[0:1] + self.elec_out[0:1])
        )
        if T > 1:
            m.add_eq(
                self.throughput[1:]
                - self.throughput[:-1]
                - (dt / 2) * (self.elec_in[1:] + self.elec_out[1:])
            )
        # capacity fade: soc <= E - deg*throughput, where E is either coupled
        # to power via the fixed duration (`RE_flowsheet.py:155-156`) or an
        # independent design variable with its own capital cost
        # (`solar_battery_hydrogen.py:214-216`, `four_hr_battery.deactivate()`)
        if duration is not None:
            self.nameplate_energy = None
            m.add_le(
                self.soc
                - duration * self.nameplate_power
                + degradation_rate * self.throughput
            )
        else:
            if energy_capacity is None:
                self.nameplate_energy = self._v(
                    "nameplate_energy", ub=energy_capacity_ub
                )
            else:
                self.nameplate_energy = self._v(
                    "nameplate_energy", lb=energy_capacity, ub=energy_capacity
                )
            m.add_le(
                self.soc
                - self.nameplate_energy
                + degradation_rate * self.throughput
            )
        # power bounds vs (possibly variable) nameplate
        m.add_le(self.elec_in - self.nameplate_power)
        m.add_le(self.elec_out - self.nameplate_power)

        if ramp_rate is not None:
            m.add_le(self.soc[0:1] - soc0 - ramp_rate)
            m.add_le(soc0 - self.soc[0:1] - ramp_rate)
            if T > 1:
                m.add_le(self.soc[1:] - self.soc[:-1] - ramp_rate)
                m.add_le(self.soc[:-1] - self.soc[1:] - ramp_rate)

        if periodic_soc:
            # last SoC returns to the initial SoC (`wind_battery_LMP.py:40-50`)
            end = self.soc[T - 1 : T]
            m.add_eq(end - soc0)

    @property
    def power_in(self):
        return self.elec_in + 0.0

    @property
    def power_out(self):
        return self.elec_out + 0.0
