"""Molten-salt and thermal-oil property correlations as torch functions
(port of `dispatches_tpu/properties/salts.py`).

The reference's IDAES property packages `solarsalt_properties.py`,
`hitecsalt_properties.py` and `thermaloil_properties.py`: the same
published polynomial correlations in temperature (solar salt per the
SQM/Sandia data; Hitec per Chang et al., Energy Procedia 69 (2015)
779-789; Therminol-66 per the Solutia data sheet), as differentiable
functions of T. Inputs may be tensors (their device kept, float64) or
numbers (float64 on the CPU).

Units: J, kg, K, Pa, W, m throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def _T(T) -> torch.Tensor:
    if isinstance(T, torch.Tensor):
        return T.to(torch.float64)
    return torch.as_tensor(np.asarray(T, dtype=float), dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class FluidProps:
    """Bundle of property callables for one heat-transfer fluid."""

    name: str
    T_min: float
    T_max: float
    cp_mass: Callable  # J/kg/K
    dens_mass: Callable  # kg/m^3
    enth_mass: Callable  # J/kg (integral of cp from the package's datum)
    visc_d: Callable  # Pa s
    therm_cond: Callable  # W/m/K

    def enthalpy_flow(self, flow_mass, T):
        """Enthalpy flow term [W] = flow_mass * enth_mass(T)."""
        return flow_mass * self.enth_mass(T)

    def temperature_from_enthalpy(self, h_target, T_guess, iters: int = 25):
        """Invert enth_mass(T) = h_target by Newton.

        The slope is the autodiff derivative of ``enth_mass``
        (``torch.func.grad``), not ``cp_mass``: for Hitec the reference's
        enthalpy polynomial is NOT the integral of its cp correlation, so
        cp is the wrong Newton slope there."""
        T = _T(T_guess)
        dh = torch.func.grad(lambda t: torch.sum(self.enth_mass(t)))
        for _ in range(iters):
            f = self.enth_mass(T) - h_target
            T = torch.clamp(T - f / dh(T), self.T_min, self.T_max)
        return T


# --- Solar salt (60% NaNO3 / 40% KNO3), T in K, datum 273.15 K --------------
_T0_SOLAR = 273.15


def _solar_dT(T):
    return _T(T) - _T0_SOLAR


SolarSalt = FluidProps(
    name="solar_salt",
    T_min=513.15,
    T_max=853.15,
    cp_mass=lambda T: 1443.0 + 0.172 * _solar_dT(T),
    dens_mass=lambda T: 2090.0 - 0.636 * _solar_dT(T),
    enth_mass=lambda T: 1443.0 * _solar_dT(T) + 0.172 * 0.5 * _solar_dT(T) ** 2,
    visc_d=lambda T: (
        2.2714e-2
        - 1.2e-4 * _solar_dT(T)
        + 2.281e-7 * _solar_dT(T) ** 2
        - 1.474e-10 * _solar_dT(T) ** 3
    ),
    therm_cond=lambda T: 0.443 + 1.9e-4 * _solar_dT(T),
)


# --- Hitec salt (NaNO3/KNO3/NaNO2 ternary), T in K (absolute-T polynomials) --
HitecSalt = FluidProps(
    name="hitec_salt",
    T_min=435.15,
    T_max=788.15,
    cp_mass=lambda T: 5806.0 - 10.833 * _T(T) + 7.2413e-3 * _T(T) ** 2,
    dens_mass=lambda T: 2293.6 - 0.7497 * _T(T),
    enth_mass=lambda T: 5806.0 * _T(T) - 10.833 * _T(T) ** 2 + 7.2413e-3 * _T(T) ** 3,
    # exp(a + b*(log(T) + c)), the Chang et al. (2015) form
    visc_d=lambda T: torch.exp(-4.343 - 2.0143 * (torch.log(_T(T)) - 5.011)),
    therm_cond=lambda T: 0.421 - 6.53e-4 * (_T(T) - 260.0),
)


# --- Therminol-66 thermal oil, T in K, datum 273.15 K ------------------------
_T0_OIL = 273.15


def _oil_dT(T):
    return _T(T) - _T0_OIL


def _oil_cp(T):
    return 1496.005 + 3.313 * _oil_dT(T) + 0.0008970785 * _oil_dT(T) ** 2


def _oil_dens(T):
    return 1026.7 - 0.7281 * _oil_dT(T)


def _oil_visc_k(T):
    # kinematic viscosity [m^2/s]: nu4 * exp(nu1/(dT + nu2) + nu3)
    return 1e-6 * torch.exp(586.375 / (_oil_dT(T) + 62.5) - 2.2809)


ThermalOil = FluidProps(
    name="thermal_oil",
    T_min=260.0,
    T_max=616.0,
    cp_mass=_oil_cp,
    dens_mass=_oil_dens,
    enth_mass=lambda T: (
        1496.005 * _oil_dT(T)
        + 3.313 * _oil_dT(T) ** 2 / 2.0
        + 0.0008970785 * _oil_dT(T) ** 3 / 3.0
    ),
    visc_d=lambda T: _oil_visc_k(T) * _oil_dens(T),  # dynamic = kinematic*rho
    therm_cond=lambda T: 0.118294 - 3.3e-5 * _oil_dT(T) - 1.5e-7 * _oil_dT(T) ** 2,
)


FLUIDS = {f.name: f for f in (SolarSalt, HitecSalt, ThermalOil)}
