"""Ideal-gas thermodynamics via NIST Shomate equations (port of
`dispatches_tpu/properties/h2.py`), as torch functions.

Replaces the reference's IDAES Generic Property packages
(`dispatches/properties/h2_ideal_vap.py:80-160` and
`hturbine_ideal_vap.py:41-200`): the same NIST Webbook Shomate coefficients
and reference state (Tref = 298.15 K, Pref = 101325 Pa), as differentiable
functions. Inputs may be tensors (their device and dtype are kept) or
numbers (float64 on the CPU).

Species: hydrogen, oxygen, nitrogen, argon, water (vapor phase).
Units: J, mol, K, Pa throughout.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

R_GAS = 8.31446261815324  # J/mol/K
P_REF = 101325.0  # Pa; the reference temperature, 298.15 K, is in the Shomate forms

# Shomate coefficients (A..H): one set per species over the reference's
# whole 273-2000 K state range (`hturbine_ideal_vap.py:55-180`)
SHOMATE: Dict[str, np.ndarray] = {
    # A, B, C, D, E, F, G, H  (cp in J/mol/K with t = T/1000; H in kJ/mol)
    "hydrogen": np.array(
        [33.066178, -11.363417, 11.432816, -2.772874, -0.158558, -9.980797, 172.707974, 0.0]
    ),
    "nitrogen": np.array(
        [19.50583, 19.88705, -8.598535, 1.369784, 0.527601, -4.935202, 212.39, 0.0]
    ),
    "oxygen": np.array(
        [31.32234, -20.23531, 57.86644, -36.50624, -0.007374, -8.903471, 246.7945, 0.0]
    ),
    "water": np.array(
        [30.092, 6.832514, 6.793435, -2.53448, 0.082139, -250.881, 223.3967, 0.0]
    ),
    "argon": np.array(
        [20.786, 2.82e-7, -1.46e-7, 1.092e-8, -3.66e-8, -6.19735, 179.999, 0.0]
    ),
}

SPECIES = ["hydrogen", "oxygen", "nitrogen", "argon", "water"]
_COEF = np.stack([SHOMATE[s] for s in SPECIES])  # (5, 8)


def _t(v) -> torch.Tensor:
    """`v` as a floating tensor: a tensor keeps its device and dtype, a
    number or array becomes float64 on the CPU."""
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else v.double()
    return torch.as_tensor(v, dtype=torch.float64)


_COEF_CACHE: Dict[tuple, torch.Tensor] = {}


def _coefs(like: torch.Tensor, n: int, species=None):
    """The first `n` Shomate coefficients (A, B, ...) in `like`'s dtype
    and on its device: each a (5,) row over SPECIES, or a 0-dim tensor of
    one species. One (8, 5) tensor is made per (dtype, device), so a call
    on the card copies nothing from the host."""
    key = (like.dtype, like.device)
    coef = _COEF_CACHE.get(key)
    if coef is None:
        coef = _COEF_CACHE[key] = torch.as_tensor(_COEF.T.copy(), dtype=like.dtype,
                                                  device=like.device)
    if species is not None:
        k = SPECIES.index(species)
        return tuple(coef[i, k] for i in range(n))
    return tuple(coef[i] for i in range(n))


def _t_over_1000(T, species):
    t = _t(T) / 1000.0
    return t if species is not None else t[..., None]


def cp_mol(T, species=None):
    """Molar heat capacity [J/mol/K]: shape (..., 5) for all species, or
    (...) for `species` alone (a name of SPECIES)."""
    t = _t_over_1000(T, species)
    A, B, C, D, E = _coefs(t, 5, species)
    return A + B * t + C * t**2 + D * t**3 + E / t**2


def enth_mol(T, species=None):
    """Molar enthalpy above the NIST reference [J/mol], shape (..., 5) or
    (...) for `species` alone:
    1000 (A t + B t^2/2 + C t^3/3 + D t^4/4 - E/t + F - H), t = T/1000."""
    t = _t_over_1000(T, species)
    A, B, C, D, E, F, _, H = _coefs(t, 8, species)
    kj = A * t + B * t**2 / 2 + C * t**3 / 3 + D * t**4 / 4 - E / t + F - H
    return 1000.0 * kj


def entr_mol(T, P=P_REF):
    """Standard molar entropy [J/mol/K] at T and pressure P, shape (..., 5)."""
    t = _t(T)[..., None] / 1000.0
    A, B, C, D, E, _, G, _ = _coefs(t, 8)
    s0 = A * torch.log(t) + B * t + C * t**2 / 2 + D * t**3 / 3 - E / (2 * t**2) + G
    p = torch.as_tensor(P, dtype=t.dtype, device=t.device)
    return s0 - R_GAS * torch.log(p[..., None] / P_REF)


def mix_enthalpy_flow(n, T):
    """Total enthalpy flow [W] for molar flows n (..., 5) [mol/s] at T [K]."""
    return torch.sum(_t(n) * enth_mol(T), dim=-1)


def mix_entropy_flow(n, T, P):
    """Total entropy flow [W/K], including ideal mixing entropy."""
    n = _t(n)
    ntot = torch.sum(n, dim=-1, keepdim=True)
    y = n / torch.clamp_min(ntot, 1e-300)
    s_i = entr_mol(T, P) - R_GAS * torch.log(torch.clamp_min(y, 1e-300))
    return torch.sum(n * s_i, dim=-1)


def isentropic_temperature(n, T_in, P_in, P_out, iters: int = 30):
    """T_out with S(n, T_out, P_out) = S(n, T_in, P_in), by a fixed number
    of Newton steps (the composition does not change across an isentropic
    step, so only the pure-component entropies move)."""
    n = _t(n)
    s_target = mix_entropy_flow(n, T_in, P_in)
    T = _t(T_in).to(n.dtype) * (_t(P_out) / _t(P_in)) ** (2.0 / 7.0)
    for _ in range(iters):
        f = mix_entropy_flow(n, T, P_out) - s_target
        dfdT = torch.sum(n * cp_mol(T), dim=-1) / T  # dS/dT = sum n_i cp_i / T
        T = torch.clamp(T - f / dfdT, 150.0, 4000.0)
    return T


def temperature_from_enthalpy(n, H_target, T_guess, iters: int = 30):
    """T with sum(n h(T)) = H_target, by a fixed number of Newton steps."""
    n = _t(n)
    T = _t(T_guess).to(n.dtype)
    for _ in range(iters):
        f = mix_enthalpy_flow(n, T) - H_target
        dfdT = torch.sum(n * cp_mol(T), dim=-1)
        T = torch.clamp(T - f / dfdT, 150.0, 4000.0)
    return T


# -- reaction data (`dispatches/properties/h2_reaction.py:74-90`) ------------
# R1: 2 H2 + O2 -> 2 H2O, dh_rxn = -4.8366e5 J/mol-extent
DH_RXN_R1 = -4.8366e5
STOICH_R1 = np.asarray([-2.0, -1.0, 0.0, 0.0, 2.0])  # H2, O2, N2, Ar, H2O
