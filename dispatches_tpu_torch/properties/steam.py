"""Steam/water thermodynamics: IAPWS-IF97 regions 1, 2 and 4 as torch
functions (port of `dispatches_tpu/properties/steam.py`).

The IAPWS Industrial Formulation 1997 stands in for the reference's
compiled Helmholtz `iapws95` package: Gibbs-energy polynomial forms whose
coefficients are public standard data, evaluated as tensor contractions
over the term axis.

Coverage:
  region 1: compressed liquid, 273.15 K <= T <= 623.15 K, P <= 100 MPa
  region 2: superheated vapor up to 1073.15 K, P <= 100 MPa (USC main and
            reheat steam, 24 MPa / 866 K, lies in region 2)
  region 4: the saturation curve (exact quadratic solution both ways)

Units: P in Pa, T in K, mass-specific results in J/kg (/K). Inputs may be
tensors (computed on their device, in float64) or numbers (float64 on the
CPU; a CPU scalar combines with a tensor on any device). Every function
is written in pure tensor ops (``torch.where``, no in-place updates, no
host reads), so ``torch.func.grad`` / ``jacfwd`` / ``hessian`` / ``vmap``
and autograd pass through it, the fixed-count Newton inversions included.

The Newton inversions evaluate only the Gibbs derivatives they need (h and
cp, or s and cp) and hoist the pressure-only powers out of the loop: the
same sums as `props_liquid` / `props_vapor`, with fewer launches in eager
execution.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

R_WATER = 461.526  # J/kg/K
T_CRIT = 647.096  # K
P_CRIT = 22.064e6  # Pa
MW_H2O = 0.01801528  # kg/mol
F64 = torch.float64

# ---------------------------------------------------------------- region 4
_N4 = np.array(
    [
        0.11670521452767e4,
        -0.72421316703206e6,
        -0.17073846940092e2,
        0.12020824702470e5,
        -0.32325550322333e7,
        0.14915108613530e2,
        -0.48232657361591e4,
        0.40511340542057e6,
        -0.23855557567849,
        0.65017534844798e3,
    ]
)

# ---------------------------------------------------------------- region 1
_I1 = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4,
     5, 8, 8, 21, 23, 29, 30, 31, 32], dtype=float
)
_J1 = np.array(
    [-2, -1, 0, 1, 2, 3, 4, 5, -9, -7, -1, 0, 1, 3, -3, 0, 1, 3, 17, -4, 0, 6,
     -5, -2, 10, -8, -11, -6, -29, -31, -38, -39, -40, -41], dtype=float
)
_N1 = np.array(
    [
        0.14632971213167, -0.84548187169114, -0.37563603672040e1,
        0.33855169168385e1, -0.95791963387872, 0.15772038513228,
        -0.16616417199501e-1, 0.81214629983568e-3, 0.28319080123804e-3,
        -0.60706301565874e-3, -0.18990068218419e-1, -0.32529748770505e-1,
        -0.21841717175414e-1, -0.52838357969930e-4, -0.47184321073267e-3,
        -0.30001780793026e-3, 0.47661393906987e-4, -0.44141845330846e-5,
        -0.72694996297594e-15, -0.31679644845054e-4, -0.28270797985312e-5,
        -0.85205128120103e-9, -0.22425281908000e-5, -0.65171222895601e-6,
        -0.14341729937924e-12, -0.40516996860117e-6, -0.12734301741641e-8,
        -0.17424871230634e-9, -0.68762131295531e-18, 0.14478307828521e-19,
        0.26335781662795e-22, -0.11947622640071e-22, 0.18228094581404e-23,
        -0.93537087292458e-25,
    ]
)

# ---------------------------------------------------------------- region 2
_J0_2 = np.array([0, 1, -5, -4, -3, -2, -1, 2, 3], dtype=float)
_N0_2 = np.array(
    [
        -0.96927686500217e1, 0.10086655968018e2, -0.56087911283020e-2,
        0.71452738081455e-1, -0.40710498223928, 0.14240819171444e1,
        -0.43839511319450e1, -0.28408632460772, 0.21268463753307e-1,
    ]
)
_I2 = np.array(
    [1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 5, 6, 6, 6, 7, 7, 7,
     8, 8, 9, 10, 10, 10, 16, 16, 18, 20, 20, 20, 21, 22, 23, 24, 24, 24],
    dtype=float,
)
_J2 = np.array(
    [0, 1, 2, 3, 6, 1, 2, 4, 7, 36, 0, 1, 3, 6, 35, 1, 2, 3, 7, 3, 16, 35, 0,
     11, 25, 8, 36, 13, 4, 10, 14, 29, 50, 57, 20, 35, 48, 21, 53, 39, 26, 40,
     58],
    dtype=float,
)
_N2 = np.array(
    [
        -0.17731742473213e-2, -0.17834862292358e-1, -0.45996013696365e-1,
        -0.57581259083432e-1, -0.50325278727930e-1, -0.33032641670203e-4,
        -0.18948987516315e-3, -0.39392777243355e-2, -0.43797295650573e-1,
        -0.26674547914087e-4, 0.20481737692309e-7, 0.43870667284435e-6,
        -0.32277677238570e-4, -0.15033924542148e-2, -0.40668253562649e-1,
        -0.78847309559367e-9, 0.12790717852285e-7, 0.48225372718507e-6,
        0.22922076337661e-5, -0.16714766451061e-10, -0.21171472321355e-2,
        -0.23895741934104e2, -0.59059564324270e-17, -0.12621808899101e-5,
        -0.38946842435739e-1, 0.11256211360459e-10, -0.82311340897998e1,
        0.19809712802088e-7, 0.10406965210174e-18, -0.10234747095929e-12,
        -0.10018179379511e-8, -0.80882908646985e-10, 0.10693031879409,
        -0.33662250574171, 0.89185845355421e-24, 0.30629316876232e-12,
        -0.42002467698208e-5, -0.59056029685639e-25, 0.37826947613457e-5,
        -0.12768608934681e-14, 0.73087610595061e-28, 0.55414715350778e-16,
        -0.94369707241210e-6,
    ]
)

# host-side coefficient vectors, moved to a device once and kept there
_TABLES = {
    "I1": _I1, "J1": _J1, "N1": _N1, "I1m1": _I1 - 1, "J1m1": _J1 - 1,
    "J1m2": _J1 - 2, "mN1I1": -_N1 * _I1, "N1J1": _N1 * _J1,
    "N1J1J1m1": _N1 * _J1 * (_J1 - 1),
    "J02": _J0_2, "N02": _N0_2, "J02m1": _J0_2 - 1, "J02m2": _J0_2 - 2,
    "N02J02": _N0_2 * _J0_2, "N02J02J02m1": _N0_2 * _J0_2 * (_J0_2 - 1),
    "I2": _I2, "J2": _J2, "N2": _N2, "I2m1": _I2 - 1, "J2m1": _J2 - 1,
    "J2m2": _J2 - 2, "N2I2": _N2 * _I2, "N2J2": _N2 * _J2,
    "N2J2J2m1": _N2 * _J2 * (_J2 - 1),
}
_ON_DEVICE: dict = {}


def _k(name: str, dev) -> torch.Tensor:
    """Coefficient table `name` as a float64 tensor on `dev` (cached)."""
    key = (name, dev)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(_TABLES[name], dtype=F64, device=dev)
    return t


def _dev(*xs) -> torch.device:
    """The device of the first non-CPU tensor among `xs`, else the CPU."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    return torch.device("cpu")


def _f(x, dev) -> torch.Tensor:
    """`x` as a float64 tensor on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=F64)
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=F64, device=dev)


def _args(*xs):
    dev = _dev(*xs)
    return (dev, *(_f(x, dev) for x in xs))


# ------------------------------------------------------------- saturation
def sat_pressure(T):
    """Saturation pressure [Pa] for 273.15 K <= T <= 647.096 K."""
    _, T = _args(T)
    n = _N4
    theta = T + n[8] / (T - n[9])
    A = theta**2 + n[0] * theta + n[1]
    B = n[2] * theta**2 + n[3] * theta + n[4]
    C = n[5] * theta**2 + n[6] * theta + n[7]
    p_mpa = (2.0 * C / (-B + torch.sqrt(B**2 - 4.0 * A * C))) ** 4
    return p_mpa * 1e6


def sat_temperature(P):
    """Saturation temperature [K] for 611.213 Pa <= P <= 22.064 MPa."""
    _, P = _args(P)
    beta = (P / 1e6) ** 0.25
    n = _N4
    E = beta**2 + n[2] * beta + n[5]
    F = n[0] * beta**2 + n[3] * beta + n[6]
    G = n[1] * beta**2 + n[4] * beta + n[7]
    D = 2.0 * G / (-F - torch.sqrt(F**2 - 4.0 * E * G))
    return 0.5 * (n[9] + D - torch.sqrt((n[9] + D) ** 2 - 4.0 * (n[8] + n[9] * D)))


class SteamProps(NamedTuple):
    v: torch.Tensor  # specific volume [m^3/kg]
    h: torch.Tensor  # specific enthalpy [J/kg]
    s: torch.Tensor  # specific entropy [J/kg/K]
    u: torch.Tensor  # specific internal energy [J/kg]
    cp: torch.Tensor  # isobaric heat capacity [J/kg/K]


# ---------------------------------------------------------------- region 1
def props_liquid(P, T) -> SteamProps:
    """Region-1 compressed-liquid properties from the Gibbs form
    g/RT = sum n_i (7.1-pi)^I_i (tau-1.222)^J_i."""
    dev, P, T = _args(P, T)
    I, J, N = _k("I1", dev), _k("J1", dev), _k("N1", dev)
    pi = P / 16.53e6
    tau = 1386.0 / T
    a = (7.1 - pi)[..., None]
    b = (tau - 1.222)[..., None]
    aI = a**I
    bJ = b**J
    g = torch.sum(N * aI * bJ, -1)
    g_pi = torch.sum(_k("mN1I1", dev) * a ** _k("I1m1", dev) * bJ, -1)
    NaI = N * aI
    g_tau = torch.sum(NaI * J * b ** _k("J1m1", dev), -1)
    g_tautau = torch.sum(NaI * J * _k("J1m1", dev) * b ** _k("J1m2", dev), -1)
    RT = R_WATER * T
    v = RT * pi * g_pi / P
    h = RT * tau * g_tau
    s = R_WATER * (tau * g_tau - g)
    return SteamProps(v=v, h=h, s=s, u=h - P * v, cp=-R_WATER * tau**2 * g_tautau)


def _liquid_pre(P):
    """The pressure-only factors of region 1's tau-derivatives:
    n J (7.1 - pi)^I and n J (J - 1) (7.1 - pi)^I, on the term axis."""
    dev = P.device
    aI = ((7.1 - P / 16.53e6)[..., None]) ** _k("I1", dev)
    return aI * _k("N1J1", dev), aI * _k("N1J1J1m1", dev)


def _liquid_h_cp(pre, T):
    """(h, cp) of region 1 at T from `_liquid_pre`'s factors."""
    dev = T.device
    c1, c2 = pre
    tau = 1386.0 / T
    b = (tau - 1.222)[..., None]
    g_tau = torch.sum(c1 * b ** _k("J1m1", dev), -1)
    g_tautau = torch.sum(c2 * b ** _k("J1m2", dev), -1)
    return R_WATER * T * tau * g_tau, -R_WATER * tau**2 * g_tautau


def enthalpy_liquid(P, T):
    """Region-1 enthalpy h(P, T) [J/kg] alone."""
    dev, P, T = _args(P, T)
    c1, _ = _liquid_pre(P)
    tau = 1386.0 / T
    b = (tau - 1.222)[..., None]
    return R_WATER * T * tau * torch.sum(c1 * b ** _k("J1m1", dev), -1)


# ---------------------------------------------------------------- region 2
def props_vapor(P, T) -> SteamProps:
    """Region-2 superheated-vapor properties, g/RT = gamma0 + gammar."""
    dev, P, T = _args(P, T)
    J0, N0 = _k("J02", dev), _k("N02", dev)
    I, J, N = _k("I2", dev), _k("J2", dev), _k("N2", dev)
    pi = P / 1e6
    tau = 540.0 / T
    t = tau[..., None]
    p = pi[..., None]

    g0 = torch.log(pi) + torch.sum(N0 * t**J0, -1)
    g0_pi = 1.0 / pi
    g0_tau = torch.sum(_k("N02J02", dev) * t ** _k("J02m1", dev), -1)
    g0_tautau = torch.sum(_k("N02J02J02m1", dev) * t ** _k("J02m2", dev), -1)

    b = (tau - 0.5)[..., None]
    pI = p**I
    bJ = b**J
    gr = torch.sum(N * pI * bJ, -1)
    gr_pi = torch.sum(_k("N2I2", dev) * p ** _k("I2m1", dev) * bJ, -1)
    NpI = N * pI
    gr_tau = torch.sum(NpI * J * b ** _k("J2m1", dev), -1)
    gr_tautau = torch.sum(NpI * J * _k("J2m1", dev) * b ** _k("J2m2", dev), -1)

    RT = R_WATER * T
    v = RT * pi * (g0_pi + gr_pi) / P
    h = RT * tau * (g0_tau + gr_tau)
    s = R_WATER * (tau * (g0_tau + gr_tau) - (g0 + gr))
    cp = -R_WATER * tau**2 * (g0_tautau + gr_tautau)
    return SteamProps(v=v, h=h, s=s, u=h - P * v, cp=cp)


def _vapor_pre(P):
    """The pressure-only factors of region 2's residual tau-derivatives:
    n J pi^I and n J (J - 1) pi^I, on the term axis."""
    dev = P.device
    pI = ((P / 1e6)[..., None]) ** _k("I2", dev)
    return pI * _k("N2J2", dev), pI * _k("N2J2J2m1", dev)


def _vapor_tau_sums(pre, T):
    """(tau, g_tau, g_tautau) of region 2 (ideal + residual parts)."""
    dev = T.device
    c1, c2 = pre
    tau = 540.0 / T
    t = tau[..., None]
    b = t - 0.5
    g_tau = torch.sum(_k("N02J02", dev) * t ** _k("J02m1", dev), -1) + torch.sum(
        c1 * b ** _k("J2m1", dev), -1
    )
    g_tautau = torch.sum(
        _k("N02J02J02m1", dev) * t ** _k("J02m2", dev), -1
    ) + torch.sum(c2 * b ** _k("J2m2", dev), -1)
    return tau, g_tau, g_tautau


def _vapor_h_cp(pre, T):
    """(h, cp) of region 2 at T from `_vapor_pre`'s factors."""
    tau, g_tau, g_tautau = _vapor_tau_sums(pre, T)
    return R_WATER * T * tau * g_tau, -R_WATER * tau**2 * g_tautau


def _vapor_s_cp(log_pi, npI, pre, T):
    """(s, cp) of region 2 at T; `log_pi` = log(P / 1 MPa) and `npI` =
    n pi^I on the term axis are the pressure-only parts of g."""
    dev = T.device
    tau, g_tau, g_tautau = _vapor_tau_sums(pre, T)
    t = tau[..., None]
    g = (
        log_pi
        + torch.sum(_k("N02", dev) * t ** _k("J02", dev), -1)
        + torch.sum(npI * (t - 0.5) ** _k("J2", dev), -1)
    )
    return R_WATER * (tau * g_tau - g), -R_WATER * tau**2 * g_tautau


def enthalpy_vapor(P, T):
    """Region-2 enthalpy h(P, T) [J/kg] alone."""
    dev, P, T = _args(P, T)
    tau, g_tau, _ = _vapor_tau_sums(_vapor_pre(P), T)
    return R_WATER * T * tau * g_tau


# ------------------------------------------------------- saturation states
def sat_liquid(P) -> SteamProps:
    """Saturated-liquid state at pressure P (region 1 on the sat curve)."""
    return props_liquid(P, sat_temperature(P))


def sat_vapor(P) -> SteamProps:
    """Saturated-vapor state at pressure P (region 2 on the sat curve)."""
    return props_vapor(P, sat_temperature(P))


# ------------------------------------------------------------- inversions
def temperature_ph_vapor(P, h_target, T_guess=None, iters: int = 25):
    """T with h_vapor(P, T) = h_target, fixed-iteration Newton."""
    dev, P, h_target = _args(P, h_target)
    shape = torch.broadcast_shapes(P.shape, h_target.shape)
    if T_guess is not None:
        T = torch.broadcast_to(_f(T_guess, dev), shape)
    else:
        T = torch.clamp(sat_temperature(P) + 10.0, min=300.0)
    T = torch.broadcast_to(T, torch.broadcast_shapes(T.shape, h_target.shape))
    pre = _vapor_pre(P)
    for _ in range(iters):
        h, cp = _vapor_h_cp(pre, T)
        T = torch.clamp(T - (h - h_target) / cp, 273.16, 2273.15)
    return T


def temperature_ph_liquid(P, h_target, iters: int = 25):
    """T with h_liquid(P, T) = h_target, fixed-iteration Newton (region 1)."""
    dev, P, h_target = _args(P, h_target)
    T = torch.full(torch.broadcast_shapes(P.shape, h_target.shape), 400.0,
                   dtype=F64, device=dev)
    pre = _liquid_pre(P)
    for _ in range(iters):
        h, cp = _liquid_h_cp(pre, T)
        T = torch.clamp(T - (h - h_target) / cp, 273.16, 647.0)
    return T


def _sat_hf_hg(P):
    """(T_sat, h_f, h_g) at P: the pressure-only saturation state."""
    Tsat = sat_temperature(P)
    return Tsat, enthalpy_liquid(P, Tsat), enthalpy_vapor(P, Tsat)


def _t_liquid_pre(pre_l, h, hf, iters):
    """The region-1 Newton for T at min(h, h_f), from 400 K."""
    T = torch.full_like(h, 400.0)
    h_l = torch.minimum(h, hf)
    for _ in range(iters):
        hh, cp = _liquid_h_cp(pre_l, T)
        T = torch.clamp(T - (hh - h_l) / cp, 273.16, 647.0)
    return T


def _t_vapor_pre(pre_v, h, Tsat, hg, iters):
    """The region-2 Newton for T at max(h, h_g), from max(T_sat + 10, 300) K."""
    T = torch.broadcast_to(torch.clamp(Tsat + 10.0, min=300.0), h.shape)
    h_v = torch.maximum(h, hg)
    for _ in range(iters):
        hh, cp = _vapor_h_cp(pre_v, T)
        T = torch.clamp(T - (hh - h_v) / cp, 273.16, 2273.15)
    return T


def _t_of_h_pre(pre_l, pre_v, h, Tsat, hf, hg, iters):
    """T(P, h) from the pressure-only factors (`_liquid_pre`, `_vapor_pre`)
    and saturation state: the region-1 Newton below h_f, the region-2
    Newton above h_g, T_sat between (the two inversions of
    `temperature_ph_liquid` / `_vapor`)."""
    return torch.where(h <= hf, _t_liquid_pre(pre_l, h, hf, iters),
                       torch.where(h >= hg, _t_vapor_pre(pre_v, h, Tsat, hg, iters), Tsat))


def _t_of_h(P, h, Tsat, hf, hg, iters):
    h = torch.broadcast_to(h, torch.broadcast_shapes(P.shape, h.shape))
    return _t_of_h_pre(_liquid_pre(P), _vapor_pre(P), h, Tsat, hf, hg, iters)


def temperature_ph_fn(P, iters: int = 25):
    """Specialized T(h) at fixed pressure with the saturation state hoisted.

    `temperature_ph` recomputes T_sat(P), h_f(P), h_g(P) on every call even
    though they only depend on P; inner loops that invert h repeatedly at
    one pressure should build this closure once instead."""
    dev, P = _args(P)
    Tsat, hf, hg = _sat_hf_hg(P)

    def t_of_h(h):
        return _t_of_h(P, _f(h, dev), Tsat, hf, hg, iters)

    return t_of_h


def temperature_ph(P, h, iters: int = 25):
    """General T(P, h) across liquid / two-phase / vapor.

    Branchless composition: below h_f(P) the region-1 inverse, above
    h_g(P) the region-2 inverse, and the exact region-4 plateau T_sat(P)
    in between. Near-critical pressures use the sub/supercritical
    region-1/2 forms extrapolated to the saturation line (IF97 region 3 is
    not implemented); plateau temperatures remain exact."""
    dev, P, h = _args(P, h)
    Tsat, hf, hg = _sat_hf_hg(P)
    return _t_of_h(P, h, Tsat, hf, hg, iters)


def vapor_fraction_ph(P, h):
    """Quality x in [0, 1] from (P, h); clamped outside the dome."""
    dev, P, h = _args(P, h)
    _, hf, hg = _sat_hf_hg(P)
    return torch.clamp((h - hf) / torch.clamp(hg - hf, min=1.0), 0.0, 1.0)


def enthalpy_pt(P, T):
    """h(P, T) choosing the liquid or vapor branch by T vs T_sat(P): the
    analogue of `iapws95.htpx(T=..., P=...)` used to pin inlet states."""
    dev, P, T = _args(P, T)
    Tsat = sat_temperature(P)
    return torch.where(T < Tsat, enthalpy_liquid(P, T), enthalpy_vapor(P, T))


def temperature_ps_vapor(P, s_target, iters: int = 25):
    """T with s_vapor(P, T) = s_target (ds/dT = cp/T)."""
    dev, P, s_target = _args(P, s_target)
    T = torch.clamp(sat_temperature(P) + 10.0, min=300.0)
    T = torch.broadcast_to(T, torch.broadcast_shapes(P.shape, s_target.shape))
    pre = _vapor_pre(P)
    log_pi = torch.log(P / 1e6)
    npI = _k("N2", dev) * (P / 1e6)[..., None] ** _k("I2", dev)
    for _ in range(iters):
        s, cp = _vapor_s_cp(log_pi, npI, pre, T)
        T = torch.clamp(T - (s - s_target) * T / cp, 273.16, 2273.15)
    return T


# ----------------------------------------------------- cycle building blocks
class ExpansionResult(NamedTuple):
    h_out: torch.Tensor  # J/kg
    T_out: torch.Tensor  # K (saturation T if two-phase)
    quality: torch.Tensor  # vapor fraction in [0,1]; 1.0 if superheated
    work: torch.Tensor  # J/kg extracted (positive)


def _expand_from_state(h_in, s_in, P_out, eta_isentropic) -> ExpansionResult:
    """Shared expansion endpoint: isentropic target at P_out (wet via
    region-4 quality mixing, dry via the (P, s) inversion), efficiency
    blend, and the actual outlet state."""
    dev, h_in, s_in, P_out = _args(h_in, s_in, P_out)
    Tsat = sat_temperature(P_out)
    liq = props_liquid(P_out, Tsat)
    vap = props_vapor(P_out, Tsat)
    wet = s_in < vap.s
    x_s = torch.clamp((s_in - liq.s) / torch.clamp(vap.s - liq.s, min=1e-9), 0.0, 1.0)
    h_s_wet = liq.h + x_s * (vap.h - liq.h)
    T_dry = temperature_ps_vapor(P_out, s_in)
    h_s_dry = enthalpy_vapor(P_out, T_dry)
    h_s = torch.where(wet, h_s_wet, h_s_dry)

    h_out = h_in - eta_isentropic * (h_in - h_s)
    wet_act = h_out < vap.h
    x = torch.clamp((h_out - liq.h) / torch.clamp(vap.h - liq.h, min=1e-9), 0.0, 1.0)
    T_out = torch.where(
        wet_act, Tsat,
        temperature_ph_vapor(P_out, h_out, T_guess=torch.maximum(T_dry, Tsat + 1.0)),
    )
    return ExpansionResult(
        h_out=h_out,
        T_out=T_out,
        quality=torch.where(wet_act, x, torch.ones_like(x)),
        work=h_in - h_out,
    )


def turbine_expansion(P_in, T_in, P_out, eta_isentropic=1.0) -> ExpansionResult:
    """Expand superheated steam from (P_in, T_in) to P_out with isentropic
    efficiency eta; wet exhaust via region-4 quality mixing (the IDAES
    HelmTurbineStage behavior)."""
    inlet = props_vapor(P_in, T_in)
    return _expand_from_state(inlet.h, inlet.s, P_out, eta_isentropic)


def turbine_expansion_ph(P_in, h_in, P_out, eta_isentropic=1.0) -> ExpansionResult:
    """Expand steam given the true inlet enthalpy (possibly two-phase): the
    (P, h) form of :func:`turbine_expansion`, for multi-stage trains whose
    later stages ingest wet steam."""
    dev, P_in, h_in = _args(P_in, h_in)
    Tsat_in = sat_temperature(P_in)
    liq_i = props_liquid(P_in, Tsat_in)
    vap_i = props_vapor(P_in, Tsat_in)
    wet_in = h_in < vap_i.h
    x_in = torch.clamp(
        (h_in - liq_i.h) / torch.clamp(vap_i.h - liq_i.h, min=1e-9), 0.0, 1.0
    )
    s_wet = liq_i.s + x_in * (vap_i.s - liq_i.s)
    T_dry_in = temperature_ph_vapor(P_in, h_in, T_guess=Tsat_in + 10.0)
    s_dry = props_vapor(P_in, T_dry_in).s
    s_in = torch.where(wet_in, s_wet, s_dry)
    return _expand_from_state(h_in, s_in, P_out, eta_isentropic)


def pump_work(P_in, P_out, T_in, eta_isentropic=1.0):
    """Feedwater pump specific work [J/kg]: v dP / eta (incompressible)."""
    dev, P_in, P_out, T_in = _args(P_in, P_out, T_in)
    v = props_liquid(P_in, T_in).v
    return v * (P_out - P_in) / eta_isentropic


def lmtd_underwood(dt1, dt2):
    """Underwood LMTD approximation (the reference FWH delta-T callback):
    ((dt1^(1/3) + dt2^(1/3)) / 2)^3, smooth-clipped positive."""
    dev, dt1, dt2 = _args(dt1, dt2)
    a = torch.clamp(dt1, min=1e-2) ** (1.0 / 3.0)
    b = torch.clamp(dt2, min=1e-2) ** (1.0 / 3.0)
    return (0.5 * (a + b)) ** 3
