"""Detailed compressed-gas hydrogen tank: nonlinear adiabatic dynamics
(port of `dispatches_tpu/units/tank_detailed.py`).

The reference's `HydrogenTank` (`dispatches/unit_models/hydrogen_tank.py:
68-622`) carries (P, T) between periods through a `previous_state` block
and lets IPOPT solve the coupled material/energy holdup equations. Here the
same physics (ideal-gas holdup, adiabatic internal-energy balance, cylinder
geometry) is a closed-form differentiable state transition:

    n      = n_prev + dt * (flow_in - flow_out)
    n u(T) = n_prev u(T_prev) + dt * (flow_in h(T_in) - flow_out h(T))
    P      = n R T / V

with u(T) = h(T) - R (T - T_ref), the IDAES ideal-gas convention (u and h
share the 298.15 K reference zero). The energy balance is solved for T by a
fixed-iteration Newton loop. A horizon is a loop over steps on a batch of
lanes (every leading axis of the flows is a lane), and gradients flow
through every step by `torch.autograd`.

Golden fill/empty numbers (`unit_models/tests/test_hydrogen_tank.py:
148-185`): fill at 1 mol/s for 1 h into a 0.1 m x 0.3 m tank from (1e5 Pa,
300 K) gives holdup 3600.0945 mol, T ~ 300.75 K, P ~ 3.82e9 Pa.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..properties.h2 import R_GAS, _t, cp_mol, enth_mol

T_REF = 298.15  # K, the Shomate forms' reference temperature


def tank_volume(diameter, length):
    """Cylinder volume [m^3] (`hydrogen_tank.py:183-187` volume_cons)."""
    return math.pi * length * (diameter / 2.0) ** 2


def _h_h2(T):
    """Pure-H2 molar enthalpy above 298.15 K [J/mol]."""
    return enth_mol(T, "hydrogen")


def _cp_h2(T):
    return cp_mol(T, "hydrogen")


def u_mol(T):
    """Ideal-gas molar internal energy [J/mol], IDAES convention
    u(T) = h(T) - R (T - T_ref), so that u(T_ref) = h(T_ref) = 0."""
    return _h_h2(T) - R_GAS * (_t(T) - T_REF)


class TankState(NamedTuple):
    holdup_mol: torch.Tensor  # total H2 holdup [mol]
    temperature: torch.Tensor  # tank temperature [K]
    pressure: torch.Tensor  # tank pressure [Pa]


def state_from_pt(pressure, temperature, volume, device="cuda", dtype=torch.float64):
    """Tank state from (P, T), the reference's `previous_state` fix idiom
    (`test_hydrogen_tank.py:88-90`), as tensors on `device`."""
    P = torch.as_tensor(pressure, dtype=dtype, device=device)
    T = torch.as_tensor(temperature, dtype=dtype, device=device)
    n = P * volume / (R_GAS * T)
    return TankState(holdup_mol=n, temperature=T, pressure=P)


def tank_step(
    state: TankState,
    flow_in_mol,  # mol/s
    T_in,  # K
    flow_out_mol,  # mol/s
    dt,  # s
    volume,  # m^3
    newton_iters: int = 20,
) -> TankState:
    """One adiabatic fill/empty step of every lane. Differentiable."""
    n_prev = state.holdup_mol
    T_prev = state.temperature
    like = dict(dtype=n_prev.dtype, device=n_prev.device)
    fin = torch.as_tensor(flow_in_mol, **like)
    fout = torch.as_tensor(flow_out_mol, **like)
    tin = torch.as_tensor(T_in, **like)

    # overdraw guard: the reference enforces holdup >= 0 through NLP bounds
    # (`hydrogen_tank.py:248` within=NonNegativeReals); the closed-form
    # transition caps the outflow at what the tank holds
    n_floor = 1e-9
    fout = torch.minimum(fout, torch.clamp_min(n_prev + dt * fin - n_floor, 0.0) / dt)

    n = n_prev + dt * (fin - fout)
    # energy balance residual in T (the outlet leaves at tank temperature,
    # so its h(T) term stays inside the Newton solve)
    rhs_const = n_prev * u_mol(T_prev) + dt * fin * _h_h2(tin)

    T = T_prev
    for _ in range(newton_iters):
        # residual n u(T) + dt fout h(T) - rhs, with u = h - R (T - T_ref);
        # d/dT = n (cp - R) + dt fout cp
        cp = _cp_h2(T)
        h = _h_h2(T)
        res = n * (h - R_GAS * (T - T_REF)) + dt * fout * h - rhs_const
        dres = n * (cp - R_GAS) + dt * fout * cp
        T = torch.clamp(T - res / dres, 150.0, 2000.0)

    P = n * R_GAS * T / volume
    return TankState(holdup_mol=n, temperature=T, pressure=P)


class HydrogenTankDetailed:
    """Horizon-level wrapper: steps `tank_step` over hourly (or finer)
    in/out flow profiles, the analogue of chaining reference tank blocks
    through `previous_state`. Tensors live on `device` (the card by
    default)."""

    def __init__(
        self,
        tank_diameter: float = 0.1,
        tank_length: float = 0.3,
        dt: float = 3600.0,
        newton_iters: int = 20,
        device="cuda",
        dtype=torch.float64,
    ):
        self.volume = tank_volume(tank_diameter, tank_length)
        self.dt = dt
        self.newton_iters = newton_iters
        self.device = torch.device(device)
        self.dtype = dtype

    def initial_state(self, pressure=1e5, temperature=300.0) -> TankState:
        return state_from_pt(pressure, temperature, self.volume, self.device, self.dtype)

    def step(self, state, flow_in_mol, T_in, flow_out_mol) -> TankState:
        return tank_step(
            state, flow_in_mol, T_in, flow_out_mol, self.dt, self.volume,
            self.newton_iters,
        )

    def simulate(self, state0: TankState, flow_in_mol, T_in, flow_out_mol) -> TankState:
        """Run the whole horizon: flows of shape (..., T) (leading axes are
        lanes) give a TankState whose leaves have shape (..., T). `T_in`
        and `flow_out_mol` broadcast against `flow_in_mol`."""
        like = dict(dtype=self.dtype, device=self.device)
        fin = torch.as_tensor(flow_in_mol, **like)
        tin = torch.broadcast_to(torch.as_tensor(T_in, **like), fin.shape)
        fout = torch.broadcast_to(torch.as_tensor(flow_out_mol, **like), fin.shape)
        lanes = fin.shape[:-1]
        st = TankState(*(torch.broadcast_to(a, lanes) for a in state0))
        traj = []
        for t in range(fin.shape[-1]):
            st = self.step(st, fin[..., t], tin[..., t], fout[..., t])
            traj.append(st)
        return TankState(*(torch.stack(leaf, dim=-1) for leaf in zip(*traj)))
