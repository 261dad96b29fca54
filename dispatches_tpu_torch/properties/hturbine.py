"""Hydrogen-turbine thermodynamic chain: compressor -> combustor ->
expander (port of `dispatches_tpu/properties/hturbine.py`).

Reproduces the physics of the reference's composite `HydrogenTurbine` unit
(`dispatches/unit_models/hydrogen_turbine_unit.py:97-167`: IDAES Compressor
-> StoichiometricReactor -> Turbine over `hturbine_ideal_vap` properties)
as a differentiable torch function. At the operating point the case
studies fix (`RE_flowsheet.py:280-324`: air/H2 ratio 10.76, dp +-24.01 bar,
isentropic efficiencies 0.86/0.89, conversion 0.99, feed at 300 K /
1.01325 bar) the net electric output is linear in the H2 feed rate;
`net_specific_work_kwh_per_mol` evaluates that specific work once, in
float64 on the CPU, as an LP coefficient.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .h2 import (
    STOICH_R1,
    _t,
    isentropic_temperature,
    mix_enthalpy_flow,
    temperature_from_enthalpy,
)

# stream compositions fixed by the case studies (`RE_flowsheet.py:261-293`)
# species order: hydrogen, oxygen, nitrogen, argon, water
Y_H2_FEED = np.asarray([0.99, 0.0025, 0.0025, 0.0025, 0.0025])
Y_AIR = np.asarray([2e-4, 0.2054, 0.7672, 0.0032, 0.0240])
AIR_H2_RATIO = 10.76  # mol air per mol hydrogen-feed stream (`load_parameters.py:77`)


class TurbineChainState(NamedTuple):
    T_comp_out: torch.Tensor
    T_reactor_out: torch.Tensor
    T_turb_out: torch.Tensor
    work_compressor: torch.Tensor  # W, positive = consumed
    work_turbine: torch.Tensor  # W, negative = produced
    net_power: torch.Tensor  # W, positive = net production
    n_out: torch.Tensor  # outlet molar flows (5,)


def turbine_chain(
    h2_feed_mol_s,
    T_in=300.0,
    p_in=1.01325e5,
    delta_p=24.01e5,
    eta_compressor=0.86,
    eta_turbine=0.89,
    conversion=0.99,
    air_h2_ratio=AIR_H2_RATIO,
) -> TurbineChainState:
    """Full compressor -> combustor -> turbine chain for a given H2-feed
    stream rate (mol/s of the 99% H2 feed: the tank's
    `outlet_to_turbine` plus purchased H2). Air is added at the fixed
    air/H2 ratio (`RE_flowsheet.py:300-302`)."""
    f = _t(h2_feed_mol_s)

    def vec(a):
        return torch.as_tensor(a, dtype=f.dtype, device=f.device)

    n_feed = f[..., None] * vec(Y_H2_FEED) + (air_h2_ratio * f)[..., None] * vec(Y_AIR)
    p_mid = p_in + delta_p

    # compressor (isentropic efficiency referenced to ideal work)
    T2s = isentropic_temperature(n_feed, T_in, p_in, p_mid)
    H1 = mix_enthalpy_flow(n_feed, T_in)
    W_comp = (mix_enthalpy_flow(n_feed, T2s) - H1) / eta_compressor
    T2 = temperature_from_enthalpy(n_feed, H1 + W_comp, T2s)

    # adiabatic stoichiometric combustor, extent = conversion * nH2 / 2. The
    # enthalpy table is formation-referenced for water (the reference zeroes
    # the Shomate H coefficient, `hturbine_ideal_vap.py:152`), so the
    # composition change itself releases the combustion heat; adding
    # DH_RXN_R1 would count it twice
    extent = conversion * n_feed[..., 0] / 2.0
    n_out = n_feed + extent[..., None] * vec(STOICH_R1)
    H3 = mix_enthalpy_flow(n_feed, T2)
    T3 = temperature_from_enthalpy(
        n_out, H3, T2 + 1500.0 * extent / torch.clamp_min(torch.sum(n_out, -1), 1e-12))

    # expander back to p_in
    T4s = isentropic_temperature(n_out, T3, p_mid, p_in)
    W_turb = (mix_enthalpy_flow(n_out, T4s) - H3) * eta_turbine  # negative (produced)
    T4 = temperature_from_enthalpy(n_out, H3 + W_turb, T4s)

    return TurbineChainState(
        T_comp_out=T2,
        T_reactor_out=T3,
        T_turb_out=T4,
        work_compressor=W_comp,
        work_turbine=W_turb,
        net_power=-(W_turb + W_comp),
        n_out=n_out,
    )


@lru_cache(maxsize=None)
def net_specific_work_kwh_per_mol(**kw) -> float:
    """Net electric output per mol/s of H2-feed stream, in kWh per mol.

    Net power is proportional to the feed with everything else fixed:
    evaluate at 1 mol/s and convert W -> kW and per mol/s -> per mol
    (the LP multiplies by 3600 itself)."""
    st = turbine_chain(1.0, **kw)
    return float(st.net_power) / 1000.0 / 3600.0
