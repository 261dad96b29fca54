"""Nuclear hybrid flowsheet: NPP -> electrical splitter -> PEM -> H2 tank ->
H2 turbine, as one differentiable forward function (port of
`dispatches_tpu/case_studies/nuclear/flowsheet.py`).

The reference wires IDAES unit blocks with Arcs, fixes the degrees of
freedom and lets IPOPT square-solve (`build_ne_flowsheet` +
`fix_dof_and_initialize`, `nuclear_flowsheet.py:74-330`). Here the same
specification (every fixed DoF is an argument) is evaluated in closed form;
the only implicit parts, the isentropic temperatures of the turbine chain,
are fixed-iteration Newton loops. Any argument may be a tensor (a batch of
operating points along its axes, or a leaf of an autograd graph).

The topology switches mirror the reference: `include_pem/tank/turbine` drop
the downstream sections as the Pyomo model does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...properties.hturbine import TurbineChainState, turbine_chain

# H-tec design: 54.517 kW-hr/kg -> mol H2 per s per kW
# (`nuclear_flowsheet.py:170` fixes pem.electricity_to_mol = 0.002527406)
PEM_ELECTRICITY_TO_MOL = 0.002527406
MW_H2 = 2.016e-3  # kg/mol


@dataclasses.dataclass
class NuclearFlowsheetResult:
    """Solved flowsheet state (the reference's post-solve variable values)."""

    np_to_grid_kw: torch.Tensor
    np_to_pem_kw: torch.Tensor
    pem_out_mol: torch.Tensor  # H2 from the electrolyzer [mol/s]
    tank_holdup_mol: Optional[torch.Tensor] = None
    h2_to_turbine_mol: Optional[torch.Tensor] = None
    h2_to_pipeline_mol: Optional[torch.Tensor] = None
    turbine: Optional[TurbineChainState] = None
    turbine_power_kw: Optional[torch.Tensor] = None


def solve_ne_flowsheet(
    np_capacity_mw: float = 500.0,
    include_pem: bool = True,
    include_tank: bool = True,
    include_turbine: bool = True,
    split_frac_grid=0.99,
    tank_holdup_previous_mol=0.0,
    flow_mol_to_turbine=1.0,
    flow_mol_to_pipeline=1.0,
    dt_s: float = 3600.0,
    pem_outlet_temperature: float = 300.0,
    pem_outlet_pressure_pa: float = 1.01325e5,
    air_h2_ratio: float = 10.76,
    compressor_dp_pa: float = 24.01e5,
    device="cuda",
    dtype=torch.float64,
) -> NuclearFlowsheetResult:
    """Square-solve the nuclear flowsheet at a fixed operating point.

    The arguments are the reference's `fix_dof_and_initialize` keyword set
    (`nuclear_flowsheet.py:225-257`). A tensor argument keeps its device,
    dtype and graph; numbers become tensors on `device` in `dtype`."""
    def t(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(v, dtype=dtype, device=device)

    np_kw = np_capacity_mw * 1e3
    sf = t(split_frac_grid)
    to_grid = np_kw * sf
    to_pem = np_kw * (1.0 - sf) if include_pem else torch.zeros_like(sf)

    if not include_pem:
        return NuclearFlowsheetResult(
            np_to_grid_kw=to_grid, np_to_pem_kw=to_pem, pem_out_mol=torch.zeros_like(sf)
        )

    pem_out = PEM_ELECTRICITY_TO_MOL * to_pem  # mol/s

    if not include_tank:
        return NuclearFlowsheetResult(
            np_to_grid_kw=to_grid, np_to_pem_kw=to_pem, pem_out_mol=pem_out
        )

    f_turb = t(flow_mol_to_turbine if include_turbine else 0.0)
    f_pipe = t(flow_mol_to_pipeline)
    # SimpleHydrogenTank holdup balance (`hydrogen_tank_simplified.py:178-184`)
    holdup = t(tank_holdup_previous_mol) + dt_s * (pem_out - f_turb - f_pipe)

    if not include_turbine:
        return NuclearFlowsheetResult(
            np_to_grid_kw=to_grid,
            np_to_pem_kw=to_pem,
            pem_out_mol=pem_out,
            tank_holdup_mol=holdup,
            h2_to_turbine_mol=f_turb,
            h2_to_pipeline_mol=f_pipe,
        )

    # the translator keeps the total molar flow and relabels the
    # composition to 99% H2 (`nuclear_flowsheet.py:163-180`); the mixer adds
    # air at the fixed ratio, and the compressor -> combustor -> expander
    # chain runs at the PEM outlet state
    # the inlet state on the flows' device: a number is a CPU tensor to
    # the property functions, which a (5,)-species term cannot mix with
    # CUDA tensors
    def like(v):
        return torch.as_tensor(v, dtype=f_turb.dtype, device=f_turb.device)

    chain = turbine_chain(
        f_turb,
        T_in=like(pem_outlet_temperature),
        p_in=like(pem_outlet_pressure_pa),
        delta_p=like(compressor_dp_pa),
        air_h2_ratio=air_h2_ratio,
    )
    return NuclearFlowsheetResult(
        np_to_grid_kw=to_grid,
        np_to_pem_kw=to_pem,
        pem_out_mol=pem_out,
        tank_holdup_mol=holdup,
        h2_to_turbine_mol=f_turb,
        h2_to_pipeline_mol=f_pipe,
        turbine=chain,
        turbine_power_kw=chain.net_power * 1e-3,
    )
