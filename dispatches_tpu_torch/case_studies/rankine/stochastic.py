"""Scenario-weighted price-taker design of the simple Rankine plant (port of
`dispatches_tpu/case_studies/rankine/stochastic.py`).

The counterpart of `stochastic_optimization_problem`
(`simple_rankine_cycle.py:605-778`): the reference instantiates one full
IDAES flowsheet per LMP scenario plus a "capex plant", couples them with
P_min/P_max constraints, and hands the NLP to IPOPT. Here the whole
problem is one smooth box-constrained program,

    x = [cap_flow, f_1 .. f_N],  f_i in [0.3, 1]  (op P in [0.3, 1]*P_max)
    op_flow_i = f_i * cap_flow

because with fixed intensive states every scenario flowsheet is the same
closed-form function of its flow (see flowsheet.py): the coupling
constraints (`eq_min_power`/`eq_max_power`, `:680-688`) become variable
bounds, and the scenario loop a tensor axis. Solved by the batched
interior-point NLP solver (`solvers/nlp.py`) on `device`.

Objective (`:750-764`): max plant_lifetime * sum_i w_i (lmp_i * P_i -
opcost_i) - capex(cap_flow) == min -(revenue - cost).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...solvers.nlp import solve_nlp
from .flowsheet import RankineSpec, capital_cost_musd, solve_rankine, specific_energies

MW_WATER = 0.01801528


@dataclasses.dataclass
class StochasticResult:
    cap_flow_mol: float
    p_max_mw: float
    op_power_mw: np.ndarray
    obj_usd: float
    converged: bool
    iterations: int
    kkt_error: float = float("nan")  # the NLP's final KKT error (not in the JAX result)


def _no_constraints(x, p):
    return x[:0]


def stochastic_optimization_problem(
    lmp,
    lmp_weights=None,
    power_demand=None,
    calc_boiler_eff: bool = False,
    p_max_lower_bound: float = 10.0,  # MW
    p_max_upper_bound: float = 300.0,
    capital_payment_years: float = 5.0,
    plant_lifetime: float = 20.0,
    spec: RankineSpec = RankineSpec(),
    min_power_frac: float = 0.3,
    x0_flow: float = 10000.0,
    tol: float = 1e-6,
    max_iter: int = 150,
    device="cuda",
    dtype=torch.float64,
) -> StochasticResult:
    """Solve the stochastic design problem for LMP scenarios `lmp` [$/MWh]
    with probabilities/durations `lmp_weights` (hours per scenario-year)."""
    lmp = torch.as_tensor(np.asarray(lmp, float), dtype=dtype, device=device)
    N = lmp.shape[0]
    w = (
        torch.ones(N, dtype=dtype, device=device) * (8760.0 / N)
        if lmp_weights is None
        else torch.as_tensor(np.asarray(lmp_weights, float), dtype=dtype, device=device)
    )
    demand = (None if power_demand is None else
              torch.as_tensor(np.asarray(power_demand, float), dtype=dtype, device=device))

    # specific net work [J/kg] is flow-independent: use it to convert the
    # P_max bounds into capacity-flow bounds
    se = specific_energies(spec)
    w_net = float(se["w_net_specific"]) * MW_WATER  # W per (mol/s)
    lb_flow = p_max_lower_bound * 1e6 / w_net
    ub_flow = p_max_upper_bound * 1e6 / w_net

    def objective(x, _p):
        cap_flow = x[0]
        f = x[1:]
        op_flow = f * cap_flow
        p_max = solve_rankine(cap_flow, spec).net_power_w
        st = solve_rankine(
            op_flow,
            spec,
            net_power_max_w=p_max,
            calc_boiler_eff=calc_boiler_eff,
        )
        rev = torch.sum(w * lmp * st.net_power_w * 1e-6)  # $/yr
        op = torch.sum(w * st.operating_cost_per_hr)  # $/yr
        capex = capital_cost_musd(cap_flow, spec) * 1e6  # $
        total_cost = plant_lifetime * op + capex
        total_rev = plant_lifetime * rev
        # penalize demand violation smoothly if a demand cap is given
        pen = 0.0
        if demand is not None:
            over = torch.clamp(st.net_power_w * 1e-6 - demand, min=0.0)
            pen = 1e9 * torch.sum(over**2)
        return -(total_rev - total_cost) * 1e-8 + pen * 1e-8  # scaled

    x0 = torch.cat([torch.tensor([x0_flow], dtype=dtype),
                    torch.full((N,), 0.9, dtype=dtype)]).to(device)
    l = torch.cat([torch.tensor([lb_flow], dtype=dtype),
                   torch.full((N,), min_power_frac, dtype=dtype)]).to(device)
    u = torch.cat([torch.tensor([ub_flow], dtype=dtype), torch.ones(N, dtype=dtype)]).to(device)

    sol = solve_nlp(objective, _no_constraints, x0, l, u, tol=tol, max_iter=max_iter)

    x = sol.x.cpu()
    cap_flow = float(x[0])
    p_max = float(solve_rankine(cap_flow, spec).net_power_w) * 1e-6
    op_power = solve_rankine(
        x[1:] * cap_flow,
        spec,
        net_power_max_w=p_max * 1e6,
        calc_boiler_eff=calc_boiler_eff,
    ).net_power_w.numpy() * 1e-6
    return StochasticResult(
        cap_flow_mol=cap_flow,
        p_max_mw=p_max,
        op_power_mw=op_power,
        obj_usd=-float(sol.obj) * 1e8,
        converged=bool(sol.converged),
        iterations=int(sol.iterations),
        kkt_error=float(sol.kkt_error),
    )


def surrogate_design_problem(
    revenue_surrogate,
    p_max_lower_bound: float = 10.0,
    p_max_upper_bound: float = 300.0,
    capital_payment_years: float = 5.0,
    plant_lifetime: float = 20.0,
    spec: RankineSpec = RankineSpec(),
    tol: float = 1e-6,
    max_iter: int = 100,
    device="cuda",
    dtype=torch.float64,
):
    """Conceptual design with a revenue surrogate in the loop: the analogue
    of `surrogate_design_scikit.py:95-180`, where trained revenue surrogates
    are embedded via OMLT into a Pyomo NLP. Here the surrogate is any torch
    callable p_max_mw -> $/yr called directly inside the autodiff'd
    objective.

    `revenue_surrogate`: callable mapping a shape-(1,) tensor [p_max in MW]
    to predicted annual revenue [$/yr]."""
    se = specific_energies(spec)
    w_net = float(se["w_net_specific"]) * MW_WATER
    lb_flow = p_max_lower_bound * 1e6 / w_net
    ub_flow = p_max_upper_bound * 1e6 / w_net

    def objective(x, _p):
        cap_flow = x[0]
        p_max_mw = solve_rankine(cap_flow, spec).net_power_w * 1e-6
        rev = torch.reshape(revenue_surrogate(torch.reshape(p_max_mw, (1,))), ())
        capex = capital_cost_musd(cap_flow, spec) * 1e6
        return -(plant_lifetime * rev - capex) * 1e-8

    t = lambda v: torch.tensor([v], dtype=dtype, device=device)  # noqa: E731
    sol = solve_nlp(objective, _no_constraints, t(0.5 * (lb_flow + ub_flow)),
                    t(lb_flow), t(ub_flow), tol=tol, max_iter=max_iter)
    cap_flow = float(sol.x[0])
    return {
        "cap_flow_mol": cap_flow,
        "p_max_mw": float(solve_rankine(cap_flow, spec).net_power_w) * 1e-6,
        "npv_usd": -float(sol.obj) * 1e8,
        "converged": bool(sol.converged),
    }
