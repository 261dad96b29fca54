"""Full market-surrogate conceptual design of the Rankine plant (port of
`dispatches_tpu/case_studies/rankine/surrogate_design.py`).

Counterpart of `surrogate_design_scikit.py:95-298` /
`surrogate_design_alamo.py` (`conceptual_design_problem_nn`): revenue,
number-of-startups and 11-bin zone-hours surrogates of the Prescient market
outcome are embedded into a design NLP over the plant size and its market
parameters (pmin multiplier, ramp multiplier, min up/down times, marginal /
no-load / startup costs). The reference builds one IDAES flowsheet per
operating zone plus OMLT encodings of three networks and solves with
IPOPT; here each zone cost is the closed-form Rankine flowsheet evaluated
at the zone power, the surrogates are direct torch callables, and the
whole model is one autodiff objective for the interior-point NLP solver
(`solvers/nlp.py`) on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ...solvers.nlp import solve_nlp
from ...surrogates.embed import smooth_nonneg
from .flowsheet import (
    MW_WATER,
    RankineSpec,
    capital_cost_musd,
    solve_rankine,
    specific_energies,
)

# zone grid: fraction of (pmax - pmin) above pmin; zone 0 handled as "off"
# (`surrogate_design_scikit.py:93`)
ZONE_OUTPUTS = np.array([0.0, 0.15, 0.25, 0.35, 0.45, 0.55, 0.65, 0.75, 0.85, 1.0])


@dataclasses.dataclass
class MarketInputBounds:
    """Design-variable bounds (`surrogate_design_scikit.py:117-124`)."""

    pmin_multi: tuple = (0.15, 0.45)
    ramp_multi: tuple = (0.5, 1.0)
    min_up_time: tuple = (1.0, 16.0)
    min_dn_multi: tuple = (0.5, 2.0)
    marg_cst: tuple = (5.0, 30.0)
    no_load_cst: tuple = (0.0, 2.5)
    startup_cst: tuple = (0.0, 136.0)


DESIGN_NAMES = ("cap_flow", "pmin_multi", "ramp_multi", "min_up_time",
                "min_dn_multi", "marg_cst", "no_load_cst", "startup_cst")


def market_design_problem(
    revenue_fn: Callable,
    nstartups_fn: Callable,
    zone_hours_fn: Callable,
    p_lower_bound: float = 10.0,
    p_upper_bound: float = 300.0,
    capital_payment_years: float = 5.0,
    plant_lifetime: float = 20.0,
    coal_price: float = 51.96,
    calc_boiler_eff: bool = False,
    bounds: MarketInputBounds = MarketInputBounds(),
    spec: RankineSpec = RankineSpec(),
    fix: dict | None = None,
    device="cuda",
    dtype=torch.float64,
):
    """The design problem of `conceptual_design_problem_nn`:
    ``(terms, lo, hi)`` with ``terms(x) -> (npv [MM$], info)`` a torch
    function of one design x (the order of `DESIGN_NAMES`) and the box
    ``lo <= x <= hi`` as lists (equal bounds for the `fix`ed names)."""
    spec = dataclasses.replace(spec, coal_price_per_ton=coal_price)
    se = specific_energies(spec)
    w_net = float(se["w_net_specific"]) * MW_WATER  # W per mol/s
    lb_flow, ub_flow = p_lower_bound * 1e6 / w_net, p_upper_bound * 1e6 / w_net

    zone_fracs = torch.as_tensor(ZONE_OUTPUTS, dtype=dtype, device=device)

    def build_terms(x):
        cap_flow = x[0]
        pmin_multi, ramp_multi, min_up, min_dn = x[1], x[2], x[3], x[4]
        marg_cst, no_load_cst, startup_cst = x[5], x[6], x[7]

        # net power is linear in flow: P = flow * w_net (see flowsheet.py)
        pmax = cap_flow * w_net * 1e-6  # MW
        pmin = pmin_multi * pmax
        inputs = torch.stack(
            [pmax, pmin_multi, ramp_multi, min_up, min_dn, marg_cst,
             no_load_cst, startup_cst]
        )

        rev = smooth_nonneg(torch.reshape(revenue_fn(inputs), ()))  # MM$/yr
        nstart = smooth_nonneg(torch.reshape(nstartups_fn(inputs), ()))
        zh_raw = smooth_nonneg(torch.reshape(zone_hours_fn(inputs), (11,)))
        # scaled_hours_i = raw_i * 8736 / total (`con_scale_zone_hours`)
        zh = zh_raw * 8736.0 / torch.sum(zh_raw)

        # operating zones: power = pmin + f*(pmax-pmin); cost from the
        # closed-form flowsheet at that power (`eq_fix_power`, `:225-227`)
        zone_p_mw = pmin + zone_fracs * (pmax - pmin)
        zone_flow = zone_p_mw * 1e6 / w_net
        st = solve_rankine(
            zone_flow,
            spec,
            net_power_max_w=pmax * 1e6,
            calc_boiler_eff=calc_boiler_eff,
        )
        zone_cost_hr = st.operating_cost_per_hr  # $/hr at each zone power
        # off zone: no-load cost * pmax [MM$count] (`off_fs.fs.operating_cost`)
        off_cost_hr = no_load_cst * pmax

        op_mm = (torch.sum(zh[1:] * zone_cost_hr) * 1e-6 + zh[0] * off_cost_hr * 1e-6)
        startup_mm = startup_cst * nstart * pmax * 1e-6
        cap_mm = capital_cost_musd(cap_flow, spec) / capital_payment_years

        total_cost = plant_lifetime * (op_mm + startup_mm) + capital_payment_years * cap_mm
        total_rev = plant_lifetime * rev
        return total_rev - total_cost, {
            "pmax": pmax,
            "pmin": pmin,
            "revenue": rev,
            "nstartups": nstart,
            "zone_hours": zh,
            "op_cost_mm": op_mm,
        }

    b = bounds
    lo = [lb_flow, b.pmin_multi[0], b.ramp_multi[0], b.min_up_time[0],
          b.min_dn_multi[0], b.marg_cst[0], b.no_load_cst[0], b.startup_cst[0]]
    hi = [ub_flow, b.pmin_multi[1], b.ramp_multi[1], b.min_up_time[1],
          b.min_dn_multi[1], b.marg_cst[1], b.no_load_cst[1], b.startup_cst[1]]
    for k, v in (fix or {}).items():
        i = DESIGN_NAMES.index(k)
        lo[i] = hi[i] = float(v)
    return build_terms, lo, hi


def conceptual_design_problem_nn(
    revenue_fn: Callable,  # (8,) inputs -> annual revenue [MM$]
    nstartups_fn: Callable,  # (8,) inputs -> startups/yr
    zone_hours_fn: Callable,  # (8,) inputs -> (11,) raw zone hours
    p_lower_bound: float = 10.0,
    p_upper_bound: float = 300.0,
    capital_payment_years: float = 5.0,
    plant_lifetime: float = 20.0,
    coal_price: float = 51.96,
    calc_boiler_eff: bool = False,
    bounds: MarketInputBounds = MarketInputBounds(),
    spec: RankineSpec = RankineSpec(),
    fix: dict | None = None,
    tol: float = 1e-6,
    max_iter: int = 200,
    device="cuda",
    dtype=torch.float64,
):
    """Surrogate inputs follow the reference ordering (`:126-129`):
    [pmax(MW), pmin_multi, ramp_multi, min_up_time, min_dn_multi, marg_cst,
    no_load_cst, startup_cst]. `fix` pins named market vars via equal bounds.
    Revenue/operating costs are in MM$ as in the reference. Solved on
    `device`."""
    build_terms, lo, hi = market_design_problem(
        revenue_fn, nstartups_fn, zone_hours_fn, p_lower_bound, p_upper_bound,
        capital_payment_years, plant_lifetime, coal_price, calc_boiler_eff, bounds, spec,
        fix, device, dtype,
    )

    def objective(x, _p):
        npv, _ = build_terms(x)
        return -npv * 1e-2


    kw = dict(dtype=dtype, device=device)
    x0 = torch.tensor([(a + c) / 2 for a, c in zip(lo, hi)], **kw)
    sol = solve_nlp(
        objective,
        lambda x, p: x[:0],
        x0,
        torch.tensor(lo, **kw),
        torch.tensor(hi, **kw),
        tol=tol,
        max_iter=max_iter,
    )
    with torch.no_grad():
        npv, info = build_terms(sol.x)
    info = {k: v.cpu() for k, v in info.items()}
    out = {
        "converged": bool(sol.converged),
        "iterations": int(sol.iterations),
        "obj_npv_usd": float(npv) * 1e6,
        "pmax_mw": float(info["pmax"]),
        "pmin_mw": float(info["pmin"]),
        "revenue_mm_per_yr": float(info["revenue"]),
        "nstartups": float(info["nstartups"]),
        "zone_hours": info["zone_hours"].numpy(),
        "op_cost_mm_per_yr": float(info["op_cost_mm"]),
    }
    for k, v in zip(DESIGN_NAMES, sol.x.cpu().numpy()):
        out[k] = float(v)
    return out
