"""Surrogate-based conceptual design of the nuclear + PEM plant (port of
`dispatches_tpu/case_studies/nuclear/conceptual_design.py`).

Counterpart of `nuclear_case/report/market_surrogates.py:40-260`
(`conceptual_design_ss_NE` + `run_exhaustive_enumeration`): the reference
embeds Keras revenue and NPP-capacity-factor surrogates into a Pyomo NLP via
OMLT and enumerates (reserve, max_lmp, H2-price) scenarios in a loop. Here
the surrogates are plain differentiable torch callables evaluated inside the
after-tax profit expression; the one-degree-of-freedom design (the PEM/NPP
capacity ratio) is a batched grid (`torch.func.vmap`) and a Newton polish
with derivatives from `torch.func.grad`; the enumeration is one batched
evaluation over the whole scenario grid.

Surrogate input convention (`:168`): [threshold_price, pem_np_cap_ratio,
reserve, max_lmp]; revenue_fn returns the annual electricity revenue [$],
cf_fn the NPP grid capacity factor in [0, 1]. Both must be torch functions
of one (4,) tensor that `torch.func` transforms pass through.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
from torch.func import grad, vmap

# ---- reference economics (`market_surrogates.py:40-57,205-222`) ----------
PEM_CAPEX = 1200.0  # $/kW
LIFETIME = 30
TAX_RATE = 0.2
DISC_RATE = 0.08
_R = 1.0 / (1.0 + DISC_RATE)
ANN_FACTOR = (1.0 / _R) * ((1.0 - _R) / (1.0 - _R**LIFETIME))
NP_CAPACITY = 400.0  # MW
H2_PROD_RATE = 1000.0 / 50.0  # kg/MWh
NUM_HOURS = 8784
NPP_VOM = 2.3  # $/MWh
PEM_VOM = 0.0
RATIO_BOUNDS = (0.05, 0.5)  # `:131`


class NEDesignResult(NamedTuple):
    pem_np_cap_ratio: torch.Tensor
    pem_capacity_mw: torch.Tensor
    objective: torch.Tensor  # $ (minimized: annualized capex - net profit)
    npv_terms: Dict[str, torch.Tensor]


def ne_objective(
    ratio,
    h2_price,
    reserve,
    max_lmp,
    revenue_fn: Callable,
    cf_fn: Callable,
):
    """The reference's objective (`:205-226`, minimized): annualized PEM
    capex - after-tax net profit at the surrogate-predicted market outcome.
    Returns (objective, term dict). `ratio` may be a tensor (its device and
    dtype carry the computation); numbers are float64 on the CPU."""
    like = next((v for v in (ratio, h2_price, reserve, max_lmp)
                 if isinstance(v, torch.Tensor)), None)
    kw = (dict(dtype=like.dtype, device=like.device) if like is not None
          else dict(dtype=torch.float64))

    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, **kw)

    ratio, h2_price = t(ratio), t(h2_price)
    threshold_price = H2_PROD_RATE * h2_price  # `:151-153`
    x = torch.stack([threshold_price, ratio, t(reserve), t(max_lmp)])
    electricity_revenue = torch.reshape(revenue_fn(x), ())
    cf = torch.clamp(torch.reshape(cf_fn(x), ()), 0.0, 1.0)

    pem_capacity = ratio * NP_CAPACITY
    net_energy_to_pem = (1.0 - cf) * NP_CAPACITY * NUM_HOURS  # MWh
    net_h2 = net_energy_to_pem * H2_PROD_RATE  # kg
    h2_revenue = h2_price * net_h2
    operating_cost = NUM_HOURS * NP_CAPACITY * NPP_VOM + net_energy_to_pem * PEM_VOM
    pem_cap_cost = ANN_FACTOR * PEM_CAPEX * 1e3 * pem_capacity
    depreciation = (PEM_CAPEX * 1e3 / LIFETIME) * pem_capacity
    pem_fom = 0.03 * PEM_CAPEX * 1e3 * pem_capacity
    npp_fom = 120.0 * 1e3 * NP_CAPACITY  # $120/kW-yr (`:218`)
    net_profit = depreciation + (1.0 - TAX_RATE) * (
        electricity_revenue
        + h2_revenue
        - operating_cost
        - pem_fom
        - npp_fom
        - depreciation
    )
    obj = pem_cap_cost - net_profit
    terms = {
        "electricity_revenue": electricity_revenue,
        "h2_revenue": h2_revenue,
        "capacity_factor": cf,
        "net_h2_production_kg": net_h2,
        "pem_cap_cost": pem_cap_cost,
        "net_profit": net_profit,
    }
    return obj, terms


def conceptual_design_ss_NE(
    revenue_fn: Callable,
    cf_fn: Callable,
    reserve: float = 10.0,
    max_lmp: float = 500.0,
    h2_price: float = 2.0,
    n_grid: int = 64,
    newton_steps: int = 8,
    device="cuda",
    dtype=torch.float64,
) -> NEDesignResult:
    """Optimal PEM sizing against the market surrogates: the one-DoF design
    of `conceptual_design_ss_NE` (`:106-227`), solved by a batched grid over
    the ratio box and a projected-Newton polish on the best point, on
    `device` (the surrogates are differentiable, so no OMLT encoding)."""
    lo, hi = RATIO_BOUNDS

    def f(r):
        return ne_objective(r, h2_price, reserve, max_lmp, revenue_fn, cf_fn)[0]

    grid = torch.linspace(lo, hi, n_grid, dtype=dtype, device=device)
    vals = vmap(f)(grid)
    r0 = grid[torch.argmin(vals)]

    df = grad(f)
    d2f = grad(df)
    r = r0
    for _ in range(newton_steps):
        g = df(r)
        h = d2f(r)
        step = torch.where(h.abs() > 1e-12, g / torch.where(h > 0, h, 1.0), 0.0)
        # a small gradient step where the curvature is not convex
        step = torch.where(h > 0, step, torch.sign(g) * (hi - lo) / n_grid)
        r = torch.clamp(r - step, lo, hi)
    # keep the better of (polished, grid): Newton on a surrogate can walk
    # to a worse stationary point
    r_opt = torch.where(f(r) <= f(r0), r, r0)
    obj, terms = ne_objective(r_opt, h2_price, reserve, max_lmp, revenue_fn, cf_fn)
    return NEDesignResult(
        pem_np_cap_ratio=r_opt,
        pem_capacity_mw=r_opt * NP_CAPACITY,
        objective=obj,
        npv_terms=terms,
    )


def run_exhaustive_enumeration(
    revenue_fn: Callable,
    cf_fn: Callable,
    h2_prices=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
    reserve: float = 10.0,
    max_lmp: float = 500.0,
    n_grid: int = 256,
    device="cuda",
    dtype=torch.float64,
) -> Dict[str, np.ndarray]:
    """The reference's scenario enumeration (`:230-260`): for each H2 price
    the full ratio grid is evaluated in one batched call and the best
    design reported. Returns numpy arrays over the H2-price axis."""
    lo, hi = RATIO_BOUNDS
    grid = torch.linspace(lo, hi, n_grid, dtype=dtype, device=device)
    prices = torch.as_tensor(h2_prices, dtype=dtype, device=device)

    def f(price, r):
        return ne_objective(r, price, reserve, max_lmp, revenue_fn, cf_fn)[0]

    vals = vmap(lambda p: vmap(lambda r: f(p, r))(grid))(prices)
    best = torch.argmin(vals, dim=1)
    return {
        "h2_price": prices.cpu().numpy(),
        "best_ratio": grid[best].cpu().numpy(),
        "best_pem_mw": (grid[best] * NP_CAPACITY).cpu().numpy(),
        "best_objective": vals[torch.arange(len(h2_prices), device=vals.device), best]
        .cpu().numpy(),
        "objective_grid": vals.cpu().numpy(),
        "ratio_grid": grid.cpu().numpy(),
    }
