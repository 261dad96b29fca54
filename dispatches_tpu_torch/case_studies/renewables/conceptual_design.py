"""Surrogate-based conceptual design of the wind + PEM plant (the OMLT
path; port of `dispatches_tpu/case_studies/renewables/conceptual_design.py`).

Counterpart of `RE_surrogate_optimization_steadystate.py:56-351`: the
reference embeds a Keras revenue surrogate and a per-cluster
dispatch-frequency surrogate into a Pyomo NLP via OMLT
`FullSpaceNNFormulation`, builds one representative-day MultiPeriod
flowsheet per cluster, and sweeps (PEM bid, PEM size) points with
`multiprocessing.Pool` (`:340-351`).

Here the surrogates are differentiable torch callables, the per-cluster
"flowsheet" collapses to its closed form (a single time point, dispatch
pinned to the cluster's capacity factors), and the design NLP goes through
the batched interior-point NLP solver (`solvers/nlp.py`) on a device; the
sweep is one `solve_nlp_batch` over the grid's points.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from ...solvers.nlp import solve_nlp, solve_nlp_batch
from ...surrogates.embed import smooth_nonneg
from ...units.pem import DEFAULT_ELECTRICITY_TO_MOL
from . import params as P


@dataclasses.dataclass
class ConceptualDesignInputs:
    """Fixed data of `conceptual_design_dynamic_RE` (`:99-130`)."""

    dispatch_cf: np.ndarray  # (K,) cluster-center grid-dispatch CFs
    pem_cf: np.ndarray  # (K,) cluster-center PEM CFs
    wind_cf: np.ndarray  # (K,) cluster-center wind resource CFs
    wind_mw: float = 847.0
    pem_mw: float = 200.0
    h2_price_per_kg: float = P.H2_PRICE_PER_KG
    extant_wind: bool = True
    include_wind_capital_cost: bool = False
    reserve_percent: float = 15.0  # `:113`
    shortfall_price: float = 1000.0  # load-shed price
    wind_cap_bounds_mw: tuple = (100.0, 1000.0)  # `:109`
    pem_cap_bounds_mw: tuple = (127.5, 423.5)  # `:111`
    pem_bid_bounds: tuple = (15.0, 45.0)  # `:112`


def _nn_inputs(wind_kw, pem_kw, pem_bid, d: ConceptualDesignInputs):
    """Surrogate input vector (`:118`): [PEM bid, PEM size scaled by the
    wind size ratio, reserve factor, load-shed price]. The reference scales
    the PEM-size input by wind_cap/847 MW so the surrogates (trained at
    847 MW of wind) transfer across wind sizes."""
    like = dict(dtype=wind_kw.dtype, device=wind_kw.device)
    return torch.stack(
        [
            pem_bid,
            pem_kw * 1e-3 / 847.0 * (wind_kw * 1e-3),
            torch.as_tensor(d.reserve_percent, **like),
            torch.as_tensor(d.shortfall_price, **like),
        ]
    )


def _smooth_min(a, b):
    """min(a, b) = a - max(a - b, 0), the max the reference's smooth one."""
    return a - smooth_nonneg(a - b)


def _npv_terms(wind_kw, pem_kw, pem_bid, d, revenue_fn, frequency_fn):
    """Shared NPV body of the pointwise design NLP and of the sweep."""
    K = len(d.dispatch_cf)
    like = dict(dtype=wind_kw.dtype, device=wind_kw.device)
    dis_cf = torch.as_tensor(np.asarray(d.dispatch_cf, float), **like)
    pem_cf = torch.as_tensor(np.asarray(d.pem_cf, float), **like)
    wind_cf = torch.as_tensor(np.asarray(d.wind_cf, float), **like)

    inputs = _nn_inputs(wind_kw, pem_kw, pem_bid, d)
    rev = torch.reshape(revenue_fn(inputs), ())  # $/yr (`m.rev`, `:141`)

    freq_raw = smooth_nonneg(torch.reshape(frequency_fn(inputs), (K,)))
    freq = freq_raw / torch.sum(freq_raw)  # `:163-166`

    # per-cluster representative-day dispatch (`:168-221`), closed form:
    # grid dispatch pinned to the cluster CF; the PEM takes the rest of the
    # available wind up to its size and the cluster's PEM CF. The min / max
    # are the reference's smooth max (`smooth_nonneg`, eps 1e-3 kW): within
    # ~1e-3 kW of the JAX package's hard ones, and smooth for the NLP, whose
    # optimum often sits where the PEM meets one of these limits
    grid_kw = wind_kw * dis_cf
    avail_kw = wind_kw * wind_cf
    pem_kw_t = _smooth_min(
        _smooth_min(pem_kw, wind_kw * pem_cf),
        smooth_nonneg(avail_kw - grid_kw),
    )
    h2_kg_hr = pem_kw_t * DEFAULT_ELECTRICITY_TO_MOL * 3600.0 / P.H2_MOLS_PER_KG
    h2_rev = torch.sum(freq * 8760.0 * h2_kg_hr) * d.h2_price_per_kg
    var_cost = torch.sum(freq * 8760.0 * P.PEM_VAR_COST * pem_kw_t)

    cap_cost = P.PEM_CAP_COST * pem_kw
    if d.include_wind_capital_cost:
        cap_cost = cap_cost + P.WIND_CAP_COST * wind_kw
    fixed_cost = P.WIND_OP_COST * wind_kw + P.PEM_OP_COST * pem_kw
    return -cap_cost + P.PA * (rev + h2_rev - var_cost - fixed_cost)


def _no_constraints(x, p):
    return x[:0]


def _wind_bounds(d: ConceptualDesignInputs):
    if d.extant_wind:
        return d.wind_mw * 1e3, d.wind_mw * 1e3
    return d.wind_cap_bounds_mw[0] * 1e3, d.wind_cap_bounds_mw[1] * 1e3


def conceptual_design_dynamic_RE(
    d: ConceptualDesignInputs,
    revenue_fn: Callable,  # (4,) inputs -> annual elec revenue [$]
    frequency_fn: Callable,  # (4,) inputs -> (K,) raw cluster frequencies
    PEM_bid: Optional[float] = None,
    PEM_MW: Optional[float] = None,
    tol: float = 1e-6,
    max_iter: int = 150,
    device="cuda",
    dtype=torch.float64,
):
    """Solve the conceptual-design NLP on `device`. Returns a results dict
    with the reference's `record_result` fields (`:241-268`)."""
    K = len(d.dispatch_cf)

    def npv(x, _p):
        return _npv_terms(x[0], x[1], x[2], d, revenue_fn, frequency_fn)

    lw, uw = _wind_bounds(d)
    lp, up = d.pem_cap_bounds_mw[0] * 1e3, d.pem_cap_bounds_mw[1] * 1e3
    lb, ub = d.pem_bid_bounds
    if PEM_MW is not None:
        lp = up = PEM_MW * 1e3
    if PEM_bid is not None:
        lb = ub = float(PEM_bid)

    kw = dict(dtype=dtype, device=device)
    x0 = torch.tensor([0.5 * (lw + uw), 0.5 * (lp + up), 0.5 * (lb + ub)], **kw)
    sol = solve_nlp(
        lambda x, p: -npv(x, p) * 1e-7,  # `m.obj` scaling (`:237`)
        _no_constraints,
        x0,
        torch.tensor([lw, lp, lb], **kw),
        torch.tensor([uw, up, ub], **kw),
        tol=tol,
        max_iter=max_iter,
    )

    x = sol.x
    with torch.no_grad():
        inputs = _nn_inputs(x[0], x[1], x[2], d)
        freq_raw = smooth_nonneg(torch.reshape(frequency_fn(inputs), (K,)))
        freq = (freq_raw / torch.sum(freq_raw)).cpu().numpy()
        e_rev = float(torch.reshape(revenue_fn(inputs), ()))
        npv_x = float(npv(x, None))
    xh = x.cpu().numpy()
    res = {
        "wind_mw": float(xh[0]) * 1e-3,
        "pem_mw": float(xh[1]) * 1e-3,
        "pem_bid": float(xh[2]),
        "e_revenue": e_rev,
        "NPV": npv_x,
        "converged": bool(sol.converged),
        "iterations": int(sol.iterations),
    }
    for k in range(K):
        res[f"freq_day_{k}"] = float(freq[k])
    return res


def design_sweep(
    d: ConceptualDesignInputs,
    revenue_fn: Callable,
    frequency_fn: Callable,
    pem_bids: np.ndarray,
    pem_mws: np.ndarray,
    tol: float = 1e-6,
    max_iter: int = 150,
    device="cuda",
    dtype=torch.float64,
):
    """The reference's multiprocessing sweep over (PEM bid, PEM size) points
    (`:340-351`) as one batch on `device`: each point fixes (bid, size) and
    re-optimizes the rest of the design (the wind size, free when
    ``extant_wind=False``) in one `solve_nlp_batch`; with extant wind
    nothing is left to optimize and the points are one batched evaluation.
    Agrees with `conceptual_design_dynamic_RE(..., PEM_bid=b, PEM_MW=s)`
    pointwise. Returns numpy arrays over the grid's points (and
    ``converged`` when NLPs were solved)."""
    grid = np.array([(b, s) for b in pem_bids for s in pem_mws], float)
    lw, uw = _wind_bounds(d)
    kw = dict(dtype=dtype, device=device)
    g = torch.as_tensor(grid, **kw)

    def npv_at(wind_kw, p):
        return _npv_terms(wind_kw, p[1] * 1e3, p[0], d, revenue_fn, frequency_fn)

    out = {"pem_bid": grid[:, 0], "pem_mw": grid[:, 1]}
    if lw == uw:
        # extant wind: nothing left to optimize, evaluate directly
        wind = torch.full((len(grid),), lw, **kw)
        with torch.no_grad():
            out["NPV"] = vmap(npv_at)(wind, g).cpu().numpy()
        return out
    sol = solve_nlp_batch(
        lambda x, p: -npv_at(x[0], p) * 1e-7,
        _no_constraints,
        torch.full((len(grid), 1), 0.5 * (lw + uw), **kw),
        torch.tensor([lw], **kw),
        torch.tensor([uw], **kw),
        params_batch=g,
        tol=tol,
        max_iter=max_iter,
    )
    with torch.no_grad():
        out["NPV"] = vmap(npv_at)(sol.x[:, 0], g).cpu().numpy()
    out["wind_mw"] = sol.x[:, 0].cpu().numpy() * 1e-3
    out["converged"] = sol.converged.cpu().numpy()
    return out
