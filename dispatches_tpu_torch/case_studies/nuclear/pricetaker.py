"""Nuclear price-taker analysis: the four settlement variants of the
reference's report study, as one parametric LP batched over prices and
designs (port of `dispatches_tpu/case_studies/nuclear/pricetaker.py`).

Reference: `case_studies/nuclear_case/report/price_taker_analysis.py:45-428`.
  V1 "DA"        day-ahead LMPs only
  V2 "RT"        real-time LMPs only
  V3 "Max-DA-RT" elementwise max(DA, RT)
  V4 "DA-RT"     two-step settlement: step 1 solves V1, step 2 settles
                 lmp_da*dispatch_da + lmp_rt*(net_power - dispatch_da)

The reference builds an 8784-block Pyomo MultiPeriodModel and calls Gurobi
once per (h2_price, pem_capacity) grid point (`run_exhaustive_enumeration`,
`:356-428`). Here the LP is lowered once, and the grid is one batched
`instantiate` (a leading lane axis on the parameters) and one batched
interior-point solve on `device`.

Flowsheet semantics (`:116-176`): NPP at a fixed 400 MW; power split to the
grid and the electrolyzer; h2_production = H2_PROD_RATE * np_to_electrolyzer
[kg/hr]; a linear tank holdup linked across periods; turbine power =
0.0125 * h2_to_turbine; first-stage capacity variables with per-period
capacity constraints. Economics (`:228-323`): VOM / electricity + H2 revenue
per period; NPV with straight-line depreciation, 20% tax, 8% discount over
30 years; annualized objective = net_profit - capex / annuity_factor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...core.model import Model
from ...solvers.ipm import solve_lp, solve_lp_batch

H2_PROD_RATE = 20.0  # kg H2 / MWh into the PEM (`price_taker_analysis.py:42`)
TURBINE_MWH_PER_KG = 0.0125  # (`price_taker_analysis.py:164-168`)
NP_CAPACITY_MW = 400.0  # RTS-GMLC 121_NUCLEAR_1 (`price_taker_analysis.py:144`)
ENUMERATION_H2_PRICES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
ENUMERATION_PEM_FRACS = tuple(i / 100 for i in range(5, 51, 5))


@dataclasses.dataclass
class NuclearPricetakerConfig:
    T: int = 366 * 24
    np_capacity_mw: float = NP_CAPACITY_MW
    demand_type: str = "variable"  # "fixed" | "variable"
    h2_demand_kg_hr: float = 400.0 * 20.0
    # design: None -> first-stage variable, number -> fixed capacity
    pem_capacity_mw: Optional[float] = None
    tank_capacity_kg: Optional[float] = 0.0
    turbine_capacity_mw: Optional[float] = 0.0
    vom_npp: float = 2.3
    vom_pem: float = 0.0  # the report's sweep uses 0 (`:364`)
    vom_turbine: float = 4.25
    plant_life: int = 30
    tax_rate: float = 0.2
    discount_rate: float = 0.08
    capex_pem_per_kw: float = 400.0  # the report's sweep default (`:356`)
    capex_tank_per_kwh: float = 29.0
    capex_turbine_per_kw: float = 947.0
    fom_pem_per_kw: Optional[float] = None  # default 3% of capex (`:393`)
    fom_turbine_per_kw: float = 7.0
    npp_fom_total: float = 120.0 * 1000 * 400
    # when True, pem_capacity is pinned to the run-time param `pem_cap_pin`
    # (an equality row), so a capacity sweep batches without re-lowering
    pin_pem_capacity: bool = False


def build_nuclear_pricetaker(cfg: NuclearPricetakerConfig):
    """Lower the multiperiod LP once. Params: `lmp` (T,), `h2_price` (),
    `da_settlement_offset` () (V4's DA position, zero otherwise) and, with
    `pin_pem_capacity`, `pem_cap_pin` ()."""
    T = cfg.T
    m = Model("nuclear_pricetaker")

    lmp = m.param("lmp", T)  # settlement price [$/MWh] (the RT price in V4)
    # V4 two-step settlement: lmp_da*d_da + lmp_rt*(net - d_da) splits into
    # lmp_rt*net plus the variable-free offset sum((lmp_da - lmp_rt)*d_da),
    # which the host precomputes (parameters enter the LP linearly, so a
    # param*param product is folded on the host)
    da_offset = m.param("da_settlement_offset")
    h2_price = m.param("h2_price")

    def _cap(v, fixed, ub=1e5):
        if fixed is None:
            return m.var(v, lb=0.0, ub=ub)
        return m.var(v, lb=fixed, ub=fixed)

    pem_cap = _cap("pem_capacity", cfg.pem_capacity_mw, ub=cfg.np_capacity_mw)
    if cfg.pin_pem_capacity:
        m.add_eq(pem_cap - m.param("pem_cap_pin"))
    tank_cap = _cap("tank_capacity", cfg.tank_capacity_kg, ub=1e7)
    turb_cap = _cap("turbine_capacity", cfg.turbine_capacity_mw, ub=1e4)

    to_grid = m.var("np_to_grid", T)
    to_pem = m.var("np_to_electrolyzer", T)
    holdup = m.var("tank_holdup", T)
    h2_pipe = m.var(
        "h2_to_pipeline",
        T,
        ub=cfg.h2_demand_kg_hr,
        lb=(cfg.h2_demand_kg_hr if cfg.demand_type == "fixed" else 0.0),
    )
    h2_turb = m.var("h2_to_turbine", T)

    # power balance at the plant (np_power fixed at capacity)
    m.add_eq(to_grid + to_pem - cfg.np_capacity_mw)

    h2_prod = H2_PROD_RATE * to_pem  # kg/hr
    turb_power = TURBINE_MWH_PER_KG * h2_turb  # MW
    net_power = to_grid + turb_power

    # tank holdup integration; the initial holdup is fixed to 0 like
    # `m.period[1].fs.tank_holdup_previous.fix(0)` (`:377`)
    m.add_eq(holdup[0:1] - (h2_prod[0:1] - h2_pipe[0:1] - h2_turb[0:1]))
    if T > 1:
        m.add_eq(
            holdup[1:] - holdup[:-1] - (h2_prod[1:] - h2_pipe[1:] - h2_turb[1:])
        )

    # first-stage capacity coupling (`pem_capacity_constraint` etc.)
    m.add_le(to_pem - pem_cap)
    m.add_le(holdup - tank_cap)
    m.add_le(turb_power - turb_cap)

    # economics
    vom = cfg.vom_pem * to_pem + cfg.vom_turbine * turb_power + cfg.vom_npp * cfg.np_capacity_mw
    # V1-V3: lmp*net_power (offset zero); V4: + the DA-position offset
    elec_rev_t = lmp * net_power
    h2_rev = h2_price * h2_pipe
    cash = (h2_rev + elec_rev_t - vom).sum() + da_offset

    fom_pem = (
        cfg.fom_pem_per_kw
        if cfg.fom_pem_per_kw is not None
        else 0.03 * cfg.capex_pem_per_kw
    )
    capex = (
        cfg.capex_pem_per_kw * 1000 * pem_cap
        + cfg.capex_tank_per_kwh * 33.3 * tank_cap
        + cfg.capex_turbine_per_kw * 1000 * turb_cap
    )
    fixed_om = 1000 * fom_pem * pem_cap + 1000 * cfg.fom_turbine_per_kw * turb_cap + cfg.npp_fom_total
    dep = capex * (1.0 / cfg.plant_life)
    net_profit = dep + (1 - cfg.tax_rate) * (cash - fixed_om - dep)
    annuity = (1 - (1 + cfg.discount_rate) ** (-cfg.plant_life)) / cfg.discount_rate

    m.expression("electricity_revenue", elec_rev_t.sum() + da_offset)
    m.expression("h2_revenue", h2_rev.sum())
    m.expression("net_profit", net_profit)
    m.expression("npv", annuity * net_profit - capex)
    m.expression("annualized_npv", net_profit - (1.0 / annuity) * capex)
    m.expression("net_power", net_power)
    m.expression("np_to_grid", to_grid + 0.0)
    m.expression("np_to_electrolyzer", to_pem + 0.0)
    m.expression("tank_holdup", holdup + 0.0)
    m.expression("h2_to_pipeline", h2_pipe + 0.0)

    # annualized objective (`append_annualized_objective_function`, `:336-340`)
    m.maximize(net_profit - (1.0 / annuity) * capex)
    return m.build()


def _params(cfg, lmp, h2_price, lmp_da=None, dispatch_da=None):
    if lmp_da is None or dispatch_da is None:
        offset = 0.0
    else:
        offset = float(
            np.sum(
                (np.asarray(lmp_da, float) - np.asarray(lmp, float))
                * np.asarray(dispatch_da, float)
            )
        )
    return {
        "lmp": np.asarray(lmp, dtype=float),
        "da_settlement_offset": np.asarray(offset),
        "h2_price": np.asarray(h2_price, dtype=float),
    }


def settlement_prices(market: str, lmp_da: np.ndarray, lmp_rt: np.ndarray):
    """V1/V2/V3 price preprocessing (`get_lmp_data`, `:45-113`)."""
    if market == "DA":
        return np.asarray(lmp_da, float)
    if market == "RT":
        return np.asarray(lmp_rt, float)
    if market == "Max-DA-RT":
        return np.maximum(lmp_da, lmp_rt)
    raise ValueError(f"unknown market variant {market!r}")


def run_price_taker(
    cfg: NuclearPricetakerConfig,
    lmp_da: np.ndarray,
    lmp_rt: np.ndarray,
    h2_price: float,
    market: str = "DA",
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
):
    """Solve one price-taker variant on `device`. V4 ("DA-RT") runs the
    two-step method: a V1 solve gives the DA dispatch schedule, then the RT
    settlement LP re-optimizes against lmp_rt with the DA position fixed in
    the revenue. Returns (program, solution, params)."""
    prog = build_nuclear_pricetaker(cfg)

    if market in ("DA", "RT", "Max-DA-RT"):
        p = _params(cfg, settlement_prices(market, lmp_da, lmp_rt), h2_price)
        sol = solve_lp(prog.instantiate(p, dtype=dtype, device=device), **solver_kw)
        return prog, sol, p

    if market != "DA-RT":
        raise ValueError(f"unknown market variant {market!r}")

    p1 = _params(cfg, lmp_da, h2_price)
    sol1 = solve_lp(prog.instantiate(p1, dtype=dtype, device=device), **solver_kw)
    dispatch_da = prog.eval_expr("net_power", sol1.x.cpu(), p1).numpy()
    p2 = _params(cfg, lmp_rt, h2_price, lmp_da=lmp_da, dispatch_da=dispatch_da)
    sol2 = solve_lp(prog.instantiate(p2, dtype=dtype, device=device), **solver_kw)
    return prog, sol2, p2


def enumeration_params(
    lmp: np.ndarray,
    h2_prices: Sequence[float] = ENUMERATION_H2_PRICES,
    pem_fracs: Sequence[float] = ENUMERATION_PEM_FRACS,
    T: Optional[int] = None,
    pem_capex: float = 400.0,
):
    """The report grid's configuration and stacked parameters, built as
    arrays (lane i = (h2_prices[i // F], pem_fracs[i % F]), F =
    len(pem_fracs)): ``(cfg, params)`` with ``params[k]`` of shape
    (lanes, ...). Shared by `run_exhaustive_enumeration` and by callers
    that solve the same grid another way (the banded year solve)."""
    lmp = np.asarray(lmp, float)
    T = lmp.shape[-1] if T is None else T
    cfg = NuclearPricetakerConfig(
        T=T, pem_capacity_mw=None, capex_pem_per_kw=pem_capex, pin_pem_capacity=True,
    )
    hp, pf = np.meshgrid(np.asarray(h2_prices, float), np.asarray(pem_fracs, float),
                         indexing="ij")
    lanes = hp.size
    params = {
        "lmp": np.ascontiguousarray(np.broadcast_to(lmp[:T], (lanes, T))),
        "da_settlement_offset": np.zeros(lanes),
        "h2_price": hp.reshape(-1),
        "pem_cap_pin": pf.reshape(-1) * NP_CAPACITY_MW,
    }
    return cfg, params


def enumeration_results(prog, x, params, h2_prices, pem_fracs, T: int) -> Dict:
    """The report's result dict from a solved grid: `x` (lanes, N) in the
    program's reduced column order, `params` from `enumeration_params`.
    Every expression is evaluated for all lanes at once on the host."""
    x = x.detach().cpu()
    hp = {k: torch.as_tensor(v, dtype=x.dtype) for k, v in params.items()}

    def ev(name):
        return prog.eval_expr(name, x, hp).numpy()

    net_npv, elec_rev = ev("annualized_npv") / 1e6, ev("electricity_revenue") / 1e6
    h2_rev, net_profit = ev("h2_revenue") / 1e6, ev("net_profit") / 1e6
    to_pem = ev("np_to_electrolyzer").sum(-1)
    pins = np.asarray(params["pem_cap_pin"])
    out = {
        "h2_price": list(h2_prices),
        "pem_cap": list(pem_fracs),
        "net_npv": {},
        "elec_rev": {},
        "h2_rev": {},
        "net_profit": {},
        "pem_cap_factor": {},
    }
    F = len(pem_fracs)
    for i in range(len(h2_prices) * F):
        key = f"{i // F}{i % F}"
        out["net_npv"][key] = float(net_npv[i])
        out["elec_rev"][key] = float(elec_rev[i])
        out["h2_rev"][key] = float(h2_rev[i])
        out["net_profit"][key] = float(net_profit[i])
        out["pem_cap_factor"][key] = float(to_pem[i] / max(pins[i] * T, 1e-9))
    return out


def run_exhaustive_enumeration(
    lmp_da: np.ndarray,
    lmp_rt: np.ndarray,
    h2_prices=ENUMERATION_H2_PRICES,
    pem_fracs=ENUMERATION_PEM_FRACS,
    market: str = "DA",
    T: int = 366 * 24,
    pem_capex: float = 400.0,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
) -> Dict:
    """The report's (h2_price x pem_capacity) sensitivity grid
    (`run_exhaustive_enumeration`, `:356-428`) as ONE batched solve on
    `device`: every grid point shares the lowered LP, and the grid's lanes
    go through the dense interior-point solver together instead of a
    Gurobi call per point."""
    lmp = settlement_prices(market, lmp_da, lmp_rt)
    cfg, stacked = enumeration_params(lmp, h2_prices, pem_fracs, T=T, pem_capex=pem_capex)
    prog = build_nuclear_pricetaker(cfg)
    sols = solve_lp_batch(prog.instantiate(stacked, dtype=dtype, device=device), **solver_kw)
    return enumeration_results(prog, sols.x, stacked, h2_prices, pem_fracs, T)
