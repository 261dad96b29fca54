"""USC + storage price-taker analysis (port of
`dispatches_tpu/case_studies/fossil/pricetaker.py`).

Counterpart of `storage/pricetaker_with_multiperiod_integrated_storage_usc.py:41-107`:
the reference builds a 24*ndays-block Pyomo model and one IPOPT solve per
tank-status scenario; here the lowered LP (`multiperiod.py`) is solved on
`device` per scenario, or for all tank scenarios at once as one batched
instantiate (a leading parameter axis) and one batched solve.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...solvers.ipm import solve_lp, solve_lp_batch
from . import usc_plant as U
from .multiperiod import build_usc_storage_model

# the reference's modified-RTS 24-h LMP vector
# (`pricetaker_with_multiperiod_integrated_storage_usc.py:52-58`)
MOD_RTS_LMP_24 = np.array(
    [
        22.9684, 21.1168, 20.4, 20.419, 20.419, 21.2877, 23.07, 25.0,
        18.4634, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        19.0342, 23.07, 200.0, 200.0, 200.0, 200.0, 200.0, 200.0,
    ]
)

TANK_SCENARIOS = {
    "hot_empty": 1_103_053.48,
    "half_full": U.TANK_MAX_KG / 2.0,
    "hot_full": U.TANK_MAX_KG - U.INVENTORY_MIN_KG,
}


def run_pricetaker_analysis(
    ndays: int = 1,
    nweeks: int = 1,
    tank_status: str = "hot_empty",
    lmp: Optional[np.ndarray] = None,
    periodic_inventory: bool = True,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
) -> Dict:
    """Solve the price-taker dispatch for one tank-status scenario on
    `device`; the results come back as numpy arrays."""
    T = 24 * ndays * nweeks
    if lmp is None:
        lmp = np.tile(MOD_RTS_LMP_24, T // 24 + 1)[:T]
    prog = build_usc_storage_model(T, periodic_inventory=periodic_inventory).build()
    params = {
        "lmp": np.asarray(lmp, float),
        "hot0": np.asarray(TANK_SCENARIOS[tank_status]),
        "power0": np.asarray((U.MIN_POWER_MW + 1 + U.MAX_POWER_MW) / 2.0),
    }
    sol = solve_lp(prog.instantiate(params, dtype=dtype, device=device), **solver_kw)
    x = sol.x.cpu()  # one device read; the expressions are evaluated on the host
    out = {
        k: prog.eval_expr(k, x, params).numpy()
        for k in (
            "net_power",
            "plant_power",
            "q_charge",
            "q_discharge",
            "salt_inventory_hot",
            "revenue",
            "operating_cost",
            "profit",
        )
    }
    out["converged"] = bool(sol.converged)
    out["lmp"] = np.asarray(lmp, float)
    return out


def run_all_tank_scenarios(ndays: int = 1, dtype=torch.float64, device="cuda",
                           **solver_kw) -> Dict[str, Dict]:
    """All three tank-status scenarios in one batched device solve."""
    T = 24 * ndays
    lmp = np.tile(MOD_RTS_LMP_24, ndays)[:T]
    prog = build_usc_storage_model(T, periodic_inventory=False).build()
    names = list(TANK_SCENARIOS)
    batch = {
        "lmp": np.stack([lmp] * len(names)),
        "hot0": np.asarray([TANK_SCENARIOS[k] for k in names]),
        "power0": np.asarray([359.5] * len(names)),
    }
    sols = solve_lp_batch(prog.instantiate(batch, dtype=dtype, device=device), **solver_kw)
    xs, conv = sols.x.cpu(), sols.converged.cpu().numpy()
    results = {}
    for i, name in enumerate(names):
        p_i = {k: v[i] for k, v in batch.items()}
        results[name] = {
            k: prog.eval_expr(k, xs[i], p_i).numpy()
            for k in ("net_power", "q_charge", "q_discharge", "salt_inventory_hot", "profit")
        }
        results[name]["converged"] = bool(conv[i])
    return results
