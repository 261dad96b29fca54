"""Run-script entry points (port of `dispatches_tpu/workflow/runners.py`).

    python -m dispatches_tpu_torch.workflow.runners pricetaker \
        --topology wind_pem --hours 168 --h2-price 2.0 2.5 3.0
    python -m dispatches_tpu_torch.workflow.runners yearsweep \
        --scenarios 16 --batch 8

Both run on the CUDA card unless ``--device cpu`` is given. Not ported yet,
and refused rather than ignored: the ResultStore checkpoint (``--out`` /
``store_path``), journal/tracer spans, cost records, neighbour warm starts,
adaptive batching and remediation.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..solvers.ipm import _reject_deferred

TOPOLOGIES = ("wind_battery", "wind_pem", "wind_pem_tank_turbine")


def run_pricetaker(
    topology: str = "wind_pem",
    hours: int = 168,
    h2_prices: Optional[List[float]] = None,
    store_path: Optional[str] = None,
    verbose: bool = True,
    tracer=None,
    device="cuda",
):
    """Price-taker design sweep over H2 prices (one weekly-scale design LP
    per price, dense IPM)."""
    from ..case_studies.renewables import params as P
    from ..case_studies.renewables.pricetaker import (
        wind_battery_optimize,
        wind_battery_pem_optimize,
        wind_battery_pem_tank_turb_optimize,
    )

    _reject_deferred(store_path=store_path, tracer=tracer)
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}")
    data = P.load_rts303()
    h2_prices = h2_prices or [2.0]
    out = []
    for i, h2 in enumerate(h2_prices):
        if topology == "wind_battery":
            res = wind_battery_optimize(
                hours, data["da_lmp"], data["da_wind_cf"], device=device
            )
        elif topology == "wind_pem":
            res = wind_battery_pem_optimize(
                hours, data["da_lmp"], data["da_wind_cf"], h2_price_per_kg=h2,
                device=device,
            )
        else:
            res = wind_battery_pem_tank_turb_optimize(
                hours, data["da_lmp"], data["da_wind_cf"], h2_price_per_kg=h2,
                device=device,
            )
        rec = {
            "h2_price": h2,
            "NPV": res["NPV"],
            "annual_revenue": res["annual_revenue"],
            "pem_kw": res.get("pem_kw", 0.0),
            "batt_kw": res.get("batt_kw", 0.0),
            "solver_stats": res.get("solver_stats", {}),
        }
        out.append(rec)
        if verbose:
            st = res.get("solver_stats", {})
            it = st.get("iterations", {})
            print(
                f"[{i}] h2=${h2}/kg: NPV ${rec['NPV']:.3e} "
                f"pem {rec['pem_kw']:.0f} kW | converged "
                f"{st.get('converged_frac', float('nan')):.3f}, "
                f"iters {it.get('median', '?')}, "
                f"gap {st.get('gap', {}).get('max', float('nan')):.1e}"
            )
    return out


def spike_slabs(Tb: int):
    """SPIKE slab count for a chain of Tb day-blocks: the divisor D of Tb
    nearest sqrt(Tb) with D >= 2 and Tb // D >= 2, which balances the
    interior chains (Tb/D - 1 steps) against the interface chain (D
    steps); None when Tb has no such divisor. Tb = 365 gives 5."""
    cands = [d for d in range(2, Tb // 2 + 1) if Tb % d == 0]
    return min(cands, key=lambda d: abs(d - Tb ** 0.5)) if cands else None


def year_sweep_solver_kw(dtype, mixed_precision=True, correctors=0,
                         inv_factors=False, factor_dtype="float64", Tb=None) -> dict:
    """Solver options of the year sweep.

    Mixed precision (f64 data, the default) stores the block factors in f32
    and sweeps them through the fused CUDA kernel, with one f64 refinement
    step per KKT solve. `factor_dtype` is where the normal equations are
    built and factored before that f32 store:

    - "float64" (default): the factorization runs in f64, split into
      `spike_slabs(Tb)` SPIKE slabs when the chain length `Tb` is given,
      and the IPM stops at tol 1e-8. Measured on the year LP, every lane
      lands within 1e-4 of HiGHS, and the slabs cut the batch's wall 3x
      at the same answers (PERF.md).
    - "float32": the JAX package's year sweep as it is (f32 factorization,
      one sequential chain, tol 1e-6). Its f32 Cholesky breaks down at
      gaps of ~1e-6..1e-5 and leaves year NPVs 1e-3..1e-2 from HiGHS, as
      the JAX package's own record shows.

    Without mixed precision (pure f64 or pure f32) the options are the JAX
    package's. Whenever the swept factors are f32 the sweeps go through
    the fused kernel; pure-f64 factors keep the scan."""
    accurate = (mixed_precision and dtype == torch.float64
                and factor_dtype in ("float64", torch.float64))
    kw = dict(tol=1e-8 if accurate else 1e-6, max_iter=100 if accurate else 80,
              refine_steps=3, correctors=correctors, inv_factors=inv_factors)
    if mixed_precision and dtype == torch.float64:
        kw.update(chol_dtype=torch.float32, kkt_refine=1)
        if accurate:
            kw.update(factor_dtype=torch.float64)
            if Tb is not None:
                kw.update(slabs=spike_slabs(Tb))
    fac = kw.get("chol_dtype", dtype)
    kw["sweep_backend"] = "fused" if fac == torch.float32 else "scan"
    return kw


def run_year_sweep(
    scenarios: int = 16,
    batch: int = 8,
    hours: int = 8760,
    block_hours: int = 24,
    h2_price: float = 2.5,
    lmp_scale_range=(0.5, 2.0),
    seed: int = 0,
    dtype: str = "float64",
    mixed_precision: bool = True,
    correctors: int = 0,
    inv_factors: bool = False,
    store_path: Optional[str] = None,
    verbose: bool = True,
    tracer=None,
    trace: bool = False,
    cost: bool = False,
    warm_starts: bool = False,
    adaptive: bool = False,
    remedy=None,
    device="cuda",
    factor_dtype: str = "float64",
):
    """Year-scale LMP-scenario design sweep: N full-year wind+battery+PEM
    design LPs solved in scenario batches of `batch` on one device by the
    block-tridiagonal IPM (`solve_lp_banded_batch`), instead of the
    reference's one-CBC-subprocess-per-scenario loop
    (`wind_battery_LMP.py:195-267`). Scenario LMP scales are drawn with
    ``np.random.default_rng(seed)``, as in the JAX package, so both packages
    solve the same scenarios. See `year_sweep_solver_kw` for the precision
    tiers: ``factor_dtype="float32"`` is the JAX package's sweep as it is.

    Each record carries ``batch_seconds``: the wall-clock of its batch's
    solve, synchronised with the device."""
    from ..case_studies.renewables import params as P
    from ..case_studies.renewables.pricetaker import HybridDesign, build_pricetaker
    from ..runtime.telemetry import batch_stats
    from ..solvers.structured import extract_time_structure, solve_lp_banded_batch

    _reject_deferred(store_path=store_path, tracer=tracer, trace=trace, cost=cost,
                     warm_starts=warm_starts, adaptive=adaptive, remedy=remedy)
    tdtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    data = P.load_rts303()
    design = HybridDesign(
        T=hours,
        with_battery=True,
        with_pem=True,
        design_opt=True,
        h2_price_per_kg=h2_price,
        initial_soc_fixed=None,
    )
    prog, _ = build_pricetaker(design)
    meta = extract_time_structure(prog, hours, block_hours=block_hours)

    base_lmp = np.resize(data["da_lmp"], hours)
    cf = torch.as_tensor(np.resize(data["da_wind_cf"], hours), dtype=tdtype, device=device)
    rng = np.random.default_rng(seed)
    scales = rng.uniform(*lmp_scale_range, scenarios)
    solver_kw = year_sweep_solver_kw(
        tdtype, mixed_precision, correctors, inv_factors, factor_dtype, meta.Tb
    )

    out = []
    pending = list(range(scenarios))
    for lo in range(0, len(pending), batch):
        todo = pending[lo : lo + batch]
        # pad to the fixed batch width, as the JAX runner does
        padded = todo + [todo[-1]] * (batch - len(todo))
        lmps = torch.as_tensor(
            np.asarray(scales)[padded, None] * base_lmp[None, :],
            dtype=tdtype, device=device,
        )
        params = {"lmp": lmps, "wind_cf": cf}
        blp_b = meta.instantiate(params, dtype=tdtype, device=device)
        if lmps.device.type == "cuda":
            torch.cuda.synchronize(lmps.device)
        t0 = time.perf_counter()
        sol = solve_lp_banded_batch(meta, blp_b, **solver_kw)
        convs = sol.converged.cpu().numpy()[: len(todo)]
        solve_wall = time.perf_counter() - t0
        npvs = prog.eval_expr("NPV", sol.x, params).cpu().numpy()[: len(todo)]
        stats = batch_stats(sol)
        iters_b = sol.iterations.cpu().numpy()[: len(todo)]
        for j, k in enumerate(todo):
            out.append({
                "scenario": k,
                "lmp_scale": float(scales[k]),
                "NPV": float(npvs[j]),
                "converged": bool(convs[j]),
                "iterations": int(iters_b[j]),
                "solver_stats": stats,
                "batch_seconds": solve_wall,
            })
        if verbose:
            print(
                f"[{todo[0]}..{todo[-1]}] {len(todo)} year-LPs: "
                f"converged {int(convs.sum())}/{len(todo)}, "
                f"NPV ${npvs.min():.3e}..${npvs.max():.3e}, "
                f"{solve_wall:.1f} s"
            )
    n_unconv = sum(1 for r in out if not r["converged"])
    if n_unconv and verbose:
        print(f"WARNING: {n_unconv} scenarios did not converge")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="dispatches-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("pricetaker", help="price-taker design sweep")
    pt.add_argument("--topology", choices=TOPOLOGIES, default="wind_pem")
    pt.add_argument("--hours", type=int, default=168)
    pt.add_argument("--h2-price", type=float, nargs="+", default=[2.0])

    ys = sub.add_parser(
        "yearsweep", help="year-scale LMP-scenario design sweep (north-star)"
    )
    ys.add_argument("--scenarios", type=int, default=16)
    ys.add_argument("--batch", type=int, default=8)
    ys.add_argument("--hours", type=int, default=8760)
    ys.add_argument("--h2-price", type=float, default=2.5)
    ys.add_argument("--seed", type=int, default=0)
    ys.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ys.add_argument("--no-mixed-precision", action="store_true")
    ys.add_argument("--correctors", type=int, default=0,
                    help="Gondzio centrality correctors per IPM iteration")
    ys.add_argument("--inv-factors", action="store_true",
                    help="store block factors as inverses")

    args = p.parse_args(argv)
    if args.cmd == "pricetaker":
        run_pricetaker(
            topology=args.topology, hours=args.hours, h2_prices=args.h2_price,
            device=args.device,
        )
    else:
        run_year_sweep(
            scenarios=args.scenarios, batch=args.batch, hours=args.hours,
            h2_price=args.h2_price, seed=args.seed, dtype=args.dtype,
            mixed_precision=not args.no_mixed_precision,
            correctors=args.correctors, inv_factors=args.inv_factors,
            device=args.device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
