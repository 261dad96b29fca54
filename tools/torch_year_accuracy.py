#!/usr/bin/env python3
"""Year-sweep accuracy of the PyTorch port against HiGHS, per lane.

Solves one batch of 8,760-h wind+battery+PEM design LPs (the scenarios of
`run_year_sweep`, seed 0) on the CUDA card under several solver settings
and holds every lane's NPV against sparse HiGHS on the host (run in
parallel worker processes while the card solves). Prints one line per lane
and setting, and writes everything to ``--out`` as JSON.

    python3 tools/torch_year_accuracy.py --out year_accuracy.json

Per lane it also prints the solve's duality gap in the NPV's units (the
sum of zl (x - l) + zu (u - x) over the finite bounds, x 1e5) against
|NPV| and against the gross objective (sum of |c_i x_i| plus |c0|, x 1e5:
the magnitude of the terms whose cancellation leaves the NPV), and the
dual objective (primal minus that gap) against HiGHS. The ``runner_tol*``
settings are the runner's tier at another stopping tolerance.
``--scatter-order device`` builds the LP with the device's own
``index_put_(accumulate=True)`` order for repeated indices, as the port
did before that order was fixed, so the trajectory of that LP can be set
beside the fixed-order one's.

    python3 tools/torch_year_accuracy.py --configs runner,runner_tol1e-9 --trace
"""
import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOURS = 8760


def _design():
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import HybridDesign

    return HybridDesign(T=HOURS, with_battery=True, with_pem=True, design_opt=True,
                        h2_price_per_kg=2.5, initial_soc_fixed=None)


def _inputs():
    from dispatches_tpu_torch.case_studies.renewables import params as P

    data = P.load_rts303()
    return np.resize(data["da_lmp"], HOURS), np.resize(data["da_wind_cf"], HOURS)


def highs_npv(scale):
    import torch

    from dispatches_tpu_torch.case_studies.renewables.pricetaker import build_pricetaker
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    prog, _ = build_pricetaker(_design())
    lmp, cf = _inputs()
    params = {"lmp": scale * lmp, "wind_cf": cf}
    t0 = time.perf_counter()
    res = solve_lp_scipy_sparse(prog, params)
    npv = float(prog.eval_expr("NPV", torch.as_tensor(res.x), params))
    return npv, time.perf_counter() - t0


def _device_scatter_add(a, idx, vals):
    """``a[..., idx] += vals`` in one ``index_put_(accumulate=True)`` on `a`'s
    device: repeated indices summed in the device's own order."""
    import torch

    idx = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
    if idx.numel() == 0:
        return a
    lead, n = a.shape[:-1], a.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    vals = torch.broadcast_to(vals, (*lead, idx.numel())).reshape(-1)
    flat = (torch.arange(nb, device=a.device)[:, None] * n + idx[None, :]).reshape(-1)
    a.reshape(-1).index_put_((flat,), vals, accumulate=True)
    return a


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--configs", default="default,runner")
    ap.add_argument("--out", default="year_accuracy.json")
    ap.add_argument("--scales", default=None,
                    help="comma list of LMP scales instead of the seed-0 draw")
    ap.add_argument("--highs-from", default=None,
                    help="reuse the HiGHS NPVs of an earlier --out file with the same scales")
    ap.add_argument("--trace", action="store_true",
                    help="record and print each lane's last IPM iterations")
    ap.add_argument("--scatter-order", choices=("fixed", "device"), default="fixed",
                    help="repeated indices summed in entry order (the port's) or in "
                         "the device's own order (before that order was fixed)")
    args = ap.parse_args()

    import torch

    from dispatches_tpu_torch.case_studies.renewables.pricetaker import build_pricetaker
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, solve_lp_banded_batch,
    )
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    scales = np.random.default_rng(0).uniform(0.5, 2.0, args.scenarios)
    if args.scales:
        scales = np.array([float(v) for v in args.scales.split(",")])
    pool = ProcessPoolExecutor(
        max_workers=min(args.scenarios, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"),
    )
    cached = None
    if args.highs_from:
        with open(args.highs_from) as f:
            prev = json.load(f)
        if not np.allclose(prev["scales"], scales, rtol=0, atol=0):
            raise SystemExit("--highs-from was made for other scales")
        cached = list(zip(prev["highs_npv"], prev["highs_seconds"]))
    futs = [] if cached else [pool.submit(highs_npv, float(s)) for s in scales]

    prog, _ = build_pricetaker(_design())
    meta = extract_time_structure(prog, HOURS, block_hours=24)
    lmp, cf = _inputs()
    lmps = torch.as_tensor(scales[:, None] * lmp[None, :], device="cuda")
    params = {"lmp": lmps, "wind_cf": torch.as_tensor(cf, device="cuda")}
    if args.scatter_order == "device":
        from dispatches_tpu_torch.core import program
        from dispatches_tpu_torch.solvers import structured

        program._scatter_add = structured._scatter_add = _device_scatter_add
    blp = meta.instantiate(params, device="cuda")
    coo = prog.instantiate_coo(params, device="cuda")
    lb = torch.as_tensor(prog.lb, device="cuda")
    ub = torch.as_tensor(prog.ub, device="cuda")
    base = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)  # the runner's default tier
    configs = {
        # the JAX package's tier (f32 factorization, tol 1e-6, one chain)
        "default": {"factor_dtype": None, "tol": 1e-6, "max_iter": 80, "slabs": None},
        "refine2": {"factor_dtype": None, "tol": 1e-6, "max_iter": 80, "slabs": None,
                    "kkt_refine": 2},
        "refine2_tol1e-8": {"factor_dtype": None, "slabs": None, "kkt_refine": 2},
        # f64 factorization at the JAX tolerance, one chain
        "f64fac": {"tol": 1e-6, "max_iter": 80, "slabs": None},
        "runner": {},  # run_year_sweep's default tier as it is
        "runner_noslabs": {"slabs": None},
        "runner_slabs73": {"slabs": 73},
        **{f"runner_tol{t}": {"tol": float(t)} for t in ("1e-6", "1e-7", "1e-9", "1e-10")},
    }
    results = {"card": torch.cuda.get_device_name(0), "scales": scales.tolist(),
               "scatter_order": args.scatter_order, "runs": {}}
    sols = {}
    for name in args.configs.split(","):
        kw = {**base, **configs[name]}
        chain_sweep.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_lp_banded_batch(meta, blp, trace=args.trace, **kw)
        torch.cuda.synchronize()
        tr = None
        if args.trace:
            sol, tr = sol
        wall = time.perf_counter() - t0
        npv = prog.eval_expr("NPV", sol.x, params).cpu().numpy()
        comp = (torch.where(torch.isfinite(lb), sol.zl * (sol.x - lb), 0.0)
                + torch.where(torch.isfinite(ub), sol.zu * (ub - sol.x), 0.0)).sum(-1)
        gross = (coo.c * sol.x).abs().sum(-1) + coo.c0.abs()
        sols[name] = dict(
            duality_gap=(1e5 * comp).cpu().tolist(),
            gross_objective=(1e5 * gross).cpu().tolist(),
            dual_npv=(npv - prog.obj_sense * 1e5 * comp.cpu().numpy()).tolist(),
            wall_s=wall, launches=chain_sweep.launches,
            options={k: str(v) for k, v in kw.items()},
            npv=npv.tolist(),
            iterations=sol.iterations.cpu().tolist(),
            converged=sol.converged.cpu().tolist(),
            status=sol.status.cpu().tolist(),
            res_primal=sol.res_primal.cpu().tolist(),
            res_dual=sol.res_dual.cpu().tolist(),
            gap=sol.gap.cpu().tolist(),
        )
        if tr is not None:
            sols[name]["trace"] = {f: getattr(tr, f).cpu().tolist() for f in tr._fields}
            for i in range(len(scales)):
                n = int(sol.iterations[i])
                rows = [
                    f"{j}:rp={tr.res_primal[i, j]:.1e},rd={tr.res_dual[i, j]:.1e},"
                    f"gap={tr.gap[i, j]:.1e},ap={tr.step_primal[i, j]:.2f},"
                    f"ad={tr.step_dual[i, j]:.2f}"
                    for j in range(max(0, n - 6), n)
                ]
                print(f"[{name}] lane {i} tail: " + " ".join(rows), flush=True)
        print(f"[{name}] wall {wall:.1f} s, launches {chain_sweep.launches}", flush=True)
    highs = cached or [f.result() for f in futs]
    pool.shutdown()
    results["highs_npv"] = [h[0] for h in highs]
    results["highs_seconds"] = [h[1] for h in highs]
    for name, rec in sols.items():
        rec["rel_vs_highs"] = [
            abs(a - h) / abs(h) for a, h in zip(rec["npv"], results["highs_npv"])
        ]
        rec["dual_rel_vs_highs"] = [
            abs(a - h) / abs(h) for a, h in zip(rec["dual_npv"], results["highs_npv"])
        ]
        results["runs"][name] = rec
        for i in range(len(scales)):
            g, n = rec["duality_gap"][i], abs(rec["npv"][i])
            print(f"[{name}] lane {i} duality gap {g:.6e} $: / |NPV| {g / n:.3e}, / gross "
                  f"{g / rec['gross_objective'][i]:.3e} (gross / |NPV| "
                  f"{rec['gross_objective'][i] / n:.1f}); dual NPV vs HiGHS rel "
                  f"{rec['dual_rel_vs_highs'][i]:.1e}", flush=True)
        for i in range(len(scales)):
            print(f"[{name}] lane {i} scale {scales[i]:.3f}: it {rec['iterations'][i]} "
                  f"conv {rec['converged'][i]} st {rec['status'][i]} "
                  f"rp {rec['res_primal'][i]:.1e} rd {rec['res_dual'][i]:.1e} "
                  f"gap {rec['gap'][i]:.1e} NPV {rec['npv'][i]:.6e} "
                  f"HiGHS {results['highs_npv'][i]:.6e} rel {rec['rel_vs_highs'][i]:.1e}",
                  flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
