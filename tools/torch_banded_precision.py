"""The banded IPM's precision tiers on the solar-hydrogen year LP, on one
card: status, iterations, residuals and wall of each configuration.

    python3 tools/torch_banded_precision.py [--hours 8736] [--configs mixed,f64slab,...]

The LP is `chip_smoke.py` cases (c2)'s: the three blends (1.0, 0.3, 0.0)
as one batch over rts303's DA LMPs and the seeded synthetic PV, load,
reserve and NG series, in 12-h blocks. Configurations (each may repeat, so
that runs can alternate; `--tol` replaces the sweep's tolerance in all):

    mixed       the year sweep's options (`year_sweep_solver_kw`: f64
                factorization in SPIKE slabs, f32 factors swept by the
                fused kernel, one f64 refinement step)
    f64slab     f64 factors and sweeps (scan), the same slabs
    esc         `solve_lp_banded_escalated`: mixed to its
                `ESCALATE_AT_ITER`, then f64 in the same slabs
    warm        2 iterations of mixed and of f64slab, not printed: builds the
                kernel and warms both paths before timed runs
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hours", type=int, default=8736)
    ap.add_argument("--configs", default="warm,mixed,f64slab,esc")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import chip_smoke as C
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables import solar_hydrogen as S
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.ipm import status_name
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, solve_lp_banded_batch, solve_lp_banded_escalated,
    )
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    H = args.hours
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    lmp = np.resize(P.load_rts303()["da_lmp"], H)
    pv, load, reserve, ng = C._solar_series(H)
    prog, _ = S.build_pricetaker(S.SolarHydrogenDesign(T=H, h2_blend_ratio=None,
                                                       ramp_wrap_border=True))
    base = S.solar_hydrogen_params(H, pv, load, reserve, lmp, ng)
    lanes = {k: np.stack([v] * 3) for k, v in base.items()}
    lanes["h2_blend"] = np.asarray((1.0, 0.3, 0.0))
    meta = extract_time_structure(prog, H, 12)
    blp = meta.instantiate(lanes, device=args.device)
    kw = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)
    if args.tol is not None:
        kw["tol"] = args.tol
    f64 = dict(tol=kw["tol"], max_iter=kw["max_iter"], refine_steps=kw["refine_steps"])
    print(f"solar year LP: {H} h, Tb {meta.Tb} blocks of {meta.mB} x {meta.nB}, "
          f"p {meta.p}, slabs {kw.get('slabs')}", flush=True)
    for name in args.configs.split(","):
        n0 = chain_sweep.launches
        t0 = time.perf_counter()
        tr = None
        if name == "warm":
            solve_lp_banded_batch(meta, blp, **{**kw, "max_iter": 2})
            solve_lp_banded_batch(meta, blp, slabs=kw["slabs"], **{**f64, "max_iter": 2})
            continue
        if name == "mixed":
            sol, tr = solve_lp_banded_batch(meta, blp, trace=True, **kw)
        elif name == "f64slab":
            sol = solve_lp_banded_batch(meta, blp, slabs=kw["slabs"], **f64)
        elif name == "esc":
            sol = solve_lp_banded_escalated(meta, blp, **kw)
        else:
            raise SystemExit(f"unknown config {name!r}")
        if args.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        line = (f"{name}: wall {wall:.2f} s, status "
                f"{[status_name(c) for c in sol.status.tolist()]}, iterations "
                f"{sol.iterations.tolist()}, res_primal "
                f"{[f'{v:.1e}' for v in sol.res_primal.tolist()]}, res_dual "
                f"{[f'{v:.1e}' for v in sol.res_dual.tolist()]}, gap "
                f"{[f'{v:.1e}' for v in sol.gap.tolist()]}, obj "
                f"{[f'{v:.9e}' for v in sol.obj.tolist()]}, chain_sweep launches "
                f"{chain_sweep.launches - n0}")
        if tr is not None:
            g = tr.gap.cpu().numpy()
            line += "; gap every 4th iteration " + " | ".join(
                " ".join(f"{v:.0e}" for v in row[np.isfinite(row)][::4]) for row in g)
        print(line, flush=True)


if __name__ == "__main__":
    main()
