#!/usr/bin/env python3
"""Weekly design LPs through the PDLP lane of both packages, on the CPU.

    env JAX_PLATFORMS=cpu python tools/torch_pdhg_weeks.py --weeks 0 5

For each week of rts303 (T = 168, the `bench.py` weekly design LP) it
solves the `instantiate_coo` LP with the JAX package's `solve_lp_pdhg`
and the port's, both with the PDLP controls on at tol 1e-6 and a budget
of 100,000 iterations, and prints each one's iterations, objective and
KKT certificates (res_primal, res_dual, comp, gap) against the default
`ConformancePolicy` bound of 1e-4. The two sequences part after a few
hundred iterations (the line search's accept tests compare nearly equal
numbers), so the point of comparison is the converged answer and its
certificates, not the iterates.

``--ulp N`` moves the largest cost entry (in magnitude) by N units in the
last place in both packages' LP before solving: how far one rounding step
moves each package's iteration count, convergence and certificates.

    env JAX_PLATFORMS=cpu python tools/torch_pdhg_weeks.py --weeks 22 --ulp 1
"""
import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weeks", type=int, nargs="+", default=[0, 5])
    ap.add_argument("--threads", type=int, default=4, help="torch intra-op threads")
    ap.add_argument("--ulp", type=int, default=0,
                    help="move the largest cost entry by this many ulps in both LPs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    from dispatches_tpu.case_studies.renewables import params as JP
    from dispatches_tpu.case_studies.renewables.pricetaker import (
        HybridDesign as JHybridDesign, build_pricetaker as j_build,
    )
    from dispatches_tpu.obs.conformance import kkt_certificates as j_certs
    from dispatches_tpu.solvers.pdhg import solve_lp_pdhg as j_pdhg
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.obs.conformance import kkt_certificates
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    torch.set_num_threads(args.threads)
    T = 168
    design = dict(T=T, with_battery=True, with_pem=True, design_opt=True,
                  h2_price_per_kg=2.5, initial_soc_fixed=None)
    jprog, _ = j_build(JHybridDesign(**design))
    tprog, _ = build_pricetaker(HybridDesign(**design))
    data = JP.load_rts303()
    kw = dict(tol=1e-6, max_iter=100_000, adaptive_restarts=True, primal_weight=True,
              linesearch=True)
    for w in args.weeks:
        params = {"lmp": data["da_lmp"].reshape(52, T)[w],
                  "wind_cf": data["da_wind_cf"].reshape(52, T)[w]}
        jlp = jprog.instantiate_coo(params)
        j = int(np.argmax(np.abs(np.asarray(jlp.c))))
        cj = np.asarray(jlp.c)[j]
        for _ in range(abs(args.ulp)):
            cj = np.nextafter(cj, np.inf if args.ulp > 0 else -np.inf)
        jlp = jlp._replace(c=jlp.c.at[j].set(cj))
        t0 = time.perf_counter()
        js = jax.block_until_ready(j_pdhg(jlp, **kw))
        j_s = time.perf_counter() - t0
        tlp = tprog.instantiate_coo(params, device="cpu")
        tlp.c[j] = float(cj)
        t0 = time.perf_counter()
        ts = solve_lp_pdhg(tlp, **kw)
        t_s = time.perf_counter() - t0
        for name, sol, cert, secs in (
            ("jax ", js, j_certs(jlp, js), j_s),
            ("port", ts, kkt_certificates(tlp, ts), t_s),
        ):
            cert = np.asarray(cert)
            print(f"week {w}{f' (c[{j}] {args.ulp:+d} ulp)' if args.ulp else ''} {name}: "
                  f"{int(sol.iterations)} iterations, converged "
                  f"{bool(sol.converged)}, obj {float(sol.obj):.10e}, certificates "
                  + " ".join(f"{v:.2e}" for v in cert)
                  + f" ({'within' if np.all(cert <= 1e-4) else 'outside'} the default "
                  f"policy), {secs:.1f} s", flush=True)


if __name__ == "__main__":
    main()
