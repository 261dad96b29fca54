#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases kernel  # build + kernel checks only

Phases (any failure raises, and the script exits non-zero):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/chain_sweep.cu with nvcc, print the seconds
  3. kernel   the chain-sweep kernel against its plain PyTorch version on
              the card at ten (chains, steps, m, k) shapes, both sweep
              directions, factors in the padded layout the kernel streams
              (`sweep_factors`), tolerance 1e-4 of the reference's max;
              times beside the HBM bound and the plain version's time, with
              the launch plan (cluster size, ring depth)
  4. weekly   `run_pricetaker` (wind+battery+PEM, T=168, three H2 prices)
              on the dense IPM; NPV within 1e-3 of HiGHS
  5. year     `run_year_sweep(scenarios=8, batch=8, hours=8760)`: mixed
              precision (f64 data and factorization in 5 SPIKE slabs, f32
              factors swept by the fused kernel, f64 refinement); all
              lanes converged,
              one scenario's NPV within 1e-3 of HiGHS, kernel launches > 0,
              wall seconds, iterations, peak memory, and the kernel's share
              of a profiled window of the same solve
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
# (chains, steps, m, k): three small ones, a year batch of 8 lanes as one
# chain each, and the shapes the year sweep's 5 SPIKE slabs give the
# kernel: 8 x 5 interior chains of 72 steps and 8 interface chains of 5;
# last, m > 256, where the forward sweep's rows take two TMA boxes
KERNEL_SHAPES = [
    (1, 12, 17, 1), (4, 6, 33, 3), (2, 5, 9, 18),
    (8, 365, 241, 1), (8, 365, 241, 3),
    (40, 72, 241, 1), (40, 72, 241, 3), (8, 5, 241, 1), (8, 5, 241, 3),
    (3, 7, 300, 2),
]
MAIN_SHAPE = (40, 72, 241, 1)  # the year sweep's interior chains, k = 1 solves
TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from dispatches_tpu_torch.solvers import chain_sweep as cs

    t0 = time.perf_counter()
    path = cs.build(verbose=True)
    cs._library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")


def _chains(D, S, m, gen):
    """Random SPD block-tridiagonal chains factored by the port's
    `_block_chol(inv=True)` in f32 on the card, in the kernel's layout."""
    from dispatches_tpu_torch.solvers.chain_sweep import sweep_factors
    from dispatches_tpu_torch.solvers.structured import _block_chol

    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    M1 = torch.randn(D, S, m, m, **kw)
    Ds = M1 @ M1.transpose(-1, -2) + m * torch.eye(m, device="cuda")
    Es = 0.3 * torch.randn(D, S, m, m, **kw)
    Es[:, 0] = 0.0
    return tuple(sweep_factors(a) for a in _block_chol(Ds, Es, inv=True))


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sweep_bytes(D, S, m, k):
    """Bytes one sweep must move: the 2S - 1 factor blocks of each chain it
    reads (neither direction needs C_0: forward skips it at the chain's
    start, backward reads C_1..C_{S-1}), R read once, the output written
    once."""
    return 4 * ((2 * S - 1) * D * m * m + 2 * D * S * m * k)


def bound_ms(D, S, m, k):
    """Least time of one sweep: `sweep_bytes` at the HBM rate, or its
    2*(2S-1)*D*m^2*k flops (a product with each block read) at the f32
    rate; the larger."""
    flops = 2 * (2 * S - 1) * D * m * m * k
    b = sweep_bytes(D, S, m, k) / HBM_BYTES_PER_S * 1e3
    f = flops / F32_FLOPS_PER_S * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def _warm_up(seconds=3.0):
    """Keep the card busy for a few seconds: its clocks ramp up under load,
    and times taken before that are the idle clock's."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def phase_kernel():
    from dispatches_tpu_torch.solvers import chain_sweep as cs
    from dispatches_tpu_torch.solvers.chain_sweep import _sweep_plain, chain_sweep

    _warm_up()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err, main = [], 0.0, {}
    for D, S, m, k in KERNEL_SHAPES:
        J, C = _chains(D, S, m, gen)
        R = torch.randn(D, S, m, k, device="cuda", generator=gen)
        for reverse in (False, True):
            got = chain_sweep(J, C, R, reverse=reverse)
            ref = _sweep_plain(J, C, R, reverse)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"chain_sweep non-finite at {(D, S, m, k)}")
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not err <= TOL * scale:
                raise AssertionError(
                    f"chain_sweep disagrees at (D,S,m,k)={(D, S, m, k)} "
                    f"reverse={reverse}: max abs err {err:.3e} > {TOL} x {scale:.3e}"
                )
            max_err = max(max_err, err)
            reps = 20 if S * m > 1000 else 200
            ms = _time_ms(lambda: chain_sweep(J, C, R, reverse=reverse), reps)
            plain_ms = _time_ms(lambda: _sweep_plain(J, C, R, reverse), max(3, reps // 10))
            bms, by = bound_ms(D, S, m, k)
            plan = cs._device_plan(D, S, m, k, reverse, cs._library())
            row = dict(shape=[D, S, m, k], reverse=reverse, max_abs_err=err,
                       ref_max=scale, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, share_of_bound=bms / ms,
                       GB_per_s=sweep_bytes(D, S, m, k) / ms / 1e6,
                       cluster=plan.cluster, width=plan.width, stages=plan.stages,
                       stage_rows=plan.stage_rows, smem_bytes=plan.smem_bytes)
            rows.append(row)
            log("[kernel] " + json.dumps(row))
            if (D, S, m, k) == MAIN_SHAPE:
                main["backward" if reverse else "forward"] = row
    log("[kernel] library_ms: null — no single PyTorch call computes a "
        "block-bidiagonal recurrence")
    return rows, max_err, main


def phase_weekly():
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy
    from dispatches_tpu_torch.workflow.runners import run_pricetaker

    hours, prices = 168, [2.0, 2.5, 3.0]
    t0 = time.perf_counter()
    recs = run_pricetaker(topology="wind_pem", hours=hours, h2_prices=prices, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    data = P.load_rts303()
    params = {"lmp": data["da_lmp"][:hours], "wind_cf": data["da_wind_cf"][:hours]}
    worst = 0.0
    for rec, h2 in zip(recs, prices):
        st = rec["solver_stats"]
        if st["converged_frac"] < 1.0:
            raise AssertionError(f"weekly h2={h2}: not converged {st}")
        prog, _ = build_pricetaker(HybridDesign(
            T=hours, with_battery=True, with_pem=True, design_opt="PEM",
            batt_mw=0.0, h2_price_per_kg=h2, initial_soc_fixed=None,
        ))
        res = solve_lp_scipy(prog.instantiate(params, device="cpu"))
        npv_ref = float(prog.eval_expr("NPV", torch.as_tensor(res.x), params))
        rel = abs(rec["NPV"] - npv_ref) / abs(npv_ref)
        worst = max(worst, rel)
        log(f"[weekly] h2={h2}: NPV {rec['NPV']:.6e} HiGHS {npv_ref:.6e} rel {rel:.2e} "
            f"iters {st['iterations']['max']}")
        if not rel <= 1e-3:
            raise AssertionError(f"weekly h2={h2}: rel {rel:.2e} > 1e-3 vs HiGHS")
    log(f"[weekly] {len(prices)} solves in {wall:.2f} s (incl. build)")
    return dict(solves=len(prices), wall_s=wall, worst_rel_vs_highs=worst)


def phase_year(scenarios=8, batch=8, hours=8760):
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, solve_lp_banded_batch,
    )
    from dispatches_tpu_torch.workflow.runners import run_year_sweep, year_sweep_solver_kw

    torch.cuda.reset_peak_memory_stats()
    chain_sweep.launches = 0
    t0 = time.perf_counter()
    recs = run_year_sweep(scenarios=scenarios, batch=batch, hours=hours, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chain_sweep.launches
    peak = torch.cuda.max_memory_allocated()
    iters = [r["iterations"] for r in recs]
    batch_s = sorted({r["batch_seconds"] for r in recs})
    log(f"[year] {len(recs)} scenarios, batch {batch}: wall {wall:.1f} s "
        f"(batch solve {batch_s} s), iterations {iters}, mean {np.mean(iters):.1f}, "
        f"peak memory {peak / 2**30:.2f} GiB, chain_sweep launches {launches} "
        f"({launches / max(iters):.1f} per IPM iteration of the batch loop)")
    if launches <= 0:
        raise AssertionError("the year sweep launched no chain_sweep kernel")
    if not all(r["converged"] for r in recs):
        raise AssertionError(f"year lanes not converged: {[r['converged'] for r in recs]}")
    if not all(np.isfinite(r["NPV"]) for r in recs):
        raise AssertionError("non-finite year NPV")

    # one scenario against HiGHS on the same LP
    data = P.load_rts303()
    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    base_lmp = np.resize(data["da_lmp"], hours)
    cf = np.resize(data["da_wind_cf"], hours)
    rec = recs[0]
    params = {"lmp": rec["lmp_scale"] * base_lmp, "wind_cf": cf}
    t1 = time.perf_counter()
    res = solve_lp_scipy_sparse(prog, params)
    highs_s = time.perf_counter() - t1
    npv_ref = float(prog.eval_expr("NPV", torch.as_tensor(res.x), params))
    rel = abs(rec["NPV"] - npv_ref) / abs(npv_ref)
    log(f"[year] scenario {rec['scenario']}: NPV {rec['NPV']:.8e} HiGHS {npv_ref:.8e} "
        f"rel {rel:.2e} (HiGHS {highs_s:.1f} s on the host)")
    if not rel <= 1e-3:
        raise AssertionError(f"year NPV rel {rel:.2e} > 1e-3 vs HiGHS")

    # profiled window: the same batch for a few IPM iterations
    meta = extract_time_structure(prog, hours, block_hours=24)
    rng = np.random.default_rng(0)
    scales = rng.uniform(0.5, 2.0, scenarios)[:batch]
    lmps = torch.as_tensor(scales[:, None] * base_lmp[None, :], device="cuda")
    blp = meta.instantiate({"lmp": lmps, "wind_cf": cf}, device="cuda")
    kw = {**year_sweep_solver_kw(torch.float64, Tb=meta.Tb), "max_iter": 3}
    solve_lp_banded_batch(meta, blp, **kw)  # warm
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        solve_lp_banded_batch(meta, blp, **kw)
        torch.cuda.synchronize()
        window = time.perf_counter() - t2
    dev_us, kern_us = 0.0, 0.0
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops; their kernels are rows of their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        dev_us += us
        top.append((us, e.key[:60]))
        if "chain_sweep_kernel" in e.key:
            kern_us += us
    top.sort(reverse=True)
    share = kern_us / 1e6 / window if window else float("nan")
    busy = dev_us / 1e6 / window if window else float("nan")
    log(f"[year] profiled window (3 IPM iterations, batch {batch}): wall {window:.3f} s, "
        f"device busy {busy:.3f}, chain_sweep share {share:.3f} "
        f"({kern_us / 1e3:.1f} ms of kernel time)")
    for us, name in top[:8]:
        log(f"[year]   {us / 1e3:9.1f} ms  {name}")
    if dev_us == 0:
        log("[year] the profiler saw no device time: kernel share not measured")
    return dict(scenarios=len(recs), wall_s=wall, batch_seconds=batch_s,
                mean_iterations=float(np.mean(iters)), peak_bytes=peak,
                launches=launches, rel_vs_highs=rel, kernel_share=share,
                device_busy=busy, window_s=window)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernel,weekly,year",
                    help="comma list of kernel, weekly, year (device and build always run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    kernel_rows, max_err, main = phase_kernel() if "kernel" in phases else ([], None, {})
    if "weekly" in phases:
        phase_weekly()
    year = phase_year() if "year" in phases else {}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    rec = {
        "name": "chain_sweep",
        "route": "cuda",
        "source": "dispatches_tpu_torch/csrc/chain_sweep.cu",
        "replaces": "dispatches_tpu/solvers/pallas_sweep.py:87",
        "launches": year.get("launches"),
        "max_abs_err": max_err,
        # the forward sweep at MAIN_SHAPE; both directions under "directions"
        "ms": main.get("forward", {}).get("ms"),
        "plain_ms": main.get("forward", {}).get("plain_ms"),
        "bound_ms": main.get("forward", {}).get("bound_ms"),
        "bound_by": main.get("forward", {}).get("bound_by"),
        "library_ms": None,
        "shape": list(MAIN_SHAPE),
        "directions": {
            d: {key: row[key] for key in ("ms", "plain_ms", "bound_ms", "share_of_bound",
                                          "cluster", "stages")}
            for d, row in main.items()
        },
    }
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
