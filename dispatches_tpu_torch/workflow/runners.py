"""Run-script entry points (port of `dispatches_tpu/workflow/runners.py`).

    python -m dispatches_tpu_torch.workflow.runners pricetaker \
        --topology wind_pem --hours 168 --h2-price 2.0 2.5 3.0 --out sweep.bin
    python -m dispatches_tpu_torch.workflow.runners battsweep \
        --ratio 0.1 0.25 0.5 --duration 2 4 8 --out batt.bin
    python -m dispatches_tpu_torch.workflow.runners yearsweep \
        --scenarios 16 --batch 8 --out year.bin
    python -m dispatches_tpu_torch.workflow.runners doubleloop \
        --days 2 --out results.csv

Every subcommand runs on the CUDA card unless ``--device cpu`` is given.
Sweeps checkpoint converged points to the ResultStore (``--out`` /
``store_path``, `runtime/native.py`) and SKIP points already in it on a
re-run (the reference's `result_*.json` skip idiom,
`run_pricetaker_wind_PEM.py:43-50`). ``yearsweep`` takes ``--warm-starts``
(each scenario seeded from its nearest solved neighbour in the previous
batch), ``--adaptive`` (converged lanes retire and the batch compacts,
`runtime/adaptive.py`) and ``--remedy`` (the remediation ladder on
unhealthy lanes, `runtime/remedy.py`; needs ``--adaptive``); none of them
changes the store keys. ``doubleloop`` runs the double-loop
co-simulation on the bundled 5-bus network (`run_double_loop`): the
optimizing RUC, the day-ahead batch and every SCED and tracking LP solve
on the card.

Observability, as in the JAX package: ``--journal PATH`` appends a JSONL
run journal (manifest, spans, solve events; read it with
`tools/trace_summary.py`), ``--record-failures DIR`` captures every failed
or unhealthy solve into a capped ring buffer (replay with
`tools/torch_replay_solve.py`), and ``--profile-dir DIR`` writes a
`torch.profiler` trace of the whole command. The runners take ``tracer=``
(default: the process tracer) and `run_year_sweep` ``trace=True``
(per-iteration traces, summarized in the journal). ``cost=True`` /
``yearsweep --cost`` counts the first batch's executed FLOPs, bytes and
peak device memory (`obs.cost`) into its journal solve event, with a
roofline point against the card's measured peak.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..obs import health as obs_health
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs.cost import CostCounter, with_roofline
from ..obs.journal import get_tracer
from ..runtime.native import ResultStore
from .options import SimulationOptions

TOPOLOGIES = ("wind_battery", "wind_pem", "wind_pem_tank_turbine")


def _point_key(*vals) -> int:
    """Stable ResultStore key derived from the sweep point's CONTENT (not
    its loop index), equal to the JAX package's for the same values:
    re-running a sweep with different grids against the same store must
    re-solve new points instead of silently skipping them because an index
    happens to be occupied."""
    digest = hashlib.blake2s(
        repr(tuple(v if isinstance(v, str) else float(v) for v in vals)).encode(),
        digest_size=8,
    ).digest()
    return int.from_bytes(digest, "big") >> 1  # non-negative int64


def _open_store(store_path):
    """(store or None, set of keys already in it)."""
    store = ResultStore(store_path) if store_path else None
    return store, set(store.keys()) if store else set()


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
    per price, dense IPM), with checkpoint/skip: converged points go to
    the store at `store_path`, and points already there are skipped.
    Journals a ``pricetaker`` span holding a ``point_<i>`` span and a
    ``point_result`` event per solved point to `tracer` (default: the
    process tracer)."""
    from ..case_studies.renewables import params as P
    from ..case_studies.renewables.pricetaker import (
        wind_battery_optimize,
        wind_battery_pem_optimize,
        wind_battery_pem_tank_turb_optimize,
    )

    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}")
    tracer = tracer if tracer is not None else get_tracer()
    data = P.load_rts303()
    h2_prices = h2_prices or [2.0]
    store, done = _open_store(store_path)
    out = []
    with tracer.span("pricetaker", topology=topology, hours=hours):
        for i, h2 in enumerate(h2_prices):
            key = _point_key(topology, hours, h2)
            if key in done:
                if verbose:
                    print(f"[{i}] h2=${h2}/kg: checkpointed, skipping")
                tracer.event("skip_checkpointed", point=i, h2_price=h2)
                obs_metrics.inc("sweep_points_skipped_total", runner="pricetaker")
                continue
            with tracer.span(f"point_{i}", h2_price=h2):
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
            obs_metrics.inc("sweep_points_total", runner="pricetaker")
            verdict = obs_health.verdict_from_stats(rec["solver_stats"])
            obs_health.note_verdicts({verdict: 1}, solve="pricetaker")
            tracer.event(
                "point_result", point=i, h2_price=h2, NPV=rec["NPV"],
                solver_stats=rec["solver_stats"], verdict=verdict,
            )
            if store and res["converged"]:
                store.append(
                    key,
                    [h2, rec["NPV"], rec["annual_revenue"], rec["pem_kw"], rec["batt_kw"]],
                )
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


def run_battery_ratio_sweep(
    ratios=(0.1, 0.25, 0.5),
    durations=(2, 4, 8),
    hours: int = 168,
    wind_mw: float = None,
    store_path: Optional[str] = None,
    verbose: bool = True,
    tracer=None,
    device="cuda",
):
    """Battery sizing sweep over (capacity ratio, duration-hours), the
    reference's `run_pricetaker_battery_ratio_size.py` (one CBC subprocess
    per grid point there; one checkpointed in-process solve per point
    here). Battery power is fixed at ratio x wind capacity; duration sets
    both the SoC dynamics and the $/kWh capex leg. Converged points go to
    the store at `store_path`; points already there are skipped. Journals
    a ``battery_ratio_sweep`` span holding a ``point_<i>`` span and a
    ``point_result`` event per solved point to `tracer` (default: the
    process tracer)."""
    from ..case_studies.renewables import params as P
    from ..case_studies.renewables.pricetaker import wind_battery_optimize

    tracer = tracer if tracer is not None else get_tracer()
    data = P.load_rts303()
    if wind_mw is None:
        wind_mw = P.FIXED_WIND_MW
    grid = [(r, d) for r in ratios for d in durations]
    store, done = _open_store(store_path)
    out = []
    with tracer.span("battery_ratio_sweep", hours=hours, points=len(grid)):
        for i, (ratio, dur) in enumerate(grid):
            key = _point_key(ratio, dur, hours, wind_mw)
            if key in done:
                if verbose:
                    print(f"[{i}] ratio={ratio} dur={dur}h: checkpointed, skipping")
                tracer.event("skip_checkpointed", point=i, ratio=ratio, duration=dur)
                obs_metrics.inc("sweep_points_skipped_total", runner="battsweep")
                continue
            with tracer.span(f"point_{i}", ratio=ratio, duration_hrs=dur):
                res = wind_battery_optimize(
                    hours, data["da_lmp"], data["da_wind_cf"], batt_mw=ratio * wind_mw,
                    wind_mw=wind_mw, design_opt=False, battery_duration_hrs=float(dur),
                    device=device,
                )
            rec = {
                "battery_ratio": ratio,
                "duration_hrs": dur,
                "batt_mw": ratio * wind_mw,
                "NPV": res["NPV"],
                "annual_revenue": res["annual_revenue"],
                "converged": bool(res["converged"]),
                "solver_stats": res.get("solver_stats", {}),
            }
            out.append(rec)
            obs_metrics.inc("sweep_points_total", runner="battsweep")
            if not rec["converged"]:
                obs_metrics.inc("sweep_points_unconverged_total", runner="battsweep")
            verdict = obs_health.verdict_from_stats(rec["solver_stats"])
            obs_health.note_verdicts({verdict: 1}, solve="battsweep")
            tracer.event(
                "point_result", point=i, ratio=ratio, duration_hrs=dur,
                NPV=rec["NPV"], converged=rec["converged"],
                solver_stats=rec["solver_stats"], verdict=verdict,
            )
            if store and rec["converged"]:
                store.append(key, [ratio, float(dur), rec["NPV"], rec["annual_revenue"]])
            if verbose:
                print(
                    f"[{i}] ratio={ratio} dur={dur}h: NPV ${rec['NPV']:.3e} "
                    f"rev ${rec['annual_revenue']:.3e}"
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
    solve, synchronised with the device.

    Converged scenarios go to the store at `store_path` and are skipped on
    a re-run; an unconverged one stays re-solvable. The keys are the JAX
    package's: the scenario's LMP scale, the horizon, the H2 price, the
    data dtype, the mixed-precision flag, and the throughput knobs when
    they are not the defaults. The port's f64-factorization tier gives
    other answers than the JAX package's f32 one, so its keys carry one
    component more ("factor_dtype=float64"): a default port run never
    skips a scenario a JAX run stored, while ``factor_dtype="float32"``
    shares the JAX package's keys.

    ``warm_starts=True`` sorts the pending scenarios by LMP scale and seeds
    each lane of a batch from its nearest solved neighbour (by scale) in
    the previous batch, through the solver's safeguard (a rejected seed
    starts cold); iterations saved against the cold first batch's mean go
    to ``warm_start_iters_saved_total``. ``adaptive=True`` solves each
    batch with `runtime.adaptive.solve_lp_banded_adaptive` (converged
    lanes retire, the batch compacts down the bucket ladder) and puts its
    stats in each record's ``adaptive_stats``. ``remedy`` (needs
    `adaptive`) runs the `runtime.remedy` ladder on lanes that retire
    unhealthy. Records say whether their batch was ``warm_started``. None
    of the three changes the store keys; all default off, leaving the
    plain solve untouched.

    The sweep journals a ``year_sweep`` span holding one ``batch_<n>``
    span per batch to `tracer` (default: the process tracer), each with a
    ``year_batch`` solve event: `batch_stats`, health verdicts, the
    adaptive stats, and with ``trace=True`` the per-iteration traces'
    summary. With a flight recorder installed, a batch with an unhealthy
    lane is captured (`solve_lp_banded_batch`, archival: the static
    structure is not serialized).

    ``cost=True`` solves the first batch under `obs.cost.CostCounter` (the
    JAX package also costs its first batch only) and puts its record in
    that batch's solve event (``cost``): the executed FLOPs
    (``flops_basis: "executed"``, where the JAX package's XLA model counts
    a loop body once), the bytes, the peak device memory, a ledger by
    operation with the `chain_sweep` kernel's launches, and a roofline
    point (FLOPs over the batch's wall against
    `obs.cost.chip_peak_tflops`). The counter intercepts every operation,
    so that batch's wall grows; the answers are bitwise those without it."""
    from ..case_studies.renewables import params as P
    from ..case_studies.renewables.pricetaker import HybridDesign, build_pricetaker
    from ..runtime.adaptive import solve_lp_banded_adaptive
    from ..runtime.telemetry import batch_stats
    from ..solvers.structured import extract_time_structure, solve_lp_banded_batch

    if remedy and not adaptive:
        raise ValueError("remedy requires adaptive=True (the ladder acts on "
                         "the lanes the adaptive solve retires)")
    tracer = tracer if tracer is not None else get_tracer()
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

    store, done = _open_store(store_path)
    mixed = 1.0 if (mixed_precision and tdtype == torch.float64) else 0.0
    knob_key = (float(correctors), 1.0 if inv_factors else 0.0) if (
        correctors or inv_factors) else ()
    tier_key = ("factor_dtype=float64",) if solver_kw.get("factor_dtype") == torch.float64 else ()

    def keys(k):
        base = ("yearsweep", float(scales[k]), hours, h2_price,
                str(tdtype).removeprefix("torch."), mixed)
        ks = [_point_key(*base, *knob_key, *tier_key)]
        if not knob_key and not tier_key:
            # the JAX package's stores from before its knobs joined the key
            ks.append(_point_key(*base, 0.0, 0.0))
        return ks

    pending = [k for k in range(scenarios) if not any(key in done for key in keys(k))]
    if warm_starts:
        # neighbour seeding wants adjacent scales in adjacent batches
        pending.sort(key=lambda k: scales[k])
    if len(pending) < scenarios:
        obs_metrics.inc("year_scenarios_skipped_total", scenarios - len(pending),
                        runner="yearsweep")
        if verbose:
            print(f"{scenarios - len(pending)} scenarios checkpointed, skipping")
    out = []
    prev_sols = None  # (scales, x, y, zl, zu) of the previous batch, host copies
    cold_iter_mean = None  # the first (cold) batch's mean iterations
    with tracer.span("year_sweep", scenarios=scenarios, batch=batch, hours=hours,
                     dtype=str(tdtype).removeprefix("torch.")):
        for lo in range(0, len(pending), batch):
            todo = pending[lo : lo + batch]
            with tracer.span(f"batch_{lo // batch}", scenarios=[int(k) for k in todo]):
                # pad to the fixed batch width, as the JAX runner does
                padded = todo + [todo[-1]] * (batch - len(todo))
                lmps = torch.as_tensor(
                    np.asarray(scales)[padded, None] * base_lmp[None, :],
                    dtype=tdtype, device=device,
                )
                params = {"lmp": lmps, "wind_cf": cf}
                blp_b = meta.instantiate(params, dtype=tdtype, device=device)
                warm_b = None
                if warm_starts and prev_sols is not None:
                    # the nearest solved neighbour (by LMP scale) seeds each lane
                    ps, *fields = prev_sols
                    nn = [int(np.argmin(np.abs(ps - scales[k]))) for k in padded]
                    warm_b = tuple(torch.as_tensor(a[nn], device=device) for a in fields)
                ad_stats = {} if adaptive else None
                if lmps.device.type == "cuda":
                    torch.cuda.synchronize(lmps.device)
                counted = cost and lo == 0
                counter = CostCounter(lmps.device) if counted else contextlib.nullcontext()
                t0 = time.perf_counter()
                with counter:
                    if adaptive:
                        solve_out = solve_lp_banded_adaptive(
                            meta, blp_b, warm_start=warm_b, stats=ad_stats, remedy=remedy,
                            trace=trace, **solver_kw)
                    else:
                        solve_out = solve_lp_banded_batch(
                            meta, blp_b, warm_start=warm_b, trace=trace, **solver_kw)
                sol, sol_tr = solve_out if trace else (solve_out, None)
                convs = sol.converged.cpu().numpy()[: len(todo)]
                solve_wall = time.perf_counter() - t0
                batch_cost = (with_roofline(counter.record(), solve_wall, lmps.device,
                                            wall_basis="counted") if counted else None)
                npvs = prog.eval_expr("NPV", sol.x, params).cpu().numpy()[: len(todo)]
                stats = batch_stats(sol)
                iters_b = sol.iterations.cpu().numpy()[: len(todo)]
                n_conv = int(convs.sum())
                obs_metrics.inc("year_scenarios_solved_total", n_conv, runner="yearsweep")
                if len(todo) - n_conv:
                    obs_metrics.inc("year_scenarios_unconverged_total", len(todo) - n_conv,
                                    runner="yearsweep")
                obs_metrics.inc("ipm_iterations_total", float(iters_b.sum()), runner="yearsweep")
                if warm_b is None:
                    if cold_iter_mean is None:
                        cold_iter_mean = float(iters_b.mean())
                else:
                    # against the cold first batch: an estimate (the cold path is
                    # not re-solved), consistent across the batches of one sweep
                    saved = cold_iter_mean * len(todo) - float(iters_b.sum())
                    if saved > 0:
                        obs_metrics.inc("warm_start_iters_saved_total", saved,
                                        runner="yearsweep", source="neighbor")
                if warm_starts:
                    prev_sols = (np.asarray(scales)[padded], *(
                        getattr(sol, f).cpu().numpy() for f in ("x", "y", "zl", "zu")))
                tracer.solve_event(
                    "year_batch", sol, trace=sol_tr, warm_starts=warm_b is not None,
                    adaptive=adaptive, iterations_total=int(iters_b.sum()),
                    **({"adaptive_stats": ad_stats} if ad_stats else {}),
                    **({"cost": batch_cost} if counted else {}),
                )
                if obs_recorder.get_recorder() is not None:
                    # the flight recorder: the batch's problem when a lane went bad
                    summary = obs_health.health_summary(sol, trace=sol_tr)
                    if summary and summary.get("n_bad"):
                        w = summary["worst"]
                        obs_recorder.maybe_capture(
                            "solve_lp_banded_batch",
                            verdict=obs_health.Verdict(
                                w["verdict"], w["first_bad_iteration"], w["quantity"], w["detail"]),
                            problem=blp_b,
                            solution=sol,
                            warm_start=obs_recorder.warm_bundle(blp_b, warm_b),
                            options={**solver_kw, "block_hours": block_hours},
                            extra={"scenarios": [int(k) for k in todo]},
                        )
                for j, k in enumerate(todo):
                    rec = {
                        "scenario": k,
                        "lmp_scale": float(scales[k]),
                        "NPV": float(npvs[j]),
                        "converged": bool(convs[j]),
                        "iterations": int(iters_b[j]),
                        "solver_stats": stats,
                        "batch_seconds": solve_wall,
                        "warm_started": warm_b is not None,
                    }
                    if adaptive:
                        rec["adaptive_stats"] = ad_stats
                    out.append(rec)
                    if store and rec["converged"]:
                        store.append(keys(k)[0], [rec["lmp_scale"], rec["NPV"], 1.0])
                if verbose:
                    print(
                        f"[{todo[0]}..{todo[-1]}] {len(todo)} year-LPs"
                        f"{' (warm-started)' if warm_b is not None else ''}: "
                        f"converged {int(convs.sum())}/{len(todo)}, "
                        f"NPV ${npvs.min():.3e}..${npvs.max():.3e}, "
                        f"iterations {iters_b.tolist()}, {solve_wall:.1f} s"
                    )
    n_unconv = sum(1 for r in out if not r["converged"])
    if n_unconv and verbose:
        print(f"WARNING: {n_unconv} scenarios did not converge "
              "(not checkpointed; they re-solve on the next run)")
    return out


def run_double_loop(
    opts: Optional[SimulationOptions] = None,
    out_csv: Optional[str] = None,
    verbose: bool = True,
    tracer=None,
    device="cuda",
):
    """Double-loop co-simulation on the network market (the
    `run_double_loop_PEM.py:39-211` analogue, fully in-framework): a
    wind + PEM participant bids into the 5-bus RUC / SCED market and
    tracks its dispatch. The JAX package's `run_double_loop`, with every
    solve on `device`."""
    from ..market import (
        DoubleLoopCoordinator,
        PerfectForecaster,
        PEMParametrizedBidder,
        ProductionCostSimulator,
        RenewableGeneratorModelData,
        Tracker,
        load_rts_format,
    )
    from ..market.double_loop import MultiPeriodWindPEM
    from .postprocess import results_to_csv, summarize_revenue

    opts = opts or SimulationOptions()
    grid = load_rts_format(opts.data_path) if opts.data_path else load_rts_format()

    wind_cfs = np.clip(grid.da_renewables[:, 0] / max(
        u.p_max for u in grid.renewable
    ), 0.0, 1.0)
    gen = opts.bidding_generator or grid.renewable[0].name
    md = RenewableGeneratorModelData(
        gen_name=gen, bus=str(grid.buses[0]), p_min=0.0, p_max=50.0
    )
    fc = PerfectForecaster({f"{gen}-DACF": wind_cfs, f"{gen}-RTCF": wind_cfs})
    mp = MultiPeriodWindPEM(
        model_data=md,
        wind_capacity_factors=wind_cfs,
        wind_pmax_mw=50,
        pem_pmax_mw=10,
    )
    bidder = PEMParametrizedBidder(
        mp,
        day_ahead_horizon=min(opts.day_ahead_horizon, 24),
        real_time_horizon=opts.real_time_horizon,
        forecaster=fc,
        pem_marginal_cost=25.0,
        pem_mw=10,
    )
    tracker = Tracker(
        mp,
        tracking_horizon=opts.tracking_horizon,
        n_tracking_hour=opts.n_tracking_hour,
        device=device,
    )
    coord = DoubleLoopCoordinator(bidder, tracker)
    sim = ProductionCostSimulator(
        grid,
        participant_segments=opts.participant_segments,
        participant_bus=opts.participant_bus,
        device=device,
    )
    tracer = tracer if tracer is not None else get_tracer()
    with tracer.span("double_loop", days=opts.num_days):
        results = sim.simulate(
            n_days=opts.num_days,
            coordinator=coord,
            tracking_horizon=opts.tracking_horizon,
        )
    if out_csv:
        results_to_csv(results, out_csv)
    summary = summarize_revenue(
        results, lmp_key=f"LMP bus{grid.buses[0]}",
        dispatch_key="Participant [MW]",
    )
    tracer.event("double_loop_summary", **summary)
    if verbose:
        print(json.dumps(summary))
    return results, summary


def main(argv=None):
    p = argparse.ArgumentParser(prog="dispatches-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")
    p.add_argument(
        "--journal", default=None, metavar="PATH",
        help="append-only JSONL run journal (manifest + spans + solve "
        "events; read it with tools/trace_summary.py)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="write a torch.profiler trace of the whole command into DIR; "
        "journal span names label its rows",
    )
    p.add_argument(
        "--record-failures", default=None, metavar="DIR",
        help="flight recorder: snapshot every failed or unhealthy solve "
        "(problem arrays + options + manifest) into a capped ring buffer "
        "under DIR (50 captures / 256 MiB; replay with "
        "tools/torch_replay_solve.py)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("pricetaker", help="price-taker design sweep")
    pt.add_argument("--topology", choices=TOPOLOGIES, default="wind_pem")
    pt.add_argument("--hours", type=int, default=168)
    pt.add_argument("--h2-price", type=float, nargs="+", default=[2.0])
    pt.add_argument("--out", default=None, help="ResultStore checkpoint path")

    dl = sub.add_parser("doubleloop", help="double-loop co-simulation")
    dl.add_argument("--days", type=int, default=2)
    dl.add_argument("--config", default=None, help="SimulationOptions JSON")
    dl.add_argument("--out", default=None, help="results CSV path")
    dl.add_argument("--device", default=argparse.SUPPRESS,
                    help="as the global --device (default: cuda)")

    bs = sub.add_parser("battsweep", help="battery ratio x duration sizing sweep")
    bs.add_argument("--ratio", type=float, nargs="+", default=[0.1, 0.25, 0.5])
    bs.add_argument("--duration", type=int, nargs="+", default=[2, 4, 8])
    bs.add_argument("--hours", type=int, default=168)
    bs.add_argument("--out", default=None, help="ResultStore checkpoint path")

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
    ys.add_argument("--out", default=None, help="ResultStore checkpoint path")
    ys.add_argument(
        "--warm-starts", action="store_true",
        help="seed each scenario from its nearest solved neighbour in the "
        "previous batch (safeguarded; falls back to cold per lane)",
    )
    ys.add_argument(
        "--adaptive", action="store_true",
        help="adaptive batching: retire converged lanes between iteration "
        "chunks and compact the batch (runtime.adaptive)",
    )
    ys.add_argument(
        "--remedy", action="store_true",
        help="arm the remediation ladder on unhealthy adaptive lanes (cold "
        "retry -> regularize -> f64; runtime.remedy; requires --adaptive)",
    )
    ys.add_argument(
        "--cost", action="store_true",
        help="count the first batch's executed FLOPs, bytes and peak memory with a "
        "roofline point into its journal solve event (obs.cost; slows that batch)",
    )

    args = p.parse_args(argv)
    if getattr(args, "remedy", False) and not args.adaptive:
        p.error("--remedy requires --adaptive (the ladder acts on the "
                "lanes the adaptive solve retires)")
    from ..obs.journal import Tracer, set_tracer
    from ..obs.profile import profile_capture
    from ..obs.recorder import FlightRecorder, set_recorder

    tracer = Tracer(args.journal, manifest_extra={"cmd": args.cmd}) if args.journal else None
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    recorder = FlightRecorder(args.record_failures) if args.record_failures else None
    prev_recorder = set_recorder(recorder) if recorder is not None else None
    try:
        with profile_capture(args.profile_dir):
            if args.cmd == "pricetaker":
                run_pricetaker(
                    topology=args.topology, hours=args.hours, h2_prices=args.h2_price,
                    store_path=args.out, device=args.device,
                )
            elif args.cmd == "doubleloop":
                opts = (SimulationOptions.load(args.config) if args.config
                        else SimulationOptions(num_days=args.days))
                opts.num_days = args.days
                run_double_loop(opts, out_csv=args.out, device=args.device)
            elif args.cmd == "battsweep":
                run_battery_ratio_sweep(
                    ratios=args.ratio, durations=args.duration, hours=args.hours,
                    store_path=args.out, device=args.device,
                )
            else:
                run_year_sweep(
                    scenarios=args.scenarios, batch=args.batch, hours=args.hours,
                    h2_price=args.h2_price, seed=args.seed, dtype=args.dtype,
                    mixed_precision=not args.no_mixed_precision,
                    correctors=args.correctors, inv_factors=args.inv_factors,
                    store_path=args.out, device=args.device,
                    warm_starts=args.warm_starts, adaptive=args.adaptive,
                    remedy=True if args.remedy else None, cost=args.cost,
                )
    finally:
        if recorder is not None:
            set_recorder(prev_recorder)
        if tracer is not None:
            tracer.close()
            set_tracer(prev_tracer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
