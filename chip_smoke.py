#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases kernel  # build + kernel checks only
    python3 chip_smoke.py --phases pdhg    # the PDHG lane alone
    python3 chip_smoke.py --phases serve   # the serving tier alone
    python3 chip_smoke.py --phases market  # the market layer and double loop alone
    python3 chip_smoke.py --phases plants  # the steam cycles and the NLP lane alone
    python3 chip_smoke.py --phases cases   # the nuclear / solar cases and surrogates alone
    python3 chip_smoke.py --phases learn   # the learned-model tools and the planes' neutrality
    python3 chip_smoke.py --phases horizon # the wind + battery year by time-axis ADMM alone

Phases (any failure raises, and the script exits non-zero; each phase
runs under the port's watchdog, `obs/watchdog.py::with_watchdog`, whose
limit (`PHASE_LIMITS_S`) turns a hang into a failure):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile csrc/chain_sweep.cu and csrc/tes_chain.cu with nvcc
              (one process each, started together), print the seconds
  3. kernel   the chain-sweep kernel against its plain PyTorch version on
              the card at 22 (chains, steps, m, k) shapes (8 of them the
              cases phase's banded year LPs), both sweep
              directions, factors in the padded layout the kernel streams
              (`sweep_factors`), tolerance 1e-4 of the reference's max;
              times beside the HBM bound and the plain version's time, with
              the launch plan (cluster size, ring depth)
  4. weekly   `run_pricetaker` (wind+battery+PEM, T=168, three H2 prices)
              on the dense IPM; NPV within 1e-3 of HiGHS
  4b. golden  the reference's four golden-dollar cases
              (`tests/test_re_goldens.py`): `load_re_goldens` on the card,
              its capacity factors within 1e-12 of the CPU's, then each
              case through the port's driver on the card at the reference's
              tolerances; NPV, sizes and seconds printed
  4c. horizon the wind + battery dispatch over rts303's 8,736 h by
              time-axis ADMM (`renewables.horizon.wind_battery_horizon_solve`):
              a coarse warm start (the year in 4-h steps, one dense solve),
              then HORIZON_SWEEPS sweeps, each the 52 weekly chunks (168 h,
              the dense IPM's weekly shape) as one batch of the diagonal-QP
              IPM. Gates: every sweep's lanes converged and finite, the
              boundary mismatch below 1 kWh (tests/test_time_axis.py), the
              objective's gap to HiGHS on the monolithic LP (a child started
              with the script, on the year HiGHS child's cores) within
              HORIZON_GAP. Printed: sweeps, IPM iterations a sweep, the
              phase's and the coarse solve's wall. It runs before `year`, so
              the card works while the year's HiGHS child finishes.
  5. year     `run_year_sweep(scenarios=8, batch=8, hours=8760)`: mixed
              precision (f64 data and factorization in 5 SPIKE slabs, f32
              factors swept by the fused kernel, f64 refinement); all
              lanes converged,
              one scenario's NPV within 1e-3 of HiGHS (a child process
              started with the script, on the two cores the plants child
              takes, beside the earlier phases; the phase waits for it
              before its timed work), kernel launches > 0,
              wall seconds, iterations, peak memory, and the kernel's share
              of a profiled window of the same solve; then the journal's
              cost: the same 8 scenarios over JOURNAL_PAIR_HOURS, plain and
              with a journal (`tracer=`, the same spans and records as at
              the year): the host time inside the tracer's calls, the
              journaled wall beside the plain one, results bitwise
  6. grad     design gradients through the LP solves:
              (a) weekly design (T=168, `build_pricetaker_design`):
                  `optimal_value` gradients in batt_kw, pem_kw, h2_price
                  against central differences (rel 1e-4, abs 1e-3), and the
                  adjoint path (`optimal_solution`) against the envelope
                  (rel 1e-3);
              (b) year value and LMP gradient (`optimal_value_banded`, 8
                  lanes x 8,760 h at the year phase's seed-0 scales and
                  solver options): every lane converged, its primal
                  objective x 1e5 within 1e-6 of the lane's year-phase
                  NPV and its value (the Lagrangian) x 1e5 within
                  YEAR_VALUE_RTOL of the gross objective (sum |c_i x_i| +
                  |c0|) of that NPV (against |NPV| and the duality gap
                  printed),
                  finite gradient, kernel launches > 0;
                  wall time beside the year phase's batch seconds, the
                  difference as the gradient's overhead, peak memory;
              (c) the gradient's LMP slope g . lmp_base = dV/ds: within
                  1e-9 (of |slope| + |V|) of the NPV's LMP term over s at
                  the solve's own x on every lane, and within rel 1e-4 of
                  the same at HiGHS's x
                  on lane 0; then the subgradient bracket: lanes 0-3 of
                  (b) re-solved at s(1 +- 1e-3) in one batch of 8, and
                  g . lmp_base lies between the one-sided slopes of V(s)
                  (convex in s) widened by 1e-4 of its magnitude, the
                  slopes taken as wide as the solves' own duality gaps
                  allow (`bracket_bounds`);
              (d) `run_battery_ratio_sweep` (168 h, 3 x 3 grid) with a
                  ResultStore in a temporary directory: every point
                  converged, and a second run solves none.
              Without the year phase, grad runs the year phase's sweep
              itself (solve only) for the NPVs and batch seconds of (b),
              and HiGHS on scenario 0 for (c).
  7. adaptive lane retirement, warm starts and remediation on the card:
              (a) `solve_lp_banded_adaptive` over the year phase's 8 lanes
                  with its solver options, chunk_iters=8, ladder_base=2
                  (buckets 8 -> 4 -> 2, so the kernel runs at 40, 20 and 10
                  interior chains): per-lane iterations and convergence the
                  year phase's, NPVs within ADAPTIVE_NPV_RTOL of its, and
                  the lanes harvested at bucket 8 bitwise its NPVs (which
                  are functions of x alone, summed in a fixed order).
                  Printed: the buckets, the
                  lane-iterations run beside 8 x the slowest lane's, the
                  wall beside the year batch's, launches by chain count;
              (b) the CLI, ``yearsweep --scenarios 16 --batch 8
                  --warm-starts --adaptive --remedy --cost --out <tmp>``: all 16
                  converged and stored, each batch's iterations (the
                  runner prints them, the warm one tagged) and the
                  iterations saved, a warm-started lane within 1e-3 of
                  HiGHS (the year phase's scenario 0, whose HiGHS solve
                  is reused, when it is one; else the largest scale),
                  and a rerun that launches no kernel; the run also takes
                  ``--journal`` and ``--record-failures``: the manifest
                  names the card, the spans are year_sweep/batch_*, the
                  solve events carry stats and health for all 16 lanes,
                  span ends a device-memory watermark, no capture (every
                  lane healthy), and `tools/trace_summary.py` reads it;
                  the first batch's ``--cost`` record (`obs.cost`, executed
                  work) in its solve event: FLOPs > 0, the normal-equations
                  products (``aten.bmm``), the block Cholesky
                  (``aten.linalg_cholesky_ex``) and ``chain_sweep`` among
                  the ledger's first COST_TOP entries, the roofline share
                  of the card's measured peak (`chip_peak_tflops`, printed
                  with the card and its power limit) at most 1;
              (c) the remedy ladder on the card: a rank-deficient dense LP
                  (reg_p = reg_d = 0) between two healthy ones through
                  `solve_lp_adaptive(remedy=RemedyPolicy(allow_lane_switch=
                  False))` recovers at "regularize", the others untouched;
                  an infeasible LP in its place gives up ("unrecoverable"):
                  the journal has its `remediation` event, the recorder its
                  capture, which `tools/torch_replay_solve.py` replays
                  bitwise on the card and with the same status on the CPU.
              (e) (a)'s run passes conformance=True: its lanes bitwise
                  those of the same run without it and with the
                  performance probe on instead (`PerfProbe(capture_sizes=
                  True)`), the certificates printed; every chunk record's
                  phases sum bitwise to its wall, each key's counted cold
                  call has FLOPs, each chunk's roofline share of the
                  measured peak is at most 1; the phase split, the
                  roofline points and the counted FLOPs printed.
              (f) learned warm starts on the year family: (a)'s 8 lanes
                  through `DatasetWriter.add_batch` (one family
                  fingerprint, hashed once for the batch: ms printed), a
                  (64, 64) predictor trained on the card, then scenarios
                  8-15 (the CLI's second batch in (b)) through
                  `solve_lp_banded_adaptive(warm_predictor=)` at (a)'s
                  options beside the same lanes cold: every seed accepted
                  by the banded solver's safeguard (its verdict replayed,
                  `structured.banded_warm_accept`, and counted), the
                  iterations not the cold lanes', every lane converged,
                  each NPV within OBJ_AGREE (of 1 + |NPV|) of the cold
                  lane's and within YEAR_WARM_NPV_RTOL of (b)'s stored
                  NPV, chain_sweep launches > 0; a NaN predictor on two
                  lanes for 8 iterations: both seeds rejected, the lanes
                  bitwise the cold run. Printed: iterations warm against
                  cold, walls, accepted and rejected seeds, fingerprint ms.
              Without the year phase, (a) runs the year phase's sweep first.
  8. pdhg     the PDHG/PDLP lane on the card:
              (s) the scatter-add sites (the dense `instantiate` of the
                  52 weekly LPs, the banded `instantiate` and
                  ``eval_expr("NPV")`` at the year shape) on the card
                  against the CPU, in ulps and fingerprints: with the
                  device's own sum order of repeated indices, printed;
                  with the port's fixed order, bitwise the CPU's; each
                  site's time and its time inside the scatter-adds, in
                  both orders, printed;
              (a) `instantiate_coo` of the weekly design LP (52 weeks)
                  twice on the card: equal fingerprints, within 1 ulp of
                  the CPU's;
              (b) the 52 weekly LPs (rts303, T=168, f64) through
                  `solve_lp_pdhg_adaptive` (PDLP controls, tol 1e-6,
                  18,000 iterations, chunks of 2,000, conformance=True)
                  and the dense IPM batch (tol 1e-8), weeks 0 and the
                  slowest through HiGHS: week 0 converged, every
                  converged lane within 1e-4 (1 + |obj_ipm|) of the IPM
                  and its residual certificates within the default
                  ConformancePolicy (comp and gap printed: PDHG does not
                  stop on them), the solver's residuals equal to the
                  certificates (rel 1e-9); the
                  card against the port's CPU PDHG on 2 weeks over two
                  check periods (controls off within 1e-9); the first 8
                  weeks, 800 iterations in chunks of 400 bitwise a
                  one-shot solve;
              (c) the year phase's 8 LMP scenarios x 8,760 h through
                  `solve_lp_pdhg` with the controls at a fixed budget of
                  2,000 iterations, traced: finite, residuals equal to
                  the certificates, two 400-iteration runs bitwise
                  equal; printed: the residual trajectory, the NPVs
                  against the year phase's, ms per iteration, peak memory;
              (d) the remedy ladder's lane switch both ways: a dense
                  lane capped below its IPM iteration count recovers at
                  "lane_switch" through PDHG (default RemedyPolicy, the
                  other lanes bitwise), a stuck SparseLP through the IPM;
              (f) profiled windows of (b) and (c): device-busy share,
                  launches per PDHG iteration, device time by op, and
                  A x / Aᵀ y against their HBM bound.
              The phase's gates are raised at its end, after every
              number has printed.
  9. serve    the serving tier on the card, over the 52 weekly design LPs
              of rts303 (T = 168, f64, the dense `instantiate` of pdhg (s),
              1,681 x 2,355 a lane, tol 1e-8, max_iter 60), each week's
              reference its lane of a one-shot `solve_lp_batch` of its
              group of 8 (the last group padded by its own weeks):
              (a) burst: the 52 submitted at once to
                  `make_dense_service(bucket=8, chunk_iters=8, perf=True,
                  capacity=SERVE_CAPACITY)`, drained: every ticket
                  resolves, every lane converges, every row bitwise its
                  reference (so both planes neutral); every chunk record
                  of the probe sums bitwise to its wall, and the exporter's
                  ``/capacity`` answers 200 with the report; printed: wall,
                  LPs/s, chunks, refills, the one-shot batch of 52's wall,
                  the phase split, the capacity estimate;
              (a2) ramp: `tools/torch_loadgen.py`'s `run_ramp` (``--ramp
                  --capacity``) over the weeks, SERVE_RAMP's rates as
                  fractions of (a)'s LPs/s: every request answered ok, the
                  observatory's estimate ok, its knee and shard
                  recommendation finite, the service's headroom gauge
                  published, its Little's-law residual below
                  SERVE_LITTLES_BOUND;
              (b) open loop: 13 Poisson arrivals (`tools/torch_loadgen.py`
                  `arrival_schedule`, seed 0) over the weeks
                  (`problem_seeds`, dup 0.25, seed mod 52) at 0.5 x (a)'s
                  rate, cache on: zero lost, every solve converged, every
                  answer (cache hits included) bitwise its week's
                  reference; latency p50/p95/p99 (`np.percentile`'s
                  interpolation: at 13 requests p99 and p95 lie between
                  the two slowest),
                  goodput, cache hits, then the serial baseline on the
                  same schedule;
              (c) deadline: the slowest week with a timeout of half a
                  chunk resolves `deadline_exceeded` with a finite best
                  iterate;
              (d) fleet: `make_dense_fleet(2, 8, telemetry=True)`, both
                  children on cuda:0: weeks 39-51 bitwise (a)'s; a second
                  pass over weeks 0-12 with shard 0 sent `fault exit` after
                  6 submissions: zero lost, a respawn, requeued lanes
                  bitwise too; spawn to
                  first pong and to first result, the slowest ping, the
                  kill-to-first-result wall; the parent's
                  serve_requests_total equal to the sum of its per-shard
                  series and the merged child counters to their fleet
                  aggregate; /metrics and /healthz scraped once from a
                  `TelemetryExporter` on 127.0.0.1 at an ephemeral port;
              (e) a `torch.profiler` window of 2 chunks at bucket 8 in steady
                  state: device-busy share, launches and device-to-host
                  scalar reads a chunk, device time by op; then the host
                  time by phase over 2 more chunks (the performance
                  probe's transfer, cold, compute, harvest, host).
              (f) a warm service: week 0 at 52 LMP scales (seed 0's
                  draw in [0.5, 2]), each solved cold in its group of 8; a
                  predictor trained on 40, the other 12 served through
                  `make_dense_service(bucket=8, warm_model=)`, journaled:
                  every answer converged, at least one seed accepted (the
                  engine's verdict on each answer's solve record, as many
                  as the accept counter), every rejected lane bitwise its
                  cold lane, every accepted lane's objective within
                  SERVE_WARM_OBJ_RTOL (1 + |obj|) of its cold lane's;
                  accepts, iterations saved and max |dx| printed.
              chain_sweep launches on this path are read (0: the dense
              IPM takes no banded sweep). The gates are raised at the
              phase's end, after every number has printed.
 10. market   the market layer and the double loop on the card (dense IPM
              only; chain_sweep's launches are read, 0):
              (a) `run_double_loop` (2 days, bundled 5-bus grid, the wind +
                  PEM participant, optimizing RUC on its device backend):
                  48 rows, every SCED converged, no shortfall above 1e-3
                  MW, the participant above 1 MW at some hour; the same 2
                  days without the participant (`test_network.py:312-322`'s
                  run): converged, no shortfall, every LMP in (0, 100); 4 sampled SCEDs' objectives within rel 1e-5 /
                  abs 1e-2 of HiGHS on the same LP; each day's RUC schedule,
                  costed by its batched evaluation, within [1 - 1e-6, 1.01]
                  x the exact MILP's cost (the host backend's choice
                  printed beside it). Printed: wall, SCEDs/s, seconds in the
                  RUC, day-ahead batches, SCEDs, tracking and bids; the mean
                  SCED and tracking LP ms, and one profiled hour (its SCED
                  and a tracking LP): launches, scalar reads, device busy;
              (b) `synthesize_network(73, 73, days=2, seed=5,
                  rating_mode="flow")` on the card, simulated 2 days with
                  the host RUC (`backend="host"`): 48 SCEDs converged, at
                  most 6 shed hours, LMPs apart by > $0.5 in >= 30% of
                  hours (`test_uc_scale.py`), 4 SCEDs against HiGHS as in
                  (a). Printed: flow-rating wall, RUC s a day, SCED s,
                  SCEDs/s;
              (c) the N-1 screen of (b)'s grid at hour 0 (every
                  non-islanding branch and every unit): the K-lane
                  instantiate's ms, `solve_lp_adaptive` and a 16-slot dense
                  engine (wall, LPs/s); every lane converged, but for
                  outages no dispatch survives (must-run generation
                  stranded: the contingency program has no over-generation
                  slack, as in the JAX package), which must end
                  suspected_primal_infeasible with HiGHS infeasible on the
                  same LP, the same lanes on both paths; every engine lane
                  bitwise its lane of a one-shot batch of 16; then
                  `secure_dispatch(conformance=True)` over the outages
                  some dispatch survives: N-1 feasible, 0 escaped,
                  certificates pass (rounds, cuts printed);
              (e) the learned screener on (c)'s outage set: hour-0 points
                  at perturbed loads labelled by full secure dispatches,
                  a screener trained through tools/torch_train_screener.py's
                  `train`, then `secure_dispatch(screener=)` at (c)'s base
                  point and one unseen point: N-1 feasible, 0 escaped, the
                  objective within MARKET_SCREEN_OBJ_RTOL of the full set's;
                  the screened set, rounds and SCEDs/s against the full
                  set's printed;
              (d) `test_stochastic_bidder.py`'s SimpleMarket double loop (3
                  days), the miscalibrated parametrized bidder against
                  `StochasticBidder(n_scenario=3)`: every scenario
                  solution and bid curve monotone within 1e-4, stochastic
                  profit above 1.02 x the parametrized. Printed: walls, the
                  ms of one scenario LP.
              The gates are raised at the phase's end.
 11. plants   the steam cycles and the NLP lane on the card (NLPs, square
              solves, dense LPs and the tube-side chain kernel; chain_sweep's
              launches are read, 0); the CPU reference of (c)'s gradient runs
              in a child process beside the card's work, on two cores of
              its own:
              (a) `tests/test_nlp.py`'s problems and square solves, then a
                  `solve_nlp_batch` of 64 seeded HS071-style lanes, on the
                  card and on the CPU: the same converged flags, x within
                  rel 1e-8. Printed: iterations, lanes whose iterations
                  differ from the CPU's, ms and launches per iteration;
              (b) the USC cycle: design (436.466 MW rel 2e-4), 300 MW
                  (flow 12,474.473 rel 5e-4), 27 MPa (446.15 MW rel 2e-3,
                  940.4 MWth rel 1e-3), `derive_performance_map` at
                  `tests/test_usc_nlp.py`'s bounds; Newton iterations,
                  residual and wall of each solve;
              (c) concrete TES at the reference geometry (10,000 tubes, 20
                  segments, 2 periods, 48 bisections, 30 Gauss-Seidel
                  iterations) through the kernel: the charge, discharge and
                  combined goldens of `tests/test_concrete_tes.py` at its
                  tolerances; the kernel against `_tes_chain_plain` on the
                  card on the combined hour's first pass (h_out within 1e-9
                  of each segment's starting bracket, weights equal where
                  the outlets agree); the kernel at every swept `levels`
                  bitwise itself at levels 1 (the serial bisection) on
                  that pass and on one whose brackets straddle the
                  plateau; the store-hour walls beside the serial kernel's
                  recorded ones, and a profiled combined hour (device busy
                  share, the kernel's device ms against the other
                  kernels'); each levels' ms a pass, rounds, the design's
                  latency bound and share, beside the serial bound (from
                  `tools/latency_probe.cu`'s measured latencies) and the
                  throughput bound of the serial path's work; the
                  stored-energy gradient in the charge flow:
                  finite, > 0, within rel 1e-6 of the CPU child's;
              (d) SCPC: design 692 +- 1 MW, `solve_scpc_with_tes` 625 +- 1
                  MW, with the TES hour's wall;
              (e) Rankine: `tests/test_rankine.py`'s two 6-scenario cases
                  with its assertions; N = 168 (rts303's first week of DA
                  LMPs, weights 8760/168): converged, KKT error under tol,
                  objective within rel 1e-6 of the port's CPU run;
                  iterations, wall, launches an iteration, device busy;
              (f) `run_all_tank_scenarios(ndays=7)` (3 lanes x 168 h, one
                  batch), each profit within rel 1e-6 of HiGHS;
                  `run_pricetaker_analysis` over rts303's first week
                  against HiGHS; `solve_superstructure` charge and
                  discharge: the CPU run's best leaf, every leaf's net
                  value within rel 1e-6; `MultiPeriodUsc` through the
                  port's `Tracker` (horizon 4, 1 hour implemented) for 24
                  hourly solves following a feasible dispatch, hours 0
                  and 12 against HiGHS.
              The gates are raised at the phase's end.
 12. cases    the nuclear and solar-hydrogen case studies, the detailed
              tank and the market-surrogate pillar on the card; the HiGHS
              references run on the host beside the card's work:
              (a) `tests/test_nuclear.py`'s three flowsheet goldens at its
                  tolerances; `traditional_tea_enumeration` (6 x 10);
              (b) the nuclear price-taker over rts303's 8,736 h (the
                  reference runs 8,784), banded (364 day-blocks, the year
                  sweep's solver options, SPIKE slabs, f32 factors swept
                  by the kernel): DA, RT and Max-DA-RT as one batch of 3
                  lanes, then DA-RT's second step from the DA lane's
                  net power; the report's 6 x 10 grid (pinned PEM
                  capacities) in batches of 60 lanes (halved while the
                  card runs out of memory). Gates: every lane converged,
                  the DA lane's and grid lane 34's annualized NPV within
                  1e-3 of HiGHS, Max-DA-RT >= DA and RT, the PEM capacity
                  factor not falling as the H2 price rises at a fixed PEM
                  fraction, chain_sweep launched. Printed: walls, LPs/s,
                  iterations, peak memory, launches by chain count;
              (c) solar hydrogen: (c1) `pv_battery_hydrogen_optimize` at
                  T = 168 for the blends 1.0, 0.3, 0.0 on the dense IPM,
                  each NPV within 1e-3 of HiGHS; (c2) the three blends as
                  one banded batch over 8,736 h in 12-h blocks (the blend a
                  parameter, the cyclic ramp through a border column)
                  through `solve_lp_banded_escalated` (the year sweep's
                  options for 16 iterations, then f64 factors in the same
                  slabs) at tol 1e-6: every lane converged, its KKT
                  certificates within the default ConformancePolicy,
                  chain_sweep launched. LMPs are
                  rts303's DA series; PV CF, load, reserve and NG price
                  seeded synthetic series (the reference's inputs are not
                  in the repository);
              (d) the detailed tank: the fill and empty goldens of
                  `tests/test_tank_detailed.py`, then 64 lanes x 168
                  hourly steps of seeded flows: mass conserved to 1e-9 rel,
                  a finite gradient of the final pressure in the inflow;
                  ms and device launches a step printed;
              (e) `tests/test_surrogate_scale.py`'s synthetic sweep
                  (10,000 runs x 8,736 h, seed 7, 5 latent prototypes) as
                  arrays into `SimulationData`; k-means (20 Lloyd steps, 2
                  restarts, seed 0) over the kept days on the card: more
                  than 2 M days kept, every prototype recovered (rms <
                  0.05); frequency labels summing to 1 (1e-6); the
                  frequency (64, 64; 150 epochs) and revenue (500 epochs)
                  networks at that file's R2 thresholds;
              (f) `conceptual_design_dynamic_RE` and a 4 x 4 (bid, size)
                  `design_sweep` with the wind size free (one
                  `solve_nlp_batch`) on (e)'s networks, the design inputs
                  mapped affinely onto the sweep's input box;
                  `conceptual_design_ss_NE` with the revenue network and
                  an analytic capacity factor; `conceptual_design_problem_nn`
                  with `tests/test_conceptual_design.py`'s stand-ins: each
                  converged and no worse than a brute-force grid over its
                  box; `fit_arma` on rts303's DA LMPs and 100 realizations
                  x 8,736 h: mean within 10% of the series', hour-of-day
                  spread within 20%.
              The gates are raised at the phase's end.
 13. learn    the learned-model tools on the card: the --self-check of
              tools/torch_train_warmstart.py, torch_train_screener.py,
              torch_train_laneroute.py and torch_lane_report.py, each
              gated as its JAX counterpart gates, the four as child
              processes started together; meanwhile 16 small LPs served
              with the lane observatory probing every solve and the
              time-series store on, bitwise the same service without them,
              and the adaptive entry with the observatory, bitwise; the
              probes' device wall printed.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
# the cases phase's banded year LPs (one SPIKE slab split each, `spike_slabs`):
# the nuclear variants (3 lanes; 364 day-blocks of 120 rows, 14 slabs: 14 x
# 3 interior chains of 25 steps, 3 interface chains of 14), the nuclear
# grid (60 lanes; blocks of 121 rows, the pinned capacity's row), solar
# hydrogen (3 lanes; 728 12-h blocks of 280 rows, 26 slabs of 27 + 1
# steps) with the Woodbury solve's 13 right-hand sides (13 border columns)
CASES_KERNEL_SHAPES = [
    (42, 25, 120, 1), (3, 14, 120, 1), (840, 25, 121, 1), (60, 14, 121, 1),
    (78, 27, 280, 1), (78, 27, 280, 13), (3, 26, 280, 1), (3, 26, 280, 13),
]
# (chains, steps, m, k): three small ones, a year batch of 8 lanes as one
# chain each, and the shapes the year sweep's 5 SPIKE slabs give the
# kernel: 8 x 5 interior chains of 72 steps and 8 interface chains of 5;
# m > 256, where the forward sweep's rows take two TMA boxes; last, the
# shapes of the adaptive year batch after compaction to 4 and 2 lanes
KERNEL_SHAPES = [
    (1, 12, 17, 1), (4, 6, 33, 3), (2, 5, 9, 18),
    (8, 365, 241, 1), (8, 365, 241, 3),
    (40, 72, 241, 1), (40, 72, 241, 3), (8, 5, 241, 1), (8, 5, 241, 3),
    (3, 7, 300, 2),
    (20, 72, 241, 1), (20, 72, 241, 3), (10, 72, 241, 1), (4, 5, 241, 1),
] + CASES_KERNEL_SHAPES
MAIN_SHAPE = (40, 72, 241, 1)  # the year sweep's interior chains, k = 1 solves
ROOT = os.path.dirname(os.path.abspath(__file__))
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
    from concurrent.futures import ThreadPoolExecutor

    from dispatches_tpu_torch import _nvcc
    from dispatches_tpu_torch.solvers import chain_sweep as cs
    from dispatches_tpu_torch.units import concrete_tes as tes

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc a source, started together
        builds = [pool.submit(mod.build, verbose=True) for mod in (cs, tes)]
        builds.append(pool.submit(_nvcc.build, LATENCY_PROBE))
        paths = [b.result() for b in builds]
    cs._library()
    tes._library()
    log(f"[build] {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.2f} s")


LATENCY_PROBE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                             "latency_probe.cu")


# `tools/latency_probe.cu`'s ops: (op, name, d, repetitions)
LATENCY_OPS = ((0, "div", 1.5, 1 << 18), (1, "shfl_add", 0.0, 1 << 18), (2, "add", 0.0, 1 << 18),
               (3, "newton1", 1.0e6, 1 << 15), (4, "newton2", 3.0e6, 1 << 15),
               (5, "ladder", 1.0, 1 << 18), (6, "plateau_step", 1.4e6, 1 << 18),
               (7, "round_sync", 1.5e6, 1 << 15))


def _latency_ns():
    """Dependent latency [ns] of the tes_chain kernel's steps at the card's
    running clock (`tools/latency_probe.cu`, k dependent repetitions): an
    f64 division, one level of the warp butterfly (shuffle + add), an f64
    add, a full region-1 and region-2 Newton step as the kernel runs them,
    the power ladder alone, a bisection step on the plateau, and a round's
    sign exchange at 31 warps."""
    import ctypes

    from dispatches_tpu_torch import _nvcc

    lib = ctypes.CDLL(str(_nvcc.build(LATENCY_PROBE)))
    lib.latency_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.latency_probe.restype = ctypes.c_int
    out = torch.empty(32, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ns = {}
    for op, name, d, k in LATENCY_OPS:
        if lib.latency_probe(op, 1024, d, out.data_ptr(), stream) != 0:
            raise RuntimeError(f"latency probe {name} did not launch")
        ms = _time_ms(lambda: lib.latency_probe(op, k, d, out.data_ptr(), stream), 3)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"latency probe {name}: non-finite result")
        ns[name] = ms * 1e6 / k
    return ns


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


def sweep_flops(D, S, m, k):
    """Operations of one sweep: a product with each block read, 2 m^2 k
    flops each."""
    return 2 * (2 * S - 1) * D * m * m * k


def bound_ms(D, S, m, k):
    """Least time of one sweep: `sweep_bytes` at the HBM rate, or its
    `sweep_flops` at the f32 rate; the larger."""
    b = sweep_bytes(D, S, m, k) / HBM_BYTES_PER_S * 1e3
    f = sweep_flops(D, S, m, k) / F32_FLOPS_PER_S * 1e3
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


def _year_lp(hours=8760):
    """The year phase's design LP (rts303, h2 at 2.5 $/kg): the program,
    the base LMPs and the wind capacity factors over `hours`."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )

    data = P.load_rts303()
    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    return prog, np.resize(data["da_lmp"], hours), np.resize(data["da_wind_cf"], hours)


def _year_highs(out_path, scenarios=8, hours=8760):
    """`--year-highs`: HiGHS on the year phase's scenario-0 LP (seed 0's
    first LMP scale), its x, NPV and seconds written as .npz; run as a
    child started with the script, on the cores `_start_year_highs` gives
    it."""
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    cores = os.environ.get("YEAR_HIGHS_CORES")
    if cores:
        _pin({int(c) for c in cores.split(",")})
    t0 = time.perf_counter()
    prog, base_lmp, cf = _year_lp(hours)
    scale = float(np.random.default_rng(0).uniform(0.5, 2.0, scenarios)[0])
    params = {"lmp": scale * base_lmp, "wind_cf": cf}
    res = solve_lp_scipy_sparse(prog, params)
    npv = float(prog.eval_expr("NPV", torch.as_tensor(res.x), params))
    np.savez(out_path, x=res.x, npv=npv, scale=scale, seconds=time.perf_counter() - t0)


def _start_year_highs():
    """Start the year phase's HiGHS reference (~1 min on the host) in a
    child process with the script, on the two cores `_start_cpu_tes_gradient`
    gives its child, so that it runs beside the phases before `year`; the
    year phase waits for it before its timed work."""
    path = os.path.join(tempfile.mkdtemp(prefix="year_"), "highs.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        env["YEAR_HIGHS_CORES"] = ",".join(map(str, cores[-2:]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--year-highs", path], env=env)
    return {"path": path, "proc": proc, "cores": cores[-2:] if len(cores) >= 4 else cores}


def phase_year(highs, scenarios=8, batch=8, hours=8760):
    """The `year` phase (see the module docstring); `highs` is
    `_start_year_highs`'s child, waited for before anything is timed."""
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, solve_lp_banded_batch,
    )
    from dispatches_tpu_torch.workflow.runners import run_year_sweep, year_sweep_solver_kw

    t1 = time.perf_counter()
    rc = highs["proc"].wait(timeout=PHASE_LIMITS_S["year"])
    waited = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"the year phase's HiGHS child failed (rc {rc})")
    ref = np.load(highs["path"])
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
    journal = _journal_overhead(scenarios, batch)
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

    prog, base_lmp, cf = _year_lp(hours)

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

    # CUDA activity only: the CPU-op recorder slows the host's launches
    # and its trace takes ~10 s to read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    # one scenario against HiGHS on the same LP (the child's)
    rec = recs[0]
    if rec["lmp_scale"] != float(ref["scale"]):
        raise AssertionError(f"scenario 0's scale {rec['lmp_scale']} is not HiGHS's "
                             f"{float(ref['scale'])}")
    npv_ref = float(ref["npv"])
    rel = abs(rec["NPV"] - npv_ref) / abs(npv_ref)
    log(f"[year] scenario {rec['scenario']}: NPV {rec['NPV']:.8e} HiGHS {npv_ref:.8e} "
        f"rel {rel:.2e} (HiGHS {float(ref['seconds']):.1f} s in a child process on cores "
        f"{highs['cores']}, started with the script; {waited:.1f} s waited for it before "
        f"the timed sweep)")
    if not rel <= 1e-3:
        raise AssertionError(f"year NPV rel {rel:.2e} > 1e-3 vs HiGHS")
    return dict(scenarios=len(recs), wall_s=wall, batch_seconds=batch_s,
                mean_iterations=float(np.mean(iters)), peak_bytes=peak,
                launches=launches, rel_vs_highs=rel, kernel_share=share,
                device_busy=busy, window_s=window, records=recs, highs_x=ref["x"],
                highs_npv=(rec["lmp_scale"], npv_ref), journal=journal)


class _TracerClock:
    """A tracer whose public calls are timed: `span` (its entry and its
    exit, where the records are written), `event`, `metric` and
    `solve_event`; everything else passes through to `tracer`."""

    def __init__(self, tracer):
        self.tracer, self.seconds = tracer, 0.0

    def __getattr__(self, name):
        attr = getattr(self.tracer, name)
        if name not in ("event", "metric", "solve_event"):
            return attr

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return attr(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t
        return timed

    @contextlib.contextmanager
    def span(self, *a, **kw):
        t = time.perf_counter()
        with self.tracer.span(*a, **kw) as s:
            self.seconds += time.perf_counter() - t
            yield s
            t = time.perf_counter()
        self.seconds += time.perf_counter() - t


# the journal-overhead pair's horizon (8,760 h, the year phase's sweep, before
# the horizon phase): a sweep writes the same spans and records at any horizon
JOURNAL_PAIR_HOURS = 720


def _journal_overhead(scenarios, batch, hours=None):
    """The sweep's scenarios over `hours` (JOURNAL_PAIR_HOURS), plain and
    then with a journal to a file: the host seconds spent inside the
    tracer's calls (spans, solve events, records: as many as at the year),
    which is the journal's cost, and the journaled run's wall beside the
    plain one's (one pair in a fixed order: their difference is not
    resolved from run-to-run noise); the same iterations and NPVs
    bitwise."""
    from dispatches_tpu_torch.obs.journal import Tracer
    from dispatches_tpu_torch.workflow.runners import run_year_sweep

    hours = hours or JOURNAL_PAIR_HOURS
    t0 = time.perf_counter()
    plain_recs = run_year_sweep(scenarios=scenarios, batch=batch, hours=hours, device="cuda",
                                verbose=False)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tracer = _TracerClock(Tracer(f"{tmp}/year.jsonl"))
        t0 = time.perf_counter()
        recs = run_year_sweep(scenarios=scenarios, batch=batch, hours=hours, device="cuda",
                              tracer=tracer, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracer.close()
        size = os.path.getsize(f"{tmp}/year.jsonl")
    same = all(a["iterations"] == b["iterations"] and a["NPV"] == b["NPV"]
               for a, b in zip(recs, plain_recs))
    log(f"[year] journaled, {scenarios} scenarios x {hours} h: {tracer.seconds * 1e3:.1f} ms "
        f"inside the tracer's calls; wall "
        f"{wall:.2f} s beside the plain run's {plain_wall:.2f} s ({wall - plain_wall:+.2f} s, "
        f"one pair: not resolved); {len(tracer.events)} records, {size} bytes; iterations "
        f"and NPVs {'bitwise the plain run' if same else 'DIFFER from the plain run'}")
    if not same:
        raise AssertionError("the journal changed the year sweep's results")
    return dict(wall_s=wall, plain_wall_s=plain_wall, tracer_s=tracer.seconds,
                records=len(tracer.events), bytes=size)


# tests/test_re_goldens.py: (driver, hours, keywords, {result key: (value, rel, abs)})
GOLDENS = {
    "wind_battery": ("wind_battery_optimize", 7 * 24, {}, {
        "NPV": (666_049_365, 1e-3, 0), "annual_revenue": (59_163_455, 1e-3, 0),
        "batt_kw": (0.0, 0, 1.0)}),
    "wind_pem": ("wind_battery_pem_optimize", 6 * 24,
                 dict(h2_price_per_kg=2.5, design_opt="PEM"), {
        "NPV": (1_339_462_317, 1e-2, 0), "annual_rev_h2": (155_129_116, 1e-2, 0),
        "annual_rev_E": (68_599_396, 1e-2, 0), "pem_kw": (487e3, 1e-2, 0),
        "batt_kw": (0.0, 0, 1.0)}),
    "wind_battery_pem": ("wind_battery_pem_optimize", 6 * 24,
                         dict(h2_price_per_kg=2.5, design_opt=True), {
        "NPV": (1_339_462_317, 1e-2, 0), "annual_rev_h2": (155_129_116, 1e-2, 0),
        "annual_rev_E": (68_599_396, 1e-2, 0), "pem_kw": (487e3, 0, 5e3),
        "batt_kw": (0.0, 0, 1.0)}),
    "wind_battery_pem_tank_turbine": ("wind_battery_pem_tank_turb_optimize", 6 * 24,
                                      dict(h2_price_per_kg=2.0, design_opt=True), {
        "NPV": (1_018_975_372, 1e-2, 0), "annual_rev_h2": (99_396_474, 1e-2, 0),
        "annual_rev_E": (28_711_076, 1e-2, 0), "pem_kw": (355e3, 0, 3e3),
        "batt_kw": (0.0, 0, 3e3), "turb_kw": (0.0, 0, 3e3),
        "tank_kg": (0.0, 0, 3.0)}),
}
GOLDEN_CF_ATOL = 1e-12  # the card's capacity factors against the CPU's


def phase_golden():
    """The reference's four golden-dollar cases on the card, from the port's
    `load_re_goldens` (capacity factors computed on the card, held to the
    CPU's) through its drivers, at `tests/test_re_goldens.py`'s
    tolerances."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables import pricetaker

    t0 = time.perf_counter()
    gold = P.load_re_goldens(device="cuda")
    cpu = P.load_re_goldens(device="cpu")
    cf_err = float(np.max(np.abs(gold["wind_cf"] - cpu["wind_cf"])))
    log(f"[golden] inputs: {gold['da_lmp'].shape[0]} LMPs (max {gold['da_lmp'].max():.0f}), "
        f"{gold['wind_cf'].shape[0]} capacity factors (mean {gold['wind_cf'].mean():.6f}) in "
        f"{time.perf_counter() - t0:.2f} s; card vs CPU max abs {cf_err:.2e}")
    if not cf_err <= GOLDEN_CF_ATOL:
        raise AssertionError(f"capacity factors on the card vs the CPU: {cf_err:.3e}")
    out = {}
    for name, (driver, hours, kw, want) in GOLDENS.items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = getattr(pricetaker, driver)(hours, gold["da_lmp"], gold["wind_cf"],
                                          device="cuda", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        if "tank_mol" in res:
            res["tank_kg"] = res["tank_mol"] / P.H2_MOLS_PER_KG
        got = {k: res[k] for k in want}
        bad = [k for k, (v, rel, ab) in want.items()
               if not abs(got[k] - v) <= max(rel * abs(v), ab)]
        log(f"[golden] {name} ({hours} h): NPV ${res['NPV']:,.0f} (reference "
            f"${want['NPV'][0]:,}, rel {abs(res['NPV'] / want['NPV'][0] - 1):.2e}), "
            + ", ".join(f"{k} {got[k]:,.1f}" for k in want if k != "NPV")
            + f"; {res['iterations']} iterations, converged {res['converged']}, {secs:.2f} s")
        if not res["converged"] or bad:
            raise AssertionError(f"golden {name}: {bad} outside the reference's tolerance {got}")
        out[name] = dict(got, seconds=secs, iterations=res["iterations"])
    return dict(cf_max_abs_err=cf_err, cases=out)


GRAD_SIZES = ("batt_kw", "pem_kw", "h2_price")
BRACKET_EPS = 1e-3  # relative step of the LMP scale in the bracket of (c)
# (b): the solve's primal objective is the year phase's NPV (the same LP
# and options): rel 1e-6. The value is the Lagrangian, the dual side of
# that optimum: it differs from the year phase's NPV by the lane's
# duality gap, which the IPM's tol (1e-8) bounds relative to the scaled
# objective's terms (`gross_objective`: sum |c_i x_i| + |c0|, 8 to 52x
# |NPV| on these lanes), not to the NPV, their small remainder. So the
# value is held to the NPV at YEAR_VALUE_RTOL of the gross objective.
# Readings on the H100 (`tools/torch_year_accuracy.py`, the gap per
# lane): tol 1e-8, 4.9e-8 to 8.6e-7; a 10x looser solve (tol 1e-7), up to
# 7.7e-6 (lanes 4 and 7 fail); tol 1e-6, 2.5e-5 to 8.1e-5 (every lane
# fails). Against |NPV| the tol-1e-8 gap reads up to 3.75e-5 (lane 5,
# the smallest |NPV|): printed
YEAR_PRIMAL_RTOL = 1e-6
YEAR_VALUE_RTOL = 3e-6
# (c): g . lmp_base against the LMP slope of the solve's own x (the same
# number by the envelope theorem, as NPV is affine in the LMPs) and of
# HiGHS's x for lane 0 (an independent solver; CPU at T=720: rel <= 1.8e-6)
SLOPE_X_RTOL = 1e-9
SLOPE_HIGHS_RTOL = 1e-4


def duality_gap(prog, sol):
    """Per lane, sum of zl (x - l) + zu (u - x) over the finite bounds: the
    gap between the primal objective of `sol` and its dual objective, in
    the units of ``sol.obj`` (the residuals, ~1e-13 here, aside)."""
    lb = torch.as_tensor(prog.lb, dtype=sol.x.dtype, device=sol.x.device)
    ub = torch.as_tensor(prog.ub, dtype=sol.x.dtype, device=sol.x.device)
    comp = (torch.where(torch.isfinite(lb), sol.zl * (sol.x - lb), 0.0)
            + torch.where(torch.isfinite(ub), sol.zu * (ub - sol.x), 0.0))
    return comp.sum(-1)


def gross_objective(prog, x, params):
    """Per lane, sum |c_i x_i| + |c0| of the LP at `params`: the magnitude
    of the objective's terms, in the units of ``sol.obj``."""
    coo = prog.instantiate_coo(params, dtype=x.dtype, device=x.device)
    return (coo.c * x).abs().sum(-1) + coo.c0.abs()


def bracket_bounds(center, minus, plus, step):
    """The widest one-sided slopes the solves allow. `center`, `minus` and
    `plus` are intervals (lo, hi) that hold the optimal value V at s,
    s - step and s + step (the primal value of a solve and that value
    moved by its duality gap: V lies between a primal and a dual
    objective). Returns (lowest left slope, highest right slope)."""
    return (center[0] - minus[1]) / step, (plus[1] - center[0]) / step


def lmp_slope(prog, x, base_lmp, scales, cf):
    """dV/ds of the design objective (NPV x 1e-5) at the point `x` for LMPs
    s * base_lmp: the NPV's LMP term over s, as the NPV is affine in the
    LMPs. Batched over a leading axis of `x` and `scales`."""
    s = np.asarray(scales, np.float64)
    x = torch.as_tensor(x, dtype=torch.float64).cpu()

    def npv(lmp):
        return prog.eval_expr("NPV", x, {"lmp": lmp, "wind_cf": cf}).numpy()

    lmp = s[..., None] * base_lmp
    return 1e-5 * (npv(lmp) - npv(0.0 * lmp)) / s


def _grad_weekly():
    """(a): weekly design gradients against central differences, and the
    adjoint path against the envelope, on the card."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker_design,
    )
    from dispatches_tpu_torch.solvers.diff import optimal_solution, optimal_value

    hours, kw = 168, dict(tol=1e-9, max_iter=60)
    prog, _ = build_pricetaker_design(HybridDesign(
        T=hours, with_battery=True, with_pem=True, h2_price_per_kg=2.5,
        initial_soc_fixed=None,
    ))
    data = P.load_rts303()
    base = {"lmp": data["da_lmp"][:hours], "wind_cf": data["da_wind_cf"][:hours],
            "batt_kw": 5000.0, "pem_kw": 1e5, "h2_price": 2.5}

    def on_card(params, grad=()):
        return {k: torch.tensor(np.asarray(v, np.float64), device="cuda",
                                requires_grad=k in grad) for k, v in params.items()}

    def npv(params):
        return optimal_value(prog, params, device="cuda", **kw) * 1e5

    t0 = time.perf_counter()
    p = on_card(base, GRAD_SIZES)
    v = npv(p)
    g = [float(x) for x in torch.autograd.grad(v, [p[k] for k in GRAD_SIZES])]
    env_s = time.perf_counter() - t0
    worst = 0.0
    for name, gi, h in zip(GRAD_SIZES, g, (1.0, 10.0, 1e-4)):
        with torch.no_grad():
            fd = (float(npv(on_card({**base, name: base[name] + h})))
                  - float(npv(on_card({**base, name: base[name] - h})))) / (2 * h)
        err = abs(gi - fd)
        worst = max(worst, err / abs(fd))
        log(f"[grad] (a) d NPV / d {name}: {gi:.9e} central difference (h={h}) "
            f"{fd:.9e} rel {err / abs(fd):.2e}")
        if not err <= max(1e-4 * abs(fd), 1e-3):
            raise AssertionError(f"weekly gradient in {name}: {gi} vs central difference {fd}")
    q = on_card(base, ("h2_price",))
    sol = optimal_solution(prog, q, device="cuda", **kw)
    if not bool(sol.converged):
        raise AssertionError("weekly design solve not converged")
    g_sol = float(torch.autograd.grad(prog.eval_expr("NPV", sol.x, q), q["h2_price"])[0])
    rel_adj = abs(g_sol - g[2]) / abs(g[2])
    log(f"[grad] (a) adjoint path d NPV / d h2_price {g_sol:.9e}, envelope {g[2]:.9e}, "
        f"rel {rel_adj:.2e}; value + gradient {env_s:.2f} s")
    if not rel_adj <= 1e-3:
        raise AssertionError(f"adjoint-path gradient rel {rel_adj:.2e} > 1e-3 of the envelope")
    return dict(npv=float(v.detach()), grads=dict(zip(GRAD_SIZES, g)), worst_rel_vs_fd=worst,
                adjoint_rel=rel_adj, value_grad_s=env_s)


def phase_grad(year_records=None, highs_x=None, n=8, hours=8760):
    """The `grad` phase (see the module docstring), on the card.
    `year_records` and `highs_x` are the year phase's records and its
    HiGHS solution of scenario 0; the phase computes them when absent."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.runtime.native import ResultStore
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, optimal_value_banded, solve_lp_banded_batch,
    )
    from dispatches_tpu_torch.workflow.runners import (
        run_battery_ratio_sweep, run_year_sweep, year_sweep_solver_kw,
    )

    weekly = _grad_weekly()

    # (b) year value and gradient over the year phase's lanes
    if year_records is None:
        log("[grad] the year phase did not run: solving its batch here (solve only)")
        year_records = run_year_sweep(scenarios=n, batch=n, hours=hours, device="cuda")
    if not all(r["converged"] for r in year_records):
        raise AssertionError("the year batch has unconverged lanes: no envelope gradient there")
    npvs = np.array([r["NPV"] for r in year_records])
    scales = np.array([r["lmp_scale"] for r in year_records])
    batch_s = year_records[0]["batch_seconds"]
    data = P.load_rts303()
    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    meta = extract_time_structure(prog, hours, block_hours=24)
    base_lmp = np.resize(data["da_lmp"], hours)
    cf = np.resize(data["da_wind_cf"], hours)
    kw = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chain_sweep.launches = 0
    t0 = time.perf_counter()
    lmps = torch.tensor(scales[:, None] * base_lmp[None], device="cuda", requires_grad=True)
    v, sol_b = optimal_value_banded(meta, {"lmp": lmps, "wind_cf": cf}, device="cuda",
                                    return_solution=True, **kw)
    g, = torch.autograd.grad(v.sum(), lmps)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = chain_sweep.launches
    peak_b = torch.cuda.max_memory_allocated()
    v = v.detach().cpu().numpy()
    primal = (prog.obj_sense * sol_b.obj).cpu().numpy()
    rel_p = np.abs(primal * 1e5 - npvs) / np.abs(npvs)
    gap_b = (duality_gap(prog, sol_b) * 1e5).cpu().numpy()
    gross = (gross_objective(prog, sol_b.x, {"lmp": lmps.detach(), "wind_cf": cf})
             * 1e5).cpu().numpy()
    rel_v = np.abs(v * 1e5 - npvs) / gross
    rel_npv = np.abs(v * 1e5 - npvs) / np.abs(npvs)
    log(f"[grad] (b) year value + LMP gradient, {n} lanes x {hours} h: wall {wall_b:.2f} s "
        f"(year batch solve {batch_s:.2f} s; gradient overhead {wall_b - batch_s:.2f} s), "
        f"peak memory {peak_b / 2**30:.2f} GiB, chain_sweep launches {launches_b}, "
        f"iterations {sol_b.iterations.tolist()}, vs year NPV rel max: primal objective "
        f"x 1e5 {rel_p.max():.2e}; value x 1e5, / the gross objective, {rel_v.max():.2e}")
    log(f"[grad] (b) per lane: NPV {np.array2string(npvs, precision=6)}; gross objective "
        f"/ |NPV| {np.array2string(gross / np.abs(npvs), precision=1)}; value x 1e5 vs NPV, "
        f"/ the gross objective {np.array2string(rel_v, precision=3)}, / |NPV| "
        f"{np.array2string(rel_npv, precision=3)}; the solve's duality gap x 1e5 / |NPV| "
        f"{np.array2string(np.abs(gap_b) / np.abs(npvs), precision=3)}")
    if launches_b <= 0:
        raise AssertionError("the year gradient solve launched no chain_sweep kernel")
    if not bool(sol_b.converged.all()):
        raise AssertionError(f"year gradient lanes not converged: {sol_b.converged.tolist()}")
    if not np.all(rel_p <= YEAR_PRIMAL_RTOL):
        raise AssertionError(
            f"year primal objective x 1e5 vs year-phase NPV rel {rel_p} > {YEAR_PRIMAL_RTOL}")
    if not np.all(rel_v <= YEAR_VALUE_RTOL):
        raise AssertionError(
            f"year value x 1e5 vs year-phase NPV, / the gross objective, {rel_v} > "
            f"{YEAR_VALUE_RTOL}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite year LMP gradient")
    d = (g.double() @ torch.as_tensor(base_lmp, device="cuda")).cpu().numpy()
    d_x = lmp_slope(prog, sol_b.x, base_lmp, scales, cf)
    # relative to |d_x| + |V|: lmp_slope's difference of two NPVs rounds
    # at the NPV's scale, which matters on a lane that sells next to nothing
    rel_x = np.abs(d - d_x) / (np.abs(d_x) + np.abs(v))
    if highs_x is None:
        log("[grad] the year phase did not run: solving scenario 0 with HiGHS here")
        highs_x = solve_lp_scipy_sparse(prog, {"lmp": scales[0] * base_lmp, "wind_cf": cf}).x
    d_h = float(lmp_slope(prog, highs_x, base_lmp, scales[0], cf))
    rel_h = abs(d[0] - d_h) / abs(d_h)
    log(f"[grad] (c) g . lmp_base {d.tolist()}; vs the LMP slope at the solve's x rel max "
        f"{rel_x.max():.2e}; lane 0 vs the slope at HiGHS's x {d_h:.9e} rel {rel_h:.2e}")
    if not np.all(rel_x <= SLOPE_X_RTOL):
        raise AssertionError(f"g . lmp vs the LMP slope at the solve's x: rel {rel_x}")
    if not rel_h <= SLOPE_HIGHS_RTOL:
        raise AssertionError(f"lane 0 g . lmp {d[0]} vs the slope at HiGHS's x {d_h}")

    # (c) subgradient bracket: V(s) is convex in the LMP scale s
    k4 = min(4, n)
    s_pm = np.repeat(scales[:k4], 2) * np.tile([1 - BRACKET_EPS, 1 + BRACKET_EPS], k4)
    blp = meta.instantiate({"lmp": s_pm[:, None] * base_lmp[None], "wind_cf": cf},
                           device="cuda")
    chain_sweep.launches = 0
    t1 = time.perf_counter()
    sol = solve_lp_banded_batch(meta, blp, **kw)
    V_pm = (prog.obj_sense * sol.obj).cpu().numpy()
    wall_c = time.perf_counter() - t1
    launches_c = chain_sweep.launches
    if not bool(sol.converged.all()):
        raise AssertionError(f"bracket lanes not converged: {sol.converged.tolist()}")
    gap_pm = duality_gap(prog, sol).cpu().numpy()
    brackets = []
    for k in range(k4):
        step = scales[k] * BRACKET_EPS
        # point slopes from (b)'s value at s_k, as the bracket is stated ...
        left, right = (v[k] - V_pm[2 * k]) / step, (V_pm[2 * k + 1] - v[k]) / step
        # ... and the widest the solves allow: V(s_k) lies between the year
        # NPV (primal) and (b)'s Lagrangian (dual), V(s_k(1 +- eps)) within
        # each solve's duality gap of its primal value
        p_k = npvs[k] * 1e-5
        center = (min(p_k, v[k]), max(p_k, v[k]))
        lo, hi = bracket_bounds(
            center,
            (V_pm[2 * k] - gap_pm[2 * k], V_pm[2 * k] + gap_pm[2 * k]),
            (V_pm[2 * k + 1] - gap_pm[2 * k + 1], V_pm[2 * k + 1] + gap_pm[2 * k + 1]),
            step,
        )
        slack = 1e-4 * abs(d[k])
        ok = lo - slack <= d[k] <= hi + slack
        brackets.append(dict(scale=scales[k], left=left, g_dot_lmp=d[k], right=right,
                             lowest_left=lo, highest_right=hi, slack=slack,
                             gaps=[float(v[k] - p_k), float(gap_pm[2 * k]),
                                   float(gap_pm[2 * k + 1])], ok=bool(ok)))
        log(f"[grad] (c) lane {k} s={scales[k]:.4f}: left {left:.6e}, g.lmp {d[k]:.6e}, "
            f"right {right:.6e}; bounds from the duality gaps [{lo:.6e}, {hi:.6e}] "
            f"+- {slack:.3e} {'ok' if ok else 'FAILS'}")
    log(f"[grad] (c) bracket batch of {2 * k4}: {wall_c:.2f} s, chain_sweep launches {launches_c}")
    if not all(b["ok"] for b in brackets):
        raise AssertionError("a year LMP gradient lies outside its subgradient bracket")

    # (d) battery sweep with a checkpoint store
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/battsweep.bin"
        t2 = time.perf_counter()
        recs = run_battery_ratio_sweep(hours=168, store_path=store, device="cuda")
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t2
        stored = len(ResultStore(store).keys())
        again = run_battery_ratio_sweep(hours=168, store_path=store, device="cuda")
    log(f"[grad] (d) battery sweep: {len(recs)} points in {wall_d:.2f} s, "
        f"{stored} stored, resumed run solved {len(again)}")
    if not (len(recs) == 9 and all(r["converged"] for r in recs)):
        raise AssertionError(f"battery sweep not converged: {[r['converged'] for r in recs]}")
    if stored != 9 or again:
        raise AssertionError(f"battery sweep resume: {stored} stored, {len(again)} re-solved")
    return dict(weekly=weekly, wall_s=wall_b, batch_seconds=batch_s,
                overhead_s=wall_b - batch_s, peak_bytes=peak_b, launches=launches_b,
                rel_value_max=float(rel_v.max()), rel_value_npv_max=float(rel_npv.max()),
                rel_primal_max=float(rel_p.max()),
                slope_x_rel_max=float(rel_x.max()), slope_highs_rel=rel_h, brackets=brackets,
                bracket_wall_s=wall_c, bracket_launches=launches_c,
                battsweep_wall_s=wall_d)


# (a): a lane's NPV after compaction against the year phase's: the same
# iterate sequence, moved only by batch-size-dependent rounding
ADAPTIVE_NPV_RTOL = 1e-9
ADAPTIVE_CHUNK, ADAPTIVE_LADDER = 8, 2
# (c): the JAX package's remedy patient (tests/test_remedy.py)
SICK_KW = dict(tol=1e-8, max_iter=60, reg_p=0.0, reg_d=0.0)


def _dense_lp(rows, device="cuda"):
    from dispatches_tpu_torch.core.program import LPData

    fields = [np.asarray(f, np.float64) for f in zip(*rows)]
    return LPData(*(torch.as_tensor(f, device=device) for f in fields))


def _adaptive_year(year_records, hours):
    """(a): the year phase's lanes through lane retirement and compaction."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.obs.perf import PerfProbe
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_banded_adaptive
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import extract_time_structure
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    data = P.load_rts303()
    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    meta = extract_time_structure(prog, hours, block_hours=24)
    scales = np.array([r["lmp_scale"] for r in year_records])
    # the year phase's data, built as `run_year_sweep` builds it
    params = {
        "lmp": torch.as_tensor(scales[:, None] * np.resize(data["da_lmp"], hours)[None, :],
                               dtype=torch.float64, device="cuda"),
        "wind_cf": torch.as_tensor(np.resize(data["da_wind_cf"], hours),
                                   dtype=torch.float64, device="cuda"),
    }
    blp = meta.instantiate(params, device="cuda")
    kw = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)
    torch.cuda.synchronize()
    chain_sweep.launches, chain_sweep.launches_by_chains = 0, {}
    stats = {}
    t0 = time.perf_counter()
    sol = solve_lp_banded_adaptive(meta, blp, chunk_iters=ADAPTIVE_CHUNK,
                                   ladder_base=ADAPTIVE_LADDER, stats=stats,
                                   conformance=True, **kw)
    conv = sol.converged.tolist()
    wall = time.perf_counter() - t0
    launches = chain_sweep.launches
    by_chains = dict(sorted(chain_sweep.launches_by_chains.items()))
    npvs = prog.eval_expr("NPV", sol.x, params).cpu().numpy()
    iters = sol.iterations.tolist()
    y_iters = [r["iterations"] for r in year_records]
    y_npvs = np.array([r["NPV"] for r in year_records])
    rel = np.abs(npvs - y_npvs) / np.abs(y_npvs)
    plain = len(iters) * max(iters)
    log(f"[adaptive] (a) {len(iters)} year lanes, chunk_iters {ADAPTIVE_CHUNK}, ladder base "
        f"{ADAPTIVE_LADDER}: buckets {stats['buckets']}, lane-iterations run "
        f"{stats['lane_iterations']} ({stats['padded_lane_iterations']} of them on padding "
        f"rows) against {plain} (= {len(iters)} x {max(iters)}) in the plain batch, wall {wall:.2f} s against the year batch's "
        f"{year_records[0]['batch_seconds']:.2f} s, chain_sweep launches {launches} by chain "
        f"count {by_chains}, lanes retired {stats['lanes_retired']}; iterations {iters}; "
        f"NPV rel vs the year phase max {rel.max():.3e}")
    if iters != y_iters or conv != [r["converged"] for r in year_records]:
        raise AssertionError(f"adaptive lanes {iters} {conv} vs the year phase's {y_iters}")
    if not all(conv):
        raise AssertionError(f"adaptive year lanes not converged: {conv}")
    if not np.all(rel <= ADAPTIVE_NPV_RTOL):
        raise AssertionError(f"adaptive NPVs vs the year phase rel {rel} > {ADAPTIVE_NPV_RTOL}")
    if launches <= 0 or stats["buckets"][-1] >= stats["buckets"][0]:
        raise AssertionError(f"no compacted kernel run: {launches} launches, "
                             f"buckets {stats['buckets']}")
    # lanes harvested before the first compaction ran only at bucket 8: the
    # year phase's batch, iterate for iterate, and `eval_expr` sums in a
    # fixed order, so their NPVs are the year phase's bits
    first = stats["buckets"].count(stats["buckets"][0]) * ADAPTIVE_CHUNK
    early = [i for i, n in enumerate(iters) if n <= first]
    diff = [float(abs(npvs[i] - y_npvs[i]) / abs(y_npvs[i])) for i in early]
    log(f"[adaptive] (a) lanes {early}, harvested at bucket {stats['buckets'][0]}: NPVs "
        f"{'bitwise the year phase' if not any(diff) else f'DIFFER from the year phase by {diff}'}")
    if any(diff):
        raise AssertionError(f"lanes harvested at bucket {stats['buckets'][0]} differ from the "
                             f"year phase by {diff}")
    # (e) the conformance plane only reads: the same run without it, with
    # the performance probe instead (it only reads the clock; its key's
    # first calls run under obs.cost's counter, so this run's wall is not
    # (a)'s)
    probe = PerfProbe(capture_sizes=True, device="cuda")
    off = solve_lp_banded_adaptive(meta, blp, chunk_iters=ADAPTIVE_CHUNK,
                                   ladder_base=ADAPTIVE_LADDER, perf=probe, **kw)
    same = _all_same(sol, off)
    conf = stats["conformance"]
    log(f"[adaptive] (e) conformance=True: {sum(ln['ok'] for ln in conf['lanes'])} of "
        f"{len(conf['lanes'])} lanes pass the default policy, worst {conf['worst']}; "
        f"lanes {'bitwise equal to' if same else 'DIFFER from'} the same run without it "
        "(perf= on instead)")
    if not same:
        raise AssertionError("conformance=True or perf= changed the adaptive year lanes")
    perf = _adaptive_perf(probe)
    return dict(wall_s=wall, stats=stats, launches=launches, launches_by_chains=by_chains,
                rel_max=float(rel.max()), bitwise_lanes=early, plain_lane_iterations=plain,
                conformance_worst=conf["worst"], perf=perf,
                _ctx=dict(prog=prog, meta=meta, blp=blp, sol=sol, kw=kw, data=data))


def _adaptive_perf(probe):
    """(e)'s probe: every chunk record's phases sum bitwise to its wall; the
    phase split, each chunk's roofline point against the card's measured
    peak (at most 1), and each key's counted cold call printed."""
    recs = probe.records
    broken = [i for i, r in enumerate(recs) if sum(r["phases"].values()) != r["wall_s"]]
    split = {}
    for r in recs:
        for k, v in r["phases"].items():
            split[k] = split.get(k, 0.0) + v
    # a key's FLOPs an iteration (from its counted call) times each chunk's
    # own loop iterations; "counted": the chunk's wall ran under the counter
    points = [(r["bucket"], r.get("flops"), r.get("achieved_tflops"), r.get("utilization"),
               r.get("wall_basis", "uncounted")) for r in recs]
    cold = [{k: r.get(k) for k in ("key", "elapsed_s", "flops", "bytes_accessed",
                                   "chain_sweep_launches", "peak_bytes")}
            for r in probe.compile_records if r["cache"] == "cold"]
    log(f"[adaptive] (e) perf: {len(recs)} chunks, phase seconds "
        f"{{{', '.join(f'{k}: {v:.3f}' for k, v in split.items())}}}, exact-sum broken in "
        f"{len(broken)}; peak {probe.peak_tflops} TFLOP/s ({probe.peak_source}); roofline "
        f"(bucket, flops, TFLOP/s, share, wall) {points}; cold calls counted {cold}")
    shares = [u for *_, u, _ in points if u is not None]
    if broken:
        raise AssertionError(f"perf chunk records break the exact sum: {broken}")
    if not cold or not all((c["flops"] or 0) > 0 for c in cold):
        raise AssertionError(f"no counted cold call: {cold}")
    if not shares or max(shares) > 1.0:
        raise AssertionError(f"roofline shares {shares}: none, or above the measured peak")
    return dict(phase_s=split, points=points, cold=cold, peak_tflops=probe.peak_tflops,
                peak_source=probe.peak_source)


def _adaptive_cli(hours, highs_npv=None):
    """(b): the yearsweep CLI with warm starts, adaptive batching and the
    remedy ladder, with a checkpoint store. `highs_npv` = (LMP scale, NPV)
    of a HiGHS solve already made (the year phase's scenario 0); it is
    reused when that scenario lies in the warm-started batch."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.obs import metrics
    from dispatches_tpu_torch.runtime.native import ResultStore
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse
    from dispatches_tpu_torch.workflow.runners import main as cli

    saved_key = 'warm_start_iters_saved_total{runner="yearsweep",source="neighbor"}'
    argv = ["--device", "cuda", "yearsweep", "--scenarios", "16", "--batch", "8",
            "--hours", str(hours), "--warm-starts", "--adaptive", "--remedy"]
    with tempfile.TemporaryDirectory() as tmp:
        store, journal, record = f"{tmp}/year.bin", f"{tmp}/year.jsonl", f"{tmp}/captures"
        saved0 = metrics.snapshot()["counters"].get(saved_key, 0.0)
        chain_sweep.launches = 0
        t0 = time.perf_counter()
        cli(["--journal", journal, "--record-failures", record] + argv
            + ["--out", store, "--cost"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = chain_sweep.launches
        saved = metrics.snapshot()["counters"].get(saved_key, 0.0) - saved0
        rows = ResultStore(store).load()
        journal_checks = _journal_checks(journal, record, scenarios=16)
        cost = _cost_checks(journal)
        chain_sweep.launches = 0
        cli(argv + ["--out", store])
        again, n_again = chain_sweep.launches, len(ResultStore(store).keys())
    log(f"[adaptive] (b) yearsweep --warm-starts --adaptive --remedy --journal "
        f"--record-failures --cost: 16 scenarios in "
        f"{wall:.1f} s, {len(rows)} stored, chain_sweep launches {launches}, warm batch "
        f"saved {saved:.1f} iterations against the cold batch's mean; rerun: {again} "
        f"launches, {n_again} records")
    if len(rows) != 16:
        raise AssertionError(f"yearsweep stored {len(rows)} of 16 scenarios (unconverged ones "
                             "are not stored)")
    if again or n_again != 16:
        raise AssertionError(f"the rerun solved again: {again} launches, {n_again} records")
    # pending scenarios run sorted by LMP scale: the 8 largest form the
    # second, warm-started batch
    warm = sorted(rows.values(), key=lambda v: v[0])[8:]
    known = [v for v in warm if highs_npv is not None and v[0] == highs_npv[0]]
    if known:
        (scale, npv, _), ref = known[0], highs_npv[1]
    else:
        scale, npv, _ = warm[-1]
        data = P.load_rts303()
        prog, _ = build_pricetaker(HybridDesign(
            T=hours, with_battery=True, with_pem=True, design_opt=True,
            h2_price_per_kg=2.5, initial_soc_fixed=None,
        ))
        params = {"lmp": scale * np.resize(data["da_lmp"], hours),
                  "wind_cf": np.resize(data["da_wind_cf"], hours)}
        ref = float(prog.eval_expr(
            "NPV", torch.as_tensor(solve_lp_scipy_sparse(prog, params).x), params))
    rel = abs(npv - ref) / abs(ref)
    log(f"[adaptive] (b) warm-started lane s={scale:.6f}: NPV {npv:.8e} HiGHS {ref:.8e} "
        f"rel {rel:.2e}")
    if not rel <= 1e-3:
        raise AssertionError(f"warm-started year NPV rel {rel:.2e} > 1e-3 vs HiGHS")
    return dict(wall_s=wall, launches=launches, iters_saved=saved, rel_vs_highs=rel,
                journal=journal_checks, cost=cost,
                _npv_by_scale={v[0]: v[1] for v in rows.values()})


# (b)'s cost ledger: the entries that must lead it (the normal-equations
# products, the block Cholesky, the kernel), among its first COST_TOP
COST_LEADERS = ("aten.bmm", "aten.linalg_cholesky_ex", "chain_sweep")
COST_TOP = 5


def _cost_checks(journal):
    """(b)'s ``--cost`` record (the first batch's), read back from the
    journal's solve events: executed FLOPs > 0, COST_LEADERS among the
    ledger's first COST_TOP entries, the roofline share of the card's
    measured peak at most 1."""
    from dispatches_tpu_torch.obs.journal import read_journal

    costs = [e["cost"] for e in read_journal(journal) if e["kind"] == "solve" and "cost" in e]
    out = []
    for i, c in enumerate(costs):
        led = c["ledger"]
        top = [r["op"] for r in led["by_op"][:COST_TOP]]
        rl = c.get("roofline") or {}
        out.append(dict(flops=c["flops"], bytes=c["bytes_accessed"],
                        basis=c["flops_basis"], peak_bytes=c.get("peak_bytes"),
                        wall_s=c["wall_s"], chain_sweep_launches=c["chain_sweep_launches"],
                        top=[(r["op"], r["count"], r["flops"], round(r["flops_share"], 4))
                             for r in led["by_op"][:COST_TOP]],
                        achieved_tflops=rl.get("achieved_tflops"),
                        utilization=rl.get("utilization"), peak_tflops=rl.get("peak_tflops"),
                        peak_source=rl.get("peak_source"), wall_basis=rl.get("wall_basis")))
        log(f"[adaptive] (b) --cost batch {i}: {c['flops']:.4e} FLOPs ({c['flops_basis']}), "
            f"{c['bytes_accessed']:.4e} bytes, peak {c.get('peak_bytes', 0) / 2**30:.2f} GiB, "
            f"chain_sweep launches {c['chain_sweep_launches']}, counted wall {c['wall_s']:.2f} "
            f"s; ledger top {out[-1]['top']}; achieved {rl.get('achieved_tflops')} TFLOP/s "
            f"over the {rl.get('wall_basis')} wall, "
            f"{rl.get('utilization')} of the peak {rl.get('peak_tflops')} "
            f"({rl.get('peak_source')})")
        if not c["flops"] > 0:
            raise AssertionError(f"(b) --cost batch {i}: no FLOPs counted")
        missing = [op for op in COST_LEADERS if op not in top]
        if missing:
            raise AssertionError(f"(b) --cost batch {i}: {missing} not among the ledger's "
                                 f"first {COST_TOP} ({top})")
        u = rl.get("utilization")
        if u is None or not 0.0 < u <= 1.0:
            raise AssertionError(f"(b) --cost batch {i}: share of the measured peak {u}")
    if len(out) != 1:
        raise AssertionError(f"(b) --cost: {len(out)} cost records in the journal, want the "
                             "first batch's")
    return out


def _journal_checks(journal, record, scenarios):
    """(b)'s journal and flight recorder, read back: the manifest names the
    card, the spans are year_sweep/batch_*, the solve events carry stats
    and health for every scenario, span ends carry a device-memory
    watermark, no capture when every lane is healthy, and the unchanged
    `tools/trace_summary.py` reads the journal."""
    from dispatches_tpu_torch.obs.journal import read_journal

    ev = read_journal(journal)
    man = ev[0]
    ends = [e for e in ev if e["kind"] == "span_end"]
    solves = [e for e in ev if e["kind"] == "solve"]
    lanes = sum(e["stats"]["batch"] for e in solves if "stats" in e)
    healthy = sum(e["health"]["counts"].get("healthy", 0) for e in solves if "health" in e)
    marks = [e.get("mem_watermark_bytes", 0) for e in ends]
    captures = os.listdir(record) if os.path.isdir(record) else []
    summary = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                              journal],
                             capture_output=True, text=True, timeout=120)
    log(f"[adaptive] (b) journal: {len(ev)} records, manifest device {man.get('device_kind')!r} "
        f"x {man.get('device_count')}, torch {man['versions'].get('torch')} cuda "
        f"{man['versions'].get('cuda')}, precision {man['precision']}; spans "
        f"{[e['span'] for e in ends]}; {len(solves)} solve events over {lanes} lanes "
        f"({healthy} healthy); span-end watermarks {[round(m / 2**30, 2) for m in marks]} GiB; "
        f"{len(captures)} captures; trace_summary exit {summary.returncode}")
    for line in summary.stdout.splitlines()[:12]:
        log(f"[adaptive] (b)   | {line}")
    batches = [e["span"] for e in ends if e["span"] != "year_sweep"]
    if man.get("device_kind") != torch.cuda.get_device_name(0):
        raise AssertionError(f"the journal's manifest does not name the card: {man}")
    if ends[-1]["span"] != "year_sweep" or not batches or not all(
            b.startswith("year_sweep/batch_") for b in batches):
        raise AssertionError(f"journal spans {[e['span'] for e in ends]}")
    if lanes != scenarios or not all("stats" in e and "health" in e for e in solves):
        raise AssertionError(f"journal solve events cover {lanes} of {scenarios} lanes")
    if not all(m > 0 for m in marks):
        raise AssertionError(f"span ends without a device-memory watermark: {marks}")
    if healthy == lanes and captures:
        raise AssertionError(f"captures {captures} though every lane is healthy")
    if summary.returncode != 0:
        raise AssertionError(f"trace_summary exit {summary.returncode}: {summary.stderr[-2000:]}")
    return dict(records=len(ev), spans=[e["span"] for e in ends], solve_events=len(solves),
                lanes=lanes, healthy=healthy, watermarks=marks, captures=len(captures))


def _adaptive_remedy():
    """(c): the remedy ladder on a dense batch on the card."""
    from dispatches_tpu_torch.obs import health
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
    from dispatches_tpu_torch.runtime.remedy import RemedyPolicy

    healthy = ([[1.0, 0.0], [0.0, 1.0]], [1.0, 1.0], [1.0, 1.0], [0.0, 0.0], [10.0, 10.0], 0.0)
    sick = ([[1.0, 1.0], [1.0, 1.0]], [1.0, 1.0], [1.0, 2.0], [0.0, 0.0], [10.0, 10.0], 0.0)
    lp = _dense_lp([healthy, sick, healthy])
    stats = {}
    sol = solve_lp_adaptive(lp, stats=stats, remedy=RemedyPolicy(allow_lane_switch=False),
                            **SICK_KW)
    off = solve_lp_adaptive(lp, **SICK_KW)
    verdicts = [v.verdict for v in health.classify_solution(sol, budget=SICK_KW["max_iter"])]
    before = [v.verdict for v in health.classify_solution(off, budget=SICK_KW["max_iter"])]
    rem = stats.get("remediated", {})
    log(f"[adaptive] (c) remedy on {sol.x.device}: verdicts {before} -> {verdicts}, {rem}")
    if list(rem) != [1] or rem[1]["rung"] != "regularize" or verdicts != ["healthy"] * 3:
        raise AssertionError(f"the remedy ladder did not recover the sick lane: {rem}")
    if not (torch.equal(off.x[0], sol.x[0]) and torch.equal(off.x[2], sol.x[2])):
        raise AssertionError("the remedy ladder changed a healthy lane")
    return dict(before=before, after=verdicts, remediated=rem, give_up=_remedy_give_up())


def _remedy_give_up():
    """(c): an infeasible dense LP between two healthy ones, the ladder
    without its lane switch: the give-up is captured and journaled; the
    capture replays bitwise on the card and with the same status on the
    CPU (`tools/torch_replay_solve.py`)."""
    import importlib

    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
    from dispatches_tpu_torch.obs.recorder import FlightRecorder, set_recorder
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
    from dispatches_tpu_torch.runtime.remedy import RemedyPolicy

    replay = importlib.import_module("tools.torch_replay_solve")
    healthy = ([[1.0, 0.0], [0.0, 1.0]], [1.0, 1.0], [1.0, 1.0], [0.0, 0.0], [10.0, 10.0], 0.0)
    infeasible = ([[1.0, 1.0], [1.0, 1.0]], [1.0, 2.0], [1.0, 2.0], [0.0, 0.0], [10.0, 10.0], 0.0)
    lp = _dense_lp([healthy, infeasible, healthy])
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        tracer, prev = Tracer(f"{tmp}/remedy.jsonl"), set_recorder(FlightRecorder(f"{tmp}/caps"))
        try:
            with use_tracer(tracer):
                solve_lp_adaptive(lp, stats=stats, remedy=RemedyPolicy(allow_lane_switch=False),
                                  **SICK_KW)
        finally:
            set_recorder(prev)
            tracer.close()
        events = [e for e in tracer.events if e["kind"] == "event"]
        caps = sorted(os.listdir(f"{tmp}/caps"))
        cap = f"{tmp}/caps/{caps[0]}" if caps else None
        on_card = replay.replay(cap) if cap else (None, {})  # where it was taken
        on_cpu = replay.replay(cap, device="cpu") if cap else (None, {})
    rem = [e for e in events if e["name"] == "remediation"]
    log(f"[adaptive] (c) an infeasible lane: {stats.get('remediated')}; journal events "
        f"{[e['name'] for e in events]}; captures {caps}; replay on the card rc {on_card[0]} "
        f"bitwise {on_card[1].get('bitwise')}, on the CPU rc {on_cpu[0]} bitwise "
        f"{on_cpu[1].get('bitwise')} status {on_cpu[1].get('status')}")
    if not rem or rem[0]["recovered"] or stats["remediated"][1]["verdict"] != "unrecoverable":
        raise AssertionError(f"no unrecoverable remediation event: {events}")
    if len(caps) != 1 or on_card[0] != replay.RC_OK or on_card[1].get("device") != "cuda":
        raise AssertionError(f"the give-up capture {caps} did not replay bitwise on the card")
    st = on_cpu[1].get("status", {})
    if on_cpu[0] not in (replay.RC_OK, replay.RC_MISMATCH) or st.get("recorded") != st.get("replayed"):
        raise AssertionError(f"the give-up capture replays on the CPU with another status: {st}")
    return dict(remediation=rem[0], captures=caps, replay_card=on_card[0],
                replay_cpu=on_cpu[0], replay_cpu_bitwise=on_cpu[1].get("bitwise"))


LEARN_DEVICE = "cuda"  # adaptive (f) and the learn phase; the CPU rehearses them with "cpu"
# (f): a warm lane's NPV against (b)'s stored one, reached by another path
# (neighbour seeds): the year phase's HiGHS band, as (b) holds its warm lane
YEAR_WARM_NPV_RTOL = 1e-3
LEARNED_EPOCHS = 2000  # (f): full-batch Adam steps on 6 of the 8 lanes (a second on the card)
LEARNED_HIDDEN = (64, 64)


def _adaptive_learned(ctx, npv_by_scale, hours):
    """(f): learned warm starts on the year family. (a)'s 8 solved lanes
    go through `DatasetWriter` (one fingerprint for all: only c varies with
    the LMP scale), a predictor trains on the card, and scenarios 8-15
    (the CLI's second batch of (b)) run through
    `solve_lp_banded_adaptive(warm_predictor=)` at the year options beside
    the same lanes cold: every seed accepted by the banded safeguard (the
    predictor's replayed verdicts, counted) and the iterations not the
    cold ones; then a NaN predictor on two lanes for 8 iterations: both
    seeds rejected, the lanes bitwise the cold run."""
    from dispatches_tpu_torch.learn import (
        DatasetWriter, WarmStartModel, WarmStartPredictor, family_fingerprints, load_dataset,
        train_warmstart_model,
    )
    from dispatches_tpu_torch.runtime.adaptive import _batch_axes, solve_lp_banded_adaptive
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import _BASE_NDIM, BandedLP

    prog, meta, blp, sol, kw = (ctx[k] for k in ("prog", "meta", "blp", "sol", "kw"))
    axes, B = _batch_axes(BandedLP, _BASE_NDIM, blp)
    t0 = time.perf_counter()
    fams = family_fingerprints(blp, axes, B)
    fp_ms = (time.perf_counter() - t0) * 1e3
    varying = [n for n, ax in zip(BandedLP._fields, axes) if ax == 0]
    log(f"[adaptive] (f) {B} year lanes: batched fields {varying}, {len(set(fams))} family "
        f"fingerprint(s), {fp_ms:.1f} ms for the batch")
    if len(set(fams)) != 1:
        raise AssertionError(f"(f) the year lanes span {len(set(fams))} families")
    with tempfile.TemporaryDirectory() as tmp:
        w = DatasetWriter(f"{tmp}/ds")
        kept = w.add_batch(blp, sol, axes, B, iterations=sol.iterations.tolist())
        w.close()
        ds = load_dataset([f"{tmp}/ds"])
        t1 = time.perf_counter()
        model, met = train_warmstart_model(ds, hidden=LEARNED_HIDDEN, epochs=LEARNED_EPOCHS,
                                           holdout_frac=0.25, seed=0, device=LEARN_DEVICE)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        model = WarmStartModel.load(model.save(f"{tmp}/warm.npz"), device=LEARN_DEVICE)
    log(f"[adaptive] (f) {kept} lanes written, {ds.X.shape[1]} features -> {ds.Y.shape[1]} "
        f"targets; trained {LEARNED_HIDDEN} x {LEARNED_EPOCHS} epochs in {train_s:.2f} s: "
        f"train R2 {met['train_R2_mean']:.3f}, holdout rel err "
        f"{met.get('holdout_rel_err', float('nan')):.3e}")
    # scenarios 8-15 of (b)'s sweep: the same data, the next scales
    scales = np.random.default_rng(0).uniform(0.5, 2.0, 16)[8:]
    base = np.resize(ctx["data"]["da_lmp"], hours)
    params = {"lmp": torch.as_tensor(scales[:, None] * base[None, :], dtype=torch.float64,
                                     device=LEARN_DEVICE),
              "wind_cf": torch.as_tensor(np.resize(ctx["data"]["da_wind_cf"], hours),
                                         dtype=torch.float64, device=LEARN_DEVICE)}
    blp2 = meta.instantiate(params, device=LEARN_DEVICE)
    pred = WarmStartPredictor(model, device=LEARN_DEVICE)
    run = dict(chunk_iters=ADAPTIVE_CHUNK, ladder_base=ADAPTIVE_LADDER, **kw)
    from dispatches_tpu_torch.obs import metrics as obs_metrics

    def verdicts(before):
        after = obs_metrics.flat_values()
        return [sum(after.get(k, 0.0) - before.get(k, 0.0) for k in after
                    if k.startswith(name) and 'entry="solve_lp_banded"' in k)
                for name in ("learned_warm_accept_total", "learned_warm_reject_total")]

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cold = solve_lp_banded_adaptive(meta, blp2, **run)
    cold_its = cold.iterations.tolist()
    cold_s = time.perf_counter() - t1
    chain_sweep.launches = 0
    before = obs_metrics.flat_values()
    t1 = time.perf_counter()
    warm = solve_lp_banded_adaptive(meta, blp2, warm_predictor=pred, **run)
    conv = warm.converged.tolist()
    wall = time.perf_counter() - t1
    launches = chain_sweep.launches
    acc, rej = verdicts(before)
    seeds_fp_ms = pred.last_fingerprint_s * 1e3
    npvs = prog.eval_expr("NPV", warm.x, params).cpu().numpy()
    cold_npv = prog.eval_expr("NPV", cold.x, params).cpu().numpy()
    ref = np.array([npv_by_scale[s] for s in scales])
    rel = np.abs(npvs - ref) / np.abs(ref)
    # two solve paths of one LP: bench.py's obj_agree band (OBJ_AGREE)
    off = np.abs(npvs - cold_npv) / (1.0 + np.abs(cold_npv))
    its = warm.iterations.tolist()
    log(f"[adaptive] (f) scenarios 8-15 (scales {np.round(scales, 4).tolist()}) through "
        f"solve_lp_banded_adaptive(warm_predictor=): wall {wall:.2f} s against the same "
        f"lanes cold {cold_s:.2f} s, iterations {its} against cold {cold_its} (sum "
        f"{sum(its)} against {sum(cold_its)}); seeds the banded safeguard accepts {acc:g}, "
        f"rejects {rej:g}; "
        f"the predictor's fingerprint {seeds_fp_ms:.1f} ms; chain_sweep launches {launches}; "
        f"NPV rel vs (b)'s stored NPVs {np.array2string(rel, precision=2)}, vs the same "
        f"lanes cold {np.array2string(off, precision=2)}")
    B2 = len(scales)
    if not (acc == B2 and rej == 0):
        raise AssertionError(f"(f) {acc:g} of {B2} learned seeds accepted, {rej:g} rejected")
    if its == cold_its:
        raise AssertionError(f"(f) the warm-started lanes took the cold iterations {its}")
    if not all(conv):
        raise AssertionError(f"(f) warm-started year lanes not converged: {conv}")
    if not np.all(off <= OBJ_AGREE):
        raise AssertionError(f"(f) warm NPVs vs the cold lanes' rel {off} > {OBJ_AGREE}")
    if not np.all(rel <= YEAR_WARM_NPV_RTOL):
        raise AssertionError(f"(f) NPVs vs (b)'s rel {rel} > {YEAR_WARM_NPV_RTOL}")
    if launches <= 0:
        raise AssertionError("(f) the warm-started year batch launched no chain_sweep kernel")
    # a NaN predictor: every seed rejected, the lanes bitwise the cold run's
    nan = WarmStartModel(model.surrogate, model.manifest)
    nan.predict_parts = lambda X: {p: np.full((X.shape[0], d), np.nan) for p, d in model.targets}
    two = BandedLP(*(a[:2] if ax == 0 else a for a, ax in zip(blp2, axes)))
    short = dict(run, max_iter=ADAPTIVE_CHUNK)
    cold2 = solve_lp_banded_adaptive(meta, two, **short)
    before = obs_metrics.flat_values()
    nan2 = solve_lp_banded_adaptive(meta, two, warm_predictor=WarmStartPredictor(nan), **short)
    nan_acc, nan_rej = verdicts(before)
    same = _all_same(cold2, nan2)
    log(f"[adaptive] (f) NaN predictor, 2 lanes x {ADAPTIVE_CHUNK} iterations: seeds accepted "
        f"{nan_acc:g}, rejected {nan_rej:g}; "
        f"{'bitwise the cold run' if same else 'DIFFERS from the cold run'}")
    if not (same and nan_acc == 0 and nan_rej == 2):
        raise AssertionError("(f) a rejected learned seed moved the banded lanes")
    return dict(wall_s=wall, cold_wall_s=cold_s, iterations=its, cold_iterations=cold_its,
                launches=launches, accepted=acc, rejected=rej, fingerprint_ms=fp_ms,
                predictor_fingerprint_ms=seeds_fp_ms, train_s=train_s,
                rel_max=float(rel.max()), train_R2=met["train_R2_mean"])


def phase_adaptive(year_records=None, highs_npv=None, n=8, hours=8760):
    """The `adaptive` phase (see the module docstring), on the card.
    `year_records` and `highs_npv` are the year phase's records and its
    HiGHS (LMP scale, NPV); the phase computes what it needs when absent."""
    from dispatches_tpu_torch.workflow.runners import run_year_sweep

    if year_records is None:
        log("[adaptive] the year phase did not run: solving its batch here")
        year_records = run_year_sweep(scenarios=n, batch=n, hours=hours, device="cuda")
    a = _adaptive_year(year_records, hours)
    b = _adaptive_cli(hours, highs_npv)
    c = _adaptive_remedy()
    t0 = time.perf_counter()
    f = _adaptive_learned(a.pop("_ctx"), b.pop("_npv_by_scale"), hours)
    log(f"[adaptive] (f) in {time.perf_counter() - t0:.1f} s")
    return dict(year=a, cli=b, remedy=c, learned=f)


PDLP_KW = dict(adaptive_restarts=True, primal_weight=True, linesearch=True)
PDHG_TOL = 1e-6
# (b): 100,000 before the cases phase, 40,000 before the learn legs, 20,000
# before the horizon phase; week 0, the lane (b) gates, converges at 17,000
PDHG_MAX_ITER = 18_000
PDHG_CHUNK = 2000
# (c): a fixed budget, not a convergence run (20,000 before the cases phase,
# 5,000 before the horizon phase); two runs of PDHG_REPEAT_ITERS, bitwise
# equal (1,000 before the horizon phase)
PDHG_YEAR_ITERS = 2_000
PDHG_REPEAT_ITERS = 400
# (b): one-shot vs chunks of PDHG_RESUME_CHUNK, 8 weeks (6,000 in chunks of 2,000
# before the cases phase, 4,000 before the horizon phase)
PDHG_RESUME_ITERS, PDHG_RESUME_CHUNK = 800, 400
PDHG_CPU_WEEKS = 2  # (b): the card against the CPU on these weeks (4 before the horizon phase)
OBJ_AGREE = 1e-4  # bench.py's obj_agree band: |obj - obj_ipm| <= 1e-4 (1 + |obj_ipm|)
CERT_RTOL = 1e-9  # solver residuals vs the certificates


def _same(a, b):
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _all_same(x, y):
    """Bitwise equality of two NamedTuples of tensors (nested ones too)."""
    return all(_all_same(a, b) if isinstance(a, tuple) else _same(a, b) for a, b in zip(x, y))


def _ulps(a, b):
    """Largest distance between two tensors in units of the last place."""
    a, b = a.double().cpu(), b.double().cpu()
    if torch.equal(a, b):  # equal values (no NaN): 0 ulps, without the divisions
        return 0.0
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~ok], b[~ok]):
        return float("inf")
    spacing = torch.nextafter(a.abs(), torch.tensor(float("inf"), dtype=torch.float64)) - a.abs()
    d = ((a - b).abs() / spacing)[ok]
    return float(d.max()) if d.numel() else 0.0


def _product_bound_ms(nnz, B, n_in, n_out):
    """Least time of one COO product over a lane batch sharing one pattern:
    its values (f64) and row and column indices (int32) read once, the B
    input vectors read once and the B outputs written once, at HBM rate."""
    return (nnz * (8 + 4 + 4) + 8 * B * (n_in + n_out)) / HBM_BYTES_PER_S * 1e3


def _pdhg_profile(tag, lp, st, iters):
    """Device time of `iters` more PDLP iterations resumed from `st` (two
    windows, `iters` apart, so the per-iteration launch count excludes the
    segment's set-up), and the sparse products against their bound."""
    from torch.profiler import ProfilerActivity, profile

    from dispatches_tpu_torch.solvers.pdhg import _Op, _Pattern, solve_lp_pdhg

    def window(n, parse=True):
        # CUDA activity only (as `_launches_of`): the CPU-op recorder slows
        # the host's launches and its trace takes ~10 s to read a window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_lp_pdhg(lp, tol=0.0, max_iter=PDHG_MAX_ITER, state=st,
                          it_stop=int(st.it.max()) + n, return_state=True, **PDLP_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not parse:  # a warm-up window's trace is not read
            return None
        dev_us, launches, by_op = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            dev_us += us
            launches += e.count
            by_op[e.key[:70]] = by_op.get(e.key[:70], 0.0) + us
        return wall, dev_us, launches, by_op

    window(iters, parse=False)  # warm
    _, _, n1, _ = window(iters)
    w2, d2, n2, by_op = window(2 * iters)
    per_it = (n2 - n1) / iters
    busy = d2 / 1e6 / w2 if w2 else float("nan")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    log(f"[pdhg] ({tag}) profiled window of {2 * iters} iterations: wall {w2:.3f} s "
        f"({w2 / (2 * iters) * 1e3:.3f} ms per iteration), device busy {busy:.3f}, "
        f"{n2} launches, {per_it:.1f} per iteration (difference of the {iters}- and "
        f"{2 * iters}-iteration windows)")
    for name, us in top:
        log(f"[pdhg] ({tag})   {us / 1e3:9.2f} ms  {name}")
    if d2 == 0:
        log(f"[pdhg] ({tag}) the profiler saw no device time: busy share not measured")
    # the two products alone, on the solver's tables for these values
    B, M, N = lp.b.shape[0], lp.b.shape[-1], lp.c.shape[-1]
    vals = lp.vals if lp.vals.dim() == 2 else lp.vals.unsqueeze(0)
    op = _Op(_Pattern(lp.rows, lp.cols, M, N, lp.b.device), vals)
    x = torch.rand(B, N, dtype=lp.b.dtype, device=lp.b.device)
    y = torch.rand(B, M, dtype=lp.b.dtype, device=lp.b.device)
    nnz = lp.rows.shape[0]
    prod = {}
    for name, fn, n_in, n_out in (("A x", lambda: op.mv(x), N, M),
                                  ("A^T y", lambda: op.rmv(y), M, N)):
        ms = _time_ms(fn, 50)
        bms = _product_bound_ms(nnz, B, n_in, n_out)
        prod[name] = dict(ms=ms, bound_ms=bms, share_of_bound=bms / ms)
        log(f"[pdhg] ({tag}) {name}: {ms:.4f} ms, HBM bound {bms:.4f} ms "
            f"({bms / ms:.3f} of it; {nnz} entries, {B} lanes)")
    return dict(window_iters=2 * iters, wall_s=w2, device_busy=busy, launches=n2,
                launches_per_iteration=per_it, top_ops=top, products=prod)


_FAILS = []


def _fail(msg):
    """A failed gate of the pdhg phase: logged now, raised at the phase's end
    (after every measurement of the phase has been printed)."""
    log(f"[pdhg] GATE FAILED: {msg}")
    _FAILS.append(msg)


def _pdhg_card_vs_cpu(slp, weeks, iters=400):
    """The card's PDHG against the port's own on the CPU, `weeks` weeks, two
    check periods: controls off within 1e-9 (no near-tie decides a branch
    there), controls on printed (the line search's accept tests part the
    two)."""
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    sub = slp._replace(b=slp.b[:weeks], c=slp.c[:weeks], c0=slp.c0[:weeks])
    cpu = type(sub)(*(a.cpu() for a in sub))
    rel = {}
    for name, kw in (("off", {}), ("on", PDLP_KW)):
        a = solve_lp_pdhg(sub, tol=0.0, max_iter=iters, **kw)
        b = solve_lp_pdhg(cpu, tol=0.0, max_iter=iters, **kw)
        rel[name] = max(float((a.x.cpu() - b.x).abs().max() / b.x.abs().max()),
                        float((a.y.cpu() - b.y).abs().max() / b.y.abs().max()))
    log(f"[pdhg] (b) card vs the port on the CPU, {weeks} weeks x {iters} iterations: "
        f"max rel difference of x, y with the controls off {rel['off']:.2e}, on {rel['on']:.2e}")
    if not rel["off"] <= 1e-9:
        _fail(f"the card's PDHG differs from the CPU's by {rel['off']:.3e} (controls off)")
    return rel


def _plain_scatter_add(a, idx, vals):
    """The scatter-add as it was before its sum order was fixed: one
    ``index_put_(accumulate=True)`` on `a`'s device, repeated indices in
    the device's own order. (s) measures it against the CPU."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=a.device)
    if idx.numel() == 0:
        return a
    lead, n = a.shape[:-1], a.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    vals = torch.broadcast_to(vals, (*lead, idx.numel())).reshape(-1)
    flat = (torch.arange(nb, device=a.device)[:, None] * n + idx[None, :]).reshape(-1)
    a.reshape(-1).index_put_((flat,), vals, accumulate=True)
    return a


@contextlib.contextmanager
def _scatter_add_as(fn):
    from dispatches_tpu_torch.core import program
    from dispatches_tpu_torch.solvers import structured

    saved = program._scatter_add
    program._scatter_add = structured._scatter_add = fn
    try:
        yield
    finally:
        program._scatter_add = structured._scatter_add = saved


def _scatter_order(hours=8760, device="cuda"):
    """(s): the scatter-add sites on the card against the CPU, with the
    device's own sum order (before) and with the port's fixed one (after):
    the dense `instantiate` (52 weekly design LPs, T = 168: a dense year A
    would take 86 GB a lane), the banded `instantiate` and
    ``eval_expr("NPV")`` at the year shape over the 8 seed-0 LMP scales
    (x drawn from seed 0). Gate: the fixed order is bitwise the CPU's.
    It also times each site's call, and the part of it inside the
    scatter-adds, in both orders: the fixed order folds repeated indices on
    the host, a device-to-host copy and back in each such scatter-add."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.core.program import lp_fingerprint
    from dispatches_tpu_torch.solvers.structured import extract_time_structure

    data = P.load_rts303()

    def program(T):
        return build_pricetaker(HybridDesign(
            T=T, with_battery=True, with_pem=True, design_opt=True,
            h2_price_per_kg=2.5, initial_soc_fixed=None))[0]

    weekly, year = program(168), program(hours)
    meta = extract_time_structure(year, hours, block_hours=24)
    rng = np.random.default_rng(0)
    scales = rng.uniform(0.5, 2.0, 8)
    p_week = {"lmp": data["da_lmp"].reshape(52, 168), "wind_cf": data["da_wind_cf"].reshape(52, 168)}
    p_year = {"lmp": scales[:, None] * np.resize(data["da_lmp"], hours)[None],
              "wind_cf": np.resize(data["da_wind_cf"], hours)}
    x = torch.as_tensor(rng.normal(size=(8, year.N)))

    def calls(device):
        pw = {k: torch.as_tensor(v, device=device) for k, v in p_week.items()}
        py = {k: torch.as_tensor(v, device=device) for k, v in p_year.items()}
        xd = x.to(device)
        return {"instantiate": lambda: weekly.instantiate(pw, device=device),
                "banded instantiate": lambda: meta.instantiate(py, device=device),
                "eval_expr NPV": lambda: year.eval_expr("NPV", xd, py)}

    def sites(device):
        out = {k: f() for k, f in calls(device).items()}
        return {k: (type(v)(*(f.cpu() for f in v)) if isinstance(v, tuple) else v.cpu())
                for k, v in out.items()}

    def host_ms(fn, repeats=3):
        """Per site: the calls' wall and the part of it inside the scatter-
        add `fn` (each call fenced by synchronizes), least of `repeats`."""
        row = {}
        for name, call in calls(device).items():
            best = None
            for _ in range(repeats):
                inside = []

                def timed(a, idx, vals):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = fn(a, idx, vals)
                    torch.cuda.synchronize()
                    inside.append(time.perf_counter() - t)
                    return out

                torch.cuda.synchronize()
                t = time.perf_counter()
                with _scatter_add_as(timed):
                    call()
                torch.cuda.synchronize()
                got = (1e3 * (time.perf_counter() - t), 1e3 * sum(inside), len(inside))
                best = got if best is None or got[0] < best[0] else best
            row[name] = dict(wall_ms=best[0], scatter_ms=best[1], scatter_calls=best[2])
        return row

    ref_fp = {}  # the CPU's fingerprints, hashed once for both comparisons

    def compare(got, ref):
        row = {}
        for name in ref:
            g, r = got[name], ref[name]
            if isinstance(r, tuple):
                ulps = {f: _ulps(a, b) for f, a, b in zip(r._fields, g, r)}
                if name not in ref_fp:
                    ref_fp[name] = lp_fingerprint(r)
                row[name] = dict(ulps=max(ulps.values()),
                                 fields={f: u for f, u in ulps.items() if u},
                                 fingerprint_equal=lp_fingerprint(g) == ref_fp[name])
            else:
                u = _ulps(g, r)
                row[name] = dict(ulps=u, fingerprint_equal=u == 0)
        return row

    t0 = time.perf_counter()
    cpu = sites("cpu")
    with _scatter_add_as(_plain_scatter_add):
        before = compare(sites(device), cpu)
    after = compare(sites(device), cpu)
    for tag, row in (("device order (before)", before), ("fixed order (after)", after)):
        log(f"[pdhg] (s) scatter-add sites on the card vs the CPU, {tag}: "
            + "; ".join(f"{k} {v['ulps']:g} ulps"
                        + (f" {v['fields']}" if v.get("fields") else "")
                        + f", fingerprint {'equal' if v['fingerprint_equal'] else 'differs'}"
                        for k, v in row.items()))
    from dispatches_tpu_torch.core.program import _scatter_add

    cost = {"device order": host_ms(_plain_scatter_add), "fixed order": host_ms(_scatter_add)}
    for tag, row in cost.items():
        log(f"[pdhg] (s) scatter-add cost on the card, {tag}: "
            + "; ".join(f"{k}: call {v['wall_ms']:.2f} ms, {v['scatter_calls']} scatter-adds "
                        f"{v['scatter_ms']:.2f} ms" for k, v in row.items()))
    log(f"[pdhg] (s) {time.perf_counter() - t0:.1f} s")
    bad = [k for k, v in after.items() if v["ulps"] or not v["fingerprint_equal"]]
    if bad:
        _fail(f"scatter-add sites {bad} on the card differ from the CPU: {after}")
    return dict(before=before, after=after, cost=cost)


def _pdhg_instantiate(prog, params):
    """(a): instantiate_coo on the card, twice, against the CPU's."""
    from dispatches_tpu_torch.core.program import lp_fingerprint

    g1 = prog.instantiate_coo(params, device="cuda")
    g2 = prog.instantiate_coo(params, device="cuda")
    cpu = prog.instantiate_coo({k: v.cpu() for k, v in params.items()}, device="cpu")
    f1, f2, fc = lp_fingerprint(g1), lp_fingerprint(g2), lp_fingerprint(cpu)
    ulps = {n: _ulps(a, b) for n, a, b in zip(cpu._fields, g1, cpu)}
    log(f"[pdhg] (a) instantiate_coo on the card: fingerprints {f1[:16]} / {f2[:16]}, "
        f"CPU {fc[:16]} ({'equal' if f1 == fc else 'differ'}); ulps vs the CPU {ulps}")
    if f1 != f2:
        raise AssertionError("instantiate_coo on the card is not repeatable")
    if max(ulps.values()) > 1:
        raise AssertionError(f"instantiate_coo on the card vs the CPU: {ulps} ulps")
    return g1, dict(fingerprint_equal_cpu=f1 == fc, ulps=ulps)


def _pdhg_weekly():
    """(a) and (b): the 52 weeks of rts303 through the adaptive PDLP lane,
    against the dense IPM batch and HiGHS."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.obs.conformance import ConformancePolicy
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_pdhg_adaptive
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    T = 168
    prog, _ = build_pricetaker(HybridDesign(
        T=T, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    data = P.load_rts303()
    lmp, cf = data["da_lmp"].reshape(52, T), data["da_wind_cf"].reshape(52, T)
    params = {"lmp": torch.as_tensor(lmp, device="cuda"),
              "wind_cf": torch.as_tensor(cf, device="cuda")}
    slp, inst = _pdhg_instantiate(prog, params)

    lp = prog.instantiate(params, device="cuda")
    solve_lp_batch(lp, tol=1e-8, max_iter=60)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ipm = solve_lp_batch(lp, tol=1e-8, max_iter=60)
    torch.cuda.synchronize()
    ipm_s = time.perf_counter() - t0
    if not bool(ipm.converged.all()):
        raise AssertionError(f"weekly IPM lanes not converged: {ipm.converged.tolist()}")

    stats = {}
    t0 = time.perf_counter()
    sol = solve_lp_pdhg_adaptive(slp, tol=PDHG_TOL, max_iter=PDHG_MAX_ITER,
                                 chunk_iters=PDHG_CHUNK, conformance=True, stats=stats,
                                 **PDLP_KW)
    torch.cuda.synchronize()
    pdhg_s = time.perf_counter() - t0
    conv = sol.converged.cpu().numpy()
    iters = sol.iterations.tolist()
    obj, obj_ipm = sol.obj.cpu().numpy(), ipm.obj.cpu().numpy()
    diff = np.abs(obj - obj_ipm)
    band = OBJ_AGREE * (1.0 + np.abs(obj_ipm))
    lanes = stats["conformance"]["lanes"]
    certs = {f: np.array([ln[f] for ln in lanes]) for f in ("res_primal", "res_dual")}
    own = {"res_primal": sol.res_primal.cpu().numpy(), "res_dual": sol.res_dual.cpu().numpy()}
    cert_rel = max(float(np.max(np.abs(own[f] - certs[f]) / np.maximum(np.abs(certs[f]), 1e-300)))
                   for f in certs)
    slow = int(np.argmax(iters))
    log(f"[pdhg] (b) 52 weekly LPs (T={T}, {slp.rows.shape[0]} entries) through "
        f"solve_lp_pdhg_adaptive (tol {PDHG_TOL}, PDLP controls, chunks of {PDHG_CHUNK}, "
        f"conformance): {int(conv.sum())} of 52 converged in {pdhg_s:.2f} s against the "
        f"dense IPM batch's {ipm_s:.2f} s (tol 1e-8, iterations {ipm.iterations.max().item()})")
    log(f"[pdhg] (b) iterations per lane {iters}; week 0 {iters[0]} (JAX package on a CPU: "
        f"~19,400, docs/performance.md); lane-iterations {stats['lane_iterations']} "
        f"({stats['padded_lane_iterations']} on padding rows), buckets {stats['buckets']}, "
        f"restarts {sol.restarts.tolist()}")
    log(f"[pdhg] (b) |obj - obj_ipm| / (1 + |obj_ipm|) max over converged lanes "
        f"{float(np.max((diff / (1 + np.abs(obj_ipm)))[conv], initial=0.0)):.3e}; "
        f"certificates worst {stats['conformance']['worst']}; solver residuals vs "
        f"certificates rel {cert_rel:.2e}")
    highs = {}
    for w in sorted({0, slow}):
        res = solve_lp_scipy_sparse(prog, {"lmp": lmp[w], "wind_cf": cf[w]})
        highs[w] = res.obj_with_offset
        log(f"[pdhg] (b) week {w}: PDHG obj {obj[w]:.10e} ({iters[w]} iterations, "
            f"converged {bool(conv[w])}), IPM {obj_ipm[w]:.10e}, HiGHS {res.obj_with_offset:.10e}")
    for w in np.nonzero(conv)[0]:
        if not lanes[w]["ok"]:
            log(f"[pdhg] (b)   week {w} ({iters[w]} iterations) fails the default policy: "
                + ", ".join(f"{f} {lanes[w][f]:.2e}" for f in ("res_primal", "res_dual",
                                                               "comp", "gap")))
    if not conv[0]:
        _fail("weekly PDHG: week 0 did not converge")
    bad = [w for w in range(52) if conv[w] and not diff[w] <= band[w]]
    if bad:
        _fail(f"weekly PDHG lanes {bad} outside the obj_agree band of the IPM")
    # PDHG stops on its scaled-frame KKT residuals alone, so the
    # complementarity and gap certificates of a converged lane can exceed
    # the policy (the JAX package's own weeks 0 and 5 do on a CPU): the
    # residual certificates are gated, comp and gap counted and printed
    pol = ConformancePolicy()
    fails = [w for w in range(52) if conv[w] and not all(
        lanes[w][f] <= pol.bound(f) for f in ("res_primal", "res_dual"))]
    if fails:
        _fail(f"weekly PDHG lanes {fails}: residual certificates outside the default policy")
    full = sum(bool(lanes[w]["ok"]) for w in range(52) if conv[w])
    log(f"[pdhg] (b) converged lanes within the whole default policy: {full} of "
        f"{int(conv.sum())}; residual certificates within it: {int(conv.sum()) - len(fails)}")
    if not cert_rel <= CERT_RTOL:
        _fail(f"solver residuals vs certificates rel {cert_rel:.3e}")
    _pdhg_card_vs_cpu(slp, weeks=PDHG_CPU_WEEKS)

    # chunked resume against the one-shot solve, first 8 weeks
    sub = slp._replace(b=slp.b[:8], c=slp.c[:8], c0=slp.c0[:8])
    kw = dict(tol=PDHG_TOL, max_iter=PDHG_RESUME_ITERS, **PDLP_KW)
    t0 = time.perf_counter()
    one, st_one = solve_lp_pdhg(sub, return_state=True, **kw)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    st = None
    for stop in range(PDHG_RESUME_CHUNK, PDHG_RESUME_ITERS + 1, PDHG_RESUME_CHUNK):
        seg, st = solve_lp_pdhg(sub, state=st, it_stop=stop, return_state=True, **kw)
    same = _all_same(one, seg) and _all_same(st_one, st)
    log(f"[pdhg] (b) 8 weeks, {PDHG_RESUME_ITERS} iterations one-shot ({one_s:.2f} s) and in "
        f"chunks of {PDHG_RESUME_CHUNK}: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        _fail("chunked PDHG resume differs from the one-shot solve on the card")
    st = solve_lp_pdhg(slp, tol=0.0, max_iter=400, return_state=True, **PDLP_KW)[1]
    prof = _pdhg_profile("weekly, 52 lanes", slp, st, 200)
    return dict(converged=int(conv.sum()), iterations=iters, wall_s=pdhg_s, ipm_wall_s=ipm_s,
                lane_iterations=stats["lane_iterations"], buckets=stats["buckets"],
                restarts=sol.restarts.tolist(), cert_rel=cert_rel, highs=highs,
                instantiate=inst, profile=prof,
                obj_rel_max=float(np.max((diff / (1 + np.abs(obj_ipm)))[conv], initial=0.0)))


def _pdhg_year(year_records, hours=8760):
    """(c): the year LPs through solve_lp_pdhg at a fixed budget."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.obs.conformance import kkt_certificates
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    data = P.load_rts303()
    if year_records is not None:
        scales = np.array([r["lmp_scale"] for r in year_records])
    else:
        scales = np.random.default_rng(0).uniform(0.5, 2.0, 8)
    base_lmp = np.resize(data["da_lmp"], hours)
    params = {"lmp": torch.as_tensor(scales[:, None] * base_lmp[None], device="cuda"),
              "wind_cf": torch.as_tensor(np.resize(data["da_wind_cf"], hours), device="cuda")}
    slp = prog.instantiate_coo(params, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol, tr = solve_lp_pdhg(slp, tol=PDHG_TOL, max_iter=PDHG_YEAR_ITERS, trace=True, **PDLP_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    its = sol.iterations.tolist()
    ms_it = wall / max(its) * 1e3
    cert = kkt_certificates(slp, sol, axes=(None, None, None, 0, 0, None, None, 0))
    own = np.stack([sol.res_primal.cpu().numpy(), sol.res_dual.cpu().numpy()], 1)
    cert_rel = float(np.max(np.abs(own - cert[:, :2]) / np.maximum(np.abs(cert[:, :2]), 1e-300)))
    finite = all(bool(torch.isfinite(a).all()) for a in (sol.x, sol.y, sol.obj))
    npv = prog.eval_expr("NPV", sol.x, params).cpu().numpy()
    log(f"[pdhg] (c) year LPs, {len(scales)} lanes x {hours} h ({slp.rows.shape[0]} entries, "
        f"M {slp.b.shape[-1]}, N {slp.c.shape[-1]}): {PDHG_YEAR_ITERS} iterations budget, "
        f"iterations {its}, converged {sol.converged.tolist()}, wall {wall:.2f} s "
        f"({ms_it:.3f} ms per iteration of the batch), peak memory {peak / 2**30:.2f} GiB, "
        f"restarts {sol.restarts.tolist()}; residuals vs certificates rel {cert_rel:.2e}")
    rp, rd = tr.res_primal.cpu().numpy(), tr.res_dual.cpu().numpy()
    step = max(1, rp.shape[1] // 10)
    for k in range(0, rp.shape[1], step):
        log(f"[pdhg] (c)   check {k:3d} (iteration {(k + 1) * 200:6d}): res_primal "
            + " ".join(f"{v:.2e}" for v in rp[:, k]) + " | res_dual "
            + " ".join(f"{v:.2e}" for v in rd[:, k]))
    rel = None
    if year_records is not None:
        ref = np.array([r["NPV"] for r in year_records])
        rel = np.abs(npv - ref) / np.abs(ref)
        log(f"[pdhg] (c) NPV after the budget vs the banded IPM's (year phase): rel "
            + " ".join(f"{v:.2e}" for v in rel))
    else:
        log("[pdhg] (c) the year phase did not run: no banded IPM NPVs to compare with")
    if not finite:
        _fail("year PDHG: non-finite results")
    if not cert_rel <= CERT_RTOL:
        _fail(f"year PDHG residuals vs certificates rel {cert_rel:.3e}")
    a = solve_lp_pdhg(slp, tol=PDHG_TOL, max_iter=PDHG_REPEAT_ITERS, **PDLP_KW)
    b = solve_lp_pdhg(slp, tol=PDHG_TOL, max_iter=PDHG_REPEAT_ITERS, **PDLP_KW)
    same = _all_same(a, b)
    log(f"[pdhg] (c) two {PDHG_REPEAT_ITERS}-iteration runs: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        _fail("two year PDHG runs differ on the card")
    st = solve_lp_pdhg(slp, tol=0.0, max_iter=400, return_state=True, **PDLP_KW)[1]
    prof = _pdhg_profile("year, 8 lanes", slp, st, 200)
    return dict(iterations=its, wall_s=wall, ms_per_iteration=ms_it, peak_bytes=peak,
                cert_rel=cert_rel, npv_rel=None if rel is None else rel.tolist(),
                res_primal_last=rp[:, -1].tolist(), res_dual_last=rd[:, -1].tolist(),
                restarts=sol.restarts.tolist(), profile=prof)


# (d): random 12 x 24 LPs (dense, 35% nonzero, a feasible x0 inside the
# box [0, 4]); the ladder caps the IPM at the second-slowest lane's count
REMEDY_SEEDS = (12, 19, 15)


def _random_lp(seed, m=12, n=24, density=0.35):
    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n)) * (r.random((m, n)) < density)
    A[np.arange(m), r.integers(0, n, m)] += 1.0  # no empty rows
    x0 = r.uniform(0.5, 2.5, n)
    return (A, A @ x0, r.normal(size=n), np.zeros(n), np.full(n, 4.0), 0.0)


def _pdhg_remedy(device="cuda"):
    """(d): the lane switch both ways on the card."""
    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.obs import health
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
    from dispatches_tpu_torch.runtime.remedy import RemedyEngine, dense_to_sparse
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

    lp = _dense_lp([_random_lp(seed) for seed in REMEDY_SEEDS], device)
    its = solve_lp_batch(lp, tol=1e-8, max_iter=60).iterations.tolist()
    sick = int(np.argmax(its))
    cap = sorted(its)[-2]
    if its[sick] <= cap:
        raise AssertionError(f"remedy batch: no lane needs more IPM iterations {its}")
    kw = dict(tol=1e-8, max_iter=cap)
    stats = {}
    sol = solve_lp_adaptive(lp, stats=stats, remedy=True, **kw)
    off = solve_lp_adaptive(lp, **kw)
    rem = stats.get("remediated", {})
    verdicts = [v.verdict for v in health.classify_solution(sol, budget=cap)]
    log(f"[pdhg] (d) dense batch, IPM iterations {its}, max_iter {cap}: remedy "
        f"{rem}, verdicts {verdicts}")
    if (list(rem) != [sick] or rem[sick]["rung"] != "lane_switch"
            or not bool(sol.converged.all()) or set(verdicts) - {"healthy", "slow"}):
        raise AssertionError(f"the dense ladder did not recover lane {sick} at lane_switch: {rem}")
    if not all(_same(a[i], b[i]) for a, b in zip(off, sol) for i in range(3) if i != sick):
        raise AssertionError("the remedy ladder changed a healthy lane")
    row = LPData(*(a[sick] for a in lp))
    slp = dense_to_sparse(row)
    eng = RemedyEngine(solver_kw=dict(tol=1e-6, max_iter=200), entry="solve_lp_pdhg")
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    stuck = solve_lp_pdhg(slp, tol=1e-6, max_iter=200)
    v = health.classify_solution(stuck, budget=200)[0]
    out = eng.remediate(slp, v)
    log(f"[pdhg] (d) SparseLP engine: verdict {v.verdict} -> {out.verdict.verdict} at "
        f"{out.rung}, history {out.history}")
    if out.rung != "lane_switch" or not bool(out.solution.converged):
        raise AssertionError(f"the PDHG ladder did not switch to the IPM: {out.history}")
    return dict(its=its, max_iter=cap, remediated=rem, sparse_history=out.history)


def phase_pdhg(year_records=None):
    """The `pdhg` phase (see the module docstring), on the card."""
    t0 = time.perf_counter()
    parts = {}
    for key, fn in (("scatter_order", _scatter_order), ("weekly", _pdhg_weekly),
                    ("year", lambda: _pdhg_year(year_records)), ("remedy", _pdhg_remedy)):
        t1 = time.perf_counter()
        parts[key] = fn()
        log(f"[pdhg] {key} in {time.perf_counter() - t1:.1f} s")
    order, weekly, year, rem = parts.values()
    log(f"[pdhg] phase {time.perf_counter() - t0:.1f} s")
    if _FAILS:
        raise AssertionError(f"pdhg phase: {len(_FAILS)} gates failed: {_FAILS}")
    return dict(scatter_order=order, weekly=weekly, year=year, remedy=rem)


# ---------------------------------------------------------------------------
# serve: the serving tier on the card

SERVE_BUCKET, SERVE_CHUNK = 8, 8
SERVE_KW = dict(tol=1e-8, max_iter=60)  # the weekly dense IPM batch's options (pdhg (b))
# (b): requests (104 before the cases phase, 52 before the learn legs, 26
# before the horizon phase; cut to pay for them), repeats, x (a)'s rate
SERVE_REQUESTS, SERVE_DUP, SERVE_LOAD = 13, 0.25, 0.5
SERVE_PROFILE_CHUNKS = 2  # (e): 3 before the horizon phase
SERVE_DEVICE = "cuda"
# (a): the capacity observatory's knobs on the burst's service
SERVE_CAPACITY = dict(window=60.0, twin_every=5.0, p95_target=5.0)
# (a2): the ramp over the weeks, offered rates as fractions of (a)'s LPs/s
# (low, high, steps), requests a step, and the bound on Little's-law
# residual: the JAX package's for a ramped live service
# (tools/capacity_plan.py LITTLES_BOUND; PERF.md §6 says why not its
# synthetic fixture's 0.1)
SERVE_RAMP = (0.4, 1.6, 3)
SERVE_RAMP_REQUESTS = 12
# (d): the fleet's two passes, this many weeks each (26 before the horizon
# phase): the last weeks, then the first with shard 0 killed halfway
SERVE_FLEET_WEEKS = 13
SERVE_LITTLES_BOUND = 0.5
_SERVE_FAILS = []


def _serve_fail(msg):
    """A failed gate of the serve phase: logged now, raised at its end."""
    log(f"[serve] GATE FAILED: {msg}")
    _SERVE_FAILS.append(msg)


def _np_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _row_diff(row, ref):
    """Names of the solution fields where `row` is not bitwise `ref`."""
    return [n for n, a, b in zip(ref._fields, row, ref) if not _np_same(a, b)]


def _serve_rows(hours=168, scales=None):
    """The 52 weekly design LPs of rts303 (T = 168, f64), built by the dense
    `instantiate` on the card from the weekly parameters of pdhg (s), as
    host rows: a request arrives from outside the card. With `scales`, week
    0 at those multiples of its LMPs instead, a row each."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.core.program import LPData

    prog = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None))[0]
    data = P.load_rts303()
    p_week = {k: data[k][:52 * hours].reshape(52, hours) for k in ("da_lmp", "da_wind_cf")}
    p_week = {"lmp": p_week["da_lmp"], "wind_cf": p_week["da_wind_cf"]}
    if scales is not None:
        p_week = {"lmp": np.asarray(scales)[:, None] * p_week["lmp"][0],
                  "wind_cf": np.repeat(p_week["wind_cf"][:1], len(scales), axis=0)}
    lp = prog.instantiate({k: torch.as_tensor(v, device=SERVE_DEVICE) for k, v in p_week.items()},
                          device=SERVE_DEVICE)
    from dispatches_tpu_torch.solvers.ipm import _LP_NDIM

    host = {n: f.cpu().numpy() for n, f in zip(LPData._fields, lp)}
    # bounds come unbatched (one l and u for every week)
    return [LPData(*(np.asarray(f[w] if f.ndim > _LP_NDIM[n] else f) for n, f in host.items()))
            for w in range(len(p_week["lmp"]))]


def _stack_rows(rows):
    from dispatches_tpu_torch.core.program import LPData

    return LPData(*(torch.as_tensor(np.stack([r[i] for r in rows]), device=SERVE_DEVICE)
                    for i in range(len(LPData._fields))))


def _serve_groups(rows):
    """Each row solved in a one-shot `solve_lp_batch` of its group of 8 (in
    submission order, the last group padded by its own rows): {row: host
    `IPMSolution`}."""
    from dispatches_tpu_torch.solvers.ipm import IPMSolution, solve_lp_batch

    ref = {}
    for g in range(0, len(rows), SERVE_BUCKET):
        weeks = list(range(g, min(g + SERVE_BUCKET, len(rows))))
        pad = (weeks * SERVE_BUCKET)[:SERVE_BUCKET]
        sol = solve_lp_batch(_stack_rows([rows[w] for w in pad]), **SERVE_KW)
        host = [f.cpu().numpy() for f in sol]
        for j, w in enumerate(weeks):
            ref[w] = IPMSolution(*(np.asarray(h[j]) for h in host))
    return ref


def _serve_reference(rows):
    """Each week solved in a one-shot `solve_lp_batch` of its group of 8 (in
    submission order, the last group padded by its own weeks), and the
    one-shot batch of all 52 weeks' wall."""
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

    ref = _serve_groups(rows)
    full = _stack_rows(rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = solve_lp_batch(full, **SERVE_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    its = [int(ref[w].iterations) for w in range(len(rows))]
    log(f"[serve] 52 weekly LPs ({rows[0].A.shape[0]} x {rows[0].A.shape[1]} each, f64, "
        f"tol {SERVE_KW['tol']}, max_iter {SERVE_KW['max_iter']}): one-shot solve_lp_batch "
        f"of 52 in {wall:.3f} s ({len(rows) / wall:.2f} LPs/s), iterations "
        f"{int(one.iterations.max())} at most; in groups of {SERVE_BUCKET}: iterations "
        f"{min(its)}..{max(its)}, largest {max(its)}")
    return ref, dict(oneshot_wall_s=wall, oneshot_lps=len(rows) / wall, max_iterations=max(its),
                     iterations=its)


def _serve_burst(rows, ref):
    """(a): the 52 weeks submitted at once to the in-process service, with
    the performance probe and the capacity plane on."""
    from dispatches_tpu_torch.core.program import lp_fingerprint
    from dispatches_tpu_torch.serve import make_dense_service

    svc = make_dense_service(SERVE_BUCKET, chunk_iters=SERVE_CHUNK, device=SERVE_DEVICE,
                             perf=True, capacity=dict(SERVE_CAPACITY), **SERVE_KW)
    t0 = time.perf_counter()
    tickets = [svc.submit(rows[w], request_id=f"w{w}") for w in range(len(rows))]
    t_sub = time.perf_counter() - t0
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    for r in rows[:8]:
        lp_fingerprint(r)
    fp_s = (time.perf_counter() - t1) / 8
    lost = [w for w, t in enumerate(tickets) if not t.done()]
    res = {w: t.result(0) for w, t in enumerate(tickets) if t.done()}
    unconv = [w for w, r in res.items() if r.solution is None or not bool(r.solution.converged)]
    diff = {w: _row_diff(r.solution, ref[w]) for w, r in res.items() if r.solution is not None}
    diff = {w: d for w, d in diff.items() if d}
    st = svc.stats()
    lps = len(rows) / wall
    log(f"[serve] (a) burst of 52 through make_dense_service(bucket={SERVE_BUCKET}, "
        f"chunk_iters={SERVE_CHUNK}): {wall:.3f} s ({lps:.2f} LPs/s; submit {t_sub:.3f} s of it, "
        f"a row's fingerprint {fp_s * 1e3:.1f} ms), {st['chunks']} chunks, "
        f"{st['refills']} refills, {wall / st['chunks'] * 1e3:.1f} ms a chunk; "
        f"lost {len(lost)}, unconverged {unconv}, bitwise-different {len(diff)}")
    if lost or unconv:
        _serve_fail(f"(a) lost {lost}, unconverged {unconv}")
    if diff:
        w = sorted(diff)[0]
        _serve_fail(f"(a) {len(diff)} weeks not bitwise the one-shot batch of 8 (week {w}: "
                    f"{diff[w]}; x ulps "
                    f"{_ulps(torch.as_tensor(res[w].solution.x), torch.as_tensor(ref[w].x))})")
    planes = _serve_planes(svc, st["chunks"])
    return dict(wall_s=wall, lps=lps, submit_s=t_sub, fingerprint_s=fp_s,
                chunks=st["chunks"], refills=st["refills"], chunk_s=wall / st["chunks"],
                bitwise=not diff, lost=len(lost), planes=planes)


def _serve_planes(svc, chunks):
    """(a)'s planes: every chunk record of the probe keeps the exact-sum
    contract (phases summing bitwise to its wall), and the exporter's
    ``/capacity`` answers with the observatory's report. The bitwise gate
    of (a) shows both neutral."""
    from dispatches_tpu_torch.obs.exporter import TelemetryExporter
    from tools.torch_loadgen import http_get

    probe = svc.engine.perf
    recs = probe.records
    broken = [i for i, r in enumerate(recs) if sum(r["phases"].values()) != r["wall_s"]]
    split = {}
    for r in recs:
        for k, v in r["phases"].items():
            split[k] = split.get(k, 0.0) + v
    t0 = time.perf_counter()
    svc.capacity.tick(force=True)  # a full cycle: the laws, the twin, the knee
    tick_s = time.perf_counter() - t0
    exporter = TelemetryExporter(0, capacity_fn=svc.capacity.report).start()
    try:
        code, body = http_get(exporter.url("/capacity"))
    finally:
        exporter.stop()
    cap = json.loads(body) if code == 200 else {}
    est = cap.get("estimate") or {}
    log(f"[serve] (a) planes: {len(recs)} chunk records of {chunks} chunks, exact-sum broken in "
        f"{len(broken)}; phase seconds {{{', '.join(f'{k}: {v:.3f}' for k, v in split.items())}}}"
        f"; segment calls cold / hit {probe.compiles}, the probe's own host time "
        f"{probe.own_s * 1e3:.2f} ms; a forced capacity tick {tick_s * 1e3:.1f} ms; "
        f"/capacity {code}: estimate ok "
        f"{est.get('ok')}, throughput {est.get('throughput_per_sec')}/s, service time "
        f"{est.get('service_time_s')} s, littles residual {est.get('littles_residual')}, "
        f"desired shards {(cap.get('recommendation') or {}).get('desired_shards')}")
    if len(recs) != chunks or broken:
        _serve_fail(f"(a) probe: {len(recs)} records for {chunks} chunks, exact-sum broken "
                    f"in chunks {broken[:5]}")
    if code != 200 or "config" not in cap:
        _serve_fail(f"(a) /capacity answered {code}")
    return dict(records=len(recs), phase_s=split, compiles=dict(probe.compiles),
                probe_own_s=probe.own_s, capacity_tick_s=tick_s, capacity_status=code,
                estimate=est)


def _serve_ramp(rows, lps):
    """(a2): `tools/torch_loadgen.py`'s ramp (``--ramp --capacity``) over
    the weeks: SERVE_RAMP's offered rates as fractions of (a)'s LPs/s, a
    fresh service with the capacity observatory. Every request answered,
    the observatory's estimate ok, its knee and shard recommendation
    finite, the headroom gauge the saturation_approach rule reads, and its
    Little's-law residual within SERVE_LITTLES_BOUND."""
    import math

    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from tools.torch_loadgen import run_ramp

    lo, hi, steps = SERVE_RAMP
    rep = run_ramp(lo * lps, hi * lps, steps, requests_per_step=SERVE_RAMP_REQUESTS,
                   bucket=SERVE_BUCKET, chunk_iters=SERVE_CHUNK, dup_frac=0.0,
                   capacity=dict(SERVE_CAPACITY), device=SERVE_DEVICE, problems=rows,
                   solver_kw=SERVE_KW)
    gauges = obs_metrics.snapshot()["gauges"]
    headroom = {k: v for k, v in gauges.items() if k.startswith("capacity_headroom_ratio")}
    cap = rep["capacity"] or {}
    est = cap.get("estimate") or {}
    twin = cap.get("twin") or {}
    knee = (twin.get("knee") or {}).get("knee_rate_per_sec")
    desired = (cap.get("recommendation") or {}).get("desired_shards")
    littles = est.get("littles_residual")
    unanswered = sum(r["offered"] - r["ok"] for r in rep["rows"])
    for r in rep["rows"]:
        log(f"[serve] (a2) ramp step {r['step']}: offered {r['rate_rps']:.3f}/s, goodput "
            f"{r['goodput_rps']:.3f}/s, p50 / p95 {r['p50_s']} / {r['p95_s']} s, "
            f"capacity {r.get('capacity')}")
    log(f"[serve] (a2) observatory: knee {knee} req/s, desired shards {desired}, littles "
        f"residual {littles}, utilization-law residual {est.get('utilization_residual')}, "
        f"model error {twin.get('model_error_ratio')}, service time {est.get('service_time_s')}"
        f" s, service quantiles {cap.get('service_quantiles')}, headroom {headroom}")
    if 'capacity_headroom_ratio{shard="0"}' not in headroom:
        _serve_fail(f"(a2) no headroom gauge for the service ({headroom})")
    if unanswered:
        _serve_fail(f"(a2) {unanswered} ramp requests not answered ok")
    if not est.get("ok"):
        _serve_fail("(a2) the capacity estimate never became ok")
    if knee is None or not math.isfinite(knee) or knee <= 0 or desired is None or desired < 1:
        _serve_fail(f"(a2) knee {knee}, desired shards {desired}: not finite")
    if littles is None or not littles < SERVE_LITTLES_BOUND:
        _serve_fail(f"(a2) Little's-law residual {littles} not below {SERVE_LITTLES_BOUND}")
    return dict(rows=rep["rows"], knee=knee, desired_shards=desired, littles=littles,
                utilization_residual=est.get("utilization_residual"),
                model_error=twin.get("model_error_ratio"), headroom=headroom)


def _serve_open_loop(rows, ref, lps):
    """(b): Poisson arrivals at SERVE_LOAD x (a)'s rate through the service
    (cache on), then the serial baseline on the same schedule."""
    from dispatches_tpu_torch.serve import make_dense_service
    from tools.torch_loadgen import (
        arrival_schedule, open_loop, percentiles, problem_seeds, serial_loop, serial_solver,
    )

    rate = SERVE_LOAD * lps
    weeks = [s % len(rows) for s in problem_seeds(SERVE_REQUESTS, SERVE_DUP, 0)]
    sched = arrival_schedule(SERVE_REQUESTS, rate, 0)
    svc = make_dense_service(SERVE_BUCKET, chunk_iters=SERVE_CHUNK, device=SERVE_DEVICE,
                             **SERVE_KW)
    svc.start()
    try:
        results, wall, _ = open_loop(svc, [rows[w] for w in weeks], sched)
    finally:
        svc.stop()
    lost = sum(r is None for r in results)
    done = [(w, r) for w, r in zip(weeks, results) if r is not None]
    hits = [(w, r) for w, r in done if r.from_cache]
    unconv = [w for w, r in done if not r.from_cache
              and (r.solution is None or not bool(r.solution.converged))]
    diff = [w for w, r in done if r.solution is not None and _row_diff(r.solution, ref[w])]
    pct = percentiles([r.latency for _, r in done])
    good = sum(r.ok for _, r in done) / wall
    repeats = SERVE_REQUESTS - len(set(weeks))
    log(f"[serve] (b) open loop: {SERVE_REQUESTS} requests over the 52 weeks "
        f"(problem_seeds dup {SERVE_DUP}, {repeats} repeats of a week), Poisson at "
        f"{rate:.2f}/s ({SERVE_LOAD} x (a)): latency p50 {pct['p50_s']:.3f} s p95 "
        f"{pct['p95_s']:.3f} s p99 {pct['p99_s']:.3f} s, goodput {good:.2f}/s, wall "
        f"{wall:.2f} s, cache hits {len(hits)}; lost {lost}, unconverged {unconv}, "
        f"not bitwise the week's one-shot row {len(diff)}")
    lat, ok, swall = serial_loop(serial_solver(SERVE_DEVICE, **SERVE_KW), [rows[w] for w in weeks],
                                 sched)
    spct = percentiles(lat)
    log(f"[serve] (b) serial baseline (one unbatched solve_lp at a time, no cache) on the same "
        f"schedule: p50 {spct['p50_s']:.3f} s p95 {spct['p95_s']:.3f} s p99 "
        f"{spct['p99_s']:.3f} s, goodput {ok / swall:.2f}/s, wall {swall:.2f} s, "
        f"{ok} converged")
    if lost or unconv:
        _serve_fail(f"(b) lost {lost}, unconverged {unconv}")
    if diff:
        _serve_fail(f"(b) {len(diff)} answers (cache hits included) not bitwise their week's "
                    f"first solve (weeks {sorted(set(diff))[:8]})")
    return dict(rate=rate, wall_s=wall, goodput=good, cache_hits=len(hits), repeats=repeats,
                **pct, serial={**spct, "goodput": ok / swall, "wall_s": swall, "converged": ok})


def _serve_deadline(rows, ref, chunk_s):
    """(c): the slowest week with a timeout half a chunk long."""
    from dispatches_tpu_torch.serve import make_dense_service

    w = max(ref, key=lambda k: int(ref[k].iterations))
    svc = make_dense_service(SERVE_BUCKET, chunk_iters=SERVE_CHUNK, cache_size=None,
                             device=SERVE_DEVICE, **SERVE_KW)
    timeout = 0.5 * chunk_s
    t = svc.submit(rows[w], timeout=timeout, request_id="late")
    svc.drain()
    res = t.result(0)
    sol = res.solution
    finite = sol is not None and bool(np.isfinite(np.asarray(sol.x)).all())
    its = None if sol is None else int(sol.iterations)
    log(f"[serve] (c) week {w} ({int(ref[w].iterations)} iterations) with a {timeout * 1e3:.1f} ms "
        f"timeout: {res.verdict} after {res.latency * 1e3:.1f} ms, best iterate at iteration "
        f"{its}, finite {finite}")
    if res.verdict != "deadline_exceeded" or not finite:
        _serve_fail(f"(c) verdict {res.verdict}, finite best iterate {finite}")
    return dict(week=w, timeout_s=timeout, verdict=res.verdict, iterations=its, finite=finite)


def _fleet_pass(fleet, rows, kill_at=None):
    """Submit the weeks to the fleet (in order) and drain; with `kill_at`,
    send shard 0 an ``exit`` fault once that many are submitted and shard
    0 holds lanes. Returns the results, the wall and the kill's stamp."""
    tickets, kill_t = [], None
    t0 = time.perf_counter()
    for w in range(len(rows)):
        if kill_at is not None and w == kill_at:
            t1 = time.monotonic()
            while fleet.shard_states()[0]["inflight"] == 0 and time.monotonic() - t1 < 120:
                fleet.pump()
            fleet.inject_fault(0, "exit")
            kill_t = time.monotonic()
        tickets.append(fleet.submit(rows[w], request_id=f"f{w}"))
    fleet.drain(timeout=240.0)
    wall = time.perf_counter() - t0
    return [t.result(0) if t.done() else None for t in tickets], wall, kill_t


def _serve_fleet(rows, ref):
    """(d): a 2-shard fleet on the one card, bitwise against (a): the last
    SERVE_FLEET_WEEKS weeks, then the first SERVE_FLEET_WEEKS with shard 0
    killed halfway through the submissions."""
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.exporter import TelemetryExporter
    from dispatches_tpu_torch.serve import make_dense_fleet
    from tools.torch_loadgen import http_get, shard_counter_deltas

    before = obs_metrics.snapshot()["counters"]
    fleet = make_dense_fleet(2, SERVE_BUCKET, chunk_iters=SERVE_CHUNK, telemetry=True,
                             cache_size=None, solver_kw=dict(SERVE_KW), device=SERVE_DEVICE)
    exporter = TelemetryExporter(0, health_fn=fleet.health).start()
    out = {}
    try:
        shards = [s.shard for s in fleet._slots]
        log(f"[serve] (d) fleet of 2 shards, child devices "
            f"{[s.device_env for s in shards]}, heartbeat_timeout {fleet.heartbeat_timeout} s")
        first = len(rows) - SERVE_FLEET_WEEKS  # pass 1: weeks 39-51
        res1, wall1, _ = _fleet_pass(fleet, rows[first:])
        start = [dict(pong_s=s.first_pong_at - s.spawned_at,
                      result_s=s.first_result_at - s.spawned_at, ping_max_s=s.ping_max)
                 for s in shards]
        lost1 = sum(r is None for r in res1)
        diff1 = [first + w for w, r in enumerate(res1)
                 if r is not None and (r.solution is None
                                       or _row_diff(r.solution, ref[first + w]))]
        log(f"[serve] (d) pass 1: weeks {first}-{len(rows) - 1} in {wall1:.2f} s "
            f"({len(res1) / wall1:.2f} LPs/s), lost "
            f"{lost1}, not bitwise (a) {len(diff1)}; spawn to first pong / first result / "
            f"slowest ping: " + ", ".join(
                f"shard {i} {d['pong_s']:.3f} / {d['result_s']:.3f} / {d['ping_max_s']:.3f} s"
                for i, d in enumerate(start)))
        half = rows[:SERVE_FLEET_WEEKS]  # weeks 0-12, shard 0 killed after 6
        res2, wall2, kill_t = _fleet_pass(fleet, half, kill_at=len(half) // 2)
        s0 = shards[0]
        recovery = (s0.first_result_at - kill_t) if s0.first_result_at else None
        st = fleet.stats()
        lost2 = sum(r is None for r in res2)
        diff2 = [w for w, r in enumerate(res2)
                 if r is not None and (r.solution is None or _row_diff(r.solution, ref[w]))]
        log(f"[serve] (d) pass 2, shard 0 sent `fault exit` after {len(half) // 2} "
            f"submissions: {len(half)} weeks in {wall2:.2f} s, lost {lost2}, respawns "
            f"{st['respawns']}, requeued lanes {st['requeued_lanes']}, not bitwise (a) "
            f"{len(diff2)}; kill to the respawned "
            f"shard's first result {recovery if recovery is None else round(recovery, 3)} s "
            f"(its spawn to first pong {s0.first_pong_at - s0.spawned_at:.3f} s, slowest ping "
            f"{s0.ping_max:.3f} s)")
        # telemetry: children ship on the heartbeat; pump until it settles
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20:
            fleet.pump()
            labeled, unlabeled = shard_counter_deltas(before, obs_metrics.snapshot()["counters"])
            if labeled and all(abs(sum(m.values()) - unlabeled.get(k, 0.0)) < 1e-9
                               for k, m in labeled.items()) and fleet.health()["ok"]:
                break
            time.sleep(0.05)
        after = obs_metrics.snapshot()["counters"]
        ok_total = after.get('serve_requests_total{status="ok"}', 0.0) - before.get(
            'serve_requests_total{status="ok"}', 0.0)
        per_shard = {s: after[s] - before.get(s, 0.0) for s in after
                     if s.startswith("serve_shard_requests_total{")}
        conserved = all(abs(sum(m.values()) - unlabeled.get(k, 0.0)) < 1e-9
                        for k, m in labeled.items())
        code_m, body = http_get(exporter.url("/metrics"))
        code_h, health = http_get(exporter.url("/healthz"))
        log(f"[serve] (d) serve_requests_total{{status=ok}} {ok_total:g} against the per-shard "
            f"series {per_shard} (sum {sum(per_shard.values()):g}); merged child counters "
            f"{ {k[0]: m for k, m in labeled.items()} } against the fleet aggregate "
            f"{ {k[0]: v for k, v in unlabeled.items()} }; exporter /metrics {code_m} "
            f"({len(body)} bytes), /healthz {code_h} {json.loads(health).get('ok')}")
        if lost1 or lost2 or diff1 or diff2:
            _serve_fail(f"(d) lost {lost1} + {lost2}, not bitwise (a) {diff1} / {diff2}")
        if st["respawns"] < 1 or st["requeued_lanes"] < 1:
            _serve_fail(f"(d) respawns {st['respawns']}, requeued {st['requeued_lanes']}")
        if ok_total != sum(per_shard.values()) or not labeled or not conserved:
            _serve_fail("(d) the fleet aggregate is not the sum of the per-shard series")
        if code_m != 200 or 'shard="0"' not in body or 'shard="1"' not in body or code_h != 200:
            _serve_fail(f"(d) exporter /metrics {code_m}, /healthz {code_h}")
        out = dict(pass1_wall_s=wall1, pass2_wall_s=wall2, startup=start,
                   respawn_pong_s=s0.first_pong_at - s0.spawned_at, recovery_s=recovery,
                   respawns=st["respawns"], requeued=st["requeued_lanes"],
                   requests_ok=ok_total, per_shard=per_shard)
    finally:
        exporter.stop()
        fleet.close()
    return out


def _serve_profile(rows):
    """(e): where a chunk's time goes, in steady state at bucket 8 (slots
    refilled from the 52 weeks as lanes retire)."""
    from torch.profiler import ProfilerActivity, profile

    from dispatches_tpu_torch.runtime.adaptive import make_dense_engine

    eng = make_dense_engine(SERVE_BUCKET, chunk_iters=SERVE_CHUNK, device=SERVE_DEVICE,
                            **SERVE_KW)
    todo = list(range(len(rows)))

    def chunk():
        while todo and eng.free_slots():
            w = todo.pop(0)
            eng.admit(w, rows[w])
        return eng.step()

    for _ in range(3):  # steady state: past the first fill and its first harvest
        chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILE_CHUNKS):
            chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, launches, syncs, by_op = 0.0, 0, 0, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            dev_us += us
            launches += e.count
            by_op[e.key[:70]] = by_op.get(e.key[:70], 0.0) + us
        elif e.key == "aten::_local_scalar_dense":
            syncs += e.count
    busy = dev_us / 1e6 / wall if wall else float("nan")
    n = SERVE_PROFILE_CHUNKS
    log(f"[serve] (e) profiled window of {n} chunks at bucket {SERVE_BUCKET}: wall {wall:.3f} s "
        f"({wall / n * 1e3:.1f} ms a chunk), device busy {busy:.3f}, {launches / n:.0f} launches "
        f"and {syncs / n:.1f} device-to-host scalar reads a chunk")
    for name, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[serve] (e)   {us / 1e3:9.2f} ms  {name}")
    if dev_us == 0:
        log("[serve] (e) the profiler saw no device time: busy share not measured")
    # the host time by phase over n more chunks: the performance probe's
    # marks (obs.perf; the chunk's one host read closes "compute")
    from dispatches_tpu_torch.obs.perf import PerfProbe

    eng.perf = PerfProbe(device=SERVE_DEVICE)
    for _ in range(n):
        chunk()
    phase = {}
    for r in eng.perf.records:
        for k, v in r["phases"].items():
            phase[k] = phase.get(k, 0.0) + v
    log(f"[serve] (e) host time by phase over {n} more chunks (the probe; "
        f"{sum(r['wall_s'] for r in eng.perf.records):.3f} s in all): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in phase.items()))
    return dict(wall_s=wall, device_busy=busy, launches_per_chunk=launches / n,
                scalar_reads_per_chunk=syncs / n,
                phase_ms={k: v * 1e3 / n for k, v in phase.items()},
                top_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:8])


SERVE_WARM_SCALES = 52  # (f): week 0 at this many LMP scales (seed 0's draw in [0.5, 2])
SERVE_WARM_TRAIN = 40  # (f): the scales a warm model trains on; the other 12 are served
# (f): an accepted seed's answer against its cold lane, |obj_warm - obj_cold|
# / (1 + |obj_cold|): the IPM's own convergence test, residuals and scaled
# gap below 100 x tol (SERVE_KW's 1e-8); two converged starts differ by
# more than tol itself. Not |dx|: two starts stop at other interior points
# near the optimal face
SERVE_WARM_OBJ_RTOL = 100 * SERVE_KW["tol"]


def _serve_warm(hours=168):
    """(f): a warm service. Week 0 at SERVE_WARM_SCALES LMP scales (the
    weekly rows themselves span a range a predictor trained on 40 of them
    does not reach: every seed was rejected), their cold lanes solved in
    groups of 8; a predictor trains on 40 and the other 12 are served
    through ``make_dense_service(bucket=8, warm_model=)``, journaled, so
    each answer's ``warm_accepted`` is the engine's own verdict."""
    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.learn import DatasetWriter, load_dataset, train_warmstart_model
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
    from dispatches_tpu_torch.serve import make_dense_service

    scales = np.random.default_rng(0).uniform(0.5, 2.0, SERVE_WARM_SCALES)
    rows = _serve_rows(hours, scales=scales)
    t0 = time.perf_counter()
    ref = _serve_groups(rows)
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        w = DatasetWriter(f"{tmp}/ds")
        for k in range(SERVE_WARM_TRAIN):
            w.add(rows[k], ref[k], iterations=int(ref[k].iterations))
        w.close()
        t1 = time.perf_counter()
        model, met = train_warmstart_model(load_dataset([f"{tmp}/ds"]), hidden=LEARNED_HIDDEN,
                                           epochs=LEARNED_EPOCHS, seed=0, device=SERVE_DEVICE)
        train_s = time.perf_counter() - t1
        path = model.save(f"{tmp}/warm.npz")
        before = obs_metrics.flat_values()
        svc = make_dense_service(SERVE_BUCKET, chunk_iters=SERVE_CHUNK, cache_size=None,
                                 warm_model=path, device=SERVE_DEVICE, **SERVE_KW)
        todo = range(SERVE_WARM_TRAIN, len(rows))
        tracer = Tracer(None)
        with use_tracer(tracer):
            t1 = time.perf_counter()
            tickets = {k: svc.submit(LPData(*rows[k]), request_id=f"s{k}") for k in todo}
            svc.drain()
            wall = time.perf_counter() - t1
        after = obs_metrics.flat_values()
    res = {k: t.result(0) for k, t in tickets.items() if t.done()}
    verdict = {int(e["request_id"][1:]): bool(e.get("warm_accepted"))
               for e in tracer.events if e.get("kind") == "solve" and "request_id" in e}

    def delta(prefix, extra=""):
        return sum(after.get(k, 0.0) - before.get(k, 0.0) for k in after
                   if k.startswith(prefix) and extra in k)

    acc, rej = delta("learned_warm_accept_total"), delta("learned_warm_reject_total")
    saved = delta("warm_start_iters_saved_total", 'source="learned"')
    dx = {k: float(np.max(np.abs(np.asarray(r.solution.x) - ref[k].x))) for k, r in res.items()}
    dobj = {k: float(abs(float(r.solution.obj) - float(ref[k].obj))
                     / (1.0 + abs(float(ref[k].obj)))) for k, r in res.items()}
    unconv = [k for k, r in res.items() if not bool(r.solution.converged)]
    its = {k: (int(r.iterations), int(ref[k].iterations)) for k, r in res.items()}
    took = [k for k in res if verdict.get(k)]
    moved = {k: _row_diff(r.solution, ref[k]) for k, r in res.items()
             if not verdict.get(k) and _row_diff(r.solution, ref[k])}
    log(f"[serve] (f) warm service on week 0 at {len(rows)} LMP scales (cold lanes in groups of "
        f"{SERVE_BUCKET}: {ref_s:.2f} s): trained on {SERVE_WARM_TRAIN} in {train_s:.2f} s "
        f"(train R2 {met['train_R2_mean']:.3f}, holdout rel err "
        f"{met.get('holdout_rel_err', float('nan')):.3e}), served {len(res)} of {len(todo)} "
        f"in {wall:.2f} s: accepted {acc:g} (lanes {took}), rejected {rej:g}, iterations saved "
        f"{saved:.1f} (against the artifact's cold mean {model.cold_iters_mean:.1f}); "
        f"iterations warm/cold {its}; accepted lanes' objective rel to cold max "
        f"{max((dobj[k] for k in took), default=0.0):.2e}, max |dx| "
        f"{max((dx[k] for k in took), default=0.0):.2e}; rejected lanes bitwise cold: "
        f"{len(res) - len(took) - len(moved)} of {len(res) - len(took)}")
    if len(res) != len(todo) or unconv:
        _serve_fail(f"(f) lost {len(todo) - len(res)}, unconverged {unconv}")
    if sorted(verdict) != sorted(res) or len(took) != acc:
        _serve_fail(f"(f) journaled verdicts {verdict} against {acc:g} counted accepts")
    if not took:
        _serve_fail("(f) no learned seed accepted: the served warm path ran no lane")
    if moved:
        _serve_fail(f"(f) rejected lanes not bitwise their cold lanes: {moved}")
    far = {k: dobj[k] for k in took if not dobj[k] <= SERVE_WARM_OBJ_RTOL}
    if far:
        _serve_fail(f"(f) accepted lanes' objectives off their cold lanes: {far}")
    return dict(served=len(res), accepted=acc, rejected=rej, iters_saved=saved,
                wall_s=wall, train_s=train_s, iterations=its,
                max_obj_rel=max((dobj[k] for k in took), default=0.0))


def phase_serve():
    """The `serve` phase (see the module docstring), on the card."""
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep

    t0 = time.perf_counter()
    chain_sweep.launches = 0
    rows = _serve_rows()
    ref, one = _serve_reference(rows)

    def timed(tag, fn):
        t1 = time.perf_counter()
        out = fn()
        log(f"[serve] {tag} in {time.perf_counter() - t1:.1f} s")
        return out

    burst = timed("(a)", lambda: _serve_burst(rows, ref))
    # before (d): a fleet's per-shard in-flight gauges stay in the process
    # registry after it closes, and the observatory would read them before
    # the service's own lanes
    ramp = timed("(a2)", lambda: _serve_ramp(rows, burst["lps"]))
    loop = timed("(b)", lambda: _serve_open_loop(rows, ref, burst["lps"]))
    late = timed("(c)", lambda: _serve_deadline(rows, ref, burst["chunk_s"]))
    fleet = timed("(d)", lambda: _serve_fleet(rows, ref))
    prof = timed("(e)", lambda: _serve_profile(rows))
    t1 = time.perf_counter()
    warm = _serve_warm()
    log(f"[serve] (f) in {time.perf_counter() - t1:.1f} s")
    launches = chain_sweep.launches
    log(f"[serve] chain_sweep launches on the serving path: {launches} (dense IPM only); "
        f"phase {time.perf_counter() - t0:.1f} s")
    if _SERVE_FAILS:
        raise AssertionError(f"serve phase: {len(_SERVE_FAILS)} gates failed: {_SERVE_FAILS}")
    return dict(reference=one, burst=burst, ramp=ramp, open_loop=loop, deadline=late,
                fleet=fleet, profile=prof, launches=launches, warm=warm)


# ------------------------------------------------------------------ market
MARKET_DEVICE = "cuda"
MARKET_BUSES = 73  # (b), (c): the reference's RTS-GMLC bus and unit count
MARKET_ENGINE_BUCKET = 16
MARKET_SAMPLE_HOURS = (0, 13, 30, 47)  # the HiGHS objective checks of (a), (b)
MARKET_KW = dict(max_iter=60)
_MARKET_FAILS = []


def _market_fail(msg):
    """A failed gate of the market phase: logged now, raised at its end."""
    log(f"[market] GATE FAILED: {msg}")
    _MARKET_FAILS.append(msg)


class _Clock:
    """Host seconds (and calls) by label around patched callables; every
    wrapped call returns host values or reads the device, so its wall is
    the solve's."""

    def __init__(self):
        self.t, self.n, self.calls = {}, {}, {}

    def add(self, key, dt, record=None):
        self.t[key] = self.t.get(key, 0.0) + dt
        self.n[key] = self.n.get(key, 0) + 1
        if record is not None:
            self.calls.setdefault(key, []).append(record)


@contextlib.contextmanager
def _timed(clock, patches):
    """Patch each (owner, attribute, label_fn) with a timed wrapper for the
    duration; `label_fn(args, kwargs)` names the call's bucket (None: untimed)
    and the wrapper records (self/args, kwargs, result) under it."""
    saved = []
    for owner, name, label in patches:
        orig = getattr(owner, name)
        saved.append((owner, name, orig))

        def wrapper(*a, _orig=orig, _label=label, **kw):
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            key = _label(a, kw)
            if key is not None:
                clock.add(key, time.perf_counter() - t0, (a, kw, out))
            return out

        setattr(owner, name, wrapper)
    try:
        yield clock
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def _market_patches():
    """Timers over the simulator's stages: the RUC, the day-ahead batch and
    each SCED (`solve_hours` by its hour count), tracking, bidding."""
    from dispatches_tpu_torch.market import bidder, network, stochastic, tracker

    return [
        (network.OptimizingUnitCommitment, "commit", lambda a, kw: "ruc"),
        (network, "solve_hours",
         lambda a, kw: "sced" if len(a[2]) == 1 else ("da" if len(a[2]) == 24 else None)),
        (tracker.Tracker, "track_market_dispatch", lambda a, kw: "tracker"),
        (bidder.PEMParametrizedBidder, "compute_day_ahead_bids", lambda a, kw: "bids"),
        (bidder.PEMParametrizedBidder, "compute_real_time_bids", lambda a, kw: "bids"),
        (stochastic.StochasticBidder, "_solve_bidding", lambda a, kw: "scenario_lp"),
    ]


def _sced_vs_highs(tag, clock, hours):
    """The HiGHS objective of each sampled hour's SCED LP (instantiated on
    the host from the recorded inputs) against the card's, at the JAX
    package's tolerances (rel 1e-5, abs 1e-2, `test_uc_scale.py:137-140`)."""
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy

    calls = clock.calls["sced"]
    worst = 0.0
    for h in hours:
        (prog, _g, loads, ren, commit), kw, out = calls[h]
        p = {"load": loads[0], "ren_cap": ren[0], "commit": commit[0]}
        if kw.get("bid_mw") is not None:
            p["bid_mw"], p["bid_cost"] = kw["bid_mw"][0], kw["bid_cost"][0]
        if kw.get("reserve_req") is not None:
            p["reserve_req"] = np.asarray(kw["reserve_req"], float)[:1]
        ref = solve_lp_scipy(prog.instantiate(p, device="cpu")).obj_with_offset
        got = float(out["cost"][0])
        err = abs(got - ref)
        worst = max(worst, err / max(abs(ref), 1e-12))
        log(f"[market] ({tag}) hour {h}: SCED objective {got:.6f} HiGHS {ref:.6f} "
            f"|diff| {err:.3e}")
        if not err <= 1e-2 + 1e-5 * abs(ref):
            _market_fail(f"({tag}) hour {h}: SCED objective {got} vs HiGHS {ref}")
    return worst


def _market_rows_gates(tag, rows, n_hours):
    """48 converged SCEDs: (shed hours, LMP array)."""
    if len(rows) != n_hours:
        _market_fail(f"({tag}) {len(rows)} rows, expected {n_hours}")
    unconv = [i for i, r in enumerate(rows) if not r["SCED Converged"]]
    if unconv:
        _market_fail(f"({tag}) SCEDs not converged at hours {unconv}")
    lmps = np.array([[v for k, v in r.items() if k.startswith("LMP")] for r in rows])
    shed = np.array([r["Shortfall [MW]"] for r in rows])
    return shed, lmps


def _profile_single_lps(fns, kernel=None):
    """One profiled window over single-LP solves (or any calls `fns`):
    launches and the device-busy share; with `kernel`, also the device ms
    and launches of the kernels whose name holds that string."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:  # warm
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, launches, syncs, k_us, k_launches = 0.0, 0, 0, 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            dev_us += us
            launches += e.count
            if kernel is not None and kernel in e.key:
                k_us += us
                k_launches += e.count
        elif e.key == "aten::_local_scalar_dense":
            syncs += e.count
    busy = dev_us / 1e6 / wall if wall else float("nan")
    out = dict(wall_s=wall, device_busy=busy, launches=launches, scalar_reads=syncs,
               device_ms=dev_us / 1e3)
    if kernel is not None:
        out.update(kernel_ms=k_us / 1e3, kernel_launches=k_launches)
    return out


def _market_doubleloop():
    """(a) `run_double_loop` (2 days, the wind + PEM participant) on the card."""
    from dispatches_tpu_torch.market import network
    from dispatches_tpu_torch.market.double_loop import MultiPeriodWindPEM
    from dispatches_tpu_torch.market.model_data import RenewableGeneratorModelData
    from dispatches_tpu_torch.market.tracker import Tracker
    from dispatches_tpu_torch.workflow.options import SimulationOptions
    from dispatches_tpu_torch.workflow.runners import run_double_loop

    clock = _Clock()
    t0 = time.perf_counter()
    with _timed(clock, _market_patches()):
        rows, summary = run_double_loop(SimulationOptions(num_days=2), verbose=False,
                                        device=MARKET_DEVICE)
    wall = time.perf_counter() - t0
    shed, lmps = _market_rows_gates("a", rows, 48)
    part = np.array([r["Participant [MW]"] for r in rows])
    if shed.max() > 1e-3:
        _market_fail(f"(a) shortfall {shed.max():.3e} MW > 1e-3")
    # the LMP gate of `test_network.py:312-322` is that test's run: the same
    # 2 days without the participant (with it, its $0 tranche sets the price
    # to 0 in some hours, as in the JAX package)
    t1 = time.perf_counter()
    rows0 = network.ProductionCostSimulator(network.load_rts_format(),
                                            device=MARKET_DEVICE).simulate(2)
    wall0 = time.perf_counter() - t1
    shed0, lmps0 = _market_rows_gates("a, no participant", rows0, 48)
    log(f"[market] (a) the same 2 days without the participant: {wall0:.2f} s, LMP "
        f"{lmps0.min():.3f}..{lmps0.max():.3f} $/MWh, shortfall max {shed0.max():.2e} MW")
    if shed0.max() > 1e-3:
        _market_fail(f"(a) no participant: shortfall {shed0.max():.3e} MW > 1e-3")
    if not (lmps0 > 0).all() or not (lmps0 < 100).all():
        _market_fail(f"(a) no participant: LMPs outside (0, 100): "
                     f"{lmps0.min():.3f}..{lmps0.max():.3f}")
    if not part.max() > 1.0:
        _market_fail(f"(a) the participant never cleared above 1 MW ({part.max():.3f})")
    split = {k: clock.t.get(k, 0.0) for k in ("ruc", "da", "sced", "tracker", "bids")}
    log(f"[market] (a) doubleloop 2 days: {len(rows)} SCEDs in {wall:.2f} s "
        f"({len(rows) / wall:.2f} SCEDs/s end to end); seconds: " +
        ", ".join(f"{k} {v:.2f}" for k, v in split.items()) +
        f", other {wall - sum(split.values()):.2f}")
    log(f"[market] (a) LMP {lmps.min():.3f}..{lmps.max():.3f} $/MWh, participant max "
        f"{part.max():.2f} MW, shortfall max {shed.max():.2e} MW; summary {summary}")
    worst = _sced_vs_highs("a", clock, MARKET_SAMPLE_HOURS)
    # the RUC: each day's device-chosen schedule, costed by its own batched
    # evaluation, between the exact MILP's cost x (1 - 1e-6) and x 1.01
    ruc = []
    for (ouc, loads, ren), _kw, sched in clock.calls["ruc"]:
        if ouc.backend != "device":
            _market_fail(f"(a) the RUC took the {ouc.backend} backend on the card")
        cost, ok = ouc._evaluate(sched[None], loads, ren)
        p = {"load_total": loads, "ren_total": ren}
        milp = network.solve_uc_milp(ouc.prog, p).obj_with_offset * 1e3
        host = network.OptimizingUnitCommitment(ouc.grid, T=ouc.T, backend="host")
        host_cost = float(host._evaluate(host.commit(loads, ren)[None], loads, ren)[0][0])
        exact = float(host._evaluate(sched[None], loads, ren)[0][0])
        ruc.append(dict(device_cost=float(cost[0]), exact_cost=exact, milp=milp,
                        host_chosen_cost=host_cost))
        log(f"[market] (a) RUC day {len(ruc) - 1}: device schedule costed {cost[0]:.2f} "
            f"(exactly {exact:.2f}), MILP {milp:.2f} (ratio {cost[0] / milp:.6f}); the host "
            f"backend's choice costs {host_cost:.2f}")
        if not (ok[0] and milp * (1 - 1e-6) <= cost[0] <= milp * 1.01):
            _market_fail(f"(a) RUC day {len(ruc) - 1}: cost {cost[0]} vs MILP {milp}")
    n_sced, n_trk = clock.n.get("sced", 0), clock.n.get("tracker", 0)
    sced_ms = clock.t.get("sced", 0.0) / max(n_sced, 1) * 1e3
    trk_ms = clock.t.get("tracker", 0.0) / max(n_trk, 1) * 1e3
    # one profiled hour: that hour's SCED and a tracking LP, replayed
    (a, kw, _) = clock.calls["sced"][13]
    md = RenewableGeneratorModelData(gen_name="p", bus="1", p_min=0.0, p_max=50.0)
    mp = MultiPeriodWindPEM(md, np.full(48, 0.5), wind_pmax_mw=50, pem_pmax_mw=10)
    trk = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device=MARKET_DEVICE)
    prof = _profile_single_lps([lambda: network.solve_hours(*a, **kw),
                                lambda: trk.track_market_dispatch([20.0] * 4, 0, 13)])
    log(f"[market] (a) single-LP solves: SCED {sced_ms:.1f} ms mean over {n_sced}, tracker "
        f"{trk_ms:.1f} ms mean over {n_trk}; one profiled hour (its SCED + a tracking LP): "
        f"{prof['wall_s'] * 1e3:.1f} ms, {prof['launches']} launches "
        f"({prof['launches'] / 2:.0f} an LP), {prof['scalar_reads']} device-to-host scalar "
        f"reads, device busy {prof['device_busy']:.3f}")
    if prof["device_ms"] == 0:
        log("[market] (a) the profiler saw no device time: busy share not measured")
    return dict(wall_s=wall, sceds=len(rows), sceds_per_s=len(rows) / wall, seconds=split,
                no_participant_wall_s=wall0,
                sced_ms=sced_ms, tracker_ms=trk_ms, worst_rel_vs_highs=worst, ruc=ruc,
                profile=prof, summary=summary)


def _market_network73():
    """(b) the production-cost simulator on the synthesized 73-bus network
    (`test_uc_scale.py:145-170`), flow-rated on the card, host RUC."""
    from dispatches_tpu_torch.market import network

    t0 = time.perf_counter()
    g = network.synthesize_network(n_buses=MARKET_BUSES, n_units=MARKET_BUSES, days=2, seed=5,
                                   rating_mode="flow", device=MARKET_DEVICE)
    t_flow = time.perf_counter() - t0
    sim = network.ProductionCostSimulator(g, device=MARKET_DEVICE)
    # the JAX package's own 73-bus record took the host RUC: one candidate
    # lane's dense UC LP here is 22,351 x 31,135 (5.6 GB in f64)
    sim.uc = network.OptimizingUnitCommitment(g, backend="host")
    clock = _Clock()
    t0 = time.perf_counter()
    with _timed(clock, _market_patches()):
        rows = sim.simulate(2)
    wall = time.perf_counter() - t0
    shed, lmps = _market_rows_gates("b", rows, 48)
    shed_hours = int((shed > 1e-3).sum())
    spread = float(np.mean((lmps.max(1) - lmps.min(1)) > 0.5))
    if shed_hours > 6:
        _market_fail(f"(b) {shed_hours} shed hours > 6")
    if spread < 0.3:
        _market_fail(f"(b) LMPs separate in {spread:.2f} of hours < 0.3")
    prog = sim.prog
    log(f"[market] (b) {len(g.buses)} buses, {len(g.branch_b)} branches, {len(g.thermal)} "
        f"units; SCED LP {prog.M} x {prog.N}; flow rating (24 DC-OPFs on the card) "
        f"{t_flow:.2f} s")
    log(f"[market] (b) 2 days: {len(rows)} SCEDs in {wall:.2f} s ({len(rows) / wall:.2f} "
        f"SCEDs/s end to end); RUC (host HiGHS) {clock.t['ruc'] / 2:.2f} s a day, DA batches "
        f"{clock.t['da']:.2f} s, SCEDs {clock.t['sced']:.2f} s ({len(rows) / clock.t['sced']:.2f} "
        f"SCEDs/s); shed hours {shed_hours}, LMP spread > $0.5 in {spread:.2f} of hours")
    worst = _sced_vs_highs("b", clock, MARKET_SAMPLE_HOURS)
    return dict(grid=g, flow_rating_s=t_flow, wall_s=wall, sceds_per_s=len(rows) / wall,
                sced_s=clock.t["sced"], ruc_s_per_day=clock.t["ruc"] / 2, da_s=clock.t["da"],
                shed_hours=shed_hours, spread_share=spread, worst_rel_vs_highs=worst,
                sced_shape=[prog.M, prog.N])


def _market_contingency(g):
    """(c) the N-1 screen of (b)'s grid at hour 0, on both paths, then the
    secure dispatch with its certificates."""
    from dispatches_tpu_torch.market import contingency as C
    from dispatches_tpu_torch.runtime.adaptive import make_dense_engine
    from dispatches_tpu_torch.solvers.ipm import STATUS_PRIMAL_INFEASIBLE, solve_lp_batch
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    prog = C.contingency_dcopf_program(g)
    base = C.base_operating_point(g, hour=0)
    cset = C.ContingencySet.n_minus_1(g)
    params = C.contingency_params(g, base, cset)
    C.stack_contingency_lp(prog, params, device=MARKET_DEVICE)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = C.stack_contingency_lp(prog, params, device=MARKET_DEVICE)
    torch.cuda.synchronize()
    inst_ms = (time.perf_counter() - t0) * 1e3
    K = cset.K
    log(f"[market] (c) K = {K} outages ({len(cset.branch_indices())} branches, "
        f"{len(cset.gen_indices())} units), a lane {prog.M} x {prog.N}; the K-lane "
        f"instantiate (branch_on group, repeats folded on the host) {inst_ms:.1f} ms")
    out = {"K": K, "lane_shape": [prog.M, prog.N], "instantiate_ms": inst_ms}
    highs = {}  # lane -> HiGHS's verdict on that lane's LP

    def highs_infeasible(k):
        if k not in highs:
            try:
                solve_lp_scipy_sparse(prog, {n: v[k] for n, v in params.items()})
                highs[k] = False
            except RuntimeError as e:
                highs[k] = "infeasible" in str(e)
        return highs[k]

    infeasible = None
    for path in ("adaptive", "engine"):
        eng = (make_dense_engine(MARKET_ENGINE_BUCKET, device=MARKET_DEVICE, **MARKET_KW)
               if path == "engine" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scr = C.screen_contingencies(prog, g, cset, base, engine=eng, device=MARKET_DEVICE,
                                     **({} if eng else MARKET_KW))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # a lane either converges or is an outage no dispatch survives: the
        # IPM then says suspected_primal_infeasible and HiGHS, on the same
        # lane's LP, infeasible (must-run blocks stranded: the program has
        # no over-generation slack, as in the JAX package)
        stuck = [int(k) for k in np.nonzero(~scr.converged)[0]]
        status = scr.sol.status.cpu().numpy()
        for k in stuck:
            if status[k] != STATUS_PRIMAL_INFEASIBLE or not highs_infeasible(k):
                _market_fail(f"(c) {path}: lane {k} ({cset[k].label}) not converged, status "
                             f"{status[k]}, HiGHS infeasible {highs_infeasible(k)}")
        if infeasible is None:
            infeasible = stuck
        elif stuck != infeasible:
            _market_fail(f"(c) {path}: unconverged lanes {stuck} differ from {infeasible}")
        log(f"[market] (c) screen via {path}: {len(stuck)} lanes infeasible "
            f"({[cset[k].label for k in stuck]}: status suspected_primal_infeasible, HiGHS "
            f"infeasible), {K - len(stuck)} converged")
        log(f"[market] (c) screen via {path}: {wall:.2f} s, {K / wall:.1f} LPs/s; critical "
            f"{int(scr.critical.sum())}, shedding {int((scr.shed_mw > C.ABS_TOL).sum())}; stats "
            f"{ {k: v for k, v in scr.stats.items() if k in ('buckets', 'chunks', 'total_iterations')} }")
        out[path] = dict(wall_s=wall, lps_per_s=K / wall, converged=int(scr.converged.sum()))
        if path == "engine":
            bad = 0
            B = MARKET_ENGINE_BUCKET
            for g0 in range(0, K, B):
                idx = [(g0 + i) if g0 + i < K else i for i in range(B)]
                ref = solve_lp_batch(type(lp)(*(leaf[idx] for leaf in lp)), **MARKET_KW)
                for j in range(min(B, K - g0)):
                    if any(getattr(ref, n)[j].cpu().numpy().tobytes()
                           != getattr(scr.sol, n)[g0 + j].cpu().numpy().tobytes()
                           for n in ("x", "y", "obj", "iterations")):
                        bad += 1
            out[path]["not_bitwise"] = bad
            log(f"[market] (c) engine lanes bitwise their one-shot batch of {B}: {K - bad} of {K}")
            if bad:
                _market_fail(f"(c) {bad} engine lanes not bitwise their one-shot lane")
    # preventive security over the outages some dispatch survives: as for
    # the islanding bridges `n_minus_1` leaves out, no cut fixes the others
    secure_set = C.ContingencySet([c for k, c in enumerate(cset) if k not in infeasible])
    t0 = time.perf_counter()
    sd = C.secure_dispatch(g, base, secure_set, conformance=True, device=MARKET_DEVICE,
                           **MARKET_KW)
    wall = time.perf_counter() - t0
    conf = sd.conformance or {}
    log(f"[market] (c) secure_dispatch over {sd.total_branch_ctg} branch outages (the "
        f"{len(infeasible)} infeasible ones left out): {sd.rounds} rounds, {len(sd.cuts)} cuts, feasible "
        f"{sd.feasible}, escaped {sd.escaped_violations}, violated outages "
        f"{len(sd.violated_outages)}, {wall:.2f} s; certificates "
        f"{ {k: conf.get(k) for k in ('res_primal', 'res_dual', 'comp', 'gap', 'outcome')} }")
    if not (sd.feasible and sd.escaped_violations == 0 and conf.get("ok")):
        _market_fail(f"(c) secure_dispatch feasible {sd.feasible}, escaped "
                     f"{sd.escaped_violations}, conformance {conf}")
    out["infeasible_outages"] = [cset[k].label for k in infeasible]
    out["secure"] = dict(rounds=sd.rounds, cuts=len(sd.cuts), feasible=sd.feasible,
                         escaped=sd.escaped_violations, wall_s=wall, conformance=conf)
    out["_screen_ctx"] = dict(base=base, secure_set=secure_set, sd=sd, wall_s=wall)
    return out


# (e): a screened dispatch's objective against the full set's, relative to
# max(1, |obj|). Both end N-1 secure over the whole set, each optimal for
# its own cuts, so each is feasible for the other's cuts and the optima
# agree up to the violation test's slack (`secure_dispatch(rel_tol=1e-4)`)
MARKET_SCREEN_OBJ_RTOL = 1e-4
MARKET_SCREEN_POINTS = 6  # (e): operating points labelled by full secure dispatches
MARKET_SCREEN_LOAD = (0.97, 1.03)  # (e): their load scales around hour 0


def _market_screener(g, ctx):
    """(e): the learned N-1 screener on (c)'s 73-bus outage set. Full
    `secure_dispatch` runs label hour-0 operating points at perturbed loads
    (`screen_targets` rows through `DatasetWriter`), one artifact trains
    through `tools/torch_train_screener.py`'s `train`, and (c)'s base point
    and one unseen point are dispatched with ``screener=``."""
    import importlib.util

    from dispatches_tpu_torch.learn.dataset import DatasetWriter
    from dispatches_tpu_torch.learn.screener import SCREEN_VARYING, screen_targets
    from dispatches_tpu_torch.market import contingency as C
    from dispatches_tpu_torch.market.network import dcopf_program

    spec = importlib.util.spec_from_file_location(
        "torch_train_screener", os.path.join(ROOT, "tools", "torch_train_screener.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    base, cset = ctx["base"], ctx["secure_set"]
    prog0 = dcopf_program(g)
    rng = np.random.default_rng(11)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        w = DatasetWriter(f"{tmp}/shards", varying=SCREEN_VARYING)
        points, label_s = [], 0.0
        for i in range(MARKET_SCREEN_POINTS + 1):
            p = dict(base)
            p["load"] = np.asarray(base["load"]) * rng.uniform(*MARKET_SCREEN_LOAD,
                                                               size=np.shape(base["load"]))
            t0 = time.perf_counter()
            sd = C.secure_dispatch(g, p, cset, device=MARKET_DEVICE, **MARKET_KW)
            dt = time.perf_counter() - t0
            label_s += dt
            if not (sd.feasible and bool(sd.sol.converged)):
                log(f"[market] (e) point {i} left out: feasible {sd.feasible}, converged "
                    f"{bool(sd.sol.converged)}")
                continue
            points.append((p, sd, dt))
            if i < MARKET_SCREEN_POINTS:
                lp = prog0.instantiate({k: np.asarray(v) for k, v in p.items()},
                                       device=MARKET_DEVICE)
                w.add(lp, {"x": screen_targets(cset, sd.violated_outages)})
        w.flush()
        t0 = time.perf_counter()
        rep = tool.train([f"{tmp}/shards"], f"{tmp}/screener.npz", epochs=400, seed=0,
                         device=MARKET_DEVICE)
        train_s = time.perf_counter() - t0
        log(f"[market] (e) {len(points)} points labelled by full secure dispatches in "
            f"{label_s:.2f} s ({w.rows_written} rows, critical share "
            f"{rep['critical_share']:.3f}); screener trained in {train_s:.2f} s: "
            f"{ {k: rep['metrics'].get(k) for k in ('train_recall', 'train_shrink', 'recall', 'shrink')} }")
        checks = [("(c)'s base point", base, ctx["sd"], ctx["wall_s"])]
        if len(points) > MARKET_SCREEN_POINTS:
            p, sd, dt = points[-1]
            checks.append(("an unseen point", p, sd, dt))
        for tag, p, full, full_s in checks:
            t0 = time.perf_counter()
            sc = C.secure_dispatch(g, p, cset, screener=rep["artifact"], device=MARKET_DEVICE,
                                   **MARKET_KW)
            sc_s = time.perf_counter() - t0
            obj, ref = float(sc.sol.obj), float(full.sol.obj)
            rel = abs(obj - ref) / max(1.0, abs(ref))
            log(f"[market] (e) {tag}: screened set {sc.evaluated} of {sc.total_branch_ctg} "
                f"outages (shrink {sc.shrink_ratio:.3f}), {sc.rounds} rounds "
                f"({sc.rounds / sc_s:.2f} SCEDs/s) in {sc_s:.2f} s against the full set's "
                f"{full.rounds} rounds in {full_s:.2f} s ({full.rounds / full_s:.2f} SCEDs/s); "
                f"screened {sc.screened}, fallback {sc.screen_fallback}, feasible "
                f"{sc.feasible}, escaped {sc.escaped_violations}, objective rel {rel:.2e}")
            if not (sc.feasible and sc.escaped_violations == 0):
                _market_fail(f"(e) {tag}: screened dispatch feasible {sc.feasible}, escaped "
                             f"{sc.escaped_violations}")
            if not rel <= MARKET_SCREEN_OBJ_RTOL:
                _market_fail(f"(e) {tag}: screened objective rel {rel:.2e} > "
                             f"{MARKET_SCREEN_OBJ_RTOL}")
            out[tag] = dict(evaluated=sc.evaluated, total=sc.total_branch_ctg,
                            rounds=sc.rounds, wall_s=sc_s, full_rounds=full.rounds,
                            full_wall_s=full_s, screened=sc.screened,
                            fallback=sc.screen_fallback, obj_rel=rel)
    out.update(points=len(points), label_s=label_s, train_s=train_s)
    return out


def _market_stochastic():
    """(d) `test_stochastic_bidder.py`'s SimpleMarket double loop (3 days),
    the miscalibrated parametrized bidder against `StochasticBidder`."""
    from dispatches_tpu_torch.market import (
        Backcaster, DoubleLoopCoordinator, PEMParametrizedBidder, PerfectForecaster,
        RenewableGeneratorModelData, SimpleMarket, StaticGenerator, Tracker,
    )
    from dispatches_tpu_torch.market.double_loop import MultiPeriodWindPEM
    from dispatches_tpu_torch.market.stochastic import StochasticBidder

    daily_cf = np.array([0.7, 0.8, 0.9, 0.8, 0.6, 0.5, 0.4, 0.5] * 3)
    daily_lmp = np.array([5.0, 10.0, 15.0, 28.0, 40.0, 35.0, 12.0, 8.0] * 3)
    cfs = np.tile(daily_cf, 400)

    def wind_pem():
        md = RenewableGeneratorModelData(gen_name="309_WIND_1", bus="Carter", p_min=0.0,
                                         p_max=50.0, generator_type="renewable")
        return MultiPeriodWindPEM(model_data=md, wind_capacity_factors=cfs, wind_pmax_mw=50.0,
                                  pem_pmax_mw=20.0, h2_price_per_kg=1.25)

    def run(bidder):
        mo_track = wind_pem()
        tracker = Tracker(mo_track, tracking_horizon=4, n_tracking_hour=1, device=MARKET_DEVICE)
        coord = DoubleLoopCoordinator(bidder, tracker)
        fleet = [StaticGenerator(f"g{int(c)}", p, c) for p, c in (
            (100.0, 5.0), (60.0, 8.0), (60.0, 10.0), (60.0, 12.0), (80.0, 15.0),
            (80.0, 28.0), (60.0, 35.0), (120.0, 40.0))]
        price_to_demand = {5.0: 80, 8.0: 140, 10.0: 200, 12.0: 260, 15.0: 330,
                           28.0: 430, 35.0: 500, 40.0: 580}
        demand = np.array([price_to_demand[p] for p in daily_lmp])
        market = SimpleMarket(demand_mw=demand, fleet=fleet, day_ahead_horizon=24)
        res = market.simulate(coord, n_days=3, tracking_horizon=4)
        h2 = sum(r["H2 Production [kg/hr]"] for r in mo_track.result_list
                 if r["Horizon [hr]"] == 0)
        return sum(r["Revenue [$]"] for r in res) + h2 * 1.25

    rng = np.random.default_rng(0)
    hist = np.concatenate([daily_lmp + rng.normal(0, 1.0, 24) for _ in range(3)])
    fc = PerfectForecaster({"309_WIND_1-DACF": cfs, "309_WIND_1-RTCF": cfs,
                            "Carter-DALMP": np.tile(daily_lmp, 400),
                            "Carter-RTLMP": np.tile(daily_lmp, 400)})
    clock = _Clock()
    t0 = time.perf_counter()
    with _timed(clock, _market_patches()):
        p_param = run(PEMParametrizedBidder(wind_pem(), 24, 4, fc, pem_marginal_cost=5.0,
                                            pem_mw=20.0))
        t_param = time.perf_counter() - t0
        stoch = StochasticBidder(wind_pem(), day_ahead_horizon=24, real_time_horizon=4,
                                 forecaster=Backcaster(hist, n_historical_days=3), n_scenario=3,
                                 device=MARKET_DEVICE)
        p_stoch = run(stoch)
    wall = time.perf_counter() - t0
    worst = 0.0
    for (self_, T, scen, _cf), _kw, (pows, _sol) in clock.calls["scenario_lp"]:
        for t in range(T):
            ps = pows[np.argsort(scen[:, t], kind="stable"), t]
            worst = min(worst, float(np.diff(ps).min()))
    for row in stoch.bids_result_list:
        pw = [row[k] for k in sorted(row) if k.startswith("Power ")]
        cs = [row[k] for k in sorted(row) if k.startswith("Cost ")]
        worst = min(worst, float(np.diff(pw).min(initial=0.0)), float(np.diff(cs).min(initial=0.0)))
    n_lp = clock.n.get("scenario_lp", 0)
    lp_ms = clock.t.get("scenario_lp", 0.0) / max(n_lp, 1) * 1e3
    log(f"[market] (d) SimpleMarket 3 days: parametrized profit {p_param:.2f} $ "
        f"({t_param:.2f} s), stochastic {p_stoch:.2f} $ ({wall - t_param:.2f} s; ratio "
        f"{p_stoch / p_param:.4f}); {n_lp} scenario LPs, {lp_ms:.1f} ms each; worst bid-curve "
        f"dip {worst:.2e}")
    if worst < -1e-4:
        _market_fail(f"(d) a bid curve dips by {worst:.2e} < -1e-4")
    if not p_stoch > 1.02 * p_param:
        _market_fail(f"(d) stochastic profit {p_stoch} <= 1.02 x parametrized {p_param}")
    return dict(wall_s=wall, profit_parametrized=p_param, profit_stochastic=p_stoch,
                scenario_lps=n_lp, scenario_lp_ms=lp_ms, worst_dip=worst)


def phase_market():
    """The `market` phase (see the module docstring), on the card."""
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep

    t0 = time.perf_counter()
    chain_sweep.launches = 0
    dl = _market_doubleloop()
    net = _market_network73()
    grid = net.pop("grid")
    ctg = _market_contingency(grid)
    t1 = time.perf_counter()
    scr = _market_screener(grid, ctg.pop("_screen_ctx"))
    log(f"[market] (e) in {time.perf_counter() - t1:.1f} s")
    sto = _market_stochastic()
    launches = chain_sweep.launches
    log(f"[market] chain_sweep launches on the market path: {launches} (dense IPM only); "
        f"phase {time.perf_counter() - t0:.1f} s")
    if _MARKET_FAILS:
        raise AssertionError(f"market phase: {len(_MARKET_FAILS)} gates failed: {_MARKET_FAILS}")
    return dict(doubleloop=dl, network=net, contingency=ctg, screener=scr, stochastic=sto,
                launches=launches)


_PLANTS_FAILS = []
PLANTS_DEVICE = "cuda"  # the CPU rehearses the phase with "cpu" (and cuda calls stubbed)
F64_FLOPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores, published
# the reference's TES goldens and inlet specs (`tests/test_concrete_tes.py`)
TES_GOLDENS = ("INIT_T", "EXP_CHARGE_WALL_P1", "EXP_CHARGE_WALL_P2", "EXP_CHARGE_FLUID_P1",
               "EXP_CHARGE_HEAT_P1", "EXP_DISCHARGE_WALL_P1", "EXP_DISCHARGE_FLUID_P1",
               "EXP_COMBINED_WALL_P1", "EXP_COMBINED_WALL_P2")
TES_CHARGE = (0.00958 * 1000 / 18.01528 * 1e4, 19.6e6, 865.0)
TES_DISCHARGE = (3 / 18.01528 * 1e4, 8.5e5, 355.0)
TES_GRAD_FLOW = 5317.0  # `tests/test_concrete_tes.py:178`
# (c): the chain kernel's halvings a round timed in turns (a cluster of 1, 1,
# 2, 4, 8, 8 blocks a lane), every one held bitwise to levels 1
TES_LEVELS_SWEEP = (1, 3, 4, 5, 6, 7)
# (c): the store-hour walls of the serial kernel (one warp a lane, a halving at
# a time) in this script's plants (c), as PERF.md §2 records them
TES_HOURS_EARLIER = ("the serial kernel's (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §2): "
                     "charge 0.478 s, discharge 0.310 s, combined 0.439 s")


def _plants_fail(msg):
    """A failed gate of the plants phase: logged now, raised at its end."""
    log(f"[plants] GATE FAILED: {msg}")
    _PLANTS_FAILS.append(msg)


def _tes_goldens():
    """The golden arrays of `tests/test_concrete_tes.py`, read from its
    source (numpy expressions of literals; the file itself imports JAX)."""
    import ast

    path = os.path.join(ROOT, "tests", "test_concrete_tes.py")
    tree = ast.parse(open(path).read())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) in TES_GOLDENS):
            expr = compile(ast.Expression(node.value), path, "eval")
            out[node.targets[0].id] = np.asarray(eval(expr, {"np": np}), dtype=float)
    missing = set(TES_GOLDENS) - set(out)
    if missing:
        raise AssertionError(f"TES goldens not found in {path}: {sorted(missing)}")
    return out


def _tes_stored_gradient(device):
    """The charge-mode hour's stored energy at the reference geometry and
    its derivative in the charge flow (`tests/test_concrete_tes.py:170-180`)."""
    from dispatches_tpu_torch.units.concrete_tes import ConcreteTES, TESDesign, stream_from_pt

    init = torch.tensor(_tes_goldens()["INIT_T"], dtype=torch.float64, device=device)
    flow = torch.tensor(TES_GRAD_FLOW, dtype=torch.float64, device=device, requires_grad=True)
    res = ConcreteTES(TESDesign(), mode="charge").hour(
        init, charge=stream_from_pt(flow, TES_CHARGE[1], TES_CHARGE[2]))
    stored = torch.sum(res.wall_temp[-1] - init)
    (g,) = torch.autograd.grad(stored, flow)
    return float(stored.detach()), float(g)


def _cpu_tes_gradient(out_path):
    """`--cpu-tes-gradient`: the port's CPU value of `_tes_stored_gradient`
    (the plain chain), written as JSON; run as a child of the plants phase,
    on the cores that `_start_cpu_tes_gradient` gives it."""
    cores = os.environ.get("PLANTS_CHILD_CORES")
    if cores:
        _pin({int(c) for c in cores.split(",")})
    t0 = time.perf_counter()
    stored, grad = _tes_stored_gradient("cpu")
    with open(out_path, "w") as f:
        json.dump({"stored": stored, "grad": grad, "seconds": time.perf_counter() - t0}, f)


def _nlp_problems():
    """`tests/test_nlp.py`'s problems: (f, c, x0, l, u, max_iter)."""
    inf = float("inf")

    def none(x, p):
        return x[:0]

    return {
        "rosenbrock": (lambda x, p: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, none,
                       [-1.2, 1.0], [-inf], [inf], 200),
        "hs006": (lambda x, p: (1 - x[0]) ** 2,
                  lambda x, p: torch.stack([10.0 * (x[1] - x[0] ** 2)]),
                  [-1.2, 1.0], [-inf], [inf], 200),
        "bounds_active": (lambda x, p: (x[0] - 2.0) ** 2, none, [0.0], [-inf], [1.0], 100),
        "hs071_param": (
            lambda x, p: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
            lambda x, p: torch.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - 40.0,
                                      x[0] * x[1] * x[2] * x[3] - x[4]]),
            [1.0, 5.0, 5.0, 1.0, 25.0], [1.0, 1, 1, 1, 25], [5.0, 5, 5, 5, inf], 300),
        "fixed_equal_bounds": (lambda x, p: (x[1] - 3.0) ** 2 + x[0] * x[1], none,
                               [1.0, 0.0], [1.0, -inf], [1.0, inf], 100),
    }


def _x_close(got, ref, rtol=1e-8):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return bool(((got - ref).abs() <= rtol * torch.clamp(ref.abs(), min=1.0)).all())


def _plants_nlp():
    """(a) the NLP lane on the card against the port's CPU run."""
    from dispatches_tpu_torch.solvers.nlp import solve_nlp, solve_nlp_batch, solve_square

    f64 = torch.float64
    for name, (f, c, x0, l, u, mi) in _nlp_problems().items():
        sols = {}
        for dev in (PLANTS_DEVICE, "cpu"):
            t = lambda v, d=dev: torch.tensor(v, dtype=f64, device=d)  # noqa: E731
            sols[dev] = solve_nlp(f, c, t(x0), t(l), t(u), tol=1e-8, max_iter=mi)
        g, r = sols[PLANTS_DEVICE], sols["cpu"]
        log(f"[plants] (a) {name}: converged {bool(g.converged)} / cpu {bool(r.converged)}, "
            f"iterations {int(g.iterations)} / cpu {int(r.iterations)}, kkt {float(g.kkt_error):.2e}")
        if bool(g.converged) != bool(r.converged) or not bool(g.converged):
            _plants_fail(f"(a) {name}: converged {bool(g.converged)}, cpu {bool(r.converged)}")
        if not _x_close(g.x, r.x):
            _plants_fail(f"(a) {name}: x {g.x.tolist()} vs cpu {r.x.tolist()} beyond rel 1e-8")

    squares = {
        "mixing": (lambda x, q: torch.stack([x[0] - (q[0] + q[2]),
                                             x[0] * x[1] - (q[0] * q[1] + q[2] * q[3])]),
                   [1.0, 350.0], [2.0, 300.0, 1.0, 450.0], 50),
        "damped_exp": (lambda x, q: torch.exp(x) - 2.0, [10.0], None, 100),
    }
    for name, (F, x0, p, mi) in squares.items():
        sols = {dev: solve_square(F, torch.tensor(x0, dtype=f64, device=dev),
                                  None if p is None else torch.tensor(p, dtype=f64, device=dev),
                                  max_iter=mi)
                for dev in (PLANTS_DEVICE, "cpu")}
        g, r = sols[PLANTS_DEVICE], sols["cpu"]
        log(f"[plants] (a) square {name}: converged {bool(g.converged)}, iterations "
            f"{int(g.iterations)} / cpu {int(r.iterations)}, x {g.x.tolist()}")
        if not (bool(g.converged) and bool(r.converged)) or not _x_close(g.x, r.x):
            _plants_fail(f"(a) square {name}: {g.x.tolist()} vs cpu {r.x.tolist()}")

    # 64 seeded HS071-style lanes (the sphere constraint's radius varies)
    f, _, x0, l, u, _ = _nlp_problems()["hs071_param"]

    def c(x, p):
        return torch.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - p,
                            x[0] * x[1] * x[2] * x[3] - x[4]])

    rad = np.random.default_rng(0).uniform(30.0, 45.0, 64)

    def batch(dev, max_iter=300):
        t = lambda v: torch.tensor(np.asarray(v), dtype=f64, device=dev)  # noqa: E731
        return solve_nlp_batch(f, c, t(np.tile(x0, (64, 1))), t(l), t(u), params_batch=t(rad),
                               tol=1e-8, max_iter=max_iter)

    batch(PLANTS_DEVICE)  # warm the card's libraries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = batch(PLANTS_DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = batch("cpu")
    it_g, it_r = g.iterations.cpu().numpy(), r.iterations.numpy()
    loops = int(it_g.max())
    # a profiled window of the first 8 iterations (all 64 lanes live)
    prof = _profile_single_lps([lambda: batch(PLANTS_DEVICE, max_iter=8)])
    differ = int((it_g != it_r).sum())
    log(f"[plants] (a) 64-lane batch: converged {int(g.converged.sum())}/64 (cpu "
        f"{int(r.converged.sum())}), iterations {int(it_g.min())}..{loops}, lanes whose "
        f"iterations differ from the CPU's: {differ}, wall {wall:.3f} s, "
        f"{wall / loops * 1e3:.2f} ms per loop iteration; profiled 8 iterations: "
        f"{prof['launches'] / 8:.0f} launches and {prof['scalar_reads'] / 8:.1f} scalar reads "
        f"an iteration, device busy {prof['device_busy']:.3f}")
    if not torch.equal(g.converged.cpu(), r.converged) or not bool(g.converged.all()):
        _plants_fail("(a) 64-lane batch: converged flags differ from the CPU's or a lane failed")
    if not _x_close(g.x, r.x):
        _plants_fail("(a) 64-lane batch: x beyond rel 1e-8 of the CPU's")
    return dict(batch_wall_s=wall, batch_loops=loops, lanes_iterations_differ=differ,
                ms_per_iteration=wall / loops * 1e3,
                launches_per_iteration=prof["launches"] / 8,
                device_busy=prof["device_busy"])


def _square_patches(*mods):
    return [(m, "solve_square", lambda a, kw, m=m: m.__name__.rsplit(".", 1)[-1]) for m in mods]


def _plants_usc():
    """(b) the USC cycle's three goldens and the performance map."""
    from dispatches_tpu_torch.case_studies.fossil import usc_nlp as U

    clock = _Clock()
    out = {}
    with _timed(clock, _square_patches(U)):
        for tag, fn in (
            ("design", lambda: U.solve_usc_cycle(device=PLANTS_DEVICE)),
            ("power_300", lambda: U.solve_usc_for_power(300.0, device=PLANTS_DEVICE)),
            ("pressure_27", lambda: U.solve_usc_cycle(P_main=27e6, device=PLANTS_DEVICE)),
            ("map", lambda: U.derive_performance_map(points=(0.65, 1.0), device=PLANTS_DEVICE)),
        ):
            n0 = clock.n.get("usc_nlp", 0)
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sols = [rec[2] for rec in clock.calls.get("usc_nlp", [])[n0:]]
            its = [int(s.iterations) for s in sols]
            resid = max(float(s.kkt_error) for s in sols)
            out[tag] = dict(wall_s=wall, solves=len(sols), newton_iterations=its, residual=resid)
            log(f"[plants] (b) USC {tag}: {len(sols)} cycle solves, Newton iterations {its}, "
                f"residual {resid:.2e}, wall {wall:.2f} s")
            if tag == "design":
                if not (float(res.residual) < 1e-8 and abs(float(res.power_mw) / 436.466 - 1) <= 2e-4):
                    _plants_fail(f"(b) design: {float(res.power_mw)} MW (436.466 rel 2e-4)")
                log(f"[plants] (b) design power {float(res.power_mw):.4f} MW (golden 436.466)")
            elif tag == "power_300":
                flow, s = res
                log(f"[plants] (b) 300 MW: flow {flow:.3f} mol/s (golden 12,474.473), "
                    f"power {float(s.power_mw):.5f}")
                if not (abs(float(s.power_mw) - 300.0) <= 1e-3 and abs(flow / 12474.473 - 1) <= 5e-4):
                    _plants_fail(f"(b) 300 MW: flow {flow}, power {float(s.power_mw)}")
            elif tag == "pressure_27":
                p, d = float(res.power_mw), float(res.heat_duty_mw)
                log(f"[plants] (b) 27 MPa: {p:.3f} MW (446.15 rel 2e-3), duty {d:.2f} (940.4 rel 1e-3)")
                if not (float(res.residual) < 1e-8 and abs(p / 446.15 - 1) <= 2e-3
                        and abs(d / 940.4 - 1) <= 1e-3):
                    _plants_fail(f"(b) 27 MPa: {p} MW, {d} MWth")
            else:
                from dispatches_tpu_torch.case_studies.fossil.usc_plant import (
                    NLP_DESIGN_DUTY_MW, NLP_DESIGN_POWER_MW, NLP_DUTY_SLOPE, plant_heat_duty_mw,
                )

                ok = (abs(res["max_power_mw"] / 436.466 - 1) <= 2e-4
                      and 2.0 < res["duty_slope"] < 2.3
                      and abs(res["max_power_mw"] / NLP_DESIGN_POWER_MW - 1) <= 1e-4
                      and abs(res["max_duty_mw"] / NLP_DESIGN_DUTY_MW - 1) <= 2e-3
                      and abs(res["duty_slope"] / NLP_DUTY_SLOPE - 1) <= 5e-2
                      and all(abs(float(plant_heat_duty_mw(p)) / d - 1) <= 0.05
                              for p, d in zip(res["powers"], res["duties"])))
                log(f"[plants] (b) map: max {res['max_power_mw']:.3f} MW / {res['max_duty_mw']:.2f} "
                    f"MWth, slope {res['duty_slope']:.4f}, intercept {res['duty_intercept']:.2f}")
                if not ok:
                    _plants_fail(f"(b) performance map outside tests/test_usc_nlp.py's bounds: {res}")
    return out


def _tes_pass_inputs(walls, specs):
    """The chain kernel's inputs of one fluid pass (one lane a side)."""
    from dispatches_tpu_torch.properties import steam
    from dispatches_tpu_torch.units.concrete_tes import TESDesign, _side, stream_from_pt

    d = TESDesign()
    sides = [_side(d, stream_from_pt(*[torch.tensor(v, dtype=torch.float64, device=PLANTS_DEVICE)
                                       for v in spec]), mode) for spec, mode in specs]
    tw = torch.stack([walls.flip(-1) if s.reverse else walls for s in sides]).contiguous()
    h_eq = steam.enthalpy_pt(torch.stack([s.P for s in sides])[:, None], tw).contiguous()
    par = torch.stack([torch.stack([s.h_in0, s.c, s.P, *s.sat]) for s in sides]).contiguous()
    return tw, h_eq, par


def _plants_tes(grad_child):
    """(c) the concrete store at the reference geometry through the kernel."""
    from dispatches_tpu_torch.properties.steam import sat_temperature
    from dispatches_tpu_torch.units.concrete_tes import (
        CHAIN_LEVELS, NEWTON_ITERS, ConcreteTES, TESDesign, _tes_chain_plain, stream_from_pt, tes_chain,
    )

    gold = _tes_goldens()
    dev = dict(dtype=torch.float64, device=PLANTS_DEVICE)
    init = torch.tensor(gold["INIT_T"], **dev)
    D = TESDesign()

    def stream(spec):
        return stream_from_pt(*[torch.tensor(v, **dev) for v in spec])

    def hour(mode, **streams):
        t0 = time.perf_counter()
        res = ConcreteTES(D, mode=mode).hour(init, **streams)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def near(got, want, atol, rtol=0.0, tag=""):
        got = got.detach().cpu().numpy()
        err = float(np.max(np.abs(got - want) - rtol * np.abs(want)))
        if not err <= atol:
            _plants_fail(f"(c) {tag}: off the golden by {err + atol:.3g} (atol {atol}, rtol {rtol})")
        return float(np.max(np.abs(got - want)))

    n0 = tes_chain.launches
    res, wall_c = hour("charge", charge=stream(TES_CHARGE))
    hour_launches = tes_chain.launches - n0
    e = [near(res.wall_temp[0], gold["EXP_CHARGE_WALL_P1"], 0.1, tag="charge wall P1"),
         near(res.wall_temp[1], gold["EXP_CHARGE_WALL_P2"], 0.1, tag="charge wall P2"),
         near(res.charge_temp[0], gold["EXP_CHARGE_FLUID_P1"], 0.1, tag="charge fluid P1"),
         near(res.heat_rate[0], gold["EXP_CHARGE_HEAT_P1"], 0.5, 2e-3, tag="charge heat P1")]
    t_out, t_sat = float(res.charge_temp[-1, -1]), float(sat_temperature(19.6e6))
    if abs(t_out - t_sat) > 0.01:
        _plants_fail(f"(c) charge outlet {t_out} K, T_sat {t_sat} K")
    log(f"[plants] (c) charge hour: {wall_c:.3f} s, {hour_launches} kernel launches, "
        f"max |err| vs goldens {max(e):.4f}")
    res, wall_d = hour("discharge", discharge=stream(TES_DISCHARGE))
    e = [near(res.wall_temp[0], gold["EXP_DISCHARGE_WALL_P1"], 0.1, tag="discharge wall P1"),
         near(res.discharge_temp[0], gold["EXP_DISCHARGE_FLUID_P1"], 0.1, tag="discharge fluid P1")]
    if not bool((res.heat_rate < 0).all()):
        _plants_fail("(c) discharge: a heat rate is not negative")
    log(f"[plants] (c) discharge hour: {wall_d:.3f} s, max |err| vs goldens {max(e):.4f}")
    n0 = tes_chain.launches
    res, wall_m = hour("combined", charge=stream(TES_CHARGE), discharge=stream(TES_DISCHARGE))
    combined_launches = tes_chain.launches - n0
    e = [near(res.wall_temp[0], gold["EXP_COMBINED_WALL_P1"], 0.1, tag="combined wall P1"),
         near(res.wall_temp[1], gold["EXP_COMBINED_WALL_P2"], 0.1, tag="combined wall P2")]
    if abs(float(res.discharge_temp[0, 0]) - 750.64) > 0.5:
        _plants_fail(f"(c) combined discharge outlet {float(res.discharge_temp[0, 0])} K (750.64 +- 0.5)")
    log(f"[plants] (c) combined hour: {wall_m:.3f} s, {combined_launches} kernel launches "
        f"(both sides a launch), max |err| vs goldens {max(e):.4f}")
    small = (TES_DISCHARGE[0] * 0.01 / 3, *TES_DISCHARGE[1:])
    res, _ = hour("combined", charge=stream(TES_CHARGE), discharge=stream(small))
    w = res.wall_temp.cpu().numpy()
    if not (np.all(np.isfinite(w)) and np.max(np.abs(w[0] - gold["EXP_CHARGE_WALL_P1"])) <= 5.0):
        _plants_fail("(c) combined with a near-zero discharge: walls off the charge-only solution")

    t0 = time.perf_counter()
    stored, grad = _tes_stored_gradient(PLANTS_DEVICE)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    main_launches = tes_chain.launches

    levels = CHAIN_LEVELS
    log(f"[plants] (c) store-hour walls at levels {levels}: charge {wall_c:.3f} s, discharge "
        f"{wall_d:.3f} s, combined {wall_m:.3f} s; {TES_HOURS_EARLIER}")
    # where a combined hour's time goes: one profiled hour (after a warm one),
    # the chain kernel's device time against all device time and the wall;
    # these launches are not the main path's
    prof = _profile_single_lps(
        [lambda: hour("combined", charge=stream(TES_CHARGE), discharge=stream(TES_DISCHARGE))],
        kernel="tes_chain_kernel")
    prof["idle"] = 1.0 - prof["device_busy"]
    log(f"[plants] (c) profiled combined hour: wall {prof['wall_s']:.3f} s (under the profiler), "
        f"device busy {prof['device_busy']:.3f} (idle {prof['idle']:.3f}), device time "
        f"{prof['device_ms']:.1f} ms in {prof['launches']} launches, of which tes_chain "
        f"{prof['kernel_ms']:.1f} ms in {prof['kernel_launches']}; other kernels "
        f"{prof['device_ms'] - prof['kernel_ms']:.1f} ms; host reads of device scalars "
        f"{prof['scalar_reads']}")

    # the kernel against the plain chain on identical inputs: the combined
    # hour's first pass (two lanes); these launches are not the main path's
    tw, h_eq, par = _tes_pass_inputs(init, [(TES_CHARGE, "charge"), (TES_DISCHARGE, "discharge")])
    got, a = tes_chain(tw, h_eq, par)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, a_ref = _tes_chain_plain(tw, h_eq, par)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    sweep_levels = sorted({*TES_LEVELS_SWEEP, levels})
    # the work this data needs at each levels, per lane, counted by a CPU replay
    _, _, work = _tes_chain_plain(tw.cpu(), h_eq.cpu(), par.cpu(), count_levels=sweep_levels)
    lat_ns = _latency_ns()
    h_in = torch.cat([par[:, :1], ref[:, :-1]], -1)
    width = (h_in - h_eq).abs()
    err = (got - ref).abs()
    max_err = float(err.max())
    rel_w = float((err / torch.clamp(width, min=1e-300)).max())
    same = got == ref
    # where the outlets agree the paths agree, but for the last halvings,
    # whose bracket is narrower than an ulp of h (the weight moves by 2^-k)
    a_diff = float((a[same] - a_ref[same]).abs().max()) if bool(same.any()) else 0.0
    a_ok = a_diff <= 1e-9
    if not bool((err <= 1e-9 * width).all()):
        _plants_fail(f"(c) kernel vs plain: h_out off by {rel_w:.2e} of the bracket (1e-9)")
    if not a_ok:
        _plants_fail(f"(c) kernel vs plain: weights {a_diff:.2e} apart where the outlets agree")

    # the midpoint tree against the serial bisection (levels = 1), bitwise, on
    # this pass and on one whose brackets straddle the plateau (walls 750 ->
    # 420 K: the discharge side at 8.5e5 Pa starts liquid and ends in vapour)
    walls = torch.linspace(750.0, 420.0, D.num_segments, **dev)
    straddle = _tes_pass_inputs(walls, [(TES_CHARGE, "charge"), (TES_DISCHARGE, "discharge")])
    s_tw, s_heq, s_par = straddle
    s_ref, _ = tes_chain(s_tw, s_heq, s_par, levels=1)
    s_in = torch.cat([s_par[:, :1], s_ref[:, :-1]], -1)
    s_lo, s_hi = torch.minimum(s_in, s_heq), torch.maximum(s_in, s_heq)
    spans = ((s_lo < s_par[:, 4:5]) & (s_hi > s_par[:, 5:6])).sum(-1)
    if not bool((spans > 0).all()):
        _plants_fail(f"(c) the straddling input spans the plateau in {spans.tolist()} segments a lane")
    for tag, inputs in (("first pass", (tw, h_eq, par)), ("straddling pass", straddle)):
        h1, a1 = tes_chain(*inputs, levels=1)
        for m in sweep_levels:
            hm, am = tes_chain(*inputs, levels=m)
            if not (torch.equal(hm, h1) and torch.equal(am, a1)):
                _plants_fail(f"(c) {tag}: levels {m} not bitwise levels 1 (h_out "
                             f"{int((hm != h1).sum())}, a {int((am != a1).sum())} of {h1.numel()} differ)")
    log(f"[plants] (c) midpoint tree vs serial bisection: levels {sweep_levels} bitwise levels 1 "
        f"on the first pass and on the straddling pass (segments spanning [h_f, h_g] a lane: "
        f"{spans.tolist()})")

    # times a pass at each levels, in turns (median of 3 turns of 10)
    turns = {m: [] for m in sweep_levels}
    for _ in range(3):
        for m in sweep_levels:
            turns[m].append(_time_ms(lambda: tes_chain(tw, h_eq, par, levels=m), 10))
    times = {m: float(np.median(v)) for m, v in turns.items()}
    ms = times[levels]
    on_plateau = (ref > par[:, 4:5]) & (ref < par[:, 5:6])
    # the latency bound: each Newton step at least its shortest dependent
    # path in the kernel, tau = T*/T (a division), one 5-level shuffle-add
    # butterfly (the two sums reduce side by side), the update's division and
    # its add; the powers, products, clamps and the rounds' exchange are left
    # out, so the bound is low. The design's bound on a lane: its rounds with
    # a point off the plateau x 12 steps, plus the halvings of its
    # plateau-only rounds x a plateau bisection step; the longest lane's.
    # The serial bound: the serial path's Newton steps x the step.
    step_ns = 2 * lat_ns["div"] + 5 * lat_ns["shfl_add"] + lat_ns["add"]

    def design_bound(w):
        lane_ns = (w.newton_rounds * NEWTON_ITERS * step_ns
                   + w.plateau_halvings * lat_ns["plateau_step"])
        return float(lane_ns.max()) * 1e-6

    serial = work[1]
    path_steps = int((serial.region1 + serial.region2).max())
    serial_bound = path_steps * step_ns * 1e-6
    sweep = {}
    for m in sweep_levels:
        w, t = work[m], times[m]
        row = sweep[m] = dict(
            ms=t, rounds=int(w.rounds.max()), newton_rounds=int(w.newton_rounds.max()),
            latency_bound_ms=design_bound(w), share_of_latency_bound=design_bound(w) / t)
        log(f"[plants] (c) tes_chain levels {m}: {t:.4f} ms a pass ({row['rounds']} "
            f"rounds a lane, {row['newton_rounds']} with a Newton point on the longest); "
            f"design's latency bound {row['latency_bound_ms']:.4f} ms, share "
            f"{row['share_of_latency_bound']:.3f}; serial bound {serial_bound:.4f} ms; "
            f"{t * 1e6 / max(row['newton_rounds'] * NEWTON_ITERS, 1):.0f} ns a Newton step "
            f"of a round")
    latency_bound = sweep[levels]["latency_bound_ms"]
    # the throughput bound: a Newton step's operations are, per term of the
    # two tau-derivative sums, two powers, two products and two adds (region
    # 1: 34 terms, region 2: 43 + 9), and ~12 for tau, the enthalpy, cp and
    # the update. The function needs the serial path's steps only; the tree
    # points the kernel evaluates beyond them are speculative work, counted
    # apart (`evaluated_newton_steps`)
    w = work[1]
    flops = int(w.region1.sum()) * (6 * 34 + 12) + int(w.region2.sum()) * (6 * 52 + 12)
    steps = int((w.region1 + w.region2).sum())
    evaluated = int((work[levels].region1 + work[levels].region2).sum())
    bound_ops = flops / F64_FLOPS_PER_S * 1e3
    bytes_moved = 8 * (tw.numel() + h_eq.numel() + par.numel() + 2 * got.numel())
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound, by = (bound_ops, "operations") if bound_ops >= bound_bytes else (bound_bytes, "bytes")
    passes = combined_launches
    log(f"[plants] (c) kernel vs plain (2 lanes x 20 segments): max |h_out diff| {max_err:.3e} J/kg "
        f"({rel_w:.2e} of the bracket), bitwise-equal outlets {int(same.sum())}/{same.numel()}, "
        f"weights there within {a_diff:.2e} (1e-9), bitwise {bool(torch.equal(a[same], a_ref[same]))}; "
        f"outlets on the plateau {int(on_plateau.sum())}")
    log(f"[plants] (c) probe (ns, dependent): " + ", ".join(f"{k} {v:.2f}" for k, v in lat_ns.items()))
    log(f"[plants] (c) tes_chain at levels {levels}: {ms:.4f} ms a pass ({ms * passes:.1f} ms of "
        f"kernel an hour at {passes} launches); plain {plain_ms:.1f} ms a pass "
        f"({plain_ms * passes / 1e3:.1f} s an hour, {passes} x the pass); throughput bound "
        f"{bound:.5f} ms ({by}: {steps} Newton steps the function needs ({int(w.region1.sum())} "
        f"region 1, {int(w.region2.sum())} region 2), {flops} flops at the f64 rate; "
        f"{bytes_moved} bytes; the tree evaluates {evaluated} at levels {levels}); "
        f"design's latency bound {latency_bound:.4f} ms, share {latency_bound / ms:.3f} "
        f"(step floor {step_ns:.1f} ns: division {lat_ns['div']:.2f}, shuffle + add "
        f"{lat_ns['shfl_add']:.2f}, add {lat_ns['add']:.2f} ns; plateau step "
        f"{lat_ns['plateau_step']:.2f} ns); serial latency bound {serial_bound:.4f} ms "
        f"({path_steps} Newton steps on the serial path of the longest lane); library: none")

    tes_chain.launches = main_launches
    t0 = time.perf_counter()
    rc = grad_child["proc"].wait(timeout=PHASE_LIMITS_S["plants"])
    if rc != 0:
        raise RuntimeError(f"(c) the CPU gradient child exited with {rc}")
    with open(grad_child["path"]) as fh:
        cpu = json.load(fh)
    log(f"[plants] (c) waited {time.perf_counter() - t0:.1f} s for the CPU child")
    rel = abs(grad - cpu["grad"]) / abs(cpu["grad"])
    log(f"[plants] (c) stored-energy gradient in the charge flow: {grad:.12e} (card, {wall_g:.2f} s) "
        f"vs {cpu['grad']:.12e} (CPU plain chain, {cpu['seconds']:.1f} s): rel {rel:.2e}; "
        f"stored {stored:.6f} K vs {cpu['stored']:.6f}")
    if not (np.isfinite(grad) and grad > 0 and rel <= 1e-6):
        _plants_fail(f"(c) gradient {grad} vs CPU {cpu['grad']} (finite, > 0, rel 1e-6)")
    return dict(hour_s={"charge": wall_c, "discharge": wall_d, "combined": wall_m},
                launches_per_hour={"charge": hour_launches, "combined": combined_launches},
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, max_abs_err=max_err,
                latency_bound_ms=latency_bound, serial_latency_bound_ms=serial_bound,
                latency_ns=lat_ns, path_newton_steps=path_steps, levels=levels,
                levels_sweep=sweep, evaluated_newton_steps=evaluated,
                needed_newton_steps=steps, hour_profile=prof,
                rel_of_bracket=rel_w, grad=grad, grad_cpu=cpu["grad"], grad_wall_s=wall_g)


def _plants_scpc():
    """(d) the SCPC cycle and the SCPC + concrete-TES golden."""
    from dispatches_tpu_torch.case_studies.fossil import scpc_nlp as S
    from dispatches_tpu_torch.units.concrete_tes import ConcreteTES

    clock = _Clock()
    with _timed(clock, _square_patches(S) + [(ConcreteTES, "hour", lambda a, kw: "tes_hour")]):
        t0 = time.perf_counter()
        s = S.solve_scpc_cycle(device=PLANTS_DEVICE)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, tes = S.solve_scpc_with_tes(device=PLANTS_DEVICE)
        torch.cuda.synchronize()
        wall_tes = time.perf_counter() - t0
    its = [int(r[2].iterations) for r in clock.calls["scpc_nlp"]]
    log(f"[plants] (d) SCPC design: {float(s.power_mw):.3f} MW (692 +- 1), residual "
        f"{float(s.residual):.2e}, {wall:.2f} s; with TES: {float(res.power_mw):.3f} MW "
        f"(625 +- 1), {wall_tes:.2f} s of which the TES hour {clock.t['tes_hour']:.2f} s; "
        f"Newton iterations {its}")
    if not (float(s.residual) < 1e-8 and abs(float(s.power_mw) - 692.0) <= 1.0):
        _plants_fail(f"(d) SCPC design {float(s.power_mw)} MW")
    if not (float(res.residual) < 1e-8 and abs(float(res.power_mw) - 625.0) <= 1.0
            and float(tes.outlet_charge.enth_mol) < 30000.0):
        _plants_fail(f"(d) SCPC + TES {float(res.power_mw)} MW")
    return dict(design_mw=float(s.power_mw), tes_mw=float(res.power_mw), wall_s=wall,
                tes_wall_s=wall_tes, tes_hour_s=clock.t["tes_hour"])


def _plants_rankine():
    """(e) the Rankine stochastic design on the card."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.rankine import stochastic_optimization_problem as sop

    res = sop(15 + 20 * np.random.default_rng(0).random(6), max_iter=120, device=PLANTS_DEVICE)
    if not (res.converged and abs(res.p_max_mw / 10.0 - 1) <= 1e-2):
        _plants_fail(f"(e) unprofitable prices: {res}")
    res = sop(np.array([30.0, 60.0, 90.0, 150.0, 220.0, 300.0]), max_iter=200, device=PLANTS_DEVICE)
    op = res.op_power_mw
    if not (res.converged and res.p_max_mw > 50.0 and abs(op[-1] / res.p_max_mw - 1) <= 1e-2
            and op[0] <= op[-1] + 1e-6 and np.all(op >= 0.3 * res.p_max_mw - 1e-3)):
        _plants_fail(f"(e) profitable prices: {res}")
    lmp = P.load_rts303()["da_lmp"][:168]
    t0 = time.perf_counter()
    g = sop(lmp, device=PLANTS_DEVICE)
    wall = time.perf_counter() - t0
    r = sop(lmp, device="cpu")
    # one profiled iteration (the solve cut at max_iter=1: set-up and one step)
    prof = _profile_single_lps([lambda: sop(lmp, max_iter=1, device=PLANTS_DEVICE)])
    rel = abs(g.obj_usd - r.obj_usd) / abs(r.obj_usd)
    log(f"[plants] (e) Rankine N=168 (rts303 week 1, weights 8760/168): converged {g.converged}, "
        f"kkt {g.kkt_error:.2e} (tol 1e-6), {g.iterations} iterations (cpu {r.iterations}), "
        f"P_max {g.p_max_mw:.4f} MW, objective {g.obj_usd:.6e} vs cpu {r.obj_usd:.6e} (rel "
        f"{rel:.2e}), wall {wall:.2f} s ({wall / g.iterations * 1e3:.1f} ms an iteration); "
        f"one profiled iteration (with the solve's set-up): {prof['launches']} launches, "
        f"{prof['scalar_reads']} scalar reads, device busy {prof['device_busy']:.3f}")
    if not (g.converged and g.kkt_error < 1e-6 and rel <= 1e-6):
        _plants_fail(f"(e) N=168: converged {g.converged}, kkt {g.kkt_error}, rel {rel}")
    return dict(iterations=g.iterations, wall_s=wall, obj_rel_cpu=rel,
                launches_one_iteration=prof["launches"], device_busy=prof["device_busy"])


def _highs_profit(prog, params):
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy

    res = solve_lp_scipy(prog.instantiate(params, device="cpu"))
    return float(prog.eval_expr("profit", torch.as_tensor(res.x), params))


def _plants_dispatch():
    """(f) the USC + storage dispatch layer on the card."""
    from dispatches_tpu_torch.case_studies import fossil as F
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.market import Tracker
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy

    out = {}
    t0 = time.perf_counter()
    tanks = F.run_all_tank_scenarios(ndays=7, device=PLANTS_DEVICE)
    out["tanks_s"] = time.perf_counter() - t0
    prog = F.build_usc_storage_model(168, periodic_inventory=False).build()
    lmp = np.tile(F.MOD_RTS_LMP_24, 7)
    worst = 0.0
    for name, hot0 in F.TANK_SCENARIOS.items():
        want = _highs_profit(prog, {"lmp": lmp, "hot0": np.asarray(hot0),
                                    "power0": np.asarray(359.5)})
        rel = abs(float(tanks[name]["profit"]) - want) / abs(want)
        worst = max(worst, rel)
        if not (tanks[name]["converged"] and rel <= 1e-6):
            _plants_fail(f"(f) tank scenario {name}: profit rel {rel:.2e} vs HiGHS")
    log(f"[plants] (f) 3 tank scenarios x 168 h in one batch: {out['tanks_s']:.2f} s, worst "
        f"profit rel {worst:.2e} vs HiGHS")

    da = P.load_rts303()["da_lmp"][:168]
    t0 = time.perf_counter()
    pt = F.run_pricetaker_analysis(ndays=7, lmp=da, device=PLANTS_DEVICE)
    out["pricetaker_s"] = time.perf_counter() - t0
    prog = F.build_usc_storage_model(168, periodic_inventory=True).build()
    want = _highs_profit(prog, {"lmp": da, "hot0": np.asarray(F.TANK_SCENARIOS["hot_empty"]),
                                "power0": np.asarray((F.usc_plant.MIN_POWER_MW + 1
                                                      + F.usc_plant.MAX_POWER_MW) / 2.0)})
    rel = abs(float(pt["profit"]) - want) / abs(want)
    log(f"[plants] (f) price-taker, rts303 week 1: profit {float(pt['profit']):.2f} vs HiGHS "
        f"{want:.2f} (rel {rel:.2e}), {out['pricetaker_s']:.2f} s")
    if not (pt["converged"] and rel <= 1e-6):
        _plants_fail(f"(f) price-taker: rel {rel:.2e} vs HiGHS")

    for mode in ("charge", "discharge"):
        t0 = time.perf_counter()
        g = F.solve_superstructure(mode, device=PLANTS_DEVICE)
        wall = time.perf_counter() - t0
        r = F.solve_superstructure(mode, device="cpu")
        rel = max(abs(a.net_annual_value - b.net_annual_value) / abs(b.net_annual_value)
                  for a, b in zip(g["leaves"], r["leaves"]))
        same = (g["best"].fluid, g["best"].steam_leg) == (r["best"].fluid, r["best"].steam_leg)
        log(f"[plants] (f) superstructure {mode}: best {g['best'].fluid}/{g['best'].steam_leg} "
            f"(cpu {r['best'].fluid}/{r['best'].steam_leg}), worst leaf rel {rel:.2e}, {wall:.2f} s")
        if not (same and rel <= 1e-6):
            _plants_fail(f"(f) superstructure {mode}: best {same}, rel {rel:.2e}")

    tr = Tracker(F.MultiPeriodUsc(), tracking_horizon=4, n_tracking_hour=1, device=PLANTS_DEVICE)
    dispatch = 360.0 + 50.0 * np.sin(2 * np.pi * np.arange(28) / 24.0)
    t0 = time.perf_counter()
    gaps = []
    for h in range(24):
        sol = tr.track_market_dispatch(dispatch[h:h + 4], 0, h)
        if h in (0, 12):
            lp = tr.program.instantiate(tr._last_params, device="cpu")
            res = solve_lp_scipy(lp)
            obj = float(lp.c @ tr._last_x + lp.c0)
            ref = float(lp.c @ torch.as_tensor(res.x) + lp.c0)
            gaps.append(abs(obj - ref) / max(abs(ref), 1.0))
            if not (bool(sol.converged) and gaps[-1] <= 1e-6):
                _plants_fail(f"(f) tracking hour {h}: objective {obj} vs HiGHS {ref}")
    out["tracking_s"] = time.perf_counter() - t0
    dev = np.abs(np.asarray(tr.get_implemented_profile()) - dispatch[:24]).max()
    log(f"[plants] (f) MultiPeriodUsc tracking, 24 hourly solves: {out['tracking_s']:.2f} s, "
        f"worst deviation from the dispatch {dev:.2e} MW, hours 0 and 12 vs HiGHS rel "
        f"{[f'{x:.1e}' for x in gaps]}")
    if dev > 0.5:
        _plants_fail(f"(f) tracking deviates {dev} MW from a feasible dispatch")
    return out


def _pin(cores):
    """Pin every thread of this process to `cores`."""
    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(OSError):  # a thread that has ended
            os.sched_setaffinity(int(tid), cores)


def _start_cpu_tes_gradient():
    """Start the CPU reference of plants (c)'s gradient (the plain chain,
    ~10^7 eager ops, ~1 min) in a child process, so that it runs beside
    the card's work of the earlier phases. With four cores or more the
    child takes the last two and this process the rest until the child
    ends, so that the child stays off the cores that drive the earlier
    phases' timed, host-bound work."""
    path = os.path.join(tempfile.mkdtemp(prefix="plants_"), "cpu_tes_gradient.json")
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    cores = sorted(os.sched_getaffinity(0))
    split = len(cores) >= 4
    if split:
        env["PLANTS_CHILD_CORES"] = ",".join(map(str, cores[-2:]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-tes-gradient", path], env=env)
    if split:
        _pin(set(cores[:-2]))
        threading.Thread(target=_unpin_when_done, args=(proc, set(cores)), daemon=True).start()
        log(f"[plants] CPU child on cores {cores[-2:]}, this process on {cores[:-2]} "
            "until the child ends")
    return {"path": path, "proc": proc}


def _unpin_when_done(proc, cores):
    """Give this process all its cores back once the child has ended."""
    proc.wait()
    _pin(cores)


def phase_plants(child):
    """The `plants` phase (see the module docstring), on the card; `child`
    is `_start_cpu_tes_gradient`'s process."""
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.units.concrete_tes import tes_chain

    t0 = time.perf_counter()
    chain_sweep.launches = 0
    tes_chain.launches = 0
    out = {}
    for key, part in (("nlp", _plants_nlp), ("usc", _plants_usc),
                      ("tes", lambda: _plants_tes(child)), ("scpc", _plants_scpc),
                      ("rankine", _plants_rankine), ("dispatch", _plants_dispatch)):
        t1 = time.perf_counter()
        out[key] = part()
        log(f"[plants] {key} in {time.perf_counter() - t1:.1f} s")
    out["tes_chain_launches"] = tes_chain.launches
    out["chain_sweep_launches"] = chain_sweep.launches
    log(f"[plants] launches on the plants path: tes_chain {out['tes_chain_launches']}, "
        f"chain_sweep {out['chain_sweep_launches']} (NLPs and dense LPs only); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if out["tes_chain_launches"] == 0:
        _plants_fail("tes_chain was launched no time on the plants path")
    if _PLANTS_FAILS:
        raise AssertionError(f"plants phase: {len(_PLANTS_FAILS)} gates failed: {_PLANTS_FAILS}")
    return out


# ----------------------------------------------------------------------
# 12. cases: the nuclear and solar-hydrogen case studies, the detailed
# tank, and the market-surrogate pillar (see the module docstring)

_CASES_FAILS = []
CASES_DEVICE = "cuda"  # the CPU rehearses the phase with "cpu" at small sizes
CASES_HOURS = 8736  # rts303's DA and RT hours: the year of (b) and (c2)
CASES_GRID_BATCH = 60  # (b2): lanes a banded batch (halved while the card runs out of memory)
CASES_GRID_LANE = 34  # (b2): the lane held to HiGHS, (h2 price 1.5, PEM fraction 0.25)
CASES_H2_PRICE = 1.25  # (b1): $/kg H2
CASES_NPV_RTOL = 1e-3
CASES_SOLAR_WEEK = 168  # (c1)
# (c2): the solar year LP's factors turn f64 after the first iterations
# (`solve_lp_banded_escalated`): its mixed tier stalls at a scaled gap of
# ~1e-3. Its tolerance is the JAX package's year tier's: in every
# precision (f64 factors too) the iterations stop at a scaled gap of
# 6e-6..2.6e-5 after 60-67 of them (`tools/torch_banded_precision.py`)
CASES_SOLAR_TOL = 1e-6
CASES_BLENDS = (1.0, 0.3, 0.0)
CASES_TANK = (64, 168)  # (d): lanes, hourly steps
CASES_RUNS = 10_000  # (e): the sweep's runs (`tests/test_surrogate_scale.py`)
CASES_ARMA = 100  # (f): realizations
# (f): the ARMA's Fourier mean. The default (24, 168, 8760 h) holds one
# daily sinusoid, and rts303's hour-of-day profile (an evening peak of 56
# against a morning 7 $/MWh) is not one: its spread would come out 0.41 of
# the series'. The daily harmonics to 3 h keep it
CASES_ARMA_PERIODS = tuple(24.0 / k for k in range(1, 9)) + (168.0, 8760.0)
_H = np.arange(24)
# `tests/test_surrogate_scale.py`'s latent day prototypes (flat, morning
# peak, evening peak, midday bump, night valley)
CASES_PROTOS = np.stack([
    np.full(24, 0.55),
    0.25 + 0.55 * np.exp(-0.5 * ((_H - 8) / 2.5) ** 2),
    0.25 + 0.55 * np.exp(-0.5 * ((_H - 19) / 2.5) ** 2),
    0.15 + 0.75 * np.exp(-0.5 * ((_H - 13) / 3.5) ** 2),
    0.65 - 0.45 * np.exp(-0.5 * ((_H - 3) / 3.0) ** 2),
]).astype(np.float32)


def _cases_fail(msg):
    """A failed gate of the cases phase: logged now, raised at its end."""
    log(f"[cases] GATE FAILED: {msg}")
    _CASES_FAILS.append(msg)


def _csync():
    if CASES_DEVICE == "cuda":
        torch.cuda.synchronize()


def _cpeak_reset():
    if CASES_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _cpeak_gib():
    return torch.cuda.max_memory_allocated() / 2**30 if CASES_DEVICE == "cuda" else float("nan")


def _highs_async(pool, prog, params, expr):
    """HiGHS on the host, in a thread (its solve releases the GIL): the
    future's value is `expr` at HiGHS's solution."""
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    def run():
        t0 = time.perf_counter()
        res = solve_lp_scipy_sparse(prog, params)
        hp = {k: torch.as_tensor(np.asarray(v, float)) for k, v in params.items()}
        return float(prog.eval_expr(expr, torch.as_tensor(res.x), hp)), time.perf_counter() - t0

    return pool.submit(run)


def _banded_year(prog, params, hours, block_hours, tag, escalate=False, tol=None):
    """One banded batch of the year sweep's solver options on the card
    (with `escalate`, through `solve_lp_banded_escalated`: f64 factors, in
    the same SPIKE slabs, from its `ESCALATE_AT_ITER` on; `tol` for the
    sweep's own): (meta, blp, sol, wall s, launches)."""
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import (
        ESCALATE_AT_ITER, extract_time_structure, solve_lp_banded_batch,
        solve_lp_banded_escalated,
    )
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    meta = extract_time_structure(prog, hours, block_hours)
    kw = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)
    if tol is not None:
        kw["tol"] = tol
    _cpeak_reset()
    n0, by0 = chain_sweep.launches, dict(chain_sweep.launches_by_chains)
    t0 = time.perf_counter()
    blp = meta.instantiate(params, device=CASES_DEVICE)
    solve = solve_lp_banded_escalated if escalate else solve_lp_banded_batch
    sol = solve(meta, blp, **kw)
    _csync()
    wall = time.perf_counter() - t0
    by = {c: n - by0.get(c, 0) for c, n in chain_sweep.launches_by_chains.items()
          if n != by0.get(c, 0)}
    log(f"[cases] {tag}: {sol.x.shape[0] if sol.x.dim() > 1 else 1} lanes, Tb {meta.Tb} "
        f"blocks of {meta.mB} x {meta.nB}, {meta.p} border columns, slabs {kw.get('slabs')}: "
        f"wall {wall:.2f} s, iterations {sol.iterations.tolist()}, peak {_cpeak_gib():.2f} GiB, "
        f"chain_sweep launches {chain_sweep.launches - n0} (by chain count {by}), tol "
        f"{kw['tol']}" + (f"; f64 factors from iteration {ESCALATE_AT_ITER}" if escalate else ""))
    return meta, blp, sol, wall, chain_sweep.launches - n0


def _cases_flowsheet():
    """(a) the nuclear flowsheet goldens and the traditional TEA grid."""
    from dispatches_tpu_torch.case_studies.nuclear import solve_ne_flowsheet
    from dispatches_tpu_torch.case_studies.nuclear.tea import traditional_tea_enumeration

    dev = CASES_DEVICE
    r = solve_ne_flowsheet(np_capacity_mw=500.0, split_frac_grid=0.6, include_tank=False,
                           include_turbine=False, device=dev)
    pem = float(r.pem_out_mol)
    ok = abs(pem / 505.481 - 1) <= 1e-4 and abs(float(r.np_to_grid_kw) - 300e3) <= 1e-6
    r = solve_ne_flowsheet(np_capacity_mw=500.0, split_frac_grid=0.6, include_turbine=False,
                           flow_mol_to_pipeline=10.0, flow_mol_to_turbine=0.0, device=dev)
    hold_tank = float(r.tank_holdup_mol)
    ok &= abs(hold_tank / (1747732.3199 + 36000) - 1) <= 1e-4
    t0 = time.perf_counter()
    r = solve_ne_flowsheet(np_capacity_mw=500.0, split_frac_grid=0.6, flow_mol_to_pipeline=10.0,
                           flow_mol_to_turbine=10.0, device=dev)
    _csync()
    turb_s = time.perf_counter() - t0
    y = (r.turbine.n_out / r.turbine.n_out.sum()).cpu().numpy()
    hold_turb = float(r.tank_holdup_mol)
    ok &= abs(hold_turb / 1747732.3199 - 1) <= 1e-4
    ok &= abs(float(r.turbine.T_comp_out) / 793.42 - 1) <= 2e-2
    ok &= abs(y[0] - 0.00088043) <= 5e-4 and abs(y[2] / 0.73278 - 1) <= 2e-2
    ok &= abs(y[1] / 0.15276 - 1) <= 5e-2
    log(f"[cases] (a) flowsheet goldens on the card (golden in parentheses): PEM "
        f"{pem:.6f} mol/s (505.481), holdups {hold_tank:,.4f} (1,783,732.32) / "
        f"{hold_turb:,.4f} (1,747,732.32) mol, compressor outlet "
        f"{float(r.turbine.T_comp_out):.2f} K (793.42), y_H2 {y[0]:.3e}, y_N2 {y[2]:.5f}, "
        f"y_O2 {y[1]:.5f}; turbine chain {turb_s * 1e3:.1f} ms: {'hold' if ok else 'FAIL'}")
    if not ok:
        _cases_fail("(a) nuclear flowsheet goldens")
    t0 = time.perf_counter()
    tea = traditional_tea_enumeration(device=dev)
    npv = tea["net_npv"].cpu().numpy()
    _csync()
    tea_ms = (time.perf_counter() - t0) * 1e3
    mono = bool((np.diff(npv, axis=0) >= -1e-9).all()
                and (np.diff(tea["h2_rev"].cpu().numpy(), axis=1) > 0).all())
    log(f"[cases] (a) ne_traditional_tea over the 6 x 10 grid: {tea_ms:.2f} ms, NPV "
        f"{npv.min():.2f}..{npv.max():.2f} $M, monotone in price and ratio: {mono}")
    if not (npv.shape == (6, 10) and np.isfinite(npv).all() and mono):
        _cases_fail("(a) traditional TEA grid")
    return dict(tea_ms=tea_ms)


def _cases_nuclear(pool):
    """(b) the nuclear price-taker over a year, banded."""
    from dispatches_tpu_torch.case_studies.nuclear import pricetaker as NP
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import solve_lp_banded
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    H = CASES_HOURS
    data = P.load_rts303()
    da, rt = np.resize(data["da_lmp"], H), np.resize(data["rt_lmp"], H)
    out = {}
    chain_sweep.launches = 0  # this path's launches: counted from 0, read at its end
    cfg = NP.NuclearPricetakerConfig(T=H)
    prog = NP.build_nuclear_pricetaker(cfg)
    markets = ("DA", "RT", "Max-DA-RT")
    lanes = [NP._params(cfg, NP.settlement_prices(mk, da, rt), CASES_H2_PRICE) for mk in markets]
    stacked = {k: np.stack([p[k] for p in lanes]) for k in lanes[0]}
    highs_da = _highs_async(pool, prog, lanes[0], "annualized_npv")
    meta, _, sol, wall, n1 = _banded_year(prog, stacked, H, 24, "(b1) DA, RT, Max-DA-RT")
    x = sol.x.cpu()
    hp = {k: torch.as_tensor(v) for k, v in stacked.items()}
    npv = prog.eval_expr("annualized_npv", x, hp).numpy()
    # DA-RT's second step: the RT settlement LP with the DA lane's position
    disp = prog.eval_expr("net_power", x[0], {k: v[0] for k, v in hp.items()}).numpy()
    p2 = NP._params(cfg, rt, CASES_H2_PRICE, lmp_da=da, dispatch_da=disp)
    t0 = time.perf_counter()
    s2 = solve_lp_banded(meta, meta.instantiate(p2, device=CASES_DEVICE),
                         **year_sweep_solver_kw(torch.float64, Tb=meta.Tb))
    _csync()
    wall2 = time.perf_counter() - t0
    npv2 = float(prog.eval_expr("annualized_npv", s2.x.cpu(),
                                {k: torch.as_tensor(v) for k, v in p2.items()}))
    conv = sol.converged.tolist() + [bool(s2.converged)]
    log(f"[cases] (b1) annualized NPV at ${CASES_H2_PRICE}/kg: "
        + ", ".join(f"{mk} {v / 1e6:.4f} $M" for mk, v in zip(markets, npv))
        + f", DA-RT {npv2 / 1e6:.4f} $M (second step {wall2:.2f} s, {int(s2.iterations)} "
        f"iterations); LPs/s {3 / wall:.3f}; converged {conv}")
    if not all(conv):
        _cases_fail(f"(b1) nuclear year lanes not converged: {conv}")
    if not (npv[2] >= npv[0] - 1e-6 * abs(npv[0]) and npv[2] >= npv[1] - 1e-6 * abs(npv[1])):
        _cases_fail(f"(b1) Max-DA-RT {npv[2]} below DA {npv[0]} or RT {npv[1]}")
    out["b1"] = dict(wall_s=wall, npv=npv.tolist(), npv_da_rt=npv2, launches=n1,
                     iterations=sol.iterations.tolist(), second_step_s=wall2)

    # (b2) the report's grid, pinned PEM capacities
    cfg2, grid = NP.enumeration_params(da, T=H)
    prog2 = NP.build_nuclear_pricetaker(cfg2)
    L = grid["lmp"].shape[0]
    lane_p = {k: v[CASES_GRID_LANE] for k, v in grid.items()}
    highs_grid = _highs_async(pool, prog2, lane_p, "annualized_npv")
    batch, xs, iters, convs, walls, peaks, t0 = CASES_GRID_BATCH, [], [], [], [], [], time.perf_counter()
    n_grid0 = chain_sweep.launches
    start = 0
    while start < L:
        part = {k: v[start:start + batch] for k, v in grid.items()}
        try:
            _, _, s, w, _ = _banded_year(prog2, part, H, 24,
                                          f"(b2) grid lanes {start}..{start + len(part['lmp']) - 1}")
        except torch.OutOfMemoryError:
            if batch == 1:
                raise
            batch = max(1, batch // 2)
            torch.cuda.empty_cache()
            log(f"[cases] (b2) out of device memory: batches of {batch}")
            continue
        xs.append(s.x.cpu())
        iters += s.iterations.tolist()
        convs += s.converged.tolist()
        walls.append(w)
        peaks.append(_cpeak_gib())
        start += len(part["lmp"])
    grid_s = time.perf_counter() - t0
    n2 = chain_sweep.launches - n_grid0
    res = NP.enumeration_results(prog2, torch.cat(xs), grid, NP.ENUMERATION_H2_PRICES,
                                 NP.ENUMERATION_PEM_FRACS, H)
    F = len(NP.ENUMERATION_PEM_FRACS)
    cap = np.array([[res["pem_cap_factor"][f"{i}{j}"] for j in range(F)]
                    for i in range(len(NP.ENUMERATION_H2_PRICES))])
    log(f"[cases] (b2) {L} grid lanes in batches of {batch}: {grid_s:.2f} s ({L / grid_s:.3f} "
        f"LPs/s), iterations {min(iters)}..{max(iters)}, peak {max(peaks):.2f} GiB "
        f"({max(peaks) / min(batch, L):.3f} GiB a lane), chain_sweep launches {n2}")
    log("[cases] (b2) PEM capacity factor (rows: H2 price, columns: PEM fraction): "
        + "; ".join(" ".join(f"{v:.3f}" for v in row) for row in cap))
    if not all(convs):
        _cases_fail(f"(b2) grid lanes not converged: {[i for i, c in enumerate(convs) if not c]}")
    if not (np.diff(cap, axis=0) >= -1e-6).all():
        _cases_fail("(b2) the PEM capacity factor falls as the H2 price rises")
    # the gates against HiGHS, whose solves ran beside the card's
    (ref_da, hs_da), (ref_g, hs_g) = highs_da.result(), highs_grid.result()
    key = f"{CASES_GRID_LANE // F}{CASES_GRID_LANE % F}"
    rel_da = abs(npv[0] - ref_da) / abs(ref_da)
    rel_g = abs(res["net_npv"][key] * 1e6 - ref_g) / abs(ref_g)
    log(f"[cases] (b) HiGHS (on the host, beside the card): DA lane {ref_da / 1e6:.6f} $M "
        f"rel {rel_da:.2e} ({hs_da:.1f} s); grid lane {CASES_GRID_LANE} {ref_g / 1e6:.6f} $M "
        f"rel {rel_g:.2e} ({hs_g:.1f} s)")
    if not (rel_da <= CASES_NPV_RTOL and rel_g <= CASES_NPV_RTOL):
        _cases_fail(f"(b) NPV vs HiGHS: DA rel {rel_da:.2e}, grid rel {rel_g:.2e}")
    out["b2"] = dict(wall_s=grid_s, batch=batch, launches=n2, iterations=iters,
                     peak_gib=max(peaks), rel_highs=rel_g, cap_factor=cap.tolist())
    out["rel_highs_da"] = rel_da
    out["launches"] = chain_sweep.launches
    if out["launches"] <= 0 and CASES_DEVICE == "cuda":
        _cases_fail("(b) chain_sweep was launched no time on the nuclear year path")
    return out


def _solar_series(hours, seed=10):
    """Seeded synthetic PV CF, load (MW), reserve (MW) and NG price
    ($/MMBtu) of `hours`: the reference's input files are not in the
    repository."""
    rng = np.random.default_rng(seed)
    h = np.arange(hours)
    day = h // 24
    season = 0.75 + 0.25 * np.cos(2 * np.pi * (day - 172) / 365)
    clouds = np.repeat(rng.uniform(0.55, 1.0, day.max() + 1), 24)[: hours]
    pv = np.clip(np.sin(np.pi * ((h % 24) - 6) / 12), 0.0, None) * season * clouds
    load = 100.0 + 20.0 * np.sin(2 * np.pi * ((h % 24) - 12) / 24) + rng.normal(0, 3, hours)
    reserve = 15.0 + 0.1 * load
    ng = np.clip(3.0 + 0.5 * np.cos(2 * np.pi * day / 365) + rng.normal(0, 0.1, hours), 1.0, None)
    return pv, load, reserve, ng


def _cases_solar(pool):
    """(c) solar hydrogen: the week on the dense IPM, the year banded."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables import solar_hydrogen as S
    from dispatches_tpu_torch.obs.conformance import ConformancePolicy, kkt_certificates
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep
    from dispatches_tpu_torch.solvers.structured import _BASE_NDIM

    out = {}
    chain_sweep.launches = 0  # this path's launches: counted from 0, read at its end
    lmp = np.resize(P.load_rts303()["da_lmp"], CASES_HOURS)
    W = CASES_SOLAR_WEEK
    pv, load, reserve, ng = _solar_series(CASES_HOURS)
    week = (pv[:W], load[:W], reserve[:W], lmp[:W], ng[:W])
    futs, c1 = {}, {}
    for r in CASES_BLENDS:
        design = S.SolarHydrogenDesign(T=W, h2_blend_ratio=r)
        prog, _ = S.build_pricetaker(design)
        futs[r] = _highs_async(pool, prog, S.solar_hydrogen_params(W, *week), "NPV")
        t0 = time.perf_counter()
        res = S.pv_battery_hydrogen_optimize(W, *week, design=design, device=CASES_DEVICE)
        c1[r] = (res, time.perf_counter() - t0)
    worst = 0.0
    for r, (res, wall) in c1.items():
        ref, hs = futs[r].result()
        rel = abs(res["NPV"] - ref) / abs(ref)
        worst = max(worst, rel)
        log(f"[cases] (c1) blend {r}: NPV {res['NPV']:.6e} HiGHS {ref:.6e} rel {rel:.2e}, "
            f"{int(res['solution'].iterations)} iterations, {wall:.2f} s (HiGHS {hs:.1f} s), "
            f"PV {res['pv_kw'] / 1e3:.1f} MW, battery {res['batt_kw'] / 1e3:.1f} MW, PEM "
            f"{res['pem_kw'] / 1e3:.1f} MW, turbine {res['turb_kw'] / 1e3:.1f} MW")
        if not (res["converged"] and rel <= CASES_NPV_RTOL):
            _cases_fail(f"(c1) blend {r}: converged {res['converged']}, rel {rel:.2e}")
    out["c1_worst_rel"] = worst

    # (c2) the three blends over the year as one banded batch, 12-h blocks
    H = CASES_HOURS
    prog, _ = S.build_pricetaker(S.SolarHydrogenDesign(T=H, h2_blend_ratio=None,
                                                       ramp_wrap_border=True))
    base = S.solar_hydrogen_params(H, pv, load, reserve, lmp, ng)
    lanes = {k: np.stack([v] * len(CASES_BLENDS)) for k, v in base.items()}
    lanes["h2_blend"] = np.asarray(CASES_BLENDS)
    meta, blp, sol, wall, n_c2 = _banded_year(prog, lanes, H, 12, "(c2) blends 1.0, 0.3, 0.0",
                                              escalate=True, tol=CASES_SOLAR_TOL)
    axes = tuple(0 if a.dim() == _BASE_NDIM[f] + 1 else None for f, a in zip(blp._fields, blp))
    cert = kkt_certificates(blp, sol, axes=axes, meta=meta)
    pol = ConformancePolicy()
    bounds = np.array([pol.bound(f) for f in ("res_primal", "res_dual", "comp", "gap")])
    npv = prog.eval_expr("NPV", sol.x.cpu(), {k: torch.as_tensor(v) for k, v in lanes.items()})
    log(f"[cases] (c2) NPV " + ", ".join(f"{r}: {v:.6e}" for r, v in zip(CASES_BLENDS, npv.tolist()))
        + f"; certificates (res_primal, res_dual, comp, gap) "
        + "; ".join(" ".join(f"{v:.1e}" for v in row) for row in cert))
    if not bool(sol.converged.all()):
        _cases_fail(f"(c2) solar year lanes not converged: {sol.converged.tolist()}")
    if not (np.isfinite(cert).all() and (cert <= bounds).all()):
        _cases_fail("(c2) KKT certificates outside the default ConformancePolicy")
    out["c2"] = dict(wall_s=wall, iterations=sol.iterations.tolist(), launches=n_c2,
                     npv=npv.tolist(), certificates=cert.tolist(), mB=meta.mB, nB=meta.nB,
                     p=meta.p, Tb=meta.Tb)
    out["launches"] = chain_sweep.launches
    if out["launches"] <= 0 and CASES_DEVICE == "cuda":
        _cases_fail("(c) chain_sweep was launched no time on the solar year path")
    return out


def _launches_of(fn):
    """(device kernels launched, host wall s) of one call of `fn`, by the
    profiler on the card; (nan, wall) on the CPU."""
    if CASES_DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return float("nan"), time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n, wall


def _cases_tank():
    """(d) the detailed tank on the card."""
    from dispatches_tpu_torch.units.tank_detailed import HydrogenTankDetailed

    tank = HydrogenTankDetailed(tank_diameter=0.1, tank_length=0.3, dt=3600.0,
                                device=CASES_DEVICE)
    st0 = tank.initial_state(pressure=1e5, temperature=300.0)
    ok = True
    for fout, (n, T, P) in ((0.0, (3600.0945, 300.749, 3820683416.0)),
                            (0.9, (360.0945, 300.055, 381276652.0))):
        st = tank.step(st0, 1.0, 300.0, fout)
        got = [float(a) for a in st]
        ok &= abs(got[0] / n - 1) <= 1e-6 and abs(got[1] - T) <= 0.2 and abs(got[2] / P - 1) <= 1e-2
        log(f"[cases] (d) golden, out {fout} mol/s: holdup {got[0]:.4f} mol ({n}), "
            f"T {got[1]:.3f} K ({T}), P {got[2]:.4e} Pa ({P:.4e})")
    if not ok:
        _cases_fail("(d) tank fill/empty goldens")
    lanes, hours = CASES_TANK
    rng = np.random.default_rng(4)
    fin = torch.tensor(rng.uniform(0.5, 1.0, (lanes, hours)), device=CASES_DEVICE,
                       requires_grad=True)
    fout = torch.tensor(rng.uniform(0.0, 0.4, (lanes, hours)), device=CASES_DEVICE)
    st = tank.initial_state()
    launches, step_s = _launches_of(lambda: tank.step(
        type(st)(*(a.expand(lanes) for a in st)), fin[:, 0].detach(), 300.0, fout[:, 0]))
    t0 = time.perf_counter()
    traj = tank.simulate(st, fin, 300.0, fout)
    _csync()
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(traj.pressure[:, -1].sum(), fin)
    _csync()
    grad_s = time.perf_counter() - t0
    expect = float(st.holdup_mol) + 3600.0 * (fin.detach() - fout).sum(1)
    mass = float(((traj.holdup_mol[:, -1].detach() - expect).abs() / expect).max())
    log(f"[cases] (d) {lanes} lanes x {hours} h: {sim_s:.3f} s ({sim_s / hours * 1e3:.3f} ms a "
        f"step; one step {step_s * 1e3:.3f} ms, {launches} launches), gradient {grad_s:.3f} s, "
        f"mass rel {mass:.2e}, final pressure gradient finite "
        f"{bool(torch.isfinite(g).all())} and > 0 {bool((g > 0).all())}")
    if not (mass <= 1e-9 and bool(torch.isfinite(g).all())):
        _cases_fail(f"(d) tank: mass rel {mass:.2e} or a non-finite gradient")
    return dict(sim_s=sim_s, step_ms=step_s * 1e3, step_launches=launches, grad_s=grad_s,
                mass_rel=mass)


def _synth_sweep(rng, n_runs):
    """`tests/test_surrogate_scale.py`'s `_synth_sweep` (copied: that file
    imports JAX): (inputs (N,4), pmax, dispatch (N, 8736) f32, revenue (N,))
    from per-run mixtures of the latent day prototypes, some zero days."""
    n_days, K = 8736 // 24, len(CASES_PROTOS)
    inputs = rng.uniform(0.0, 1.0, (n_runs, 4)).astype(np.float32)
    inputs[:, 0] = 100.0 + 350.0 * inputs[:, 0]
    pmax = inputs[:, 0]
    unit = inputs.copy()
    unit[:, 0] = (pmax - 100.0) / 350.0
    Wm = rng.normal(0, 1, (4, K)).astype(np.float32)
    logits = unit @ Wm
    mix = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    u = rng.uniform(0, 1, (n_runs, n_days)).astype(np.float32)
    cdf = np.cumsum(mix, axis=1)
    day_proto = (u[:, :, None] > cdf[:, None, :]).sum(2)
    cf = CASES_PROTOS[day_proto]
    cf = cf + rng.normal(0, 0.02, cf.shape).astype(np.float32)
    cf = np.clip(cf, 0.0, 1.0)
    zero_frac = 0.3 * unit[:, 3]
    zero_days = rng.uniform(0, 1, (n_runs, n_days)) < zero_frac[:, None]
    cf[zero_days] = 0.0
    dispatch = (cf * pmax[:, None, None]).reshape(n_runs, 8736).astype(np.float32)
    revenue = (1e6 * unit[:, 0] + 4e5 * np.sin(np.pi * unit[:, 1])
               + 2e5 * unit[:, 2] * unit[:, 0] - 3e5 * unit[:, 3]
               + rng.normal(0, 1e4, n_runs)).astype(np.float32)
    return inputs, pmax, dispatch, revenue


def _cases_surrogates():
    """(e) the surrogate pillar at the reference's sweep scale."""
    from dispatches_tpu_torch.surrogates import SimulationData, TimeSeriesClustering, TrainNNSurrogates

    t0 = time.perf_counter()
    inputs, _, dispatch, revenue = _synth_sweep(np.random.default_rng(7), CASES_RUNS)
    sd = SimulationData(dispatch, inputs, case_type="RE")
    cf = sd.dispatch_capacity_factors().astype(np.float32)
    data_s = time.perf_counter() - t0
    tsc = TimeSeriesClustering(num_clusters=len(CASES_PROTOS))
    t0 = time.perf_counter()
    res = tsc.clustering_data(cf, seed=0, n_iter=20, n_init=2, device=CASES_DEVICE)
    km_s = time.perf_counter() - t0
    kept = res["labels"].shape[0]
    rms = [float(np.sqrt(((res["centers"] - p[None]) ** 2).mean(1)).min()) for p in CASES_PROTOS]
    log(f"[cases] (e) sweep {CASES_RUNS} runs x 8736 h made in {data_s:.1f} s (host); k-means "
        f"(k-means++ + 20 Lloyd steps, 2 restarts) over {kept} kept days in {km_s:.2f} s; "
        f"prototype rms {[f'{v:.4f}' for v in rms]}")
    if CASES_RUNS >= 10_000 and kept <= 2e6:
        _cases_fail(f"(e) only {kept} kept days")
    if max(rms) >= 0.05:
        _cases_fail(f"(e) a latent prototype not recovered (rms {max(rms):.3f})")
    trainer = TrainNNSurrogates(sd, {"cluster_centers": res["centers"]}, device=CASES_DEVICE)
    t0 = time.perf_counter()
    y = trainer.generate_label_data_frequency()
    label_s = time.perf_counter() - t0
    sums = float(np.abs(y.sum(1) - 1.0).max())
    t0 = time.perf_counter()
    sur_f, met_f = trainer.train_NN_frequency(hidden=(64, 64), epochs=150, lr=3e-3)
    _csync()
    freq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sur_r, met_r = trainer.train_NN_revenue(revenue, hidden=(64, 64), epochs=500, lr=3e-3)
    _csync()
    rev_s = time.perf_counter() - t0
    r2f, r2r = np.asarray(met_f["R2"]), np.asarray(met_r["R2"])
    log(f"[cases] (e) labels {label_s:.2f} s (rows sum to 1 within {sums:.1e}); training "
        f"frequency (150 epochs) {freq_s:.2f} s, revenue (500 epochs) {rev_s:.2f} s; R2 "
        f"frequency {np.round(r2f, 4).tolist()} (min {r2f.min():.4f}, mean {r2f.mean():.4f}), "
        f"revenue {r2r.min():.5f}")
    if not sums <= 1e-6:
        _cases_fail(f"(e) frequency labels sum to 1 within {sums:.1e}")
    if not (r2r.min() > 0.95 and r2f.min() > 0.6 and r2f.mean() > 0.75):
        _cases_fail(f"(e) R2 below `tests/test_surrogate_scale.py`'s thresholds")
    return dict(kmeans_s=km_s, label_s=label_s, train_freq_s=freq_s, train_rev_s=rev_s,
                data_s=data_s, kept=kept, rms=rms, r2_freq=r2f.tolist(),
                r2_rev=r2r.tolist()), (sur_r, sur_f, res["centers"])


def _no_worse(tag, best, grid_best):
    """A design's optimum against the best point of a brute-force grid over
    its box (maximized NPV)."""
    ok = best >= grid_best - 1e-6 * abs(grid_best)
    log(f"[cases] (f) {tag}: optimum {best:.8e}, best grid point {grid_best:.8e}: "
        f"{'no worse' if ok else 'WORSE'}")
    if not ok:
        _cases_fail(f"(f) {tag}: optimum {best} below the grid's {grid_best}")


def _cases_designs(surrogates):
    """(f) the designs that embed (e)'s networks, and ARMA."""
    import dataclasses

    from torch.func import vmap

    from dispatches_tpu_torch.case_studies.nuclear import conceptual_design as NCD
    from dispatches_tpu_torch.case_studies.rankine import surrogate_design as RS
    from dispatches_tpu_torch.case_studies.renewables import conceptual_design as RCD
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.surrogates import surrogate_fn
    from dispatches_tpu_torch.tea.arma import fit_arma, generate

    dev, f64 = CASES_DEVICE, torch.float64
    sur_r, sur_f, centers = surrogates
    net_r, net_f = surrogate_fn(sur_r), surrogate_fn(sur_f)

    def sweep_box(x, lo, hi):
        """A design's 4 surrogate inputs mapped affinely onto the synthetic
        sweep's input box (pmax 100-450 MW, the rest in [0, 1]), so that
        (e)'s networks are evaluated where they were trained: input i runs
        from lo[i] to hi[i] across the box."""
        lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
        hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
        u = (x - lo_t) / (hi_t - lo_t)
        scale = torch.tensor([350.0, 1.0, 1.0, 1.0], dtype=x.dtype, device=x.device)
        shift = torch.tensor([100.0, 0.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
        return shift + scale * u

    # the wind + PEM design's inputs: [PEM bid, PEM size x wind / 847 MW,
    # reserve %, shortfall price]; the size first, as the sweep's pmax
    re_lo, re_hi = [127.5, 15.0, 0.0, 0.0], [423.5, 45.0, 100.0, 1000.0]

    def rev_fn(x):
        return net_r(sweep_box(torch.stack([x[1], x[0], x[2], x[3]]), re_lo, re_hi))

    def freq_fn(x):
        return net_f(sweep_box(torch.stack([x[1], x[0], x[2], x[3]]), re_lo, re_hi))
    # the frequency net's bins: zero days, the k clusters, full days
    dis_cf = np.concatenate([[0.0], centers.mean(1), [1.0]])
    d = RCD.ConceptualDesignInputs(dispatch_cf=dis_cf, pem_cf=np.full(dis_cf.size, 0.3),
                                   wind_cf=np.clip(dis_cf + 0.2, 0.0, 1.0))
    out = {}
    t0 = time.perf_counter()
    res = RCD.conceptual_design_dynamic_RE(d, rev_fn, freq_fn, device=dev)
    out["re_s"] = time.perf_counter() - t0
    log(f"[cases] (f) conceptual_design_dynamic_RE: converged {res['converged']} in "
        f"{res['iterations']} iterations, {out['re_s']:.2f} s; PEM {res['pem_mw']:.2f} MW, "
        f"bid {res['pem_bid']:.3f}, NPV {res['NPV']:.6e}")
    sizes = torch.linspace(d.pem_cap_bounds_mw[0] * 1e3, d.pem_cap_bounds_mw[1] * 1e3, 61,
                           dtype=f64, device=dev)
    bids = torch.linspace(*d.pem_bid_bounds, 61, dtype=f64, device=dev)
    S_, B_ = torch.meshgrid(sizes, bids, indexing="ij")
    wind = torch.full_like(S_.reshape(-1), d.wind_mw * 1e3)
    with torch.no_grad():
        vals = vmap(lambda w, s, b: RCD._npv_terms(w, s, b, d, rev_fn, freq_fn))(
            wind, S_.reshape(-1), B_.reshape(-1))
    if not res["converged"]:
        _cases_fail("(f) conceptual_design_dynamic_RE did not converge")
    _no_worse("wind + PEM design (61 x 61 grid of size x bid)", res["NPV"], float(vals.max()))

    free = dataclasses.replace(d, extant_wind=False)
    bid_pts, mw_pts = np.linspace(20.0, 40.0, 4), np.linspace(150.0, 400.0, 4)
    t0 = time.perf_counter()
    sw = RCD.design_sweep(free, rev_fn, freq_fn, bid_pts, mw_pts, device=dev)
    out["sweep_s"] = time.perf_counter() - t0
    winds = torch.linspace(free.wind_cap_bounds_mw[0] * 1e3, free.wind_cap_bounds_mw[1] * 1e3,
                           201, dtype=f64, device=dev)
    g = torch.as_tensor(np.stack([sw["pem_bid"], sw["pem_mw"]], 1), dtype=f64, device=dev)
    with torch.no_grad():
        best = vmap(lambda p: vmap(lambda w: RCD._npv_terms(
            w, p[1] * 1e3, p[0], free, rev_fn, freq_fn))(winds).max())(g).cpu().numpy()
    log(f"[cases] (f) design_sweep 4 x 4 (bid, size), wind free, one solve_nlp_batch: "
        f"{out['sweep_s']:.2f} s, converged {int(sw['converged'].sum())} of 16, wind "
        f"{np.round(sw['wind_mw'], 1).tolist()} MW")
    if not sw["converged"].all():
        _cases_fail("(f) design_sweep lanes not converged")
    worst = float(np.min((sw["NPV"] - best) / np.abs(best)))
    _no_worse(f"design_sweep (each lane against 201 wind sizes; worst lane rel {worst:.2e})",
              float(sw["NPV"][int(np.argmin((sw['NPV'] - best) / np.abs(best)))]),
              float(best[int(np.argmin((sw['NPV'] - best) / np.abs(best)))]))

    # the nuclear design's inputs: [threshold price, PEM/NPP ratio, reserve,
    # max LMP]; the ratio first, as the sweep's pmax; the revenue network's
    # output ($/yr of the sweep) stands for the NPP's electricity revenue
    ne_lo, ne_hi = [0.05, 0.0, 0.0, 0.0], [0.5, 100.0, 100.0, 1000.0]

    def ne_rev_fn(x):
        return net_r(sweep_box(torch.stack([x[1], x[0], x[2], x[3]]), ne_lo, ne_hi))

    def cf_fn(x):
        return 0.98 - 0.5 * x[1]

    t0 = time.perf_counter()
    ne = NCD.conceptual_design_ss_NE(ne_rev_fn, cf_fn, h2_price=2.0, device=dev)
    out["ne_s"] = time.perf_counter() - t0
    rs = torch.linspace(*NCD.RATIO_BOUNDS, 2001, dtype=f64, device=dev)
    with torch.no_grad():
        nvals = vmap(lambda r: NCD.ne_objective(r, 2.0, 10.0, 500.0, ne_rev_fn, cf_fn)[0])(rs)
    log(f"[cases] (f) conceptual_design_ss_NE (the revenue network, an analytic CF): ratio "
        f"{float(ne.pem_np_cap_ratio):.4f}, objective {float(ne.objective):.6e} $, "
        f"{out['ne_s']:.2f} s")
    _no_worse("nuclear PEM sizing (2001 ratios; objective negated)", -float(ne.objective),
              -float(nvals.min()))

    def rv(inp):
        return torch.reshape(0.5 * inp[0] - 0.05 * (inp[5] - 18.0) ** 2, (1,))

    def ns(inp):
        return torch.reshape(50.0 - 2.0 * inp[3], (1,))

    def zf(inp):
        return torch.linspace(2.0, 1.0, 11, dtype=inp.dtype, device=inp.device) * (1.0 + 0.001 * inp[0])

    t0 = time.perf_counter()
    rk = RS.conceptual_design_problem_nn(rv, ns, zf, device=dev)
    out["rankine_s"] = time.perf_counter() - t0
    terms, lo, hi = RS.market_design_problem(rv, ns, zf, device=dev)
    axes = [torch.linspace(a, b, 9 if i == 0 else 3, dtype=f64, device=dev)
            for i, (a, b) in enumerate(zip(lo, hi))]
    pts = torch.cartesian_prod(*axes)
    with torch.no_grad():
        rvals = torch.cat([vmap(lambda x: terms(x)[0])(c) for c in pts.split(8192)])
    log(f"[cases] (f) conceptual_design_problem_nn (analytic stand-ins): converged "
        f"{rk['converged']} in {rk['iterations']} iterations, {out['rankine_s']:.2f} s; pmax "
        f"{rk['pmax_mw']:.2f} MW, NPV {rk['obj_npv_usd']:.6e} $")
    if not rk["converged"]:
        _cases_fail("(f) conceptual_design_problem_nn did not converge")
    _no_worse(f"Rankine market design ({pts.shape[0]}-point grid, $M)", rk["obj_npv_usd"] / 1e6,
              float(rvals.max()))

    series = np.resize(P.load_rts303()["da_lmp"], 8736)
    t0 = time.perf_counter()
    model = fit_arma(series, fourier_periods=CASES_ARMA_PERIODS)
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    sims = generate(model, 8736, gen, n_realizations=CASES_ARMA, device=dev)
    _csync()
    gen_s = time.perf_counter() - t0
    sims = sims.cpu().numpy()
    mean_rel = abs(sims.mean() - series.mean()) / abs(series.mean())
    spread = np.ptp(sims.reshape(CASES_ARMA, -1, 24).mean(axis=(0, 1)))
    ref_spread = np.ptp(series.reshape(-1, 24).mean(0))
    spread_rel = abs(spread - ref_spread) / ref_spread
    log(f"[cases] (f) ARMA(2, 1) fit on rts303's DA LMPs (seasonal mean: 8 daily harmonics, "
        f"weekly, annual) {fit_s:.2f} s; {CASES_ARMA} x 8736 h "
        f"generated in {gen_s:.2f} s; mean {sims.mean():.3f} against {series.mean():.3f} "
        f"(rel {mean_rel:.3f}), hour-of-day spread {spread:.3f} against {ref_spread:.3f} "
        f"(rel {spread_rel:.3f})")
    if not (mean_rel <= 0.10 and spread_rel <= 0.20 and np.isfinite(sims).all()):
        _cases_fail(f"(f) ARMA realizations: mean rel {mean_rel:.3f}, spread rel {spread_rel:.3f}")
    out.update(arma_fit_s=fit_s, arma_gen_s=gen_s, arma_mean_rel=mean_rel,
               arma_spread_rel=spread_rel)
    return out


def phase_cases():
    """The `cases` phase (see the module docstring), on the card."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    out = {}
    with ThreadPoolExecutor(2) as pool:  # HiGHS references beside the card's work
        parts = (("flowsheet", _cases_flowsheet), ("nuclear", lambda: _cases_nuclear(pool)),
                 ("solar", lambda: _cases_solar(pool)), ("tank", _cases_tank))
        for key, part in parts:
            t1 = time.perf_counter()
            out[key] = part()
            log(f"[cases] {key} in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["surrogates"], nets = _cases_surrogates()
    log(f"[cases] surrogates in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["designs"] = _cases_designs(nets)
    log(f"[cases] designs in {time.perf_counter() - t1:.1f} s")
    log(f"[cases] chain_sweep launches: nuclear {out['nuclear']['launches']}, solar "
        f"{out['solar']['launches']}; phase {time.perf_counter() - t0:.1f} s")
    if _CASES_FAILS:
        raise AssertionError(f"cases phase: {len(_CASES_FAILS)} gates failed: {_CASES_FAILS}")
    return out


# ------------------------------------------------------------------ learn
LEARN_TOOLS = ("torch_train_warmstart", "torch_train_screener", "torch_train_laneroute",
               "torch_lane_report")


def _learn_neutral():
    """A small dense batch served with the lane observatory probing every
    solve and the time-series store on, against the same batch with both
    off; and the adaptive entry with the observatory on. Bitwise, and the
    probes' device wall printed (the plane's cost)."""
    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.obs.lanes import as_lanes
    from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
    from dispatches_tpu_torch.serve import make_dense_service

    A = np.random.default_rng(7).standard_normal((4, 8))

    def row(seed):
        r = np.random.default_rng(seed)
        return LPData(A, A @ r.uniform(0.5, 3.5, 8), r.standard_normal(8), np.zeros(8),
                      np.full(8, 4.0), np.float64(0.0))

    rows = [row(s) for s in range(16)]
    got, walls = {}, {}
    for on in (False, True):
        svc = make_dense_service(8, cache_size=None, device=LEARN_DEVICE, timeseries=on,
                                 lanes={"probe_fraction": 1.0, "max_probes_per_tick": 16}
                                 if on else None)
        t0 = time.perf_counter()
        tickets = [svc.submit(r) for r in rows]
        svc.drain()
        walls[on] = time.perf_counter() - t0
        got[on] = [t.result(0).solution for t in tickets]
        if on:
            rep = svc.lanes.report()
            series = svc.store.stats()["series"]
    same = all(_np_same(a, b) for x, y in zip(got[False], got[True]) for a, b in zip(x, y))
    lp = _dense_lp(rows[:8], device=LEARN_DEVICE)
    obs = as_lanes({"probe_fraction": 1.0})
    same_a = _all_same(solve_lp_adaptive(lp), solve_lp_adaptive(lp, lanes=obs))
    one = LPData(*(a[0] for a in lp))
    same_a &= _all_same(solve_lp_adaptive(one), solve_lp_adaptive(one, lanes=obs))
    probes = obs.run_probes()
    outcomes = obs.report()["outcomes"]
    per = (obs.report()["probe_wall_seconds"] / len(probes)) if probes else float("nan")
    log(f"[learn] neutrality: 16 LPs served with lanes (probe rate 1.0) and timeseries: "
        f"{'bitwise equal to' if same else 'DIFFER from'} the service without them "
        f"({walls[True]:.2f} s against {walls[False]:.2f} s; {rep['probes_run']} probes, "
        f"{rep['probe_wall_seconds']:.3f} s inside them, outcomes {rep['outcomes']}, "
        f"{series} series); adaptive entry with lanes "
        f"{'bitwise' if same_a else 'DIFFERS'}; its {len(probes)} probe(s) {per * 1e3:.1f} ms "
        f"each, outcomes {outcomes}")
    if not (same and same_a):
        raise AssertionError("lanes= / timeseries= moved a solve's bits")
    return dict(bitwise=True, probes=rep["probes_run"], probe_wall_s=rep["probe_wall_seconds"],
                served_wall_on_s=walls[True], served_wall_off_s=walls[False],
                adaptive_probe_ms=per * 1e3)


# the learn tools' child processes, killed when the script ends
_LEARN_CHILDREN = []


def phase_learn():
    """The `learn` phase (see the module docstring), on the card. The four
    tools' self-checks run as child processes started together (each
    reaches the card on its own, the host has a core for each, and none
    keeps the card busy), the planes' neutrality in this process
    meanwhile. Each child's output is printed when it has ended."""
    out = {}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    ends, procs = {}, {}
    t0 = time.perf_counter()
    for name in LEARN_TOOLS:
        f = tempfile.TemporaryFile(mode="w+")
        p = subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", f"{name}.py"),
                              "--self-check", "--device", LEARN_DEVICE],
                             cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
        _LEARN_CHILDREN.append(p)
        procs[name] = (p, f)

        def wait(name=name, p=p):
            p.wait()
            ends[name] = time.perf_counter() - t0

        threading.Thread(target=wait, daemon=True).start()
    try:
        t1 = time.perf_counter()
        out["neutral"] = _learn_neutral()
        log(f"[learn] neutrality in {time.perf_counter() - t1:.1f} s")
        for name, (p, f) in procs.items():
            rc = p.wait(timeout=PHASE_LIMITS_S["learn"])
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[learn]   {name} | {line}")
            dt = ends.get(name, time.perf_counter() - t0)
            log(f"[learn] {name} --self-check on {LEARN_DEVICE}: rc {rc}, ended {dt:.1f} s "
                "after the four started")
            if rc != 0:
                raise AssertionError(f"{name} --self-check failed on {LEARN_DEVICE} (rc {rc})")
            out[name] = dict(rc=rc, seconds=dt)
    finally:
        for p, f in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return out


# ------------------------------------------------------------------ horizon
HORIZON_DEVICE = "cuda"  # the CPU rehearses the phase with "cpu" at a short horizon
HORIZON_HOURS = 8736  # rts303's DA hours
HORIZON_CHUNK = 168  # a chunk a week: the dense IPM's weekly shape, 52 lanes a sweep
# ADMM sweeps from the coarse warm start and the hours of its steps: the
# defaults of `wind_battery_horizon_solve`. The last solve's residual is not
# monotone in the sweeps (at 20 it read 14.4 kWh; PERF.md §6)
HORIZON_SWEEPS = 80
HORIZON_AGG = 4
HORIZON_RESIDUAL = 1.0  # kWh: the boundary mismatch bound of tests/test_time_axis.py:126,131
# the objective's gap to HiGHS on the monolithic LP, (obj - ref) / |ref|,
# set from a CPU run of both packages at T = 672 (PERF.md §6): no worse than
# the JAX package's documented worst (3.2% at T = 672,
# tests/test_time_axis.py:160-170), and not below the monolithic optimum by
# more than the consensus slack allows
HORIZON_GAP = (-1e-3, 3.2e-2)


def _horizon_mono(hours):
    """The monolithic wind + battery LP over `hours` (tests/test_time_axis.py's
    `_monolithic`): the program and rts303's parameters."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.core.model import Model
    from dispatches_tpu_torch.units.battery import BatteryStorage
    from dispatches_tpu_torch.units.splitter import ElectricalSplitter
    from dispatches_tpu_torch.units.wind import WindPower

    data = P.load_rts303()
    m = Model("horizon_mono")
    wind = WindPower(m, hours, capacity=P.FIXED_WIND_MW * 1e3, cf_param="wind_cf")
    split = ElectricalSplitter(m, hours, inlet=wind.electricity_out,
                               outlet_list=["grid", "battery"])
    batt = BatteryStorage(m, hours, duration=P.BATTERY_DURATION_HRS,
                          charging_eta=P.BATTERY_EFF, discharging_eta=P.BATTERY_EFF,
                          degradation_rate=P.BATTERY_DEGRADATION, power_capacity=25e3,
                          initial_soc=0.0, initial_throughput=0.0, periodic_soc=True)
    m.add_eq(batt.elec_in - split.outlets["battery"])
    lmp = m.param("lmp", hours)
    rev = 1e-3 * (lmp * (split.outlets["grid"] + batt.elec_out))
    profit = rev.sum() - (P.BATT_REP_COST_KWH * P.BATTERY_DEGRADATION) * (
        batt.throughput[hours - 1: hours].sum())
    m.minimize(-profit * 1e-5)
    return m.build(), {"lmp": data["da_lmp"][:hours], "wind_cf": data["da_wind_cf"][:hours]}


def _horizon_highs(out_path):
    """`--horizon-highs`: HiGHS on the monolithic horizon LP, its objective
    and seconds written as .npz; a child started with the script on the
    cores `_start_year_highs` gives its child."""
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    cores = os.environ.get("YEAR_HIGHS_CORES")
    if cores:
        _pin({int(c) for c in cores.split(",")})
    t0 = time.perf_counter()
    prog, params = _horizon_mono(HORIZON_HOURS)
    res = solve_lp_scipy_sparse(prog, params)
    np.savez(out_path, obj=res.obj_with_offset, seconds=time.perf_counter() - t0,
             shape=np.array([prog.M, prog.N]))


def _start_horizon_highs():
    """Start `_horizon_highs` in a child with the script, on the year HiGHS
    child's cores (each HiGHS one thread)."""
    path = os.path.join(tempfile.mkdtemp(prefix="horizon_"), "highs.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        env["YEAR_HIGHS_CORES"] = ",".join(map(str, cores[-2:]))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--horizon-highs", path], env=env)
    return {"path": path, "proc": proc}


def _wait_child(child, what, timeout=600):
    rc = child["proc"].wait(timeout=timeout)
    if rc != 0:
        raise AssertionError(f"{what} child exited {rc}")
    with np.load(child["path"]) as z:
        return {k: z[k] for k in z.files}


def phase_horizon(highs):
    """The `horizon` phase (see the module docstring); `highs` is
    `_start_horizon_highs`'s child."""
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.horizon import wind_battery_horizon_solve
    from dispatches_tpu_torch.solvers.chain_sweep import chain_sweep

    hours = HORIZON_HOURS
    data = P.load_rts303()
    lmp, cf = data["da_lmp"][:hours], data["da_wind_cf"][:hours]
    n_chunks = hours // HORIZON_CHUNK
    chain_sweep.launches = 0
    if HORIZON_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = wind_battery_horizon_solve(lmp, cf, n_chunks=n_chunks, admm_iters=HORIZON_SWEEPS,
                                     agg=HORIZON_AGG, device=HORIZON_DEVICE)
    obj, res = float(sol.obj), float(sol.primal_residual)
    wall = time.perf_counter() - t0
    st = sol.stats
    ref = _wait_child(highs, "horizon HiGHS")
    ref_obj = float(ref["obj"])
    gap = (obj - ref_obj) / abs(ref_obj)
    its = st["ipm_iterations"]
    log(f"[horizon] wind + battery over {hours} h as {n_chunks} chunks of {HORIZON_CHUNK} h "
        f"({sol.program.M} x {sol.program.N} a lane, f64) on {HORIZON_DEVICE}: "
        f"{st['sweeps']} ADMM sweeps + the final solve in {wall:.2f} s (the coarse "
        f"warm start, {hours // HORIZON_AGG} steps of {HORIZON_AGG} h, "
        f"{sol.coarse_seconds:.2f} s of it; {(wall - sol.coarse_seconds) / len(its):.3f} s a "
        f"batch of {n_chunks} lanes); IPM iterations a sweep {its}; every sweep converged "
        f"and finite: {all(st['converged_finite'])}; objective {obj:.10e} against HiGHS "
        f"{ref_obj:.10e} on the monolithic {int(ref['shape'][0])} x {int(ref['shape'][1])} LP "
        f"({float(ref['seconds']):.1f} s in its child): gap {gap:.4e}, gate {HORIZON_GAP}; "
        f"primal residual {res:.4e} kWh (< {HORIZON_RESIDUAL}), by sweep "
        f"{[float(f'{r:.3g}') for r in st['residuals']]}; chain_sweep launches "
        f"{chain_sweep.launches} (dense IPM only)")
    if not all(st["converged_finite"]):
        bad = [i for i, ok in enumerate(st["converged_finite"]) if not ok]
        raise AssertionError(f"horizon sweeps {bad} had an unconverged or non-finite lane")
    if not res < HORIZON_RESIDUAL:
        raise AssertionError(f"horizon primal residual {res} kWh >= {HORIZON_RESIDUAL}")
    if not HORIZON_GAP[0] <= gap <= HORIZON_GAP[1]:
        raise AssertionError(f"horizon gap to HiGHS {gap:.4e} outside {HORIZON_GAP}")
    return dict(wall_s=wall, coarse_s=sol.coarse_seconds, sweeps=st["sweeps"],
                ipm_iterations=its, obj=obj, highs_obj=ref_obj, gap=gap, residual=res,
                highs_s=float(ref["seconds"]), launches=chain_sweep.launches)


# each phase runs under the port's watchdog with a generous limit: a phase
# that hangs raises WatchdogTimeout (journaled as a "hang"), and the
# script exits non-zero
PHASE_LIMITS_S = {"build": 300, "kernel": 300, "weekly": 300, "golden": 300, "horizon": 300,
                  "year": 600, "grad": 600, "adaptive": 900, "pdhg": 900, "serve": 300,
                  "market": 400, "plants": 600, "cases": 400, "learn": 300}


def _guarded(name, fn):
    from dispatches_tpu_torch.obs.watchdog import with_watchdog

    t0 = time.perf_counter()
    out = with_watchdog(fn, timeout_s=PHASE_LIMITS_S[name], stage=name)
    log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernel,weekly,golden,horizon,year,grad,adaptive,pdhg,serve,market,"
                    "plants,cases,learn",
                    help="comma list of kernel, weekly, golden, horizon, year, grad, adaptive, "
                    "pdhg, serve, market, plants, cases, learn (device and build always run)")
    ap.add_argument("--cpu-tes-gradient", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--year-highs", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--horizon-highs", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_tes_gradient:  # the plants phase's CPU reference child
        _cpu_tes_gradient(args.cpu_tes_gradient)
        return 0
    if args.year_highs:  # the year phase's HiGHS child
        _year_highs(args.year_highs)
        return 0
    if args.horizon_highs:  # the horizon phase's HiGHS child
        _horizon_highs(args.horizon_highs)
        return 0
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()
    phase_device()
    child = _start_cpu_tes_gradient() if "plants" in phases else None
    highs = _start_year_highs() if "year" in phases else None
    horizon_highs = _start_horizon_highs() if "horizon" in phases else None
    try:
        return _run_phases(phases, t_start, child, highs, horizon_highs)
    finally:
        for c in (child, highs, horizon_highs):
            if c is not None and c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
        for p in _LEARN_CHILDREN:
            if p.poll() is None:
                p.kill()
                p.wait()


def _run_phases(phases, t_start, child, highs, horizon_highs):
    _guarded("build", phase_build)
    kernel_rows, max_err, main = (_guarded("kernel", phase_kernel) if "kernel" in phases
                                  else ([], None, {}))
    if "weekly" in phases:
        _guarded("weekly", phase_weekly)
    if "golden" in phases:
        _guarded("golden", phase_golden)
    # before the year phase: the card works while the year's HiGHS child
    # finishes, instead of the year phase waiting for it
    horizon = (_guarded("horizon", lambda: phase_horizon(horizon_highs))
               if "horizon" in phases else {})
    year = _guarded("year", lambda: phase_year(highs)) if "year" in phases else {}
    grad = (_guarded("grad", lambda: phase_grad(year.get("records"), year.get("highs_x")))
            if "grad" in phases else {})
    adaptive = (_guarded("adaptive", lambda: phase_adaptive(year.get("records"),
                                                             year.get("highs_npv")))
                if "adaptive" in phases else {})
    if "pdhg" in phases:
        _guarded("pdhg", lambda: phase_pdhg(year.get("records")))
    serve = _guarded("serve", phase_serve) if "serve" in phases else {}
    market = _guarded("market", phase_market) if "market" in phases else {}
    plants = _guarded("plants", lambda: phase_plants(child)) if "plants" in phases else {}
    cases = _guarded("cases", phase_cases) if "cases" in phases else {}
    if "learn" in phases:
        _guarded("learn", phase_learn)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    rec = {
        "name": "chain_sweep",
        "route": "cuda",
        "source": "dispatches_tpu_torch/csrc/chain_sweep.cu",
        "replaces": "dispatches_tpu/solvers/pallas_sweep.py:87",
        # the year phase's launches; each path's under "launches_by_path"
        "launches": year.get("launches", grad.get("launches")),
        "launches_by_path": {"year": year.get("launches"),
                             "grad_year": grad.get("launches"),
                             "grad_bracket": grad.get("bracket_launches"),
                             "adaptive_year": adaptive.get("year", {}).get("launches"),
                             "yearsweep_warm_adaptive": adaptive.get("cli", {}).get("launches"),
                             "adaptive_learned_warm": adaptive.get("learned", {}).get("launches"),
                             # the journaled yearsweep's counted batch (--cost)
                             "yearsweep_cost": sum(
                                 c["chain_sweep_launches"]
                                 for c in adaptive.get("cli", {}).get("cost", [])) or None,
                             "horizon": horizon.get("launches"),
                             "serve": serve.get("launches"),
                             "market": market.get("launches"),
                             "plants": plants.get("chain_sweep_launches"),
                             "cases_nuclear": cases.get("nuclear", {}).get("launches"),
                             "cases_solar": cases.get("solar", {}).get("launches")},
        # the adaptive year batch's launches by chain count (compaction)
        "adaptive_launches_by_chains": adaptive.get("year", {}).get("launches_by_chains"),
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
    tes = plants.get("tes", {})
    tes_rec = {
        "name": "tes_chain",
        "route": "cuda",
        "source": "dispatches_tpu_torch/csrc/tes_chain.cu",
        # a kernel of the port's own: the JAX package runs this chain as a
        # lax.scan that XLA compiles, no Pallas kernel
        "replaces": "none (dispatches_tpu/units/concrete_tes.py:174, a lax.scan)",
        "launches": plants.get("tes_chain_launches"),
        "launches_per_hour": tes.get("launches_per_hour"),
        "max_abs_err": tes.get("max_abs_err"),
        # one fluid pass at the reference geometry, both sides as two lanes
        "ms": tes.get("ms"),
        "plain_ms": tes.get("plain_ms"),
        # the throughput bound (roofline) of the serial path's Newton steps,
        # the work the function needs; the tree's evaluated steps beside it
        "bound_ms": tes.get("bound_ms"),
        "bound_by": tes.get("bound_by"),
        "needed_newton_steps": tes.get("needed_newton_steps"),
        "evaluated_newton_steps": tes.get("evaluated_newton_steps"),
        "library_ms": None,
        # the design's latency bound (rounds of the midpoint tree) and the
        # kernel's share of it; the bound of the serial path beside it
        "levels": tes.get("levels"),
        "latency_bound_ms": tes.get("latency_bound_ms"),
        "share_of_latency_bound": (tes["latency_bound_ms"] / tes["ms"]) if tes else None,
        "serial_latency_bound_ms": tes.get("serial_latency_bound_ms"),
        "levels_sweep": tes.get("levels_sweep"),
        "latency_ns": tes.get("latency_ns"),
        "shape": [2, 20],
    }
    print(json.dumps({"kernels": [rec, tes_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
