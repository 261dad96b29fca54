#!/usr/bin/env python
"""Open-loop load generator for the PyTorch port's dispatch service (the
port's `tools/loadgen.py`).

Drives `dispatches_tpu_torch.serve.DispatchService` (or, with
``--shards N``, the sharded fleet) with Poisson arrivals: seeded and
open-loop, the arrival times fixed up front and never waiting for
completions, so queueing delay is part of the measurement. It reports
latency percentiles and goodput. ``--baseline serial`` replays the same
arrival schedule against one unbatched solve at a time, FIFO, no cache.
Everything runs on the card unless ``--device cpu`` asks for the CPU.

    python tools/torch_loadgen.py --requests 400 --rate 200 --bucket 8
    python tools/torch_loadgen.py --baseline serial --requests 400 --rate 200
    python tools/torch_loadgen.py --shards 2 --kill-shard   # fleet chaos run
    python tools/torch_loadgen.py --self-check --device cpu

``--kill-shard`` SIGKILLs the busiest shard halfway through the run to
exercise the respawn + requeue path under load; ``--telemetry`` has the
children ship their metrics registry into the parent (shard-labelled),
and ``--exporter-port P`` serves /metrics, /healthz, /slo and /snapshot
from this process during the run.

``--self-check`` pushes ~200 small LPs through the service with request
journeys on, and fails (exit 1) unless every ticket resolves, every
non-cached solve converges, the journeys are complete (phases sum to the
latency, the timeline export validates), the p95 and the normal-class
SLO burn rate stay under loose bounds, and the fleet legs pass: a 2-shard
fleet with one shard killed mid-run loses nothing, respawns, requeues,
flips /healthz to 503 and back, keeps the fleet aggregates equal to the
sum of the per-shard series, and answers bitwise as the single-engine
service does; a ``nan``-faulted shard's rows are re-solved healthy by
the parent's remediation ladder, and a request that kills every worker
it reaches is quarantined as ``poisoned``. Exit 2 on an error.

``--warm-model PATH`` serves through the learned warm start (an artifact
from tools/torch_train_warmstart.py); the report then carries the
accept / iterations-saved counter deltas.

``--ramp LO:HI:STEPS`` sweeps the offered rate in equal steps over ONE
service (or fleet) and reports goodput / p50 / p95 / shed per step: the
measured saturation curve `tools/torch_capacity_plan.py --self-check`
gates the fleet twin's knee against. ``--capacity`` attaches the capacity
observatory (`obs/capacity.py`), so each row also carries its forced
reading (desired shards, knee, model error, Little's-law residual) and
the report its final ``/capacity`` payload. The self-check's fleet leg
runs with the time-series store on (``/query`` and ``/alerts`` gated) and
its capacity leg ramps a service with the observatory (estimate ok, knee
and recommendation finite, ``/capacity`` answering).

    python tools/torch_loadgen.py --ramp 20:200:6 --capacity --requests 60

The workload is synthetic: small random feasible box LPs with a duplicate
fraction (``--dup-frac``), so the fingerprint cache sees repeats.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

RC_OK, RC_GATE, RC_ERROR = 0, 1, 2
HEALTHY = ("healthy", "slow")


def make_problem(seed: int, n: int = 8, m: int = 4):
    """One small feasible box LP (A x = b with x0 interior, bounded), as
    host numpy arrays: a request arrives from outside the device, so the
    service and the serial baseline both pay the host-to-device copy."""
    import numpy as np

    from dispatches_tpu_torch.core.program import LPData

    r = np.random.default_rng(seed)
    A = r.normal(size=(m, n))
    x0 = r.uniform(0.5, 1.5, size=n)
    b = A @ x0
    c = r.normal(size=n)
    return LPData(A, b, c, np.zeros(n), np.full(n, 4.0), np.float64(0.0))


def arrival_schedule(n: int, rate: float, seed: int):
    """Poisson process: exponential inter-arrival gaps at `rate` req/s."""
    import numpy as np

    gaps = np.random.default_rng(seed).exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def problem_seeds(n: int, dup_frac: float, seed: int):
    """Request -> problem-seed map with ~dup_frac exact repeats."""
    import numpy as np

    r = np.random.default_rng(seed + 1)
    uniques = max(1, int(round(n * (1.0 - dup_frac))))
    pool = np.arange(uniques)
    extra = r.choice(pool, size=n - uniques) if n > uniques else []
    seeds = np.concatenate([pool, np.asarray(extra, dtype=pool.dtype)])
    r.shuffle(seeds)
    return [int(s) for s in seeds]


def percentiles(latencies):
    import numpy as np

    if not latencies:
        return {"p50_s": None, "p95_s": None, "p99_s": None}
    q = np.percentile(np.asarray(latencies), [50, 95, 99])
    return {"p50_s": float(q[0]), "p95_s": float(q[1]), "p99_s": float(q[2])}


def open_loop(svc, problems, sched, *, request_ids=None, deadline_s=None,
              kill_shard=False, result_timeout=240.0):
    """Submit ``problems[i]`` at ``sched[i]`` seconds after the start to a
    started service or fleet, then wait for every ticket. With
    `kill_shard` (a fleet), the busiest up shard is SIGKILLed once half
    the requests are in. Returns ``(results, wall_s, killed_shard)``;
    `results` holds None for a ticket that never resolved."""
    t0 = time.monotonic()
    tickets = []
    killed = None
    for i, (p, due) in enumerate(zip(problems, sched)):
        lag = t0 + due - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        tickets.append(svc.submit(
            p, request_id=request_ids[i] if request_ids else f"r{i}",
            timeout=deadline_s,
        ))
        if kill_shard and killed is None and i >= len(problems) // 2:
            busy = [
                k for k, st in svc.shard_states().items()
                if st["state"] == "up" and st["inflight"] > 0
            ]
            if busy:
                svc.kill_shard(busy[0])
                killed = busy[0]
    results = []
    for t in tickets:
        try:
            results.append(t.result(timeout=result_timeout))
        except TimeoutError:
            results.append(None)
    return results, time.monotonic() - t0, killed


def serial_loop(solve, problems, sched):
    """The same open-loop schedule served one unbatched solve at a time,
    FIFO, no cache: `solve(problem)` returns a host response ``(obj, x,
    converged)``. Latency counts the wait behind earlier requests.
    Returns ``(latencies, converged_count, wall_s)``."""
    t0 = time.monotonic()
    lat, ok = [], 0
    for p, due in zip(problems, sched):
        lag = t0 + due - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        ok += bool(solve(p)[2])
        lat.append(time.monotonic() - (t0 + due))
    return lat, ok, time.monotonic() - t0


def summarize(results, wall, **extra) -> dict:
    done = [r for r in results if r is not None]
    ok = [r for r in done if r.ok]
    lat = [r.latency for r in done if r.latency is not None]
    return {
        **extra,
        "resolved": len(done),
        "lost": len(results) - len(done),
        "ok": len(ok),
        "cached": sum(r.from_cache for r in done),
        "shed": sum(r.verdict == "shed" for r in done),
        "deadline_exceeded": sum(r.verdict == "deadline_exceeded" for r in done),
        "unhealthy": sum(
            r.verdict not in HEALTHY + ("shed", "deadline_exceeded") for r in done
        ),
        "wall_s": wall,
        "goodput_rps": len(ok) / wall if wall > 0 else 0.0,
        **percentiles(lat),
    }


def run_service(
    requests: int = 200,
    rate: float = 200.0,
    bucket: int = 8,
    chunk_iters: int = 8,
    max_iter: int = 60,
    queue_limit: int = 256,
    dup_frac: float = 0.25,
    seed: int = 0,
    deadline_s: float = None,
    lp_n: int = 8,
    lp_m: int = 4,
    reqtrace: bool = False,
    detail: bool = False,
    shards: int = 0,
    kill_shard: bool = False,
    telemetry: bool = False,
    exporter_port=None,
    device="cuda",
    warm_model=None,
) -> dict:
    """Drive the service (or, with `shards` > 0, the fleet) on `device` at
    `rate` req/s; returns the report dict. `reqtrace` records per-request
    journeys into the process tracer's journal; `detail` adds a
    per-request-id latency map (for validation). `kill_shard` SIGKILLs the
    busiest shard halfway through the submissions; `telemetry` (fleet
    only) ships shard-child registry deltas into the parent registry;
    `exporter_port` serves /metrics, /healthz and /slo from this process
    for the run (0 = ephemeral). `warm_model` (an artifact path) seeds the
    admitted lanes through the safeguarded learned warm start; the report
    then carries the accept / iterations-saved counter deltas (a fleet's
    need `telemetry` to fold the children's registries in)."""
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.serve import make_dense_fleet, make_dense_service

    warm_before = obs_metrics.flat_values() if warm_model is not None else None
    if shards > 0:
        svc = make_dense_fleet(
            shards, bucket, chunk_iters=chunk_iters, queue_limit=queue_limit,
            reqtrace=reqtrace, telemetry=telemetry,
            solver_kw={"max_iter": max_iter}, device=device, warm_model=warm_model,
        )
    else:
        svc = make_dense_service(
            bucket, chunk_iters=chunk_iters, max_iter=max_iter,
            queue_limit=queue_limit, reqtrace=reqtrace, device=device,
            warm_model=warm_model,
        )
    seeds = problem_seeds(requests, dup_frac, seed)
    problems = {s: make_problem(s, n=lp_n, m=lp_m) for s in set(seeds)}
    # the first solve outside the measurement window (a server would have
    # warmed up at deploy time); batch priority keeps it out of the
    # normal-class SLO accounting
    svc.submit(make_problem(10**6, n=lp_n, m=lp_m), priority="batch")
    svc.drain()
    sched = arrival_schedule(requests, rate, seed)

    svc.start()
    exporter = None
    if exporter_port is not None:
        from dispatches_tpu_torch.obs.exporter import TelemetryExporter

        exporter = TelemetryExporter(
            int(exporter_port), health_fn=svc.health if shards > 0 else None,
        ).start()
        print(f"exporter: {exporter.url('/metrics')}", file=sys.stderr)
    try:
        results, wall, killed = open_loop(
            svc, [problems[s] for s in seeds], sched, deadline_s=deadline_s,
            kill_shard=kill_shard,
        )
    finally:
        if exporter is not None:
            exporter.stop()
        if shards > 0:
            svc.close()
        else:
            svc.stop()
    report = summarize(results, wall, mode="service", requests=requests,
                       rate_rps=rate, bucket=bucket, device=str(device))
    report["service"] = svc.stats()
    if shards > 0:
        report["mode"] = "fleet"
        report["shards"] = shards
        report["killed_shard"] = killed
        # per-shard goodput on the shared wall clock: shards serve at the
        # same time, so the per-shard rates sum to the fleet's
        report["per_shard"] = {
            k: {**v, "goodput_rps": v.get("completed", 0) / wall if wall > 0 else 0.0}
            for k, v in (report["service"].get("per_shard") or {}).items()
        }
    if warm_before is not None:
        after = obs_metrics.flat_values()

        def _delta(prefix, extra=""):
            return sum(after.get(k, 0.0) - warm_before.get(k, 0.0)
                       for k in after if k.startswith(prefix) and extra in k)

        report["warm"] = {
            "model": str(warm_model),
            "accepted": _delta("learned_warm_accept_total"),
            "rejected": _delta("learned_warm_reject_total"),
            "iters_saved": _delta("warm_start_iters_saved_total", 'source="learned"'),
        }
    if exporter is not None:
        report["exporter_url"] = exporter.url()
    if detail:
        report["latencies_by_id"] = {
            r.request_id: r.latency for r in results
            if r is not None and r.request_id is not None and r.latency is not None
        }
    return report


def capacity_snapshot(svc):
    """The capacity observatory's report, or None with the plane off (a
    fleet through its lock-holding `capacity_report`)."""
    fn = getattr(svc, "capacity_report", None)
    if fn is not None:
        return fn() or None
    cap = getattr(svc, "capacity", None)
    return cap.report() if cap is not None else None


def run_ramp(
    lo: float,
    hi: float,
    steps: int,
    requests_per_step: int = 60,
    bucket: int = 8,
    chunk_iters: int = 8,
    max_iter: int = 60,
    queue_limit: int = 256,
    dup_frac: float = 0.25,
    seed: int = 0,
    shards: int = 0,
    capacity=False,
    lp_n: int = 8,
    lp_m: int = 4,
    deadline_s=None,
    out=None,
    device="cuda",
    problems=None,
    solver_kw=None,
) -> dict:
    """Stepped open-loop rate ramp: LO..HI req/s across `steps` equal steps
    over ONE service (or fleet) on `device`, so the retained telemetry and
    the capacity observatory reading it (``capacity=True`` or a mapping of
    its knobs) span every operating point. Each step offers
    `requests_per_step` Poisson arrivals at its rate and reports offered,
    goodput, p50 / p95 and shed for that step alone; with the observatory
    each row also carries its reading after a forced tick, and the
    report's ``capacity`` its final report (``service_quantiles`` included:
    enough to rebuild the twin offline). `problems` (a list of LP rows)
    replaces the synthetic box LPs: step k offers rows k * n .. k * n + n - 1
    (cyclically), so steps do not replay each other's fingerprints.
    `solver_kw` overrides ``max_iter`` with the service's solver options."""
    from dispatches_tpu_torch.serve import make_dense_fleet, make_dense_service

    if steps < 1 or lo <= 0 or hi < lo:
        raise ValueError("ramp wants 0 < LO <= HI and STEPS >= 1")
    rates = [lo + (hi - lo) * i / max(steps - 1, 1) for i in range(steps)]
    kw = dict(solver_kw) if solver_kw else {"max_iter": max_iter}
    if shards > 0:
        svc = make_dense_fleet(shards, bucket, chunk_iters=chunk_iters,
                               queue_limit=queue_limit, solver_kw=kw, capacity=capacity,
                               device=device)
    else:
        svc = make_dense_service(bucket, chunk_iters=chunk_iters, queue_limit=queue_limit,
                                 capacity=capacity, device=device, **kw)
    n = requests_per_step

    def step_problems(k):
        if problems is not None:
            return [problems[(k * n + i) % len(problems)] for i in range(n)]
        # offset the seed pool per step: dup_frac repeats stay within a
        # step, steps never replay an earlier step's fingerprints
        seeds = [s + 100_000 * k for s in problem_seeds(n, dup_frac, seed + 101 * k)]
        pool = {s: make_problem(s, n=lp_n, m=lp_m) for s in set(seeds)}
        return [pool[s] for s in seeds]

    # the executables' first use outside the measurement window: one
    # distinct problem a shard (a warm-up at deploy time)
    warm = (problems[-max(1, shards):] if problems is not None
            else [make_problem(10**6 + w, n=lp_n, m=lp_m) for w in range(max(1, shards))])
    for p in warm:
        svc.submit(p, priority="batch")
    svc.drain()
    svc.start()
    rows = []
    try:
        for k, r in enumerate(rates):
            sched = arrival_schedule(n, r, seed + 101 * k)
            results, wall, _ = open_loop(
                svc, step_problems(k), sched, deadline_s=deadline_s,
                request_ids=[f"ramp{k}_{i}" for i in range(n)],
            )
            rep = summarize(results, wall)
            row = {"step": k, "rate_rps": r, "offered": n, "ok": rep["ok"],
                   "shed": rep["shed"], "lost": rep["lost"], "wall_s": wall,
                   "goodput_rps": rep["goodput_rps"], "p50_s": rep["p50_s"],
                   "p95_s": rep["p95_s"], "p99_s": rep["p99_s"]}
            cap = getattr(svc, "capacity", None)
            if cap is not None:
                # a forced cycle: the row reads THIS step's window
                cap.tick(force=True)
                snap = capacity_snapshot(svc) or {}
                twin = snap.get("twin") or {}
                row["capacity"] = {
                    "desired_shards": (snap.get("recommendation") or {}).get("desired_shards"),
                    "knee_rate_per_sec": (twin.get("knee") or {}).get("knee_rate_per_sec"),
                    "model_error_ratio": twin.get("model_error_ratio"),
                    "littles_residual": (snap.get("estimate") or {}).get("littles_residual"),
                    "time_to_breach_s": (snap.get("forecast") or {}).get("time_to_breach_s"),
                }
            rows.append(row)
            if out is not None:
                print(f"ramp step {k}: rate={r:.2f}/s goodput={row['goodput_rps']:.2f}/s "
                      f"p95={(row['p95_s'] or 0.0) * 1e3:.0f}ms shed={row['shed']}", file=out)
        final_capacity = capacity_snapshot(svc)
    finally:
        if shards > 0:
            svc.close()
        else:
            svc.stop()
    return {"mode": "ramp", "lo_rps": lo, "hi_rps": hi, "steps": steps,
            "requests_per_step": n, "bucket": bucket, "shards": shards,
            "device": str(device), "rows": rows, "capacity": final_capacity}


def run_serial(
    requests: int = 200,
    rate: float = 200.0,
    max_iter: int = 60,
    dup_frac: float = 0.25,
    seed: int = 0,
    lp_n: int = 8,
    lp_m: int = 4,
    device="cuda",
) -> dict:
    """The naive baseline: the same open-loop schedule served by one
    unbatched `solve_lp` at a time on `device`, FIFO, no cache; each
    request end to end, host payload in and host response (objective,
    primal, converged flag) out."""
    seeds = problem_seeds(requests, dup_frac, seed)
    problems = {s: make_problem(s, n=lp_n, m=lp_m) for s in set(seeds)}
    solve = serial_solver(device, max_iter=max_iter)
    solve(next(iter(problems.values())))  # warm
    lat, ok, wall = serial_loop(
        solve, [problems[s] for s in seeds], arrival_schedule(requests, rate, seed)
    )
    return {
        "mode": "serial",
        "requests": requests,
        "rate_rps": rate,
        "device": str(device),
        "resolved": requests,
        "lost": 0,
        "ok": ok,
        "wall_s": wall,
        "goodput_rps": ok / wall if wall > 0 else 0.0,
        **percentiles(lat),
    }


def serial_solver(device="cuda", **solver_kw):
    """`solve(problem) -> (obj, x, converged)` through one unbatched
    `solve_lp` on `device`, the response copied to the host."""
    import numpy as np
    import torch

    from dispatches_tpu_torch.solvers.ipm import solve_lp

    def solve(p):
        lp = type(p)(*(torch.as_tensor(a, device=device) for a in p))
        sol = solve_lp(lp, **solver_kw)
        return float(sol.obj), np.asarray(sol.x.cpu()), bool(sol.converged)

    return solve


# ---------------------------------------------------------------------------
# --self-check


def _terminal_mini_pass(out, device) -> dict:
    """A pump-driven mini-scenario forcing the terminals the open-loop run
    cannot guarantee (shed, queued deadline, cache hit), at batch priority
    so the normal-class SLO gate never sees them."""
    from dispatches_tpu_torch.serve import make_dense_service

    svc = make_dense_service(
        2, chunk_iters=4, max_iter=40, queue_limit=1, cache_size=8,
        reqtrace=True, device=device,
    )
    tickets = {}
    # expires before the first pump can grant a slot
    tickets["mini_late"] = svc.submit(
        make_problem(7001), priority="batch", timeout=0.0, request_id="mini_late",
    )
    # the queue of 1 is full and the newcomer is not more urgent
    tickets["mini_shed"] = svc.submit(
        make_problem(7002), priority="batch", request_id="mini_shed",
    )
    svc.drain()
    tickets["mini_a"] = svc.submit(
        make_problem(7003), priority="batch", request_id="mini_a",
    )
    svc.drain()
    tickets["mini_hit"] = svc.submit(
        make_problem(7003), priority="batch", request_id="mini_hit",
    )
    svc.drain()
    results = {rid: t.result(0) for rid, t in tickets.items()}
    print(f"terminal mini-pass: { {rid: r.verdict for rid, r in results.items()} }", file=out)
    return {rid: r.latency for rid, r in results.items() if r.latency is not None}


def http_get(url: str):
    """(status, body) even for non-2xx responses: /healthz 503 is a signal
    here, not an error."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def shard_counter_deltas(before: dict, after: dict, prefixes=("adaptive_",)):
    """Counter deltas between two registry snapshots for the child-only
    engine counters (names the fleet parent never increments itself, so
    their label-free aggregates come from `MetricsRegistry.merge` alone),
    split into shard-labelled and label-free series: ``(labelled,
    unlabelled)`` keyed by ``(name, base-label-items)``, `labelled` values
    mapping shard id -> delta."""
    from dispatches_tpu_torch.obs.metrics import parse_series

    labeled, unlabeled = {}, {}
    for series in set(before) | set(after):
        d = after.get(series, 0.0) - before.get(series, 0.0)
        if d == 0:
            continue
        name, labels = parse_series(series)
        if not name.startswith(prefixes):
            continue
        shard = labels.pop("shard", None)
        key = (name, tuple(sorted(labels.items())))
        if shard is None:
            unlabeled[key] = unlabeled.get(key, 0.0) + d
        else:
            labeled.setdefault(key, {})[shard] = d
    return labeled, unlabeled


def _telemetry_checks(fleet, exporter, before, n_solved, out) -> list:
    """After the chaos drain: both children shipped shard-labelled series,
    the label-free aggregates equal the sum of the per-shard series (on
    deltas against the pre-fleet snapshot), /metrics carries both shards,
    and the per-shard request counters sum to the solved count."""
    from dispatches_tpu_torch.obs import metrics as obs_metrics

    failures = []
    labeled, unlabeled = {}, {}
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        # children ship on the heartbeat: pump until the final counters
        # from both shards have landed
        fleet.pump()
        labeled, unlabeled = shard_counter_deltas(before, obs_metrics.snapshot()["counters"])
        seen = {s for m in labeled.values() for s in m}
        if {"0", "1"} <= seen and all(
            abs(sum(m.values()) - unlabeled.get(k, 0.0)) < 1e-9 for k, m in labeled.items()
        ):
            break
        time.sleep(0.02)
    seen = {s for m in labeled.values() for s in m}
    if not {"0", "1"} <= seen:
        failures.append(f"telemetry: engine counters from shards {sorted(seen)}, want 0 and 1")
    bad = [(k, sum(m.values()), unlabeled.get(k)) for k, m in labeled.items()
           if abs(sum(m.values()) - unlabeled.get(k, 0.0)) > 1e-6]
    if bad:
        failures.append(f"telemetry: fleet aggregate != sum of per-shard series ({bad[0]})")
    else:
        print(f"telemetry: conservation holds over {len(labeled)} merged counter "
              f"series from shards {sorted(seen)}", file=out)
    after = obs_metrics.snapshot()["counters"]
    by_shard = sum(after.get(s, 0.0) - before.get(s, 0.0) for s in after
                   if s.startswith("serve_shard_requests_total{"))
    if int(by_shard) != n_solved:
        failures.append(f"telemetry: serve_shard_requests_total sums to {by_shard}, "
                        f"want {n_solved}")
    code, body = http_get(exporter.url("/metrics"))
    if code != 200:
        failures.append(f"telemetry: /metrics returned {code}")
    else:
        for want in ('shard="0"', 'shard="1"', "serve_shard_ping_seconds"):
            if want not in body:
                failures.append(f"telemetry: /metrics lacks {want!r}")
    code, body = http_get(exporter.url("/slo"))
    if code != 200 or "worst_burn_rate" not in json.loads(body):
        failures.append(f"telemetry: /slo unusable (status {code})")
    st = fleet.stats()
    if int(st.get("telemetry_frames", 0)) < 2 or int(st.get("telemetry_errors", 0)):
        failures.append(f"telemetry: {st.get('telemetry_frames')} frames merged, "
                        f"{st.get('telemetry_errors')} errors")
    return failures


def _timeseries_checks(exporter, out) -> list:
    """The retention plane over the exporter: ``/query`` returns non-empty,
    aligned windows of the queue-depth and per-shard in-flight gauges the
    pump sampled, and ``/alerts`` serves the rule pack with the shard_down
    lifecycle the chaos leg induced."""
    failures = []
    for name in ("serve_queue_depth", "serve_shard_inflight"):
        code, body = http_get(exporter.url(f"/query?name={name}&window=300"))
        if code != 200:
            failures.append(f"timeseries: /query?name={name} returned {code}")
            continue
        series = json.loads(body).get("series") or []
        pts = sum(len(s.get("t") or []) for s in series)
        misaligned = [s["series"] for s in series
                      if len(s.get("t") or []) != len(s.get("v") or [])]
        if not pts:
            failures.append(f"timeseries: /query {name} window is empty")
        elif misaligned:
            failures.append(f"timeseries: /query {name} t/v misaligned: {misaligned}")
        else:
            print(f"timeseries: /query {name}: {len(series)} series, {pts} aligned points",
                  file=out)
    code, body = http_get(exporter.url("/alerts"))
    if code != 200:
        failures.append(f"timeseries: /alerts returned {code}")
    else:
        rep = json.loads(body)
        rules = {r.get("name") for r in rep.get("rules") or []}
        if "shard_down" not in rules:
            failures.append(f"timeseries: /alerts rule pack lacks shard_down ({rules})")
        if "shard_down" not in {h.get("rule") for h in rep.get("history") or []}:
            failures.append("timeseries: /alerts history lacks the shard_down lifecycle")
    return failures


def _capacity_pass(out, device) -> list:
    """A 3-step ramp over one service with the capacity observatory: zero
    lost, the estimate ok, the twin's knee and the shard recommendation
    finite, and ``/capacity`` answering the report through an exporter."""
    import math

    from dispatches_tpu_torch.obs.exporter import TelemetryExporter

    failures = []
    rep = run_ramp(50.0, 200.0, 3, requests_per_step=40, bucket=4, chunk_iters=4,
                   dup_frac=0.0, seed=3, device=device,
                   capacity={"window": 30.0, "twin_every": 1.0, "eval_every": 0.5},
                   out=out)
    lost = sum(r["lost"] + r["offered"] - r["ok"] - r["shed"] for r in rep["rows"])
    cap = rep["capacity"] or {}
    est = cap.get("estimate") or {}
    knee = ((cap.get("twin") or {}).get("knee") or {}).get("knee_rate_per_sec")
    desired = (cap.get("recommendation") or {}).get("desired_shards")
    print(f"capacity: knee {knee} req/s, desired shards {desired}, littles residual "
          f"{est.get('littles_residual')}, model error "
          f"{(cap.get('twin') or {}).get('model_error_ratio')}", file=out)
    if lost:
        failures.append(f"capacity: {lost} ramp requests lost or unsolved")
    if not est.get("ok"):
        failures.append("capacity: the estimator window never became ok")
    if knee is None or not math.isfinite(knee) or knee <= 0:
        failures.append(f"capacity: no finite knee ({knee})")
    if desired is None or desired < 1:
        failures.append(f"capacity: no shard recommendation ({desired})")
    exporter = TelemetryExporter(0, capacity_fn=lambda: cap).start()
    try:
        code, body = http_get(exporter.url("/capacity"))
    finally:
        exporter.stop()
    if code != 200 or json.loads(body).get("config") != cap.get("config"):
        failures.append(f"capacity: /capacity answered {code}")
    return failures


def _fleet_chaos_pass(out, device) -> list:
    """A 2-shard fleet with one shard SIGKILLed while it holds in-flight
    lanes loses no ticket, respawns the shard, requeues and re-solves the
    killed lanes, flips /healthz to 503 and back, and answers bitwise as
    the single-engine service at the same bucket (a requeued lane
    re-solves from iteration 0). A rate-limited tenant's second request
    is shed with ``shed_tenant_quota``. The time-series store and the
    alert pack run on (`_timeseries_checks`), so the bitwise comparison
    also shows them neutral."""
    import numpy as np

    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.exporter import TelemetryExporter
    from dispatches_tpu_torch.serve import (
        TenantConfig, make_dense_fleet, make_dense_service,
    )

    failures = []
    bucket = 4
    seeds = list(range(8000, 8024))
    problems = {s: make_problem(s) for s in seeds}
    before = obs_metrics.snapshot()["counters"]
    fleet = make_dense_fleet(
        2, bucket, chunk_iters=4, cache_size=None,
        tenants={"limited": TenantConfig(rate=0.001, burst=1.0)},
        solver_kw={"max_iter": 60}, reqtrace=True, telemetry=True,
        heartbeat_every=0.1, timeseries=True, device=device,
    )
    exporter = TelemetryExporter(0, health_fn=fleet.health, store=fleet.store,
                                 alerts=fleet.alerts).start()
    results, lost = {}, 0
    try:
        tickets = {s: fleet.submit(problems[s], priority="batch", request_id=f"chaos{s}")
                   for s in seeds}
        t_ok = fleet.submit(make_problem(8100), priority="batch", tenant="limited")
        t_quota = fleet.submit(make_problem(8101), priority="batch", tenant="limited")
        if not (t_quota.done() and t_quota.result(0).verdict == "shed_tenant_quota"):
            failures.append("fleet chaos: expected the shed_tenant_quota verdict")
        victim = None
        t0 = time.monotonic()
        while victim is None and time.monotonic() - t0 < 60.0:
            fleet.pump()
            busy = [k for k, st in fleet.shard_states().items()
                    if st["state"] == "up" and st["inflight"] > 0]
            victim = busy[0] if busy else None
        if victim is None:
            failures.append("fleet chaos: no shard ever held in-flight work")
        else:
            n_inflight = fleet.shard_states()[victim]["inflight"]
            fleet.kill_shard(victim)
            print(f"fleet chaos: killed shard {victim} with {n_inflight} lanes in flight",
                  file=out)
            code = None
            t0 = time.monotonic()
            while code != 503 and time.monotonic() - t0 < 30.0:
                fleet.pump()
                code, body = http_get(exporter.url("/healthz"))
            if code != 503 or not json.loads(body).get("shards"):
                failures.append(f"fleet chaos: /healthz never answered 503 with per-shard "
                                f"detail after the kill (last {code})")
        fleet.drain(timeout=300.0)
        if victim is not None:
            code = None
            t0 = time.monotonic()
            while code != 200 and time.monotonic() - t0 < 30.0:
                fleet.pump()
                code, _ = http_get(exporter.url("/healthz"))
                if code != 200:
                    time.sleep(0.05)
            if code != 200:
                failures.append("fleet chaos: /healthz never recovered after the respawn")
        st = fleet.stats()
        for s, t in tickets.items():
            if t.done():
                results[s] = t.result(0)
            else:
                lost += 1
        lost += (not t_ok.done()) + (not t_quota.done())
        if lost:
            failures.append(f"fleet chaos: {lost} tickets never resolved")
        bad = [s for s, r in results.items() if r.verdict not in HEALTHY]
        if bad:
            failures.append(f"fleet chaos: {len(bad)} unhealthy results")
        if victim is not None and (st["respawns"] < 1 or st["requeued_lanes"] < 1):
            failures.append(f"fleet chaos: respawns {st['respawns']}, requeued "
                            f"{st['requeued_lanes']}; want both >= 1")
        print(f"fleet chaos: {len(results)}/{len(seeds)} resolved, respawns="
              f"{st['respawns']} requeued={st['requeued_lanes']} "
              f"tenant_shed={st['tenant_shed']}", file=out)
        n_solved = sum(r.verdict in HEALTHY for r in results.values()) + (
            t_ok.done() and t_ok.result(0).verdict in HEALTHY)
        failures += _telemetry_checks(fleet, exporter, before, n_solved, out)
        failures += _timeseries_checks(exporter, out)
    finally:
        exporter.stop()
        fleet.close()
    if lost or not results:
        return failures
    svc = make_dense_service(bucket, chunk_iters=4, max_iter=60, cache_size=None,
                             device=device)
    ref = {s: svc.submit(problems[s], priority="batch") for s in seeds}
    svc.drain()
    mismatched = sum(
        any(np.asarray(a).tobytes() != np.asarray(b).tobytes()
            for a, b in zip(results[s].solution, ref[s].result(0).solution))
        for s in seeds
    )
    if mismatched:
        failures.append(f"fleet chaos: {mismatched} results differ bitwise from the "
                        "single-engine service")
    else:
        print(f"fleet chaos: all {len(seeds)} results bitwise the single-engine "
              "service's", file=out)
    return failures


class _PinRouter:
    """Deterministic routing for the quarantine leg: poison dispatches (a
    ``fault`` payload) go to shard 0 only, innocents to shard 1 only, so a
    kill never catches an innocent in flight."""

    def __init__(self):
        from dispatches_tpu_torch.serve.router import Router

        self._base = Router()

    def __getattr__(self, name):  # note_dispatch / forget_shard / ...
        return getattr(self._base, name)

    def pick(self, req, shards):
        want = 0 if getattr(req, "fault", None) else 1
        for s in shards:
            if s.shard_id == want and s.inflight() < s.bucket:
                return s
        return None  # the wanted shard is down or full: stay queued


def _poison_quarantine_pass(out, device) -> list:
    """Self-healing: a ``nan``-faulted shard's rows are re-solved healthy by
    the parent's ladder; a request whose dispatch kills its worker
    (``fault="exit"``) is quarantined as ``poisoned`` after `max_requeues`
    crash requeues, every innocent resolves healthy, and every shard ends
    the leg up."""
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.serve import make_dense_fleet

    failures = []

    def recovered_total() -> float:
        return sum(v for k, v in obs_metrics.snapshot()["counters"].items()
                   if k.startswith("remediation_recovered_total"))

    fleet = make_dense_fleet(2, 4, chunk_iters=4, cache_size=None,
                             solver_kw={"max_iter": 60}, heartbeat_every=0.1,
                             remedy=True, device=device)
    try:
        fleet.inject_fault(0, "nan")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.3:  # let the fault op land first
            fleet.pump()
        rec0 = recovered_total()
        tix = {s: fleet.submit(make_problem(s), priority="batch", request_id=f"nan{s}")
               for s in range(9000, 9012)}
        fleet.drain(timeout=300.0)
        bad = [s for s, t in tix.items()
               if not t.done() or t.result(0).verdict not in HEALTHY]
        if bad:
            failures.append(f"poison leg: {len(bad)} requests through the nan-faulted "
                            "fleet not healthy")
        rec = recovered_total() - rec0
        if rec < 1:
            failures.append("poison leg: no nan-corrupted row was remediated")
        else:
            print(f"poison leg: {rec:.0f} nan-corrupted rows remediated healthy by the "
                  "parent ladder", file=out)
    finally:
        fleet.close()

    fleet = make_dense_fleet(2, 4, chunk_iters=4, cache_size=None,
                             solver_kw={"max_iter": 60}, heartbeat_every=0.1,
                             max_requeues=1, remedy=True, router=_PinRouter(),
                             device=device)
    try:
        innocents = {s: fleet.submit(make_problem(s), priority="batch",
                                     request_id=f"innocent{s}")
                     for s in range(9100, 9112)}
        poison = fleet.submit(make_problem(9999), priority="batch", request_id="poison",
                              fault="exit")
        fleet.drain(timeout=300.0)
        if not poison.done() or poison.result(0).verdict != "poisoned":
            failures.append("poison leg: the poison request was not quarantined")
        else:
            print(f"poison leg: quarantined after {poison.request.requeues} crash "
                  "requeues", file=out)
        if any(not t.done() or t.result(0).verdict not in HEALTHY
               for t in innocents.values()):
            failures.append("poison leg: an innocent request was lost or unhealthy")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30.0:
            fleet.pump()
            if all(s["state"] == "up" for s in fleet.shard_states().values()):
                break
            time.sleep(0.05)
        down = [k for k, s in fleet.shard_states().items() if s["state"] != "up"]
        if down:
            failures.append(f"poison leg: shards {down} still down after the quarantine")
    finally:
        fleet.close()
    return failures


def _check_journeys(journal, latencies, out) -> list:
    """Every terminal request has a complete journey whose phases sum to
    its reported latency; the timeline exporter accepts the run; the
    normal-class SLO burn rate stays under its bound (through
    `journal_diff.compare`, so direction and threshold are CI's)."""
    import journal_diff
    import trace_timeline

    from dispatches_tpu_torch.obs import slo as obs_slo
    from dispatches_tpu_torch.obs.journal import read_journal

    failures = []
    recs = read_journal(journal)
    journeys = {r.get("request_id"): r for r in recs
                if r.get("kind") == "journey" and r.get("request_id")}
    missing = sorted(set(latencies) - set(journeys))
    if missing:
        failures.append(f"{len(missing)} requests without a journey (first: {missing[:5]})")
    terminals = {j.get("terminal") for j in journeys.values()}
    for want in ("complete", "cache_hit", "shed", "deadline_exceeded"):
        if want not in terminals:
            failures.append(f"no journey with terminal {want!r}")
    tol = 1e-6  # float-add slack; every stamp is the same service clock
    bad_sum = sum(abs(sum((j.get("phases") or {}).values()) - j.get("latency_s", 0.0)) > tol
                  for j in journeys.values())
    bad_lat = sum(rid in latencies and abs(j["latency_s"] - latencies[rid]) > tol
                  for rid, j in journeys.items())
    if bad_sum or bad_lat:
        failures.append(f"{bad_sum} journeys whose phases do not sum to the latency, "
                        f"{bad_lat} disagreeing with the ticket latency")
    trace = trace_timeline.export_trace(recs)
    problems = trace_timeline.validate_trace(trace)
    n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    if problems or not n_spans:
        failures.append(f"timeline export invalid ({problems[:3]}, {n_spans} spans)")
    print(f"timeline: {n_spans} spans from {len(journeys)} journeys", file=out)
    objective = float(os.environ.get("LOADGEN_SLO_LATENCY_S", "2.0"))
    report = obs_slo.evaluate_slos(recs, slos=[obs_slo.SLO("normal", objective, 0.99, "normal")])
    burn = obs_slo.worst_burn_rate(report)
    print(f"slo: normal-class objective {objective:.2f}s target 0.99, worst burn rate "
          f"{burn:.3f}", file=out)
    rows = journal_diff.compare(
        {"serve/slo/normal/burn_rate": float(os.environ.get("LOADGEN_BURN_BOUND", "1.0"))},
        {"serve/slo/normal/burn_rate": burn}, default_threshold=0.0,
    )
    failures += [f"slo gate: burn rate {r['new']:.3f} over bound {r['base']:.3f}"
                 for r in rows if r["regression"]]
    return failures


def self_check(out=sys.stdout, device="cuda") -> int:
    """~200 requests with journeys, zero lost, p95 + journey completeness +
    timeline export + SLO burn gated, and the fleet legs."""
    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import journal_diff

    journal = os.path.join(
        os.environ.get("LOADGEN_OUT", os.environ.get("TMPDIR", "/tmp")),
        "torch_loadgen_selfcheck.jsonl",
    )
    if os.path.exists(journal):
        os.unlink(journal)  # the Tracer appends; the gate wants one run
    with use_tracer(Tracer(journal, manifest_extra={"run": "torch-loadgen-self-check"})) as tr:
        report = run_service(requests=200, rate=400.0, bucket=8, dup_frac=0.25, seed=0,
                             reqtrace=True, detail=True, device=device)
        latencies = report.pop("latencies_by_id")
        latencies.update(_terminal_mini_pass(out, device))
        # the capacity leg before the fleet legs: a fleet's per-shard
        # in-flight gauges stay in the process registry after it closes,
        # and the observatory reads them before the service's own lanes
        failures = _capacity_pass(out, device)
        failures += _fleet_chaos_pass(out, device)
        failures += _poison_quarantine_pass(out, device)
        tr.event("loadgen_report", **{k: v for k, v in report.items()
                                      if isinstance(v, (int, float))})
        tr.close()
    print(json.dumps(report, indent=2, default=str), file=out)
    failures += _check_journeys(journal, latencies, out)
    if report["lost"] or report["unhealthy"]:
        failures.append(f"{report['lost']} lost, {report['unhealthy']} unhealthy")
    if report["shed"] or report["deadline_exceeded"]:
        failures.append("shed/deadline in an unbounded-queue run: "
                        f"{report['shed']}/{report['deadline_exceeded']}")
    if report["ok"] + report["cached"] < report["requests"]:
        failures.append("ok+cached below the request count")
    rows = journal_diff.compare(
        {"serve/loadgen/p95_s": float(os.environ.get("LOADGEN_P95_BOUND_S", "2.0"))},
        {"serve/loadgen/p95_s": report["p95_s"]}, default_threshold=0.0,
    )
    failures += [f"p95 gate: {r['new']:.4f}s over bound {r['base']:.4f}s"
                 for r in rows if r["regression"]]
    if failures:
        for f in failures:
            print(f"loadgen self-check FAIL: {f}", file=out)
        return RC_GATE
    print(f"loadgen self-check passed on {device}: {report['requests']} requests, 0 lost, "
          f"p95={report['p95_s'] * 1e3:.1f}ms goodput={report['goodput_rps']:.0f}/s "
          f"(journal: {journal})", file=out)
    return RC_OK


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_loadgen",
        description="Poisson open-loop load generator for the port's dispatch service "
        "(or a serial baseline).",
    )
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate, requests/second")
    ap.add_argument("--bucket", type=int, default=8)
    ap.add_argument("--chunk-iters", type=int, default=8)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--queue-limit", type=int, default=256)
    ap.add_argument("--dup-frac", type=float, default=0.25,
                    help="fraction of requests repeating an earlier problem")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline, seconds from submit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default: the card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve through a fleet of N crash-domain shard processes")
    ap.add_argument("--kill-shard", action="store_true",
                    help="chaos: SIGKILL the busiest shard halfway through the run "
                    "(needs --shards >= 2)")
    ap.add_argument("--telemetry", action="store_true",
                    help="fleet only: children ship metrics and journal deltas into "
                    "the parent on the heartbeat")
    ap.add_argument("--exporter-port", type=int, default=None,
                    help="serve /metrics /healthz /slo /snapshot on this port for the "
                    "run (0 = ephemeral; implies --telemetry when --shards > 0)")
    ap.add_argument("--ramp", default=None, metavar="LO:HI:STEPS",
                    help="stepped open-loop rate ramp: LO..HI req/s across STEPS equal "
                    "steps over one service, per-step rate/goodput/p95 rows "
                    "(--requests = requests per step)")
    ap.add_argument("--capacity", action="store_true",
                    help="attach the capacity observatory to the ramp's service; rows "
                    "gain its desired-shards/knee/model-error readings")
    ap.add_argument("--warm-model", default=None,
                    help="learned warm-start artifact (.npz) seeding the admitted lanes")
    ap.add_argument("--baseline", choices=["serial"], default=None,
                    help="run the one-at-a-time baseline instead")
    ap.add_argument("--json", action="store_true", help="emit the raw report dict only")
    ap.add_argument("--reqtrace", action="store_true",
                    help="record per-request journeys and report SLO burn rates")
    ap.add_argument("--journal", default=None,
                    help="write the run journal here (implies --reqtrace)")
    ap.add_argument("--slo-latency", type=float, default=0.25,
                    help="SLO latency objective (s) for the burn-rate report")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="SLO good-fraction target for the burn-rate report")
    ap.add_argument("--self-check", action="store_true")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(device=args.device)
    if args.kill_shard and args.shards < 2:
        ap.error("--kill-shard needs --shards >= 2 (a 1-shard fleet killed mid-run has "
                 "nowhere to requeue)")
    if args.ramp is not None:
        try:
            lo_s, hi_s, steps_s = args.ramp.split(":")
            lo, hi, steps = float(lo_s), float(hi_s), int(steps_s)
        except ValueError:
            ap.error("--ramp wants LO:HI:STEPS (e.g. 20:200:6)")
        report = run_ramp(
            lo, hi, steps, requests_per_step=args.requests, bucket=args.bucket,
            chunk_iters=args.chunk_iters, max_iter=args.max_iter,
            queue_limit=args.queue_limit, dup_frac=args.dup_frac, seed=args.seed,
            shards=args.shards, capacity=args.capacity, deadline_s=args.deadline,
            device=args.device, out=None if args.json else sys.stderr,
        )
        print(json.dumps(report, indent=None if args.json else 2, default=str))
        return RC_OK
    if args.baseline == "serial":
        report = run_serial(requests=args.requests, rate=args.rate, max_iter=args.max_iter,
                            dup_frac=args.dup_frac, seed=args.seed, device=args.device)
    else:
        reqtrace = args.reqtrace or bool(args.journal)
        tracer = None
        if reqtrace:
            from dispatches_tpu_torch.obs.journal import Tracer, set_tracer

            tracer = Tracer(args.journal, manifest_extra={"run": "torch_loadgen"})
            set_tracer(tracer)
        try:
            report = run_service(
                requests=args.requests, rate=args.rate, bucket=args.bucket,
                chunk_iters=args.chunk_iters, max_iter=args.max_iter,
                queue_limit=args.queue_limit, dup_frac=args.dup_frac, seed=args.seed,
                deadline_s=args.deadline, reqtrace=reqtrace, shards=args.shards,
                kill_shard=args.kill_shard,
                telemetry=args.telemetry or (args.shards > 0
                                             and args.exporter_port is not None),
                exporter_port=args.exporter_port, device=args.device,
                warm_model=args.warm_model,
            )
        finally:
            if tracer is not None:
                from dispatches_tpu_torch.obs.journal import set_tracer

                set_tracer(None)
                tracer.close()
        if tracer is not None:
            from dispatches_tpu_torch.obs import slo as obs_slo

            report["slo"] = obs_slo.evaluate_slos(
                tracer.events, slos=[obs_slo.SLO("all", args.slo_latency, args.slo_target)],
            )
    print(json.dumps(report, indent=None if args.json else 2, default=str))
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
