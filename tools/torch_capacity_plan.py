#!/usr/bin/env python
"""What-if capacity planning over the measured fleet twin (the port's
`tools/capacity_plan.py`).

Answers operator questions — "how many shards for 40 req/s under a
250 ms p95?", "where is this fleet's knee?", "what happens at double
today's rate?" — by rebuilding the `dispatches_tpu_torch.obs.capacity`
fleet twin from a capacity report's ``service_quantiles`` and
replaying hypothetical load through it. Three report sources:

    python tools/torch_capacity_plan.py --url http://host:9100        # live
    python tools/torch_capacity_plan.py --journal bench_journal.jsonl
    python tools/torch_capacity_plan.py --bench BENCH_DIAG.json
    ... [--rate 40] [--shards 4] [--p95 0.25] [--json]

``--url`` scrapes a running exporter's ``/capacity`` endpoint (the
observatory's full report); ``--journal`` takes the last
``capacity_report`` event from a journal (bench.py writes one);
``--bench`` reads the ``serve.capacity.report`` block of a
BENCH_DIAG.json snapshot. All three carry the measured service-time
CDF, so planning is offline and deterministic — no fleet required.

With no question flags the tool prints the current estimate, the
fleet's knee and the recommendation. ``--rate R`` asks for the
smallest fleet meeting the p95 target at R req/s plus the predicted
latency/goodput at the CURRENT fleet size; ``--shards N`` asks for the
knee and operating point of an N-shard fleet; ``--p95 T`` overrides
the report's target.

`--self-check` is the acceptance of the whole capacity plane, on the
card unless ``--device cpu`` asks for the CPU. It drives a real 2-shard
fleet through a `tools/torch_loadgen.py` stepped ramp (large LPs, so the
fleet saturates inside the ramp),
locates the measured saturation knee from the per-step goodput rows,
and gates:

- the twin's knee prediction within a factor of ``KNEE_TOL`` (4x) of
  the measured knee — generous because the twin extrapolates beyond
  the sampled operating points and shared CI boxes jitter, but tight
  enough to catch an estimator that is order-of-magnitude wrong;
- the twin's predicted p95 at the measured knee within a factor of
  ``P95_TOL`` (6x) of the observed p95 at that step;
- Little's-law residual at the saturated operating point under
  ``LITTLES_BOUND`` (0.5) and the twin's mean-sojourn model error
  under ``MODEL_ERROR_BOUND`` (0.75);
- ``fleet_desired_shards`` non-decreasing across the ramp (hysteresis
  must not oscillate) and >= 2 once saturated;
- zero lost requests, and the offline planning path answering from
  the ramp's own saved report;
- bitwise neutrality: `capacity=True` must not change solver results.

Exit 0 pass / 1 gate trip / 2 error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

RC_OK, RC_GATE, RC_ERROR = 0, 1, 2

# documented self-check tolerances (see module docstring)
KNEE_TOL = 4.0
P95_TOL = 6.0
LITTLES_BOUND = 0.5
MODEL_ERROR_BOUND = 0.75
GOODPUT_KNEE_FRAC = 0.8


# -- report sources ----------------------------------------------------

def _http_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10.0) as r:
        return json.loads(r.read().decode("utf-8"))


def load_report(
    url=None, journal=None, bench=None, report_path=None,
) -> dict:
    """One capacity report dict from whichever source was given."""
    if url is not None:
        return _http_json(url.rstrip("/") + "/capacity")
    if journal is not None:
        from dispatches_tpu_torch.obs.journal import read_journal

        reps = [
            r.get("report") for r in read_journal(journal)
            if r.get("kind") == "capacity_report" and r.get("report")
        ]
        if not reps:
            raise ValueError(f"no capacity_report events in {journal}")
        return reps[-1]
    if bench is not None:
        with open(bench) as f:
            diag = json.load(f)
        rep = ((diag.get("serve") or {}).get("capacity") or {}).get(
            "report"
        )
        if not rep:
            raise ValueError(f"no serve.capacity.report block in {bench}")
        return rep
    if report_path is not None:
        with open(report_path) as f:
            rep = json.load(f)
        # accept either a bare report or a loadgen ramp report that
        # embeds one under "capacity"
        return rep.get("capacity", rep) if "rows" in rep else rep
    raise ValueError("no report source given")


# -- offline planning --------------------------------------------------

def twin_from_report(report: dict):
    """Rebuild the deterministic fleet twin from a report's measured
    service-time CDF + config (the whole point of shipping
    ``service_quantiles`` in the report)."""
    from dispatches_tpu_torch.obs.capacity import FleetTwin

    cfg = report.get("config") or {}
    quantiles = report.get("service_quantiles")
    if not quantiles:
        raise ValueError(
            "report carries no service_quantiles (estimator window was "
            "not ok yet — drive some load first)"
        )
    return FleetTwin(
        [(float(q), float(v)) for q, v in quantiles],
        lanes_per_shard=int(cfg.get("lanes_per_shard", 1)),
        queue_limit=int(cfg.get("queue_limit", 256)),
        seed=int(cfg.get("seed", 0)),
    )


def plan(
    report: dict,
    rate=None,
    shards=None,
    p95=None,
    max_shards: int = 32,
) -> dict:
    """Answer the what-if questions offline. Returns a JSON-safe dict
    with the rebuilt twin's knee for the current (or asked) fleet size
    and, when ``rate`` is given, the smallest fleet meeting the p95
    target at that rate."""
    twin = twin_from_report(report)
    cfg = report.get("config") or {}
    target = float(p95) if p95 is not None else float(
        cfg.get("p95_target", 0.25)
    )
    goodput_frac = float(cfg.get("goodput_frac", 0.85))
    cur = int(shards) if shards is not None else int(
        ((report.get("recommendation") or {}).get("actual_up_shards"))
        or cfg.get("shards", 1)
    )
    out = {
        "source_estimate": report.get("estimate"),
        "p95_target_s": target,
        "shards": cur,
        "mean_service_s": twin.mean_service_s,
        "knee": twin.knee(
            cur, p95_limit=target, goodput_frac=goodput_frac
        ),
    }
    if rate is not None:
        rate = float(rate)
        out["at_rate"] = {
            "rate_per_sec": rate,
            "current_fleet": twin.simulate(rate, cur),
        }
        feasible = None
        for s in range(1, int(max_shards) + 1):
            sim = twin.simulate(rate, s)
            if (
                sim["p95_s"] <= target
                and sim["goodput_per_sec"] >= goodput_frac * rate
            ):
                feasible = {"shards": s, "predicted": sim}
                break
        out["at_rate"]["smallest_fleet"] = feasible  # None = infeasible
    return out


# -- self-check --------------------------------------------------------

def _measured_knee(rows) -> float:
    """Highest offered rate whose goodput still tracked the offer
    (>= GOODPUT_KNEE_FRAC of it). Falls back to the first step when
    even that one fell short — 'already past saturation'."""
    knee = None
    for row in rows:
        if row["goodput_rps"] >= GOODPUT_KNEE_FRAC * row["rate_rps"]:
            knee = row["rate_rps"]
    return knee if knee is not None else rows[0]["rate_rps"]


def _neutrality_leg(out, device) -> list:
    """capacity=True must be bitwise-neutral on solver results."""
    import numpy as np

    from dispatches_tpu_torch.serve import make_dense_service

    from torch_loadgen import make_problem

    failures = []
    probs = [make_problem(s) for s in range(3000, 3012)]

    def _run(**kw):
        svc = make_dense_service(
            2, chunk_iters=4, max_iter=40, cache_size=None, device=device, **kw
        )
        tix = [svc.submit(p, priority="batch") for p in probs]
        svc.drain()
        return [t.result(0) for t in tix]

    base = _run()
    cap = _run(capacity=True)
    mismatched = 0
    for a, b in zip(base, cap):
        for la, lb in zip(a.solution, b.solution):
            if np.asarray(la).tobytes() != np.asarray(lb).tobytes():
                mismatched += 1
                break
        if a.verdict != b.verdict:
            mismatched += 1
    if mismatched:
        failures.append(
            f"neutrality: {mismatched}/{len(probs)} results differ "
            "with capacity=True"
        )
    else:
        print(
            f"neutrality: {len(probs)} solves bitwise-identical with "
            "capacity=True", file=out,
        )
    return failures


def _ramp_leg(out, device) -> list:
    """The measured-knee acceptance: ramp a 2-shard fleet into
    saturation, gate the twin against what actually happened."""
    from torch_loadgen import run_ramp

    failures = []
    # 768 x 384 LPs (~0.4 s for a batch of 2 on two CPU threads) make the
    # fleet saturate near ~10 req/s: drivable open-loop from Python, so
    # the ramp's top steps overload it and the estimator sees a
    # saturated operating point
    rep = run_ramp(
        3.0, 12.0, 4, requests_per_step=24, shards=2, bucket=2,
        chunk_iters=8, max_iter=60, dup_frac=0.0,
        capacity={
            "window": 20.0, "p95_target": 1.0, "twin_every": 2.0,
            "max_shards": 8,
        },
        lp_n=512, lp_m=256, out=out, device=device,
    )
    rows = rep["rows"]
    lost = sum(
        row["offered"] - row["ok"] - row["shed"] for row in rows
    )
    if lost:
        failures.append(f"ramp: {lost} requests lost")
    capacity = rep.get("capacity") or {}
    est = capacity.get("estimate") or {}
    if not est.get("ok"):
        failures.append("ramp: estimator window never became ok")
        return failures

    measured_knee = _measured_knee(rows)
    knee = (capacity.get("twin") or {}).get("knee") or {}
    twin_knee = knee.get("knee_rate_per_sec")
    if not twin_knee:
        failures.append("ramp: twin published no knee")
        return failures
    ratio = twin_knee / measured_knee
    print(
        f"knee: measured={measured_knee:.1f}/s twin={twin_knee:.1f}/s "
        f"(ratio {ratio:.2f}, tolerance {KNEE_TOL}x)", file=out,
    )
    if not (1.0 / KNEE_TOL <= ratio <= KNEE_TOL):
        failures.append(
            f"knee gate: twin {twin_knee:.1f}/s vs measured "
            f"{measured_knee:.1f}/s outside {KNEE_TOL}x"
        )

    # p95 at the measured knee: rebuild the twin from the ramp's own
    # report (this also exercises the offline planning path end to end)
    twin = twin_from_report(capacity)
    sim = twin.simulate(measured_knee, 2)
    knee_rows = [
        r for r in rows
        if r["rate_rps"] <= measured_knee and r["p95_s"] is not None
    ]
    observed_p95 = knee_rows[-1]["p95_s"] if knee_rows else None
    if observed_p95:
        p95_ratio = sim["p95_s"] / observed_p95
        print(
            f"p95 at knee: observed={observed_p95 * 1e3:.0f}ms "
            f"twin={sim['p95_s'] * 1e3:.0f}ms (ratio {p95_ratio:.2f}, "
            f"tolerance {P95_TOL}x)", file=out,
        )
        if not (1.0 / P95_TOL <= p95_ratio <= P95_TOL):
            failures.append(
                f"p95 gate: twin {sim['p95_s']:.3f}s vs observed "
                f"{observed_p95:.3f}s at the knee outside {P95_TOL}x"
            )

    littles = est.get("littles_residual")
    if littles is None or littles > LITTLES_BOUND:
        failures.append(
            f"laws gate: littles_residual {littles} over "
            f"{LITTLES_BOUND} at the saturated operating point"
        )
    else:
        print(f"laws: littles_residual={littles:.3f} "
              f"(bound {LITTLES_BOUND})", file=out)
    err = (capacity.get("twin") or {}).get("model_error_ratio")
    if err is None or err > MODEL_ERROR_BOUND:
        failures.append(
            f"validation gate: model_error_ratio {err} over "
            f"{MODEL_ERROR_BOUND}"
        )
    else:
        print(f"validation: model_error_ratio={err:.3f} "
              f"(bound {MODEL_ERROR_BOUND})", file=out)

    desired = [
        (row.get("capacity") or {}).get("desired_shards")
        for row in rows
    ]
    desired = [d for d in desired if d is not None]
    if len(desired) < 2:
        failures.append("autoscale gate: no desired_shards trajectory")
    else:
        drops = [
            (a, b) for a, b in zip(desired, desired[1:]) if b < a
        ]
        if drops:
            failures.append(
                f"autoscale gate: fleet_desired_shards oscillated "
                f"within the ramp ({desired})"
            )
        if desired[-1] < 2:
            failures.append(
                f"autoscale gate: saturated 2-shard fleet recommends "
                f"only {desired[-1]} shard(s) ({desired})"
            )
        if not drops and desired[-1] >= 2:
            print(f"autoscale: desired_shards trajectory {desired} "
                  "(monotone, saturated >= 2)", file=out)

    # the offline planner must answer from the saved report
    answer = plan(capacity, rate=measured_knee, max_shards=8)
    if not (answer.get("knee") or {}).get("knee_rate_per_sec"):
        failures.append("plan: offline path produced no knee")
    return failures


def _determinism_leg(out) -> list:
    """Same twin inputs -> bitwise-same predictions."""
    from dispatches_tpu_torch.obs.capacity import FleetTwin

    q = [(0.0, 0.05), (0.5, 0.1), (0.95, 0.3), (1.0, 0.4)]
    a = FleetTwin(q, lanes_per_shard=4, seed=7).simulate(20.0, 2)
    b = FleetTwin(q, lanes_per_shard=4, seed=7).simulate(20.0, 2)
    if a != b:
        return [f"determinism: twin replay diverged ({a} vs {b})"]
    print("determinism: twin replay bitwise-stable", file=out)
    return []


def self_check(out=sys.stdout, device="cuda") -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if str(device).startswith("cpu"):
        import torch

        # two threads a process (the shard children take the parent's
        # count): with one a core, the children oversubscribe the host
        torch.set_num_threads(min(2, torch.get_num_threads()))

    failures = []
    failures += _determinism_leg(out)
    failures += _neutrality_leg(out, device)
    failures += _ramp_leg(out, device)
    if failures:
        for f in failures:
            print(f"capacity_plan self-check FAIL: {f}", file=out)
        return RC_GATE
    print("capacity_plan self-check passed", file=out)
    return RC_OK


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_capacity_plan",
        description="What-if capacity planning over the measured fleet "
        "twin (live exporter, journal, or bench snapshot).",
    )
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--url", default=None,
                     help="scrape a live exporter's /capacity endpoint")
    src.add_argument("--journal", default=None,
                     help="read the last capacity_report event from a "
                     "journal")
    src.add_argument("--bench", default=None,
                     help="read the serve.capacity.report block of a "
                     "BENCH_DIAG.json snapshot")
    src.add_argument("--report", default=None,
                     help="read a saved /capacity JSON (or a loadgen "
                     "--ramp report embedding one)")
    ap.add_argument("--rate", type=float, default=None,
                    help="ask: smallest fleet meeting the p95 target at "
                    "this arrival rate (req/s)")
    ap.add_argument("--shards", type=int, default=None,
                    help="ask: knee and operating point of an N-shard "
                    "fleet (default: the report's current fleet)")
    ap.add_argument("--p95", type=float, default=None,
                    help="override the report's p95 target (seconds)")
    ap.add_argument("--max-shards", type=int, default=32)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw answer dict only")
    ap.add_argument("--self-check", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the self-check's services run (default: the card)")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(device=args.device)

    try:
        report = load_report(
            url=args.url, journal=args.journal, bench=args.bench,
            report_path=args.report,
        )
        answer = plan(
            report, rate=args.rate, shards=args.shards, p95=args.p95,
            max_shards=args.max_shards,
        )
    except Exception as e:  # noqa: BLE001 - operator-facing CLI
        print(f"capacity_plan error: {e}", file=sys.stderr)
        return RC_ERROR
    print(json.dumps(answer, indent=None if args.json else 2,
                     default=str))
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
