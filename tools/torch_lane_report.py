#!/usr/bin/env python
"""torch_lane_report — routing decision ledger, shadow-probe regret,
advice (the port's counterpart of tools/lane_report.py, on PyTorch).

The lane observatory's operator console (docs/observability.md §14):
`obs/lanes.py` journals every routing decision (schema-v6
``lane_decision``), re-solves a sampled fraction on the alternate
IPM<->PDHG lane (``lane_probe``), and keeps per-(family, lane)
scoreboards whose damped ``route_advice`` the router can consume. This
tool renders all of it, from either a recorded journal or a live
exporter:

- **journal**: ``--journal run.jsonl`` scans ``lane_decision`` events
  for the per-(entry, lane) decision ledger and per-family lane shares,
  ``lane_probe`` events for the regret summary (outcomes, regret
  count/total/p50/p95 per family), and ``lane_advice_flip`` events for
  the advice history.
- **live**: ``--url http://HOST:PORT`` reads the exporter's ``/lanes``
  report (decision/probe counters + the full scoreboard).
- **export**: ``--export-dataset DIR`` runs a short probing session
  over the synthetic dense LP family (the same generator
  `tools/torch_canary_report.py` certifies goldens from), probes every solve
  on both lanes, and writes the retained (features -> per-lane walls/
  iterations/chosen) pairs as `learn.dataset` shards — the demo path
  for the ROADMAP item-2 training set; real deployments export from
  their live observatory (``fleet.lanes.export_dataset(dir)``).
- **self-check**: ``--self-check`` (the CI gate) proves the loop the
  plane exists for: it pins a deliberately *wrong* route (PDHG on a
  small dense-friendly family), serves solves down that route, and
  asserts the shadow probes measure nonzero regret
  (``lane_regret_seconds`` p95 > 0, ``regret`` outcomes counted), that
  unpinning lets the measured scoreboard flip ``route_advice`` back to
  the dense lane (a ``lane_advice_flip`` journal event lands), that the
  probes' lane mapping agrees with `runtime.remedy`'s lane switch, and
  that the exported probe dataset loads through
  `learn.dataset.load_dataset`. ``--exporter-port`` additionally serves
  ``/lanes`` from the self-check observatory while it runs.

The export and the self-check solve on ``--device`` (default the card);
the probes time the device (`obs.lanes`).

Usage:
    python tools/torch_lane_report.py --journal run.jsonl
    python tools/torch_lane_report.py --url http://127.0.0.1:9100
    python tools/torch_lane_report.py --export-dataset ./lane_ds --probes 24
    python tools/torch_lane_report.py --self-check [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the synthetic dense LP family shared with tools/torch_canary_report.py's
# goldens: fixed A and bounds, per-seed feasible b and objective c —
# small/dense enough that the IPM lane wins every probe on a host
_FAM_N, _FAM_M, _FAM_SEED = 8, 4, 7


def _family_problem(seed: int, device="cuda"):
    import numpy as np
    import torch

    from dispatches_tpu_torch.core.program import LPData

    A = np.random.default_rng(_FAM_SEED).standard_normal((_FAM_M, _FAM_N))
    r = np.random.default_rng(seed)
    x0 = r.uniform(0.5, 3.5, _FAM_N)
    c = r.standard_normal(_FAM_N)
    return LPData(*(torch.as_tensor(a, device=device) for a in (
        A, A @ x0, c, np.zeros(_FAM_N), np.full(_FAM_N, 4.0), np.asarray(0.0),
    )))


# ---------------------------------------------------------------------------
# journal mode


def _read_journal(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue  # torn tail line of a crashed run
    return records


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    import numpy as np

    return float(np.quantile(np.asarray(values, np.float64), q))


def summarize_journal(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure-host aggregation (unit-testable without solving anything):
    the decision ledger from ``lane_decision`` events, the regret
    summary from ``lane_probe`` events, the advice history from
    ``lane_advice_flip`` events."""
    decisions: Dict[tuple, int] = {}
    fam_lanes: Dict[str, Dict[str, int]] = {}
    probes: Dict[str, Dict[str, Any]] = {}
    flips: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("kind") != "event":
            continue
        name = rec.get("name")
        if name == "lane_decision":
            key = (rec.get("entry", "?"), rec.get("lane", "?"))
            decisions[key] = decisions.get(key, 0) + 1
            fam = rec.get("family")
            if fam:
                per = fam_lanes.setdefault(fam, {})
                lane = rec.get("lane", "?")
                per[lane] = per.get(lane, 0) + 1
        elif name == "lane_probe":
            fam = rec.get("family", "?")
            agg = probes.setdefault(fam, {
                "probes": 0, "outcomes": {}, "regrets": [],
            })
            agg["probes"] += 1
            outcome = rec.get("outcome", "?")
            agg["outcomes"][outcome] = agg["outcomes"].get(outcome, 0) + 1
            if outcome == "regret" and rec.get("regret_s") is not None:
                agg["regrets"].append(float(rec["regret_s"]))
        elif name == "lane_advice_flip":
            flips.append({
                "family": rec.get("family"),
                "previous": rec.get("previous"),
                "lane": rec.get("lane"),
            })
    for agg in probes.values():
        rs = agg.pop("regrets")
        agg["regret_count"] = len(rs)
        agg["regret_total_s"] = sum(rs)
        agg["regret_p50_s"] = _quantile(rs, 0.5)
        agg["regret_p95_s"] = _quantile(rs, 0.95)
    return {
        "decisions": {
            f"{entry}/{lane}": n
            for (entry, lane), n in sorted(decisions.items())
        },
        "family_lane_share": fam_lanes,
        "probes": probes,
        "advice_flips": flips,
    }


def _print_journal_summary(summary: Dict[str, Any], out=sys.stdout) -> None:
    print("== lane decisions ==", file=out)
    if not summary["decisions"]:
        print("  (no lane_decision events — observatory off, or a "
              "pre-v6 journal)", file=out)
    for key, n in summary["decisions"].items():
        print(f"  {key:<32} {n}", file=out)
    if summary["family_lane_share"]:
        print("== per-family lane share ==", file=out)
        for fam, per in sorted(summary["family_lane_share"].items()):
            total = sum(per.values())
            share = "  ".join(
                f"{lane}={n}({100.0 * n / total:.0f}%)"
                for lane, n in sorted(per.items())
            )
            print(f"  {fam[:12]:<14} {share}", file=out)
    print("== shadow probes ==", file=out)
    if not summary["probes"]:
        print("  (no lane_probe events)", file=out)
    for fam, agg in sorted(summary["probes"].items()):
        outc = ",".join(
            f"{k}={v}" for k, v in sorted(agg["outcomes"].items())
        )
        line = f"  {fam[:12]:<14} probes={agg['probes']} [{outc}]"
        if agg["regret_count"]:
            line += (
                f" regret: n={agg['regret_count']}"
                f" total={agg['regret_total_s']:.4f}s"
                f" p50={agg['regret_p50_s']:.4f}s"
                f" p95={agg['regret_p95_s']:.4f}s"
            )
        print(line, file=out)
    if summary["advice_flips"]:
        print("== advice flips ==", file=out)
        for f in summary["advice_flips"]:
            print(f"  {str(f['family'])[:12]:<14} "
                  f"{f['previous']} -> {f['lane']}", file=out)


def journal_mode(path: str) -> int:
    summary = summarize_journal(_read_journal(path))
    _print_journal_summary(summary)
    return 0


# ---------------------------------------------------------------------------
# live mode


def _fetch_json(url: str) -> Any:
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _print_scoreboard(rep: Dict[str, Any], out=sys.stdout) -> None:
    print(f"decisions={rep.get('decisions', 0)} "
          f"probes_run={rep.get('probes_run', 0)} "
          f"pending={rep.get('pending_probes', 0)} "
          f"probe_wall={rep.get('probe_wall_seconds', 0.0):.3f}s",
          file=out)
    outc = rep.get("outcomes") or {}
    if outc:
        print("outcomes: " + ", ".join(
            f"{k}={v}" for k, v in sorted(outc.items())
        ), file=out)
    board = rep.get("scoreboard") or {}
    if not board:
        print("(no scored families yet)", file=out)
        return
    print(f"{'family':<14}{'lane':<8}{'probes':>7}{'wins':>6}"
          f"{'ratio':>7}{'wall_p50':>10}{'wall_p95':>10}  advice",
          file=out)
    for fam, entry in sorted(board.items()):
        advice = entry.get("advice") or "-"
        if entry.get("forced"):
            advice += " (forced)"
        for lane, ls in sorted((entry.get("lanes") or {}).items()):
            def _f(v, unit="s"):
                return "-" if v is None else f"{v:.4f}"
            print(
                f"{fam[:12]:<14}{lane:<8}{ls['probes']:>7}{ls['wins']:>6}"
                f"{ls['win_ratio']:>7.2f}{_f(ls['wall_p50']):>10}"
                f"{_f(ls['wall_p95']):>10}  {advice}",
                file=out,
            )
            advice = ""  # once per family block


def live_mode(url: str) -> int:
    try:
        rep = _fetch_json(url.rstrip("/") + "/lanes")
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print("exporter has no lane observatory attached "
                  "(serve with lanes= / --lanes)", file=sys.stderr)
            return 1
        raise
    _print_scoreboard(rep)
    return 0


# ---------------------------------------------------------------------------
# probing session (export + self-check share it)


def _probe_session(
    *,
    probes: int,
    wrong_route: bool,
    seed0: int = 100,
    config: Optional[Dict[str, Any]] = None,
    device="cuda",
):
    """Build an observatory, serve `probes` instances of the synthetic
    family down one route (`wrong_route=True` takes the PDHG lane on
    this dense-friendly family), probe every one, and return
    ``(observatory, family, problems)``."""
    from dispatches_tpu_torch.learn.dataset import family_fingerprint
    from dispatches_tpu_torch.obs.lanes import LaneConfig, LaneObservatory
    from dispatches_tpu_torch.runtime.remedy import dense_to_sparse
    from dispatches_tpu_torch.solvers.ipm import solve_lp
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    import numpy as np

    cfg = {"probe_fraction": 1.0, "max_pending": max(64, probes),
           "min_probes": 3, "hold": 2}
    cfg.update(config or {})
    obs = LaneObservatory(LaneConfig.from_mapping(cfg))
    problems = []
    for i in range(probes):
        lp = _family_problem(seed0 + i, device)
        if wrong_route:
            slp = dense_to_sparse(lp)
            sol = solve_lp_pdhg(slp, tol=1e-6)
            obs.note_solve(
                slp, "pdhg", entry="lane_report",
                iterations=int(sol.iterations),
            )
            problems.append(slp)
        else:
            sol = solve_lp(lp)
            obs.note_solve(
                lp, "dense", entry="lane_report",
                iterations=int(sol.iterations),
            )
            problems.append(lp)
    family = family_fingerprint(problems[0])
    return obs, family, problems


def export_mode(directory: str, probes: int, device="cuda") -> int:
    obs, family, _ = _probe_session(probes=probes, wrong_route=False, device=device)
    obs.run_probes()
    paths = obs.export_dataset(directory)
    rep = obs.report()
    print(f"probed {rep['probes_run']} solve(s) over family "
          f"{family[:12]}...: outcomes={rep['outcomes']}")
    if not paths:
        print("lane_report: no scored probe pairs to export "
              "(every probe errored?)", file=sys.stderr)
        return 1
    for p in paths:
        print(f"wrote {p}")
    print("load with: learn.dataset.load_dataset("
          f"[{directory!r}], varying=('b', 'c'))")
    return 0


# ---------------------------------------------------------------------------
# self-check


def self_check(exporter_port: Optional[int] = None, device="cuda") -> int:
    import tempfile
    import time

    import numpy as np

    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        print(f"  {'PASS' if ok else 'FAIL'}  {name}"
              + (f"  ({detail})" if detail and not ok else ""))
        if not ok:
            failures.append(name)

    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.journal import Tracer, set_tracer
    from dispatches_tpu_torch.obs.lanes import LANE_CODES

    tracer = Tracer(None)  # in-memory: the flip event is asserted below
    set_tracer(tracer)

    t0 = time.monotonic()
    # Install the deliberately wrong route: this family is small and
    # dense — the IPM lane beats first-order PDHG on every instance —
    # but we pin PDHG advice and serve every solve down the PDHG lane.
    obs, family, _ = _probe_session(probes=8, wrong_route=True, device=device)
    obs.force_advice(family, "pdhg")
    check("wrong route pinned", obs.advice(family) == "pdhg")
    check("route_advice gauge shows the pinned lane",
          obs_metrics.sum_gauges("route_advice", family=family[:8])
          == LANE_CODES["pdhg"])

    recs = obs.run_probes()
    print(f"  ran {len(recs)} shadow probe(s) "
          f"({time.monotonic() - t0:.1f}s)")
    outcomes = obs.report()["outcomes"]
    check("every queued probe was scored", len(recs) == 8,
          str(outcomes))
    check("shadow probes measure nonzero regret on the wrong route",
          outcomes.get("regret", 0) > 0, str(outcomes))
    p95 = obs_metrics.histogram_quantile(
        "lane_regret_seconds", 0.95, family=family[:8]
    )
    check("lane_regret_seconds p95 is positive",
          p95 is not None and p95 > 0.0, str(p95))
    board = obs.scoreboard()[family]["lanes"]
    check("the dense lane out-wins the routed PDHG lane",
          board["dense"]["wins"] > board["pdhg"]["wins"], str(board))

    # remedy-mapping agreement: the probe's cross-lane objective must
    # match what remedy's own lane-switch row mapping reports
    probe0 = recs[0]
    check("probe lanes agree in optimum (remedy mapping round-trip)",
          probe0["outcome"] in ("regret", "chosen_best")
          and abs(probe0["obj_chosen"] - probe0["obj_alt"])
          <= 1e-4 * max(1.0, abs(probe0["obj_chosen"])),
          str(probe0))

    # Unpin: the measured scoreboard must now overturn the route. A few
    # more served-and-probed solves re-evaluate advice on each probe.
    obs.force_advice(family, None)
    from dispatches_tpu_torch.runtime.remedy import dense_to_sparse
    from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg

    for i in range(4):
        slp = dense_to_sparse(_family_problem(400 + i, device))
        sol = solve_lp_pdhg(slp, tol=1e-6)
        obs.note_solve(
            slp, "pdhg", entry="lane_report",
            iterations=int(sol.iterations),
        )
    obs.run_probes()
    check("measured regret flips route_advice to the dense lane",
          obs.advice(family) == "dense", str(obs.scoreboard()))
    flips = [
        e for e in tracer.events
        if e.get("kind") == "event" and e.get("name") == "lane_advice_flip"
    ]
    check("lane_advice_flip journal event landed",
          any(f.get("lane") == "dense" for f in flips), str(flips))
    check("route_advice gauge flipped with it",
          obs_metrics.sum_gauges("route_advice", family=family[:8])
          == LANE_CODES["dense"])

    # journal summary sees the same story
    summary = summarize_journal(tracer.events)
    check("journal ledger counts every decision",
          summary["decisions"].get("lane_report/pdhg", 0) == 12,
          str(summary["decisions"]))
    check("journal regret summary is populated",
          summary["probes"].get(family, {}).get("regret_count", 0) > 0,
          str(summary["probes"]))

    # exported probe pairs load as a learn/ dataset
    with tempfile.TemporaryDirectory(prefix="lane_check_") as tmp:
        paths = obs.export_dataset(tmp)
        check("probe pairs exported as shards", bool(paths))
        try:
            from dispatches_tpu_torch.learn.dataset import load_dataset

            ds = load_dataset([tmp], varying=("b", "c"))
            nrows = int(np.asarray(ds.X).shape[0])
            check("load_dataset ingests the lane-probe shards",
                  nrows > 0 and ds.family == family,
                  f"rows={nrows} family={ds.family[:12]}")
        except Exception as e:
            check("load_dataset ingests the lane-probe shards", False,
                  f"{type(e).__name__}: {e}")

    exporter = None
    if exporter_port is not None:
        from dispatches_tpu_torch.obs.exporter import TelemetryExporter

        exporter = TelemetryExporter(
            exporter_port, lanes_fn=obs.report
        ).start()
        print(f"  exporter: {exporter.url('/lanes')}")
    try:
        from dispatches_tpu_torch.obs.exporter import TelemetryExporter

        ex = exporter or TelemetryExporter(lanes_fn=obs.report)
        status, _, body = ex.handle_path("/lanes")
        payload = json.loads(body.decode("utf-8"))
        check("/lanes serves the scoreboard",
              status == 200 and payload.get("probes_run", 0) >= 12,
              f"status={status}")
    finally:
        if exporter is not None:
            exporter.stop()

    print(
        f"torch_lane_report self-check: {'OK' if not failures else 'FAILED'} "
        f"({len(failures)} failure(s), {time.monotonic() - t0:.1f}s)"
    )
    return 1 if failures else 0


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--journal", default=None,
                    help="journal .jsonl to summarize")
    ap.add_argument("--url", default=None,
                    help="live exporter base URL (reads /lanes)")
    ap.add_argument("--export-dataset", default=None, metavar="DIR",
                    help="run a synthetic probing session and write "
                    "learn/-format lane-probe shards to DIR")
    ap.add_argument("--probes", type=int, default=24,
                    help="probe count for --export-dataset (default 24)")
    ap.add_argument("--self-check", action="store_true",
                    help="CI gate: wrong route -> measured regret -> "
                    "advice flip -> ingestible dataset")
    ap.add_argument("--exporter-port", type=int, default=None,
                    help="with --self-check: also serve /lanes from the "
                    "self-check observatory")
    ap.add_argument("--device", default="cuda",
                    help="where the export and the self-check solve "
                    "(default: the card)")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(args.exporter_port, device=args.device)
    if args.journal:
        return journal_mode(args.journal)
    if args.url:
        return live_mode(args.url)
    if args.export_dataset:
        return export_mode(args.export_dataset, args.probes, device=args.device)
    ap.error("one of --journal / --url / --export-dataset / --self-check "
             "is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
