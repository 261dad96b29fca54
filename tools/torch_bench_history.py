#!/usr/bin/env python
"""Bench trajectory: render, append to, and trend-gate the bench history
(the port's `tools/bench_history.py`, over `dispatches_tpu_torch.obs.
benchstore`; a history file crosses between the two tools both ways).

    python tools/torch_bench_history.py HISTORY.jsonl                # trajectory
    python tools/torch_bench_history.py HISTORY.jsonl --gate         # judge last
    python tools/torch_bench_history.py HISTORY.jsonl --gate-entry NEW.json \\
        --label bench                                                # judge file
    python tools/torch_bench_history.py HISTORY.jsonl --append NEW.json --label X
    python tools/torch_bench_history.py --self-check                 # synthetic gates

Where `tools/journal_diff.py` compares two points, this tool judges a run
against the **median of its last K comparable history entries** with
MAD-scaled thresholds (`obs.benchstore.trend_gate`): drift that passes
every pairwise diff accumulates against the median, while a single noisy
baseline point cannot gate the next run by itself. Per-metric direction
is `journal_diff`'s inference, so the two gates can never disagree about
which way "worse" points.

`--append` adds one entry from any nested-numeric JSON artifact, its
fingerprint naming this host's card (``torch.cuda.get_device_name``), so
an H100 entry never gates against TPU or CPU history.

Options:
  --gate              judge the newest history entry against the rest
  --gate-entry FILE   judge a metrics JSON against the whole history
  --label L           label for --gate-entry/--append rows (default bench)
  --k N               trailing window size (default 5)
  --nmad F            MAD multiplier (default 4.0)
  --rel-floor F       relative threshold floor (default 0.05)
  --min-points N      minimum comparable points before gating (default 3)
  --only PAT          gate only metrics containing PAT (repeatable)
  --ignore PAT        drop metrics containing PAT (repeatable)
  --list              print every gated row, not just regressions

Exit codes: 0 = ok / trajectory rendered, 1 = regression(s), 2 = error.

Stdlib + obs.benchstore only: the gate itself touches no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from dispatches_tpu_torch.obs import benchstore  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import journal_diff  # noqa: E402  (direction inference shared with the pair gate)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_trajectory(
    history: List[Dict[str, Any]], out=sys.stdout, last: int = 12
) -> None:
    """Per-run trajectory table over the metrics the whole tail shares."""
    if not history:
        print("bench_history: empty history", file=out)
        return
    tail = history[-last:]
    common = set(tail[0]["metrics"])
    for h in tail[1:]:
        common &= set(h["metrics"])
    cols = sorted(common)[:6]
    hdr = f"{'when':<17} {'label':<12} {'device':<14} {'sha':<8}"
    for c in cols:
        hdr += f" {c.rsplit('/', 1)[-1][:14]:>14}"
    print(hdr, file=out)
    import time as _time

    for h in tail:
        fp = h.get("fingerprint") or {}
        when = _time.strftime(
            "%Y-%m-%d %H:%M", _time.localtime(h.get("ts", 0))
        )
        row = (f"{when:<17} {str(h.get('label', '?')):<12} "
               f"{str(fp.get('device_kind') or 'host'):<14} "
               f"{str(fp.get('git_sha') or '')[:7]:<8}")
        for c in cols:
            row += f" {_fmt(h['metrics'].get(c)):>14}"
        print(row, file=out)
    print(f"{len(history)} entries ({len(tail)} shown), "
          f"{len(common)} shared metrics", file=out)


def render_gate(result: Dict[str, Any], out=sys.stdout,
                verbose: bool = False) -> None:
    shown = result["rows"] if verbose else result["regressions"]
    if shown:
        w = max(len(r["metric"]) for r in shown)
        for r in shown:
            if "median" in r:
                detail = (f"{r['value']:>12.6g} vs median {r['median']:.6g}"
                          f" (thr {r['threshold']:.3g}, {r['direction']})")
            else:
                detail = f"{r['value']:>12.6g} ({r['verdict']})"
            print(f"  {r['metric']:<{w}}  {detail}  {r['verdict']}",
                  file=out)
    print(f"{len(result['rows'])} metrics vs {result['baseline_n']} "
          f"baseline entries, {len(result['regressions'])} regression(s)",
          file=out)


def _load_metrics_json(path: str) -> Dict[str, float]:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return benchstore.flatten_metrics(json.load(fh))


def _filtered(entry: Dict[str, Any], only: List[str],
              ignore: List[str]) -> Dict[str, Any]:
    def keep(m: str) -> bool:
        if only and not any(p in m for p in only):
            return False
        return not any(p in m for p in ignore)

    out = dict(entry)
    out["metrics"] = {
        k: v for k, v in entry.get("metrics", {}).items() if keep(k)
    }
    return out


# ---------------------------------------------------------------------
# self-check


def _mk(label: str, ts: float, device: Optional[str],
        **metrics: float) -> Dict[str, Any]:
    # hand-built rows (not make_entry) so the scenario controls the
    # fingerprint instead of inheriting this host's
    return {
        "ts": ts,
        "label": label,
        "fingerprint": {"device_kind": device, "git_sha": "0" * 7},
        "metrics": dict(metrics),
    }


def self_check(out=sys.stdout) -> int:
    """Synthetic-history scenarios for the trend gate: flag an injected
    regression, pass an unchanged run, keep the device-kind fences."""
    checks: List = []

    def gate(history, entry, **kw):
        return benchstore.trend_gate(
            history, entry, lower_is_better=journal_diff.lower_is_better,
            **kw,
        )

    def ck(name: str, ok: bool) -> None:
        checks.append((name, ok))

    # jittery but stable history: wall wobbles ~2%, goodput ~1%
    hist = [
        _mk("bench", float(i), "TPU v4",
            wall_s=1.00 + 0.02 * (i % 3 - 1),
            goodput_rps=120.0 + (i % 2),
            flops=1e12)
        for i in range(8)
    ]
    same = _mk("bench", 99.0, "TPU v4",
               wall_s=1.01, goodput_rps=120.5, flops=1e12)
    g = gate(hist, same)
    ck("unchanged run passes", g["ok"])
    ck("jitter within MAD band never flags",
       all(r["verdict"] in ("ok", "improved") for r in g["rows"]))

    g = gate(hist, _mk("bench", 99.0, "TPU v4",
                       wall_s=1.60, goodput_rps=120.0, flops=1e12))
    ck("injected 60% slowdown flagged",
       not g["ok"]
       and any(r["metric"] == "wall_s" for r in g["regressions"]))

    g = gate(hist, _mk("bench", 99.0, "TPU v4",
                       wall_s=1.00, goodput_rps=60.0, flops=1e12))
    ck("goodput collapse flagged (higher is better)",
       any(r["metric"] == "goodput_rps" for r in g["regressions"]))

    g = gate(hist, _mk("bench", 99.0, "TPU v4",
                       wall_s=0.50, goodput_rps=240.0, flops=1e12))
    ck("improvement both directions never flags",
       g["ok"] and all(r["verdict"] == "improved"
                       for r in g["rows"] if r["metric"] != "flops"))

    # drift the pairwise gate is blind to: +4% per run on a stable base.
    # Each step is well under a 10% pairwise threshold, but the median
    # stays anchored at the stable level, so the gate fires within a
    # couple of steps of cumulative drift.
    drift_hist = [_mk("bench", float(i), "TPU v4", wall_s=1.0)
                  for i in range(5)]
    wall, fired_at = 1.0, None
    for step in range(1, 6):
        prev = wall
        wall *= 1.04
        if (wall - prev) / prev >= 0.10:
            fired_at = -1  # pairwise step too big — scenario is broken
            break
        nxt = _mk("bench", 10.0 + step, "TPU v4", wall_s=wall)
        if not gate(drift_hist, nxt)["ok"]:
            fired_at = step
            break
        drift_hist.append(nxt)
    ck("every pairwise step is under the 10% pair threshold",
       fired_at != -1)
    ck("cumulative drift gates against the median",
       fired_at is not None and fired_at >= 1)

    # comparability fences
    g = gate(hist, _mk("bench", 99.0, None, wall_s=9.0))
    ck("CPU run never gates against TPU history",
       g["baseline_n"] == 0
       and all(r["verdict"] == "new" for r in g["rows"]))
    g = gate(hist, _mk("bench", 99.0, "NVIDIA H100 80GB HBM3", wall_s=9.0))
    ck("H100 run never gates against TPU history",
       g["baseline_n"] == 0
       and all(r["verdict"] == "new" for r in g["rows"]))
    h100 = [_mk("bench", float(i), "NVIDIA H100 80GB HBM3", wall_s=0.5)
            for i in range(5)]
    g = gate(hist + h100, _mk("bench", 99.0, "NVIDIA H100 80GB HBM3", wall_s=0.9))
    ck("H100 run gates against H100 history only",
       g["baseline_n"] == 5 and not g["ok"])
    g = gate(hist, _mk("other_bench", 99.0, "TPU v4", wall_s=9.0))
    ck("different label never gates", g["baseline_n"] == 0)
    g = gate(hist[:2], _mk("bench", 99.0, "TPU v4", wall_s=9.0))
    ck("under min_points stays insufficient, never fires",
       g["ok"] and all(r["verdict"] == "insufficient" for r in g["rows"]))
    g = gate(hist, _mk("bench", 99.0, "TPU v4",
                       wall_s=1.0, brand_new_metric=7.0, goodput_rps=120.0,
                       flops=1e12))
    ck("brand-new metric lands as 'new', not a regression", g["ok"])

    # zero-MAD history: the relative floor carries the threshold
    flat = [_mk("bench", float(i), "TPU v4", wall_s=1.0) for i in range(5)]
    g = gate(flat, _mk("bench", 9.0, "TPU v4", wall_s=1.02))
    ck("2% wobble on a zero-MAD history passes (rel floor)", g["ok"])
    g = gate(flat, _mk("bench", 9.0, "TPU v4", wall_s=1.2))
    ck("20% jump on a zero-MAD history fails", not g["ok"])

    # direction inference really is journal_diff's
    ck("direction shared with journal_diff",
       not journal_diff.lower_is_better("x_goodput_rps")
       and journal_diff.lower_is_better("wall_s"))

    # round-trip through the real store (torn final line tolerated)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "hist.jsonl")
        for h in hist:
            benchstore.append_entry(path, h)
        with open(path, "a") as fh:
            fh.write('{"torn": ')
        back = benchstore.read_history(path)
        ck("store round-trips with a torn tail", len(back) == len(hist))
        g = gate(back, same)
        ck("gate over the re-read store still passes", g["ok"])

    ok = True
    for name, good in checks:
        if not good:
            ok = False
        print(f"  [{'ok' if good else 'FAIL'}] {name}", file=out)
    print(("self-check passed" if ok else "self-check FAILED")
          + f" ({len(checks)} scenarios)", file=out)
    return 0 if ok else 2


# ---------------------------------------------------------------------
# CLI


def main(argv: Optional[List[str]] = None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_bench_history",
        description="Render / append / trend-gate the bench history.",
    )
    ap.add_argument("history", nargs="?", help="history JSONL path")
    ap.add_argument("--gate", action="store_true",
                    help="judge the newest entry against the rest")
    ap.add_argument("--gate-entry", metavar="FILE",
                    help="judge a metrics JSON against the whole history")
    ap.add_argument("--append", metavar="FILE",
                    help="append a metrics JSON as a new entry")
    ap.add_argument("--label", default="bench")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--nmad", type=float, default=4.0)
    ap.add_argument("--rel-floor", type=float, default=0.05)
    ap.add_argument("--min-points", type=int, default=3)
    ap.add_argument("--only", action="append", default=[])
    ap.add_argument("--ignore", action="append", default=[])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--self-check", action="store_true")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(out)
    if not args.history:
        ap.print_usage(file=out)
        print("bench_history: need a HISTORY path (or --self-check)",
              file=out)
        return 2

    history = benchstore.read_history(args.history)

    if args.append:
        try:
            entry = benchstore.make_entry(
                args.label, _load_metrics_json(args.append)
            )
        except (OSError, json.JSONDecodeError) as e:
            print(f"bench_history: {e}", file=out)
            return 2
        benchstore.append_entry(args.history, entry)
        print(f"appended {len(entry['metrics'])} metrics as "
              f"'{args.label}' -> {args.history}", file=out)
        return 0

    gate_kw = dict(k=args.k, nmad=args.nmad, rel_floor=args.rel_floor,
                   min_points=args.min_points,
                   lower_is_better=journal_diff.lower_is_better)

    if args.gate_entry:
        try:
            entry = benchstore.make_entry(
                args.label, _load_metrics_json(args.gate_entry)
            )
        except (OSError, json.JSONDecodeError) as e:
            print(f"bench_history: {e}", file=out)
            return 2
        result = benchstore.trend_gate(
            history, _filtered(entry, args.only, args.ignore), **gate_kw
        )
        render_gate(result, out, verbose=args.list)
        return 0 if result["ok"] else 1

    if args.gate:
        if not history:
            print("bench_history: empty history, nothing to gate",
                  file=out)
            return 2
        result = benchstore.trend_gate(
            history[:-1], _filtered(history[-1], args.only, args.ignore),
            **gate_kw,
        )
        render_gate(result, out, verbose=args.list)
        return 0 if result["ok"] else 1

    render_trajectory(history, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
