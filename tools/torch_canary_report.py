#!/usr/bin/env python
"""torch_canary_report — per-family canary pass/fail and residual trend
(the port's counterpart of tools/canary_report.py, on PyTorch).

The conformance plane's operator console (docs/observability.md §12):
golden canary probes (`serve/canary.py`) tell you whether the fleet
still reproduces certified answers; the per-solve KKT residual stream
(`obs/conformance.py`) tells you whether answer quality is drifting
even when every probe passes. This tool renders both, from either a
recorded journal or a live exporter:

- **journal**: ``--journal run.jsonl`` scans solve records for their
  ``conformance`` certificates (per-entry residual trend: count, worst,
  p50, first-half vs second-half drift) and ``canary`` events for the
  per-golden pass/fail table.
- **live**: ``--url http://HOST:PORT`` reads the exporter's
  ``/conformance`` report (checker aggregate + canary scheduler state)
  and the retained ``solve_residual_*_p95`` tracks from ``/query``.
- **certify**: ``--certify goldens.npz`` builds and certifies goldens
  over the synthetic dense LP family (the same generator the
  self-check and `tools/torch_train_warmstart.py --self-check` use) and
  writes the versioned artifact `serve.canary.save_goldens` emits —
  the demo path; real deployments certify their own problems through
  `serve.canary.certify_golden`.
- **self-check**: ``--self-check`` (the CI gate) proves the plane
  catches what trajectory health cannot: it trains a small warm-start
  artifact, tampers with its destandardization constants (a *silent*
  corruption — version and family manifest still load cleanly), runs
  two 2-shard fleets at a loose solver tolerance, and asserts the
  canary round flags the tampered fleet (``canary_mismatch`` firing,
  probe verdicts still ``healthy`` — the answers converged, they are
  just wrong) while the clean fleet reproduces every golden and stays
  silent.

Certification, training and the self-check's fleets run on ``--device``
(default the card). The goldens artifact is the JAX package's format.

Usage:
    python tools/torch_canary_report.py --journal run.jsonl
    python tools/torch_canary_report.py --url http://127.0.0.1:9100
    python tools/torch_canary_report.py --certify goldens.npz --goldens 3
    python tools/torch_canary_report.py --self-check [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RESIDUAL_FIELDS = ("res_primal", "res_dual", "comp", "gap")

# the synthetic dense LP family shared with tools/torch_train_warmstart.py's
# self-check: fixed A and bounds, per-seed feasible b and objective c
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


def _trend(values: List[float]) -> str:
    """First-half vs second-half mean: the cheapest honest drift arrow."""
    if len(values) < 4:
        return "-"
    half = len(values) // 2
    a = sum(values[:half]) / half
    b = sum(values[half:]) / (len(values) - half)
    if b > 2.0 * a and b > 1e-12:
        return "degrading"
    if a > 2.0 * b and a > 1e-12:
        return "improving"
    return "flat"


def summarize_journal(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure-host aggregation (unit-testable without a fleet): residual
    streams per entry from solve records' ``conformance`` attrs, and the
    per-golden canary ledger from ``canary`` events."""
    residuals: Dict[str, Dict[str, List[float]]] = {}
    outcomes: Dict[str, Dict[str, int]] = {}
    canaries: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") == "solve" and isinstance(
            rec.get("conformance"), dict
        ):
            conf = rec["conformance"]
            entry = str(rec.get("name", "?"))
            per = residuals.setdefault(
                entry, {f: [] for f in RESIDUAL_FIELDS}
            )
            for f in RESIDUAL_FIELDS:
                v = conf.get(f)
                if isinstance(v, (int, float)):
                    per[f].append(float(v))
            out = str(conf.get("outcome", "pass"))
            oc = outcomes.setdefault(entry, {})
            oc[out] = oc.get(out, 0) + 1
        elif rec.get("kind") == "event" and rec.get("name") == "canary":
            g = str(rec.get("golden", "?"))
            led = canaries.setdefault(
                g, {"rounds": 0, "outcomes": {}, "last": None}
            )
            led["rounds"] += 1
            out = str(rec.get("outcome", "?"))
            led["outcomes"][out] = led["outcomes"].get(out, 0) + 1
            led["last"] = {
                k: rec.get(k)
                for k in ("round", "verdict", "outcome", "rel_x", "rel_obj")
            }
    return {"residuals": residuals, "outcomes": outcomes,
            "canaries": canaries}


def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.2e}"


def render_report(summary: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    canaries = summary["canaries"]
    lines.append("canary probes:")
    if not canaries:
        lines.append("  (no canary events)")
    else:
        lines.append(
            f"  {'golden':>12}  {'rounds':>6}  {'exact':>5}  {'tol':>5}"
            f"  {'mismatch':>8}  {'inconcl':>7}  {'last rel_x':>10}  status"
        )
        for g in sorted(canaries):
            led = canaries[g]
            oc = led["outcomes"]
            last = led["last"] or {}
            bad = oc.get("mismatch", 0)
            status = "FAIL" if bad else "ok"
            lines.append(
                f"  {g:>12}  {led['rounds']:>6}  {oc.get('exact', 0):>5}"
                f"  {oc.get('tolerance', 0):>5}  {bad:>8}"
                f"  {oc.get('inconclusive', 0):>7}"
                f"  {_fmt(last.get('rel_x')):>10}  {status}"
            )
    lines.append("residual streams:")
    residuals = summary["residuals"]
    if not residuals:
        lines.append("  (no solve records carried conformance certificates)")
    else:
        for entry in sorted(residuals):
            oc = summary["outcomes"].get(entry, {})
            bad = sum(v for k, v in oc.items() if k != "pass")
            lines.append(
                f"  {entry}: {sum(oc.values())} checked, {bad} failed"
            )
            for f in RESIDUAL_FIELDS:
                vals = residuals[entry][f]
                if not vals:
                    continue
                srt = sorted(vals)
                lines.append(
                    f"    {f:>10}  n={len(vals):<5} worst={max(vals):.2e}"
                    f"  p50={srt[len(srt) // 2]:.2e}  trend={_trend(vals)}"
                )
    return lines


def run_journal(args: argparse.Namespace) -> int:
    summary = summarize_journal(_read_journal(args.journal))
    print(f"torch_canary_report: {args.journal}")
    for line in render_report(summary):
        print(line)
    mismatches = sum(
        led["outcomes"].get("mismatch", 0)
        for led in summary["canaries"].values()
    )
    if args.fail_on_mismatch and mismatches:
        print(f"torch_canary_report: FAIL — {mismatches} canary mismatch(es)")
        return 1
    print("torch_canary_report: OK")
    return 0


# ---------------------------------------------------------------------------
# live mode


def _get_json(url: str, timeout: float = 3.0) -> Optional[Dict[str, Any]]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError:
        return None
    except (OSError, ValueError):
        return None


def run_live(args: argparse.Namespace) -> int:
    base = args.url.rstrip("/")
    rep = _get_json(base + "/conformance")
    print(f"torch_canary_report: {base}")
    if rep is None:
        print("  no /conformance report (plane off, or exporter predates it)")
        return 1
    mismatches = 0
    canary = rep.get("canary")
    if canary:
        print(
            f"  canary {canary.get('scheduler')}: "
            f"{canary.get('rounds', 0)} round(s), "
            f"{canary.get('mismatches', 0)} mismatch(es), "
            f"{canary.get('pending', 0)} pending"
        )
        mismatches = int(canary.get("mismatches") or 0)
        for g, last in sorted((canary.get("goldens") or {}).items()):
            last = last or {}
            print(
                f"    {g:>12}  last={last.get('outcome', '-'):>10}"
                f"  rel_x={_fmt(last.get('rel_x'))}"
                f"  verdict={last.get('verdict', '-')}"
            )
    conf = rep.get("conformance")
    if conf:
        print(
            f"  conformance: {conf.get('checked', 0)} checked, "
            f"outcomes={conf.get('outcomes')}"
        )
        for entry, worst in sorted((conf.get("worst") or {}).items()):
            fields = "  ".join(
                f"{f}={_fmt(worst.get(f))}" for f in RESIDUAL_FIELDS
            )
            print(f"    {entry}: {fields}")
    for f in ("primal", "dual", "comp", "gap"):
        q = _get_json(
            base + f"/query?name=solve_residual_{f}_p95&window={args.window}"
        )
        series = (q or {}).get("series") or []
        pts = [
            v for s in series for v in (s.get("v") or [])
            if isinstance(v, (int, float))
        ]
        if pts:
            print(
                f"  residual_{f}_p95: {len(pts)} point(s), "
                f"last={pts[-1]:.2e}, worst={max(pts):.2e}, "
                f"trend={_trend(pts)}"
            )
    if args.fail_on_mismatch and mismatches:
        print(f"torch_canary_report: FAIL — {mismatches} canary mismatch(es)")
        return 1
    print("torch_canary_report: OK")
    return 0


# ---------------------------------------------------------------------------
# certify mode


def run_certify(args: argparse.Namespace) -> int:
    from dispatches_tpu_torch.serve.canary import certify_golden, save_goldens

    goldens = []
    for i in range(args.goldens):
        lp = _family_problem(args.seed + i, args.device)
        g = certify_golden(
            f"dense{i}", lp, tol=args.tol,
            certify_tol=args.certify_tol, max_iter=args.max_iter,
            device=args.device,
        )
        goldens.append(g)
        print(
            f"  certified {g.name}: obj_ref={g.obj_ref:.6g} "
            f"fingerprint={g.fingerprint[:12]}..."
        )
    path = save_goldens(args.certify, goldens)
    print(f"torch_canary_report: wrote {len(goldens)} golden(s) -> {path}")
    return 0


# ---------------------------------------------------------------------------
# self-check


def _train_artifacts(tmpdir: str, device="cuda") -> Dict[str, str]:
    """A clean warm-start artifact over the synthetic family, plus a
    tampered twin whose destandardization means are shifted — the
    manifest (version, family, schema) still loads cleanly, so nothing
    refuses it: predictions are simply, silently wrong."""
    import numpy as np

    from dispatches_tpu_torch.learn import (
        DatasetWriter, load_dataset, train_warmstart_model,
    )
    from dispatches_tpu_torch.solvers.ipm import solve_lp

    ds_dir = os.path.join(tmpdir, "dataset")
    writer = DatasetWriter(ds_dir, varying=("b", "c"))
    for s in range(24):
        p = _family_problem(s, device)
        sol = solve_lp(p)
        writer.add(p, sol, iterations=int(sol.iterations))
    writer.close()
    ds = load_dataset([ds_dir], varying=("b", "c"))
    model, _ = train_warmstart_model(ds, hidden=(16, 16), epochs=150, seed=0,
                                     device=device)
    clean = model.save(os.path.join(tmpdir, "warm_clean.npz"))

    # tamper: shift the x-part output means in-bounds. The safeguard
    # still ACCEPTS these seeds (strictly interior, clip < 10% of the
    # bound range) — they just start the solve somewhere wrong.
    with np.load(clean, allow_pickle=False) as dat:
        payload = {k: np.asarray(dat[k]) for k in dat.files}
    ym = np.array(payload["scale/y_mean"], dtype=np.float64)
    ym[:_FAM_N] = np.clip(ym[:_FAM_N] + 0.9, 0.5, 3.5)
    payload["scale/y_mean"] = ym
    dirty = os.path.join(tmpdir, "warm_dirty.npz")
    np.savez(dirty, **payload)
    return {"clean": clean, "dirty": dirty}


def _run_probe_fleet(
    goldens_path: str,
    warm_model: Optional[str],
    *,
    rounds: int = 2,
    timeout_s: float = 120.0,
    device="cuda",
) -> Dict[str, Any]:
    """One 2-shard fleet at a loose solver tolerance, pumped until the
    canary has scored `rounds` full rounds (and, when a mismatch
    landed, until the alert pack has had a sampled evaluation)."""
    from dispatches_tpu_torch.serve import make_dense_fleet

    fleet = make_dense_fleet(
        2, 4, cache_size=None, timeseries=True,
        # loose policy: this self-check is about what certificates DON'T
        # catch — a converged-but-wrong answer passes its KKT check and
        # only the known-answer probe can flag it
        conformance={"res_primal": 1e-2, "res_dual": 1e-2,
                     "comp": 1e-2, "gap": 1e-2},
        canary=goldens_path,
        warm_model=warm_model,
        solver_kw={"max_iter": 120, "tol": 1e-4},
        device=device,
    )
    fleet.canary.every_s = 0.25
    try:
        deadline = time.monotonic() + timeout_s
        scored: List[Dict[str, Any]] = []
        while time.monotonic() < deadline:
            fleet.pump()
            scored = [
                s for g in fleet.canary._last.values() for s in [g] if s
            ]
            if fleet.canary.rounds >= rounds and not fleet.canary._pending:
                if fleet.canary.mismatches == 0:
                    break
                # give the rate rule one sampled window to fire
                if any(
                    f["rule"] == "canary_mismatch"
                    for f in fleet.alerts.firing()
                ):
                    break
            time.sleep(0.05)
        return {
            "report": fleet.conformance_report(),
            "scores": scored,
            "mismatches": fleet.canary.mismatches,
            "firing": sorted({f["rule"] for f in fleet.alerts.firing()}),
        }
    finally:
        fleet.close()


def self_check(device="cuda") -> int:
    import tempfile

    from dispatches_tpu_torch.serve.canary import certify_golden, save_goldens

    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        print(f"  {'PASS' if ok else 'FAIL'}  {name}"
              + (f"  ({detail})" if detail and not ok else ""))
        if not ok:
            failures.append(name)

    with tempfile.TemporaryDirectory(prefix="canary_check_") as tmp:
        t0 = time.monotonic()
        arts = _train_artifacts(tmp, device)
        print(f"  trained clean + tampered warm artifacts "
              f"({time.monotonic() - t0:.1f}s)")

        # goldens certified at the SAME tolerance the fleets solve at:
        # the clean cold path then reproduces x_ref bitwise (chunked
        # solves are bitwise-identical to full solves), while any
        # accepted-but-wrong warm seed stops the loose solve elsewhere
        goldens = [
            certify_golden(
                f"g{i}", _family_problem(200 + i, device), tol=1e-6,
                certify_tol=1e-4, max_iter=120,
                policy={"res_primal": 1e-2, "res_dual": 1e-2,
                        "comp": 1e-2, "gap": 1e-2},
                device=device,
            )
            for i in range(3)
        ]
        gpath = save_goldens(os.path.join(tmp, "goldens.npz"), goldens)

        clean = _run_probe_fleet(gpath, None, device=device)
        print(f"  clean fleet: rounds scored, mismatches="
              f"{clean['mismatches']}, firing={clean['firing']}")
        check("clean fleet reproduces every golden",
              clean["mismatches"] == 0 and all(
                  s["outcome"] in ("exact", "tolerance")
                  for s in clean["scores"]
              ), str(clean["scores"]))
        check("clean fleet raises no canary alert",
              "canary_mismatch" not in clean["firing"],
              str(clean["firing"]))

        dirty = _run_probe_fleet(gpath, arts["dirty"], device=device)
        print(f"  tampered fleet: mismatches={dirty['mismatches']}, "
              f"firing={dirty['firing']}")
        check("tampered warm artifact trips the canary",
              dirty["mismatches"] > 0, str(dirty["scores"]))
        check("canary_mismatch alert fires",
              "canary_mismatch" in dirty["firing"], str(dirty["firing"]))
        mismatched = [
            s for s in dirty["scores"] if s["outcome"] == "mismatch"
        ]
        check("the wrong answers were trajectory-healthy "
              "(the verdict health cannot catch)",
              mismatched and all(
                  s["verdict"] == "healthy" for s in mismatched
              ), str(mismatched))

    print(
        f"torch_canary_report self-check: {'OK' if not failures else 'FAILED'} "
        f"({len(failures)} failure(s))"
    )
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_canary_report.py",
        description="canary pass/fail table + residual trend "
        "(docs/observability.md §12)",
    )
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--journal", help="journal JSONL to summarize")
    src.add_argument("--url", help="exporter base URL (live mode)")
    src.add_argument("--certify", metavar="OUT.npz",
                     help="certify synthetic-family goldens and write "
                     "the artifact")
    ap.add_argument("--goldens", type=int, default=3,
                    help="goldens to certify (--certify mode)")
    ap.add_argument("--seed", type=int, default=200,
                    help="first instance seed (--certify mode)")
    ap.add_argument("--tol", type=float, default=1e-6,
                    help="canary match tolerance frozen into each golden")
    ap.add_argument("--certify-tol", type=float, default=1e-9,
                    help="reference-solve tolerance (--certify mode)")
    ap.add_argument("--max-iter", type=int, default=200,
                    help="reference-solve iteration cap (--certify mode)")
    ap.add_argument("--window", type=float, default=300.0,
                    help="/query window for residual tracks (live mode)")
    ap.add_argument("--fail-on-mismatch", action="store_true",
                    help="exit 1 when any canary mismatch is present")
    ap.add_argument("--self-check", action="store_true",
                    help="run the tampered-artifact fleet scenario "
                    "(the CI gate)")
    ap.add_argument("--device", default="cuda",
                    help="where --certify and the self-check solve "
                    "(default: the card)")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(args.device)
    if args.journal:
        return run_journal(args)
    if args.url:
        return run_live(args)
    if args.certify:
        return run_certify(args)
    ap.error("one of --journal / --url / --certify / --self-check "
             "is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
