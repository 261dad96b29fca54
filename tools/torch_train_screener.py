#!/usr/bin/env python
"""Train an N-1 contingency-screening artifact from journaled solves (the
port's counterpart of tools/train_screener.py, on PyTorch).

    python tools/torch_train_screener.py SHARD.npz -o screener.npz
    python tools/torch_train_screener.py RUN.jsonl SHARD_DIR -o screener.npz
    python tools/torch_train_screener.py --self-check [--device cpu]

Sources are any mix of `learn.dataset` shards (features = the base-case
SCED's b-vector, targets = the 0/1 critical-outage indicator from full
`secure_dispatch` runs — `learn.screener.screen_targets`), directories
of them, and JSONL journals (followed to their ``dataset_shard`` paths).
The artifact (`learn.ScreenerModel` .npz) predicts per-outage
criticality scores and refuses to load against a different family or
artifact kind at serve time; it keeps the JAX package's keys, so either
package loads the other's. Training, the SCED solves and the self-check
run on ``--device`` (default the card).

Serve it with ``secure_dispatch(..., screener=PATH)`` (or an explicit
`learn.as_screener(PATH)`); screened solves are always verified against
the full contingency set post-solve, so the model can cost a wasted
screened solve (``screener_violation_fallback_total``) but never a
missed violation.

``--self-check`` runs the loop end to end on a synthetic grid whose
branch limits are tightened until outages genuinely bind: full
`secure_dispatch` runs label two dozen operating points, shards ride
the journal, one artifact trains from the journal, and fresh operating
points are served screened — gating on zero escaped violations, the
bitwise screener-off identity against the plain SCED solve,
artifact refuse-to-load (family + version), and a violation-injection
probe proving a deliberately blind screen is caught by the full-set
verify and falls back.

Exit codes: 0 = ok, 1 = self-check gate failed, 2 = error.
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

RC_OK, RC_GATE, RC_ERROR = 0, 1, 2


def train(sources, out, *, family=None, hidden=(32, 32), epochs=300,
          lr=1e-3, seed=0, holdout_frac=0.2, threshold=None,
          verbose=False, device="cuda"):
    """Load indicator pairs, train one per-family screener, save the
    artifact. Returns the report dict (journaled as
    `screener_artifact`)."""
    from dispatches_tpu_torch.learn import load_dataset, train_screener_model
    from dispatches_tpu_torch.learn.screener import DEFAULT_THRESHOLD, SCREEN_VARYING
    from dispatches_tpu_torch.obs.journal import get_tracer

    ds = load_dataset(
        sources, varying=SCREEN_VARYING, family=family, healthy_only=False,
    )
    model, metrics = train_screener_model(
        ds, hidden=hidden, epochs=epochs, lr=lr, seed=seed,
        holdout_frac=holdout_frac,
        threshold=DEFAULT_THRESHOLD if threshold is None else threshold,
        verbose=verbose, device=device,
    )
    path = model.save(out)
    report = {
        "artifact": path,
        "family": ds.family,
        "problem_type": ds.problem_type,
        "varying": list(ds.varying),
        "rows": int(len(ds)),
        "rows_skipped": int(ds.skipped),
        "feature_dim": int(ds.X.shape[1]),
        "target_dim": model.target_dim,
        "critical_share": model.manifest["train_critical_share"],
        "metrics": metrics,
    }
    get_tracer().event(
        "screener_artifact", path=path, family=ds.family,
        rows=int(len(ds)), target_dim=model.target_dim, metrics=metrics,
    )
    return report


def self_check(keep=None, device="cuda"):
    """Full-CG labeling -> shards -> train -> screened serving, gated;
    every SCED solve and the training on `device`."""
    import dataclasses
    import functools
    import shutil
    import tempfile

    import numpy as np

    from dispatches_tpu_torch.learn import ArtifactMismatch, ScreenerModel
    from dispatches_tpu_torch.learn.dataset import DatasetWriter
    from dispatches_tpu_torch.learn.screener import (
        SCREEN_VARYING, as_screener, screen_targets,
    )
    from dispatches_tpu_torch.market.contingency import (
        ContingencySet, base_operating_point,
    )
    from dispatches_tpu_torch.market.contingency import secure_dispatch as _sd
    from dispatches_tpu_torch.market.network import dcopf_program, synthesize_network
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
    from dispatches_tpu_torch.solvers.ipm import solve_lp

    secure_dispatch = functools.partial(_sd, device=device)

    rng = np.random.default_rng(7)
    grid = synthesize_network(8, 6, days=1, seed=0)

    # soften must-run minimums (keeping p_min + sum(seg_mw) = p_max so
    # capacity is unchanged) and tighten limits to 0.75x: the base case
    # stays feasible with zero shed, but N-1 projections genuinely
    # violate — a screener trained on a violation-free grid has nothing
    # to learn, and hard must-run floors under tight limits go primal
    # infeasible instead of violating
    def _soften(u, k=0.15):
        pmin = k * u.p_min
        scale = (u.p_max - pmin) / max(u.p_max - u.p_min, 1e-9)
        return dataclasses.replace(
            u, p_min=pmin, seg_mw=np.asarray(u.seg_mw) * scale,
        )

    grid = dataclasses.replace(
        grid,
        thermal=[_soften(u) for u in grid.thermal],
        branch_limit=np.asarray(grid.branch_limit, float) * 0.75,
    )
    cset = ContingencySet.n_minus_1(grid, gens=False)
    base = base_operating_point(grid, hour=0)
    prog0 = dcopf_program(grid)

    def draw(scale_lo=0.9, scale_hi=1.15):
        p = dict(base)
        p["load"] = np.asarray(base["load"]) * rng.uniform(
            scale_lo, scale_hi, size=np.asarray(base["load"]).shape
        )
        return p

    tmp = keep or tempfile.mkdtemp(prefix="screener-selfcheck-")
    try:
        journal = os.path.join(tmp, "run.jsonl")
        with use_tracer(Tracer(journal)):
            # -- label 24 operating points with FULL (unscreened) runs --
            writer = DatasetWriter(
                os.path.join(tmp, "shards"), varying=SCREEN_VARYING,
                shard_rows=8,
            )
            labeled = critical_rows = 0
            for _ in range(24):
                p = draw()
                sd = secure_dispatch(grid, p, cset)
                if sd.escaped_violations:
                    print("self-check: GATE full CG run left "
                          f"{sd.escaped_violations} escaped violations",
                          file=sys.stderr)
                    return RC_GATE
                if not bool(sd.sol.converged):
                    print("self-check: GATE full CG base solve unhealthy",
                          file=sys.stderr)
                    return RC_GATE
                lp = prog0.instantiate(
                    {k: np.asarray(v) for k, v in p.items()}, device=device,
                )
                ind = screen_targets(cset, sd.violated_outages)
                if writer.add(lp, {"x": ind}):
                    labeled += 1
                    critical_rows += int(ind.any())
            writer.flush()
            if labeled < 24:
                print(f"self-check: GATE writer kept {labeled}/24 pairs",
                      file=sys.stderr)
                return RC_GATE
            if not critical_rows:
                print("self-check: GATE no operating point produced a "
                      "critical outage — nothing to learn", file=sys.stderr)
                return RC_GATE
            print(f"self-check: labeled 24 points "
                  f"({critical_rows} with critical outages)")

            # -- train FROM THE JOURNAL (the production path) ----------
            rep = train(
                [journal], os.path.join(tmp, "screener.npz"),
                epochs=400, seed=0, device=device,
            )
            print("self-check: trained "
                  f"family {rep['family'][:8]}... "
                  + json.dumps(rep["metrics"]))

        # -- refuse-to-load: family + version ---------------------------
        try:
            ScreenerModel.load(rep["artifact"], expect_family="0" * 64,
                               device=device)
        except ArtifactMismatch:
            pass
        else:
            raise AssertionError("family mismatch did not refuse to load")
        tampered = os.path.join(tmp, "tampered.npz")
        with np.load(rep["artifact"], allow_pickle=False) as dat:
            payload = {k: dat[k] for k in dat.files}
        man = json.loads(str(payload["__manifest__"]))
        man["version"] = 999
        payload["__manifest__"] = np.asarray(json.dumps(man))
        np.savez(tampered, **payload)
        try:
            ScreenerModel.load(tampered, device=device)
        except ArtifactMismatch:
            pass
        else:
            raise AssertionError("version mismatch did not refuse to load")
        print("self-check: refuse-to-load ok (family, version)")

        # -- bitwise screener-off identity vs the plain SCED --------------
        # a light-load point needs no cuts: secure_dispatch must return
        # the plain dcopf solve bit-for-bit, screened or not
        p_light = draw(0.3, 0.4)
        lp_light = prog0.instantiate(
            {k: np.asarray(v) for k, v in p_light.items()}, device=device,
        )
        ref = solve_lp(lp_light)
        sd_off = secure_dispatch(grid, p_light, cset)
        if sd_off.rounds != 1 or sd_off.cuts:
            print("self-check: GATE light-load point still generated "
                  f"cuts (rounds={sd_off.rounds})", file=sys.stderr)
            return RC_GATE
        for attr in ("x", "y", "obj"):
            a = getattr(ref, attr).cpu().numpy()
            b = getattr(sd_off.sol, attr).cpu().numpy()
            if a.tobytes() != b.tobytes():
                print(f"self-check: GATE screener-off sol.{attr} not "
                      "bitwise-identical to the plain SCED solve",
                      file=sys.stderr)
                return RC_GATE
        scr = as_screener(rep["artifact"], device=device)
        sd_scr = secure_dispatch(grid, p_light, cset, screener=scr)
        if sd_scr.sol.x.cpu().numpy().tobytes() != ref.x.cpu().numpy().tobytes():
            print("self-check: GATE screened no-cut dispatch differs "
                  "from the plain SCED solve", file=sys.stderr)
            return RC_GATE
        print("self-check: bitwise screener-off identity ok")

        # -- screened serving: zero escaped violations ------------------
        screened_runs = fallbacks = 0
        for _ in range(8):
            sd = secure_dispatch(grid, draw(), cset, screener=scr)
            if sd.escaped_violations or not sd.feasible:
                print("self-check: GATE screened dispatch left "
                      f"{sd.escaped_violations} escaped violations",
                      file=sys.stderr)
                return RC_GATE
            screened_runs += int(sd.screened)
            fallbacks += int(sd.screen_fallback)
        fv = obs_metrics.flat_values()
        if fv.get("contingency_escaped_violations_total", 0.0) != 0.0:
            print("self-check: GATE contingency_escaped_violations_total "
                  f"= {fv['contingency_escaped_violations_total']}",
                  file=sys.stderr)
            return RC_GATE
        print(f"self-check: 8 screened dispatches, {screened_runs} "
              f"screened, {fallbacks} full-set fallbacks, zero escaped")

        # -- violation injection: a blind screen MUST be caught ---------
        class _BlindScreener:
            """Deliberately wrong: screens out every outage."""

            def screen(self, problem, cs):
                return np.zeros(
                    sum(1 for c in cs if c.kind == "branch"), bool
                )

            def note_accept(self):
                pass

            def note_violation_fallback(self, n=1):
                self.caught = getattr(self, "caught", 0) + n

        before = obs_metrics.flat_values().get(
            "screener_violation_fallback_total", 0.0
        )
        blind = _BlindScreener()
        p_heavy = draw(1.05, 1.15)
        sd = secure_dispatch(grid, p_heavy, cset, screener=blind)
        after = obs_metrics.flat_values().get(
            "screener_violation_fallback_total", 0.0
        )
        if not getattr(blind, "caught", 0):
            # the heavy draw happened to be violation-free — the blind
            # screen was "right"; that's a vacuous probe, not a pass
            print("self-check: GATE violation-injection probe found no "
                  "violations to catch", file=sys.stderr)
            return RC_GATE
        if not sd.screen_fallback:
            print("self-check: GATE blind screen did not trigger the "
                  "full-set fallback", file=sys.stderr)
            return RC_GATE
        if sd.escaped_violations or not sd.feasible:
            print("self-check: GATE blind-screen dispatch not repaired "
                  f"(escaped={sd.escaped_violations})", file=sys.stderr)
            return RC_GATE
        if not after > before:
            print("self-check: GATE screener_violation_fallback_total "
                  "did not increase", file=sys.stderr)
            return RC_GATE
        print("self-check: violation injection caught by full-set "
              f"verify ({int(blind.caught)} violations), dispatch "
              "repaired")
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    print("self-check: OK (label -> train -> screened serve, "
          "zero escaped violations)")
    return RC_OK


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="indicator shards (.npz), shard dirs, and/or "
                         "JSONL journals")
    ap.add_argument("-o", "--out", help="artifact output path (.npz)")
    ap.add_argument("--family", default=None,
                    help="expected family fingerprint (hex); rows outside "
                         "it are skipped, an empty result errors")
    ap.add_argument("--hidden", default="32,32",
                    help="MLP hidden widths (default: 32,32)")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout-frac", type=float, default=0.2)
    ap.add_argument("--threshold", type=float, default=None,
                    help="serve-side criticality threshold stored in the "
                         "artifact (default: learn.screener default)")
    ap.add_argument("--device", default="cuda",
                    help="where training and the self-check run (default: "
                         "the card)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON only")
    ap.add_argument("--self-check", action="store_true",
                    help="label -> train -> screened-serve round trip")
    ap.add_argument("--keep", default=None,
                    help="with --self-check: keep scratch under this dir")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(keep=args.keep, device=args.device)
    if not args.sources or not args.out:
        ap.error("sources and -o/--out required (or --self-check)")
    try:
        hidden = tuple(int(h) for h in args.hidden.split(",") if h)
        report = train(
            args.sources, args.out, family=args.family,
            hidden=hidden, epochs=args.epochs, lr=args.lr, seed=args.seed,
            holdout_frac=args.holdout_frac, threshold=args.threshold,
            verbose=args.verbose, device=args.device,
        )
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"train_screener: error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return RC_ERROR
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        mt = report["metrics"]
        print(f"train_screener: {report['artifact']}")
        print(f"  family {report['family'][:16]}... "
              f"({report['problem_type']}, varying={report['varying']})")
        print(f"  rows {report['rows']} (+{report['rows_skipped']} "
              f"skipped) features {report['feature_dim']} -> "
              f"{report['target_dim']} outages "
              f"(critical share {report['critical_share']:.3f})")
        print("  " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in mt.items() if v is not None
        ))
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
