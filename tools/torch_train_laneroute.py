#!/usr/bin/env python
"""Train a lane-portfolio routing artifact from lane-probe shards (the
port's counterpart of tools/train_laneroute.py, on PyTorch).

    python tools/torch_train_laneroute.py SHARD.npz -o lanes.npz
    python tools/torch_train_laneroute.py RUN.jsonl SHARD_DIR -o lanes.npz
    python tools/torch_train_laneroute.py --self-check [--device cpu]

Sources are any mix of `obs.lanes.LaneObservatory.export_dataset` probe
shards, directories of them, and JSONL journals (followed to the
``dataset_shard`` paths they mention). Rows outside the first source's
LP family are skipped, not mixed in; pass ``--family`` to pin one when a
journal announces several. The artifact (`learn.LaneRouteModel` .npz)
predicts per-lane ``[wall_dense, wall_pdhg, iters_dense, iters_pdhg]``
from the schema-v6 feature vector and refuses to load against a
different family or artifact kind at serve time; it keeps the JAX
package's keys, so either package loads the other's. Training, the
self-check's solves and the model run on ``--device`` (default the card).

Serve it with ``solve_lp_adaptive(..., lane_policy="model",
lane_model=PATH)`` (same on `solve_lp_pdhg_adaptive`) or
``make_dense_fleet(..., lane_policy="model", lane_model=PATH)``; routed
solves keep flowing through the lane observatory, so mispredictions
surface as ``lane_shadow_probes_total{outcome="regret"}`` and fallbacks
count under ``lane_model_fallback_total``.

``--self-check`` runs the loop synthetically: feed two families of
probe pairs through the real observatory probe path (lane timers
instrumented so the measured winner is controlled — dense wins one
family, PDHG the other), export shards, train one artifact per family
from the journal, and serve fresh instances of both families through
the adaptive entries under ``lane_policy="model"`` — the dense-friendly
family must re-lane to IPM, the year-scale stand-in must re-lane to
PDHG, with zero unhealthy solves, plus family-mismatch refusal and the
unseen-family fallback counter.

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


def train(sources, out, *, varying, family=None, hidden=(32, 32),
          epochs=300, lr=1e-3, seed=0, holdout_frac=0.2, verbose=False,
          device="cuda"):
    """Load probe pairs, train one per-family portfolio model, save the
    artifact. Returns the report dict (journaled as
    `laneroute_artifact`)."""
    from dispatches_tpu_torch.learn import load_dataset, train_laneroute_model
    from dispatches_tpu_torch.obs.journal import get_tracer

    ds = load_dataset(
        sources, varying=varying, family=family, healthy_only=False,
    )
    model, metrics = train_laneroute_model(
        ds, hidden=hidden, epochs=epochs, lr=lr, seed=seed,
        holdout_frac=holdout_frac, verbose=verbose, device=device,
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
        "train_best_lane": model.train_best_lane,
        "lane_share": model.manifest["lane_share"],
        "metrics": metrics,
    }
    get_tracer().event(
        "laneroute_artifact", path=path, family=ds.family,
        rows=int(len(ds)), best_lane=model.train_best_lane,
        metrics=metrics,
    )
    return report


def self_check(keep=None, device="cuda"):
    """Probe -> export -> train -> model-routed serving round trip, the
    solves and the training on `device`."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    import torch

    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.learn import ArtifactMismatch, LaneRouteModel
    from dispatches_tpu_torch.learn.laneroute import as_laneroute
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
    from dispatches_tpu_torch.obs.lanes import LaneConfig, LaneObservatory
    from dispatches_tpu_torch.runtime.adaptive import (
        solve_lp_adaptive, solve_lp_pdhg_adaptive,
    )
    from dispatches_tpu_torch.runtime.remedy import dense_to_sparse

    rng = np.random.default_rng(11)
    n, m = 8, 4
    # two structural families: DF rides the PDHG-native entry and its
    # measured probes say dense/IPM wins; YS (the year-scale stand-in)
    # rides the dense-native entry and its probes say PDHG wins
    A_df = rng.standard_normal((m, n))
    A_ys = rng.standard_normal((m, n))

    def mk(Amat, seed):
        r = np.random.default_rng(seed)
        x0 = r.uniform(0.5, 3.5, n)
        return LPData(*(torch.as_tensor(a, device=device) for a in (
            Amat, Amat @ x0, r.standard_normal(n),
            np.zeros(n), np.full(n, 4.0), np.asarray(0.0),
        )))

    def stub(wall, iters, clk):
        # deterministic lane timer: the probe machinery, scoring,
        # retention, and export stay real — only the two walls are pinned
        def f(problem):
            clk[0] += wall
            sol = SimpleNamespace(
                x=np.zeros(n), iterations=iters, obj=-1.0, converged=True,
            )
            return sol, wall
        return f

    tmp = keep or tempfile.mkdtemp(prefix="laneroute-selfcheck-")
    try:
        journal = os.path.join(tmp, "run.jsonl")
        with use_tracer(Tracer(journal)):
            obs = LaneObservatory(LaneConfig(
                probe_fraction=1.0, max_pending=256, warm_probes=False,
                min_probes=5,
            ))
            obs.checker = None  # stub solutions carry no certifiable x
            clk = [0.0]
            # DF family arrives as SparseLP at the pdhg entry; probes
            # measure dense 100x faster
            obs._solve_dense = stub(0.01, 9, clk)
            obs._solve_pdhg = stub(1.0, 950, clk)
            for s in range(48):
                obs.note_solve(
                    dense_to_sparse(mk(A_df, 100 + s)), "pdhg",
                    entry="self_check",
                )
            obs.run_probes(None)
            # YS family arrives dense; probes measure pdhg 100x faster
            obs._solve_dense = stub(1.0, 60, clk)
            obs._solve_pdhg = stub(0.01, 420, clk)
            for s in range(48):
                obs.note_solve(mk(A_ys, 500 + s), "dense",
                               entry="self_check")
            obs.run_probes(None)
            shards = obs.export_dataset(os.path.join(tmp, "probes"))
            if len(shards) != 2:
                print(f"self-check: GATE expected 2 probe shards, got "
                      f"{len(shards)}", file=sys.stderr)
                return RC_GATE
            # train FROM THE JOURNAL (dataset_shard events -> shards),
            # one artifact per family, exactly the production path
            fams = []
            for p in shards:
                meta = json.loads(str(
                    np.load(p, allow_pickle=False)["__meta__"]
                ))
                fams.append((meta["family"], meta["problem_type"]))
            reports = {}
            for fam, ptype in fams:
                rep = train(
                    [journal],
                    os.path.join(tmp, f"lanes-{fam[:8]}.npz"),
                    varying=("b", "c"), family=fam, hidden=(32, 32),
                    epochs=400, seed=0, device=device,
                )
                reports[ptype] = rep
                print(f"self-check: trained {ptype} family "
                      f"{fam[:8]}... best_lane={rep['train_best_lane']} "
                      + json.dumps(rep["metrics"]))
        df_rep = reports.get("SparseLP")
        ys_rep = reports.get("LPData")
        if df_rep is None or ys_rep is None:
            print("self-check: GATE missing a family artifact",
                  file=sys.stderr)
            return RC_GATE
        if df_rep["train_best_lane"] != "dense":
            print("self-check: GATE dense-friendly family trained to "
                  f"{df_rep['train_best_lane']!r}, expected 'dense'",
                  file=sys.stderr)
            return RC_GATE
        if ys_rep["train_best_lane"] != "pdhg":
            print("self-check: GATE year-scale family trained to "
                  f"{ys_rep['train_best_lane']!r}, expected 'pdhg'",
                  file=sys.stderr)
            return RC_GATE

        # -- refuse-to-load on a family mismatch -----------------------
        try:
            LaneRouteModel.load(df_rep["artifact"], expect_family="0" * 64,
                                device=device)
        except ArtifactMismatch:
            pass
        else:
            raise AssertionError("family mismatch did not refuse to load")

        # -- serve fresh instances through the adaptive entries --------
        router = as_laneroute([df_rep["artifact"], ys_rep["artifact"]],
                              device=device)
        unhealthy = 0
        for s in range(6):
            stats = {}
            sol = solve_lp_pdhg_adaptive(
                dense_to_sparse(mk(A_df, 2000 + s)), stats=stats,
                lane_policy="model", lane_model=router,
            )
            if stats.get("relaned") != "dense":
                print("self-check: GATE dense-friendly solve not "
                      f"re-laned to IPM (stats={stats})", file=sys.stderr)
                return RC_GATE
            if not bool(sol.converged):
                unhealthy += 1
        for s in range(6):
            stats = {}
            sol = solve_lp_adaptive(
                mk(A_ys, 3000 + s), stats=stats,
                lane_policy="model", lane_model=router,
            )
            if stats.get("relaned") != "pdhg":
                print("self-check: GATE year-scale solve not re-laned "
                      f"to PDHG (stats={stats})", file=sys.stderr)
                return RC_GATE
            if not bool(sol.converged):
                unhealthy += 1
        if unhealthy:
            print(f"self-check: GATE {unhealthy} unhealthy model-routed "
                  "solves", file=sys.stderr)
            return RC_GATE
        print("self-check: 12 model-routed solves "
              "(DF->IPM, YS->PDHG), zero unhealthy")

        # -- unseen family degrades to the fallback path ---------------
        before = obs_metrics.flat_values()
        A_new = rng.standard_normal((m, n))
        stats = {}
        sol = solve_lp_adaptive(
            mk(A_new, 1), stats=stats, lane_policy="model",
            lane_model=router,
        )
        after = obs_metrics.flat_values()
        key = 'lane_model_fallback_total{reason="unseen_family"}'
        if stats.get("relaned") is not None:
            print("self-check: GATE unseen family was re-laned",
                  file=sys.stderr)
            return RC_GATE
        if not after.get(key, 0.0) > before.get(key, 0.0):
            print(f"self-check: GATE {key} did not increase",
                  file=sys.stderr)
            return RC_GATE
        if not bool(sol.converged):
            print("self-check: GATE unseen-family native solve "
                  "unhealthy", file=sys.stderr)
            return RC_GATE
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    print("self-check: OK (probe export -> train -> model-routed lanes)")
    return RC_OK


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="probe shards (.npz), shard dirs, and/or JSONL "
                         "journals")
    ap.add_argument("-o", "--out", help="artifact output path (.npz)")
    ap.add_argument("--varying", default="b,c",
                    help="comma-separated per-instance fields -> features "
                         "(default: b,c)")
    ap.add_argument("--family", default=None,
                    help="expected family fingerprint (hex); rows outside "
                         "it are skipped, an empty result errors")
    ap.add_argument("--hidden", default="32,32",
                    help="MLP hidden widths (default: 32,32)")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--holdout-frac", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="where training and the self-check run (default: "
                         "the card)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON only")
    ap.add_argument("--self-check", action="store_true",
                    help="synthetic probe->train->route round trip")
    ap.add_argument("--keep", default=None,
                    help="with --self-check: keep scratch under this dir")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(keep=args.keep, device=args.device)
    if not args.sources or not args.out:
        ap.error("sources and -o/--out required (or --self-check)")
    try:
        hidden = tuple(int(h) for h in args.hidden.split(",") if h)
        varying = tuple(v for v in args.varying.split(",") if v)
        report = train(
            args.sources, args.out,
            varying=varying, family=args.family,
            hidden=hidden, epochs=args.epochs, lr=args.lr, seed=args.seed,
            holdout_frac=args.holdout_frac, verbose=args.verbose,
            device=args.device,
        )
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"train_laneroute: error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return RC_ERROR
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        mt = report["metrics"]
        print(f"train_laneroute: {report['artifact']}")
        print(f"  family {report['family'][:16]}... "
              f"({report['problem_type']}, varying={report['varying']})")
        print(f"  rows {report['rows']} (+{report['rows_skipped']} "
              f"skipped) features {report['feature_dim']} -> "
              f"best_lane {report['train_best_lane']} "
              f"(share {report['lane_share']:.2f})")
        print("  " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in mt.items() if v is not None
        ))
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
