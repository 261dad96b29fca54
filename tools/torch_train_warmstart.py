#!/usr/bin/env python
"""Train a learned warm-start artifact from journaled solves (the port's
counterpart of tools/train_warmstart.py, on PyTorch).

    python tools/torch_train_warmstart.py RUN.jsonl -o warm.npz
    python tools/torch_train_warmstart.py SHARD_DIR CAPTURE_DIR -o warm.npz
    python tools/torch_train_warmstart.py --self-check [--device cpu] [--seed N]

Sources are any mix of JSONL journals (followed to the `dataset_shard` /
`capture` paths they mention), `learn.DatasetWriter` shard directories,
and flight-recorder capture dirs. Rows outside the first source's LP
family (structural `family_fingerprint`) are skipped, not mixed in; the
artifact refuses to load against a different family at serve time.

The artifact (`learn.WarmStartModel` .npz) carries weights + feature
scaling + the family manifest + the measured cold-iteration baseline
used for ``warm_start_iters_saved_total{source="learned"}`` attribution,
under the JAX package's keys: either package loads the other's. Serve it
with ``make_dense_service(..., warm_model=PATH)``,
``make_dense_fleet(..., warm_model=PATH)``, ``torch_loadgen.py
--warm-model``, or ``solve_lp_adaptive(..., warm_predictor=PATH)``.
Training and the self-check run on ``--device`` (default the card).

``--self-check`` runs the whole loop synthetically: journal a cold solve
sweep, train on the journal, serve a fresh request stream through the
safeguarded warm path, and require iterations saved with zero
lost/unhealthy requests — plus family-mismatch refusal and cold-path
determinism with the predictor off.

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
# a served warm answer's objective against its cold lane's, relative to
# 1 + |obj|: ten times the IPM's tolerance (1e-8 on the scaled gap)
WARM_OBJ_RTOL = 1e-7


def train(sources, out, *, varying, family=None, healthy_only=True,
          hidden=(64, 64), epochs=300, lr=1e-3, seed=0, holdout_frac=0.2,
          verbose=False, device="cuda"):
    """Load pairs, train one per-family predictor on `device`, save the
    artifact. Returns the report dict (also journaled as
    `warmstart_artifact`)."""
    from dispatches_tpu_torch.learn import load_dataset, train_warmstart_model
    from dispatches_tpu_torch.obs.journal import get_tracer

    ds = load_dataset(
        sources, varying=varying, family=family, healthy_only=healthy_only,
    )
    model, metrics = train_warmstart_model(
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
        "target_dim": int(ds.Y.shape[1]),
        "metrics": metrics,
    }
    get_tracer().event("warmstart_artifact", path=path, family=ds.family,
                       rows=int(len(ds)), metrics=metrics)
    return report


def _drain(service, tickets, pumps=10000):
    for _ in range(pumps):
        service.pump()
        if all(t.done() for t in tickets):
            return [t.result(timeout=0) for t in tickets]
    raise RuntimeError("service did not drain (lost requests)")


def self_check(keep=None, device="cuda", seed=0):
    """Journal -> train -> serve round trip on a synthetic LP family, every
    solve and the training on `device`; `seed` seeds the training."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.learn import (
        ArtifactMismatch, DatasetWriter, WarmStartModel,
    )
    from dispatches_tpu_torch.obs import metrics as obs_metrics
    from dispatches_tpu_torch.obs.journal import Tracer, use_tracer
    from dispatches_tpu_torch.serve.service import make_dense_service
    from dispatches_tpu_torch.solvers.ipm import solve_lp

    rng = np.random.default_rng(7)
    n, m = 8, 4
    A = rng.standard_normal((m, n))

    def make_problem(seed):
        r = np.random.default_rng(seed)
        x0 = r.uniform(0.5, 3.5, n)
        c = r.standard_normal(n)
        return LPData(A, A @ x0, c, np.zeros(n), np.full(n, 4.0), np.float64(0.0))

    def on_device(p):
        return LPData(*(torch.as_tensor(a, device=device) for a in p))

    tmp = keep or tempfile.mkdtemp(prefix="warmstart-selfcheck-")
    try:
        # -- first half: journaled cold sweep feeding the dataset ------
        journal = os.path.join(tmp, "run.jsonl")
        with use_tracer(Tracer(journal)):
            writer = DatasetWriter(
                os.path.join(tmp, "dataset"), varying=("b", "c"),
            )
            for s in range(64):
                p = on_device(make_problem(s))
                sol = solve_lp(p)
                assert bool(sol.converged), s
                writer.add(p, sol, iterations=int(sol.iterations))
            writer.close()
            # train FROM THE JOURNAL: the artifact path every production
            # run has (journal -> dataset_shard events -> shards)
            report = train(
                [journal], os.path.join(tmp, "warm.npz"),
                varying=("b", "c"), hidden=(32, 32), epochs=400, seed=seed,
                device=device,
            )
        print("self-check: trained", json.dumps(report["metrics"]))
        assert report["rows"] == 64, report

        # -- refuse-to-load on a family mismatch -----------------------
        try:
            WarmStartModel.load(report["artifact"], expect_family="0" * 64,
                                device=device)
        except ArtifactMismatch:
            pass
        else:
            raise AssertionError("family mismatch did not refuse to load")

        # -- second half: serve a fresh stream through the warm path ---
        reqs = [make_problem(1000 + s) for s in range(24)]
        before = obs_metrics.flat_values()
        svc = make_dense_service(
            4, cache_size=None, warm_model=report["artifact"], max_iter=60,
            device=device,
        )
        warm_res = _drain(svc, [svc.submit(p) for p in reqs])
        after = obs_metrics.flat_values()

        bad = [r.verdict for r in warm_res if r.verdict != "healthy"]
        if bad:
            print(f"self-check: GATE unhealthy verdicts {bad}",
                  file=sys.stderr)
            return RC_GATE
        saved = sum(
            after.get(k, 0.0) - before.get(k, 0.0)
            for k in after
            if k.startswith("warm_start_iters_saved_total")
            and 'source="learned"' in k
        )
        accepted = sum(
            after.get(k, 0.0) - before.get(k, 0.0)
            for k in after
            if k.startswith("learned_warm_accept_total")
        )
        print(f"self-check: served {len(warm_res)} warm "
              f"(accepted={accepted:g}, iters_saved={saved:g})")
        if not saved > 0:
            print("self-check: GATE warm_start_iters_saved_total"
                  '{source="learned"} did not increase', file=sys.stderr)
            return RC_GATE

        # -- predictor off: the historical cold path, deterministic ----
        svc_a = make_dense_service(4, cache_size=None, max_iter=60, device=device)
        cold_a = _drain(svc_a, [svc_a.submit(p) for p in reqs])
        svc_b = make_dense_service(4, cache_size=None, max_iter=60, device=device)
        cold_b = _drain(svc_b, [svc_b.submit(p) for p in reqs])
        for ra, rb in zip(cold_a, cold_b):
            xa, xb = np.asarray(ra.solution.x), np.asarray(rb.solution.x)
            if not (xa.dtype == xb.dtype and np.array_equal(xa, xb)):
                print("self-check: GATE cold path not deterministic",
                      file=sys.stderr)
                return RC_GATE
        # warm answers against cold answers, each served answer itself: its
        # objective within WARM_OBJ_RTOL (1 + |obj|) of its cold lane's. Not
        # max |dx| <= 1e-6 as the JAX tool gates: the IPM stops at a scaled
        # gap of 1e-8, where x still sits ~mu / z off a bound with a small
        # reduced cost z, so two starts can stop ~1e-6 apart in x at one
        # optimum (the JAX tool fails its own gate at some training seeds;
        # --seed runs this check at another one)
        dxs = [
            float(np.max(np.abs(np.asarray(w.solution.x)
                                - np.asarray(c.solution.x))))
            for w, c in zip(warm_res, cold_a)
        ]
        dobj = [
            abs(float(w.solution.obj) - float(c.solution.obj))
            / (1.0 + abs(float(c.solution.obj)))
            for w, c in zip(warm_res, cold_a)
        ]
        print(f"self-check: warm-vs-cold max |dx| = {max(dxs):.2e}, "
              f"max objective rel = {max(dobj):.2e}")
        if not max(dobj) <= WARM_OBJ_RTOL:
            print("self-check: GATE warm answers diverged from cold",
                  file=sys.stderr)
            return RC_GATE
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    print("self-check: OK (journal -> train -> safeguarded warm serving)")
    return RC_OK


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*",
                    help="journals (.jsonl), DatasetWriter shard dirs, "
                         "and/or recorder capture dirs")
    ap.add_argument("-o", "--out", help="artifact output path (.npz)")
    ap.add_argument("--varying", default="b,c",
                    help="comma-separated per-instance fields -> features "
                         "(default: b,c)")
    ap.add_argument("--family", default=None,
                    help="expected family fingerprint (hex); rows outside "
                         "it are skipped, an empty result errors")
    ap.add_argument("--include-unhealthy", action="store_true",
                    help="keep non-converged pairs (default: healthy only)")
    ap.add_argument("--hidden", default="64,64",
                    help="MLP hidden widths (default: 64,64)")
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
                    help="synthetic journal->train->serve round trip")
    ap.add_argument("--keep", default=None,
                    help="with --self-check: keep scratch under this dir")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(keep=args.keep, device=args.device, seed=args.seed)
    if not args.sources or not args.out:
        ap.error("sources and -o/--out required (or --self-check)")
    try:
        hidden = tuple(int(h) for h in args.hidden.split(",") if h)
        varying = tuple(v for v in args.varying.split(",") if v)
        report = train(
            args.sources, args.out,
            varying=varying, family=args.family,
            healthy_only=not args.include_unhealthy,
            hidden=hidden, epochs=args.epochs, lr=args.lr, seed=args.seed,
            holdout_frac=args.holdout_frac, verbose=args.verbose,
            device=args.device,
        )
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"train_warmstart: error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return RC_ERROR
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        mt = report["metrics"]
        print(f"train_warmstart: {report['artifact']}")
        print(f"  family {report['family'][:16]}... "
              f"({report['problem_type']}, varying={report['varying']})")
        print(f"  rows {report['rows']} (+{report['rows_skipped']} skipped) "
              f"features {report['feature_dim']} -> targets "
              f"{report['target_dim']}")
        print("  " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in mt.items() if v is not None
        ))
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
