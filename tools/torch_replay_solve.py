#!/usr/bin/env python3
"""Replay a flight-recorder capture of the PyTorch port: reload the exact
problem instance, rerun the exact solver entry point, and compare every
solution field bitwise against what the capture observed.

    python tools/torch_replay_solve.py RECORD_DIR/cap-000001-solve_lp
    python tools/torch_replay_solve.py RECORD_DIR --last        # newest capture
    python tools/torch_replay_solve.py CAPTURE --device cpu     # cross-device check
    python tools/torch_replay_solve.py --self-check             # smoke

The replay runs on the device type the capture was taken on (its
``meta.json`` ``device``; the CPU for captures that do not record one,
such as the JAX package's), where it reproduces bitwise. ``--device``
overrides it: a card's capture replayed with ``--device cpu`` gives the
same status, but its last bits may differ (other matrix-product and
Cholesky kernels), so that replay reports a mismatch.

Exit codes: 0 = reproduced bitwise, 1 = mismatch, 2 = error, 3 = capture
not replayable (a BandedLP capture needs its static structure, which is
not serialized: it is for offline analysis).

The port of `tools/replay_solve.py`: it imports the port alone, never JAX.
"""
import argparse
import inspect
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

RC_OK, RC_MISMATCH, RC_ERROR, RC_NOT_REPLAYABLE = 0, 1, 2, 3

_SOLVERS = ("solve_lp", "solve_lp_pdhg")


def _find_capture(path, last=False):
    if os.path.isfile(os.path.join(path, "meta.json")):
        return path
    caps = sorted(
        os.path.join(path, n)
        for n in os.listdir(path)
        if n.startswith("cap-") and os.path.isfile(os.path.join(path, n, "meta.json"))
    )
    if not caps:
        raise FileNotFoundError(f"no captures under {path}")
    if not last and len(caps) > 1:
        print(f"replay: {len(caps)} captures, using newest (pass the "
              "capture dir to pick one)", file=sys.stderr)
    return caps[-1]


def _apply_precision(meta):
    """The capture's float32 matmul precision and TF32 flags."""
    import torch

    prec = (meta.get("manifest") or {}).get("precision") or {}
    if "float32_matmul_precision" in prec:
        torch.set_float32_matmul_precision(prec["float32_matmul_precision"])
    if "cuda_matmul_allow_tf32" in prec:
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["cuda_matmul_allow_tf32"])
    if "cudnn_allow_tf32" in prec:
        torch.backends.cudnn.allow_tf32 = bool(prec["cudnn_allow_tf32"])


def _filtered_options(fn, options):
    """The options `fn` takes; dtypes stored as "torch.<name>" come back
    as dtypes."""
    import torch

    sig = inspect.signature(fn)
    opts = {}
    for k, v in (options or {}).items():
        if k not in sig.parameters or k == "trace":  # replay compares solutions
            continue
        if isinstance(v, str) and v.startswith("torch.") and hasattr(torch, v[6:]):
            v = getattr(torch, v[6:])
        opts[k] = v
    dropped = sorted(set(options or {}) - set(opts) - {"trace"})
    if dropped:
        print(f"replay: dropping unknown options {dropped}", file=sys.stderr)
    return opts


def replay(capture_path, device=None):
    """Rerun one capture on `device` (default: the device type it was taken
    on); returns (rc, report dict)."""
    with open(os.path.join(capture_path, "meta.json"), encoding="utf-8") as fh:
        meta = json.load(fh)
    if device is None:
        device = meta.get("device") or "cpu"
    solver = meta.get("solver")
    if solver not in _SOLVERS or not meta.get("problem_type"):
        return RC_NOT_REPLAYABLE, {
            "capture": capture_path,
            "solver": solver,
            "error": "capture is archival-only (no replayable problem: banded "
            "solves need their static structure)",
        }
    _apply_precision(meta)

    import numpy as np
    import torch

    from dispatches_tpu_torch.obs.recorder import load_capture

    cap = load_capture(capture_path)
    problem = cap["problem"]
    if problem is None or not hasattr(problem, "_fields"):
        return RC_NOT_REPLAYABLE, {
            "capture": capture_path,
            "solver": solver,
            "error": f"cannot rebuild problem type {meta['problem_type']!r}",
        }
    problem = type(problem)(*(torch.as_tensor(a, device=device) for a in problem))
    if solver == "solve_lp":
        from dispatches_tpu_torch.solvers.ipm import solve_lp as entry

        warm_parts = ("x", "y", "zl", "zu")
    else:
        from dispatches_tpu_torch.solvers.pdhg import solve_lp_pdhg as entry

        warm_parts = ("x", "y")
    opts = _filtered_options(entry, meta.get("options"))
    # the raw warm seed re-feeds the solver, whose safeguard re-applies;
    # `applied_*` / `accepted` are the post-safeguard view, for reading
    warm = cap.get("warm_start") or {}
    warm_start = None
    if all(p in warm for p in warm_parts):
        warm_start = tuple(torch.as_tensor(warm[p], device=device) for p in warm_parts)
    sol = entry(problem, warm_start=warm_start, **opts)

    recorded = cap["solution"]
    report = {
        "capture": capture_path,
        "solver": solver,
        "device": str(device),
        "captured_on": meta.get("device"),
        "captured_card": (meta.get("manifest") or {}).get("device_kind"),
        "options": {k: str(v) if isinstance(v, torch.dtype) else v for k, v in opts.items()},
        "verdict_at_capture": meta.get("verdict"),
        "warm_start": sorted(warm) if warm else None,
        "fields": {},
    }
    bitwise = True
    for f in sol._fields:
        if f not in recorded:
            continue
        new = getattr(sol, f).detach().cpu().numpy()
        same = new.dtype == recorded[f].dtype and np.array_equal(
            new, recorded[f], equal_nan=True)
        report["fields"][f] = bool(same)
        bitwise = bitwise and same
    report["bitwise"] = bitwise
    report["status"] = {
        "recorded": recorded.get("status", recorded.get("converged")),
        "replayed": getattr(sol, "status", getattr(sol, "converged", None)),
    }
    for k, v in report["status"].items():
        if v is not None:
            report["status"][k] = (v.tolist() if isinstance(v, torch.Tensor)
                                   else np.asarray(v).tolist())
    return (RC_OK if bitwise else RC_MISMATCH), report


def self_check():
    """Synthesize a failing LP, check the health engine flags it, capture
    it, replay it, and require a bitwise reproduction (a warm-started
    capture too); an archival capture must be refused."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.obs.health import classify_trace
    from dispatches_tpu_torch.obs.recorder import FlightRecorder, warm_bundle
    from dispatches_tpu_torch.solvers.ipm import solve_lp

    # min -(x1+x2)  s.t.  x1 - x2 = 0,  x >= 0: unbounded below, so the
    # IPM cannot converge
    lp = LPData(*(torch.as_tensor(np.asarray(a, np.float64)) for a in (
        [[1.0, -1.0]], [0.0], [-1.0, -1.0], [0.0, 0.0], [np.inf, np.inf], 0.0)))
    options = dict(tol=1e-8, max_iter=30)
    sol, tr = solve_lp(lp, trace=True, **options)
    verdict = classify_trace(tr, sol=sol)[0]
    if verdict.verdict == "healthy":
        raise AssertionError(f"self-check fixture unexpectedly healthy: {verdict}")
    print(f"self-check: fixture verdict = {verdict.verdict} "
          f"(first bad iter {verdict.first_bad_iteration}, quantity {verdict.quantity})")
    tmp = tempfile.mkdtemp(prefix="replay-selfcheck-")
    try:
        rec = FlightRecorder(tmp)
        cap = rec.capture("solve_lp", problem=lp, options=options, verdict=verdict,
                          solution=sol)
        rc, report = replay(cap)
        print(json.dumps(report, indent=1, default=str))
        if rc != RC_OK:
            raise AssertionError(f"replay not bitwise (rc={rc})")
        arch = rec.capture("solve_lp_banded_batch", arrays={"x0": np.zeros(3)})
        if replay(arch)[0] != RC_NOT_REPLAYABLE:
            raise AssertionError("an archival capture was replayed")
        seed = (torch.full((2,), 0.5, dtype=torch.float64), torch.zeros(1, dtype=torch.float64),
                torch.full((2,), 0.1, dtype=torch.float64),
                torch.full((2,), 0.1, dtype=torch.float64))
        sol_w = solve_lp(lp, warm_start=seed, **options)
        cap_w = rec.capture("solve_lp", problem=lp, options=options, verdict=verdict,
                            warm_start=warm_bundle(lp, seed), solution=sol_w)
        rc_w, rep_w = replay(cap_w)
        if not rep_w["warm_start"] or rc_w != RC_OK:
            raise AssertionError(f"warm-started replay not bitwise (rc={rc_w})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("self-check: OK (capture -> replay reproduced bitwise, warm-started "
          "capture included)")
    return RC_OK


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capture", nargs="?",
                    help="capture dir (cap-*/) or a --record-failures dir")
    ap.add_argument("--last", action="store_true",
                    help="with a record dir: replay the newest capture")
    ap.add_argument("--device", default=None,
                    help="torch device to replay on (default: the one the capture was "
                         "taken on)")
    ap.add_argument("--self-check", action="store_true",
                    help="synthetic capture -> replay round trip")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check()
    if not args.capture:
        ap.error("capture path required (or --self-check)")
    try:
        cap = _find_capture(args.capture, last=args.last)
        rc, report = replay(cap, device=args.device)
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"replay: error: {type(exc).__name__}: {exc}", file=sys.stderr)
        return RC_ERROR
    print(json.dumps(report, indent=1, default=str))
    if rc == RC_OK:
        print("replay: reproduced bitwise")
    elif rc == RC_MISMATCH:
        bad = [f for f, ok in report.get("fields", {}).items() if not ok]
        print(f"replay: MISMATCH in fields {bad}", file=sys.stderr)
    else:
        print(f"replay: {report.get('error')}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
