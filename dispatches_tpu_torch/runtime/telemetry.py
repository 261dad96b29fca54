"""Solve statistics (port of `batch_stats` from
`dispatches_tpu/runtime/telemetry.py`)."""
from __future__ import annotations

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def batch_stats(sol) -> dict:
    """Self-diagnosing statistics for a batched IPM or PDHG solution:
    converged fraction, iteration histogram, residual quantiles, and the
    PDLP restart counts where the solution has them. Non-finite
    entries are clamped out of the histogram/quantiles and counted in
    `nonfinite_count` instead of crashing the report."""
    from ..solvers.ipm import status_name

    conv = np.atleast_1d(_np(sol.converged))
    iters = np.atleast_1d(_np(sol.iterations).astype(np.float64))
    nonfinite = int((~np.isfinite(iters)).sum())
    it_fin = iters[np.isfinite(iters)]
    if it_fin.size == 0:
        it_fin = np.zeros(1)
    # integer bin edges so rounded labels can never collide
    lo, hi = int(it_fin.min()), int(it_fin.max())
    step = max(1, int(np.ceil((hi - lo + 1) / 8)))
    edges = np.arange(lo, hi + step + 1, step)
    counts, edges = np.histogram(it_fin, bins=edges)
    stats = {
        "batch": int(conv.size),
        "converged_frac": float(conv.mean()),
        "iterations": {
            "min": lo,
            "median": float(np.median(it_fin)),
            "max": hi,
            "hist": {
                f"{int(edges[i])}-{int(edges[i + 1])}": int(counts[i])
                for i in range(len(counts))
            },
        },
    }
    for field in ("res_primal", "res_dual", "gap"):
        if not hasattr(sol, field):
            continue
        v = np.atleast_1d(_np(getattr(sol, field)).astype(np.float64))
        nonfinite += int((~np.isfinite(v)).sum())
        vf = v[np.isfinite(v)]
        if vf.size == 0:
            vf = np.array([np.nan])
        stats[field] = {
            "median": float(np.median(vf)),
            "p90": float(np.quantile(vf, 0.9)),
            "max": float(vf.max()),
        }
    stats["nonfinite_count"] = nonfinite
    # PDLP restart counts (solvers/pdhg.py, adaptive_restarts): how often
    # the lanes snapped back to their running averages; solutions without
    # the field (IPM) skip it
    if hasattr(sol, "restarts"):
        r = np.atleast_1d(_np(sol.restarts).astype(np.float64))
        rfin = r[np.isfinite(r)]
        if rfin.size:
            stats["restarts"] = {"total": int(rfin.sum()), "max": int(rfin.max())}
    if hasattr(sol, "status"):
        codes = np.atleast_1d(_np(sol.status))
        stats["status"] = {
            status_name(c): int((codes == c).sum()) for c in np.unique(codes)
        }
    return stats
