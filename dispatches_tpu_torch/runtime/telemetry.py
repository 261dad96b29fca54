"""Solve telemetry, NaN guards and unit reporting (port of
`dispatches_tpu/runtime/telemetry.py`).

- :class:`SolveTelemetry`: per-solve iteration / residual records from a
  solution's fields, fed into the metrics registry and the health
  verdicts, with a flight-recorder capture of a failed or unhealthy solve;
- :func:`batch_stats`: the self-diagnosing summary the journal embeds;
- :func:`check_finite`: a NaN / Inf guard over nested results;
- :func:`report_unit`: the IDAES ``unit.report()`` stream table of one
  unit's solution values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import health as _health
from ..obs import metrics as _metrics
from ..obs import recorder as _recorder

# iteration-count buckets (the wall-clock default buckets are wrong for a
# quantity that lives in [1, max_iter])
_ITER_BUCKETS = (1, 2, 5, 10, 20, 30, 45, 60, 80, 100, 150)


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclasses.dataclass
class SolveRecord:
    name: str
    iterations: int
    converged: bool
    res_primal: float
    res_dual: float
    gap: float
    wall_s: float
    batch: int = 1
    failed: bool = False  # fn raised; `error` holds the exception type
    error: str = ""
    verdict: str = "healthy"  # worst obs.health verdict across the batch


def _field_max(sol, field, default=float("nan")) -> float:
    """max of a solution field, tolerating absent fields (PDHGSolution has
    no `gap`), non-array values and all-NaN arrays."""
    v = getattr(sol, field, None)
    if v is None:
        return default
    try:
        arr = np.atleast_1d(_np(v).astype(np.float64))
    except (TypeError, ValueError):
        return default
    fin = arr[np.isfinite(arr)]
    return float(fin.max()) if fin.size else default


class SolveTelemetry:
    """Collects per-solve records; wrap solves with :meth:`observe`."""

    def __init__(self):
        self.records: List[SolveRecord] = []

    def observe(self, name: str, fn, *args, **kwargs):
        """Run `fn(*args, **kwargs)` and record its telemetry; returns the
        result unchanged. A result that is not solution-shaped (a tuple,
        None) is recorded with NaN residuals. When `fn` raises, a
        ``failed=True`` record with the exception type is appended and the
        exception re-raised.

        Every observation also lands in the metrics registry, labelled
        ``solve="<name>"``: `solves_total` / `solve_failures_total`,
        `solve_batch_total`, `solve_unconverged_total`,
        `solve_verdict_total{verdict=...}` (from
        `obs.health.classify_solution`), and the `solve_wall_seconds` /
        `solve_iterations` histograms. With a flight recorder installed
        (`obs.recorder.set_recorder`), a failed or non-healthy solve whose
        problem is ``args[0]`` is captured. The wall clock waits for the
        device (`torch.cuda.synchronize`) when CUDA is in use."""
        problem = args[0] if args and hasattr(args[0], "_fields") else None
        t0 = time.perf_counter()
        try:
            sol = fn(*args, **kwargs)
        except Exception as e:
            wall = time.perf_counter() - t0
            _metrics.inc("solve_failures_total", solve=name, error=type(e).__name__)
            _metrics.inc("solve_verdict_total", solve=name, verdict="failed")
            _metrics.observe("solve_wall_seconds", wall, solve=name)
            _recorder.maybe_capture(
                name, verdict="failed", problem=problem,
                warm_start=_recorder.warm_bundle(problem, kwargs.get("warm_start")),
                extra={"error": f"{type(e).__name__}: {e}"},
            )
            self.records.append(SolveRecord(
                name=name, iterations=0, converged=False, res_primal=float("nan"),
                res_dual=float("nan"), gap=float("nan"), wall_s=wall, batch=0,
                failed=True, error=type(e).__name__, verdict="failed",
            ))
            raise
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        conv = np.atleast_1d(_np(getattr(sol, "converged", False)))
        iters = np.atleast_1d(_np(getattr(sol, "iterations", 0)))
        it_fin = iters[np.isfinite(iters.astype(np.float64))]
        max_iters = int(it_fin.max()) if it_fin.size else 0
        _metrics.inc("solves_total", solve=name)
        _metrics.inc("solve_batch_total", int(conv.size), solve=name)
        if not bool(conv.all()):
            _metrics.inc("solve_unconverged_total", int(conv.size - conv.sum()), solve=name)
        _metrics.observe("solve_wall_seconds", wall, solve=name)
        _metrics.observe("solve_iterations", max_iters, buckets=_ITER_BUCKETS, solve=name)
        # end-state diagnosis (no trace rides through telemetry); a result
        # that is not solution-shaped classifies as None: healthy by absence
        worst = "healthy"
        verdicts = _health.classify_solution(sol) if hasattr(sol, "converged") else None
        if verdicts is not None:
            worst_v = _health.worst_verdict(verdicts)
            worst = worst_v.verdict
            counts: Dict[str, int] = {}
            for v in verdicts:
                counts[v.verdict] = counts.get(v.verdict, 0) + 1
            _health.note_verdicts(counts, solve=name)
            if worst != "healthy":
                _recorder.maybe_capture(
                    name, verdict=worst_v, problem=problem, solution=sol,
                    warm_start=_recorder.warm_bundle(problem, kwargs.get("warm_start")),
                )
        self.records.append(SolveRecord(
            name=name, iterations=max_iters, converged=bool(conv.all()),
            res_primal=_field_max(sol, "res_primal"), res_dual=_field_max(sol, "res_dual"),
            gap=_field_max(sol, "gap"), wall_s=wall, batch=int(conv.size), verdict=worst,
        ))
        return sol

    def summary(self) -> dict:
        if not self.records:
            return {"solves": 0}
        return {
            "solves": len(self.records),
            "total_batch": sum(r.batch for r in self.records),
            "all_converged": all(r.converged for r in self.records),
            "max_iterations": max(r.iterations for r in self.records),
            "worst_gap": max(r.gap for r in self.records),
            "total_wall_s": sum(r.wall_s for r in self.records),
        }

    def __str__(self):
        lines = [
            f"{'solve':<24}{'batch':>6}{'iters':>7}{'conv':>6}"
            f"{'gap':>11}{'wall [s]':>10}  {'verdict'}"
        ]
        for r in self.records:
            lines.append(
                f"{r.name:<24}{r.batch:>6}{r.iterations:>7}"
                f"{str(r.converged):>6}{r.gap:>11.2e}{r.wall_s:>10.3f}"
                f"  {r.verdict}"
            )
        return "\n".join(lines)


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


def _leaves(tree, path=()):
    """(path, leaf) pairs of nested NamedTuples, tuples, lists and dicts,
    the path's parts spelt as JAX's tree paths spell them."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def check_finite(tree, name: str = "value"):
    """Raise FloatingPointError if any floating leaf holds NaN / Inf; a
    host-side guard for solve outputs and checkpoint payloads. Returns
    `tree`."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = _np(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append("/".join(path) or "<leaf>")
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return tree


def report_unit(
    prog, x, unit: str, time_points: Optional[int] = 6, stream=None
) -> Dict[str, np.ndarray]:
    """Print an IDAES-style stream table of one unit's solution values
    (`battery.py:178-233` `_get_stream_table_contents` analogue) and return
    the {var: values} dict. `unit` is the variable-name prefix ("battery",
    "pem", ...)."""
    rows: Dict[str, np.ndarray] = {}
    for name in prog._vars:
        if name == unit or name.startswith(unit + "."):
            rows[name] = np.atleast_1d(_np(prog.extract(name, torch.as_tensor(x))))
    if not rows:
        raise KeyError(f"no variables with prefix {unit!r}")
    width = max(len(n) for n in rows) + 2
    lines = [f"Unit report: {unit}", "=" * (width + 40)]
    for name, vals in rows.items():
        shown = vals[:time_points] if time_points else vals
        body = ", ".join(f"{v:.6g}" for v in shown)
        suffix = " ..." if time_points and len(vals) > time_points else ""
        lines.append(f"{name:<{width}}[{body}{suffix}]")
    text = "\n".join(lines)
    print(text, file=stream) if stream else print(text)
    return rows
