"""Solver health engine (port of `dispatches_tpu/obs/health.py`):
per-solve verdicts from solver end states and `SolveTrace` trajectories.

Verdicts: ``healthy`` (converged within the budget), ``slow`` (converged
late, or out of budget while still improving), ``stalled`` (unconverged,
the blocking residual's running minimum no longer improving),
``diverged`` (ends far above its running minimum), ``cycling`` (the tail
repeats with a short period) and ``nonfinite`` (a NaN / Inf inside the
recorded region); ``unrecoverable`` is the remediation ladder's
(`runtime/remedy.py`). Everything here is host-side numpy over results
already produced: tensors on any device are copied to the host first,
and solver results are the same with the engine in use.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from . import metrics as _metrics


def _host(v, dtype=None) -> np.ndarray:
    """`v` (a tensor on any device, an array or a number) as numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=dtype)


# ---------------------------------------------------------------------------
# thresholds (documented in docs/observability.md §7)
# ---------------------------------------------------------------------------
BLOWUP = 1e3  # diverged: final value > BLOWUP x running min (flag_divergent)
STALL_WINDOW = 8  # stalled: look-back window, in recorded entries
STALL_RTOL = 1e-2  # stalled: min relative improvement expected per window
SLOW_FRAC = 0.9  # slow: converged using >= this fraction of the budget
CYCLE_WINDOW = 12  # cycling: tail length inspected for periodicity
CYCLE_RTOL = 0.05  # cycling: relative match tolerance at lag p
CYCLE_AMP = 0.10  # cycling: minimum relative amplitude (flat != cycling)

# severity order: index = badness (worst-offender selection). The list is
# the JAX package's, service and fleet verdicts included, so severities
# compare across the two packages.
SEVERITY = (
    "healthy", "slow", "inaccurate", "cycling", "stalled",
    "deadline_exceeded", "shed", "shed_tenant_quota", "poisoned",
    "diverged", "nonfinite", "unrecoverable", "hang", "failed",
)

# trajectory fields in blame-precedence order: residuals first (what the
# convergence test reads), then steps (a symptom, not a criterion)
_RESIDUAL_FIELDS = ("res_primal", "res_dual", "gap")
_ALL_FIELDS = _RESIDUAL_FIELDS + ("step_primal", "step_dual")


class Verdict(NamedTuple):
    """One trajectory's diagnosis.

    ``first_bad_iteration`` is the index into the *recorded* entries where
    the pathology sets in (for PDHG that's a convergence-check index, one per
    ``check_every`` iterations); None for ``healthy``. ``quantity`` names the
    trajectory that went bad (``res_primal``/``res_dual``/``gap``/
    ``step_primal``/``step_dual``) or ``iterations`` for budget verdicts.
    """

    verdict: str
    first_bad_iteration: Optional[int] = None
    quantity: Optional[str] = None
    detail: str = ""


def severity(verdict: str) -> int:
    try:
        return SEVERITY.index(verdict)
    except ValueError:
        return len(SEVERITY)  # unknown names sort worst — fail loud in UIs


def worst_verdict(verdicts: List[Verdict]) -> Verdict:
    if not verdicts:
        return Verdict("healthy")
    return max(verdicts, key=lambda v: severity(v.verdict))


# ---------------------------------------------------------------------------
# single-trajectory classification
# ---------------------------------------------------------------------------
def _first_nonfinite(fields: Dict[str, np.ndarray]) -> Optional[Verdict]:
    """Earliest non-finite entry across recorded fields (field order breaks
    ties). Fields that are entirely NaN inside the recorded region are taken
    as not-recorded-by-this-solver and skipped, not flagged."""
    best: Optional[Verdict] = None
    for name in _ALL_FIELDS:
        v = fields.get(name)
        if v is None or v.size == 0:
            continue
        fin = np.isfinite(v)
        if not fin.any():  # solver never records this field
            continue
        if fin.all():
            continue
        idx = int(np.argmin(fin))  # first False
        if best is None or idx < best.first_bad_iteration:
            best = Verdict(
                "nonfinite", idx, name,
                f"first non-finite {name} at recorded entry {idx}",
            )
    return best


def _divergence(fields: Dict[str, np.ndarray]) -> Optional[Verdict]:
    """`flag_divergent` criterion with an onset index: the series *ends*
    more than BLOWUP x above its running minimum; first-bad is the start of
    the terminal excursion (a recovered transient spike is not divergence)."""
    best: Optional[Verdict] = None
    for name in ("gap", "res_primal"):
        g = fields.get(name)
        if g is None or g.size == 0 or not np.isfinite(g).any():
            continue
        runmin = np.minimum.accumulate(g)
        bad = g > BLOWUP * np.maximum(runmin, 1e-300)
        if not bad[-1]:
            continue
        good_idx = np.flatnonzero(~bad)
        onset = int(good_idx[-1]) + 1 if good_idx.size else 0
        onset = min(onset, len(g) - 1)
        if best is None or onset < best.first_bad_iteration:
            best = Verdict(
                "diverged", onset, name,
                f"{name} ends {g[-1] / max(runmin[-1], 1e-300):.1e}x above "
                f"its running min (blowup > {BLOWUP:g})",
            )
    return best


def _blocking_quantity(fields: Dict[str, np.ndarray]) -> Optional[str]:
    """The residual field with the largest final value — the quantity the
    convergence test is waiting on."""
    cand = None
    cand_val = -np.inf
    for name in _RESIDUAL_FIELDS:
        v = fields.get(name)
        if v is None or v.size == 0 or not np.isfinite(v[-1]):
            continue
        if float(v[-1]) > cand_val:
            cand, cand_val = name, float(v[-1])
    return cand


def _cycling(r: np.ndarray, name: str, n: int) -> Optional[Verdict]:
    w = min(n, CYCLE_WINDOW)
    if w < 6:
        return None
    t = r[n - w : n]
    top = float(np.max(np.abs(t)))
    if top <= 0 or not np.isfinite(t).all():
        return None
    if (np.max(t) - np.min(t)) <= CYCLE_AMP * top:
        return None  # flat tail: a stall, not a cycle
    for p in range(2, w // 2 + 1):
        lagged = np.abs(t[p:] - t[:-p])
        if np.all(lagged <= CYCLE_RTOL * np.maximum(np.abs(t[:-p]), 1e-300)):
            return Verdict(
                "cycling", n - w, name,
                f"{name} tail repeats with period {p} over the last {w} "
                "recorded entries",
            )
    return None


def _stalled(r: np.ndarray, name: str, n: int) -> Optional[Verdict]:
    if n <= STALL_WINDOW:
        return None
    runmin = np.minimum.accumulate(r)
    if runmin[-1] < (1.0 - STALL_RTOL) * runmin[-1 - STALL_WINDOW]:
        return None  # still improving across the window
    improved = np.flatnonzero(runmin[1:] < (1.0 - STALL_RTOL) * runmin[:-1])
    onset = int(improved[-1]) + 2 if improved.size else 1
    onset = min(onset, n - 1)
    return Verdict(
        "stalled", onset, name,
        f"{name} running min improved < {STALL_RTOL:.0%} over the last "
        f"{STALL_WINDOW} recorded entries",
    )


def classify_trajectory(
    fields: Dict[str, np.ndarray],
    converged: bool,
    budget: Optional[int] = None,
) -> Verdict:
    """Diagnose ONE trajectory from its recorded (finite-prefix) entries.

    `fields` maps trace-field names to 1-D arrays already clipped to the
    recorded region; `budget` is the total trace length (max_iter slots).
    """
    n = max((v.size for v in fields.values() if v is not None), default=0)
    if n == 0:
        # zero recorded entries: converged at iteration 0 (presolve-trivial)
        # or the solve never ran — nothing to diagnose either way
        return Verdict("healthy") if converged else Verdict(
            "stalled", 0, None, "no recorded iterations"
        )
    bad = _first_nonfinite(fields)
    if bad is not None:
        return bad
    if converged:
        if budget and n >= SLOW_FRAC * budget:
            return Verdict(
                "slow", n, "iterations",
                f"converged but used {n}/{budget} of the budget",
            )
        return Verdict("healthy")
    bad = _divergence(fields)
    if bad is not None:
        return bad
    block = _blocking_quantity(fields)
    if block is not None:
        r = fields[block]
        bad = _cycling(r, block, n)
        if bad is not None:
            return bad
        bad = _stalled(r, block, n)
        if bad is not None:
            return bad
    return Verdict(
        "slow", n, block or "iterations",
        "unconverged at budget exhaustion but still improving",
    )


# ---------------------------------------------------------------------------
# batched entry points
# ---------------------------------------------------------------------------
def classify_trace(tr, sol=None, converged=None) -> List[Verdict]:
    """Per-trajectory verdicts for a (possibly vmapped) `SolveTrace`.

    Convergence comes from `sol.converged` (or an explicit `converged`
    array); without either, a trajectory is treated as unconverged — the
    conservative reading for a diagnosis layer."""
    rp = np.atleast_2d(_host(tr.res_primal))
    B, L = rp.shape
    if converged is None and sol is not None:
        converged = getattr(sol, "converged", None)
    conv = (
        np.broadcast_to(np.atleast_1d(_host(converged)), (B,))
        if converged is not None
        else np.zeros(B, dtype=bool)
    )
    raw = {
        name: np.atleast_2d(_host(getattr(tr, name))) for name in _ALL_FIELDS
    }
    # recorded region per lane: through the LAST finite entry across all
    # fields — not the finite-entry COUNT of res_primal (that convention,
    # used by `recorded_iterations`, would clip out a mid-solve NaN before
    # the nonfinite detector could blame it)
    out: List[Verdict] = []
    for b in range(B):
        n = 0
        for name in _ALL_FIELDS:
            fin = np.flatnonzero(np.isfinite(raw[name][b]))
            if fin.size:
                n = max(n, int(fin[-1]) + 1)
        fields = {name: raw[name][b, :n] for name in _ALL_FIELDS}
        v = classify_trajectory(fields, bool(conv[b]), budget=L)
        if v.verdict != "nonfinite" and not conv[b] and sol is not None:
            # a lane whose final record wrote NaN to EVERY field looks like
            # padding to the region scan; the solution's end-state residuals
            # still carry the breakdown
            for name in _RESIDUAL_FIELDS:
                ev = getattr(sol, name, None)
                if ev is None:
                    continue
                evb = np.atleast_1d(_host(ev, dtype=np.float64))
                val = evb[b] if evb.shape[0] == B else evb[0]
                if not np.isfinite(val):
                    v = Verdict(
                        "nonfinite", n, name,
                        f"end-state {name} non-finite (trace tail lost)",
                    )
                    break
        out.append(v)
    return out


def classify_solution(sol, budget: Optional[int] = None) -> Optional[List[Verdict]]:
    """Trace-free fallback: diagnose from a solution's end-state fields
    alone (converged flags, residuals, IPM status codes). Far coarser than
    `classify_trace` — no trajectory means no cycling/divergence-onset
    analysis. Returns None when `sol` is not solution-shaped (no
    `converged` field), so callers can wrap arbitrary results."""
    if not hasattr(sol, "converged"):
        return None
    conv = np.atleast_1d(_host(sol.converged)).astype(bool)
    B = conv.shape[0]
    iters = np.broadcast_to(
        np.atleast_1d(_host(getattr(sol, "iterations", 0), dtype=np.float64)),
        (B,),
    )
    res: Dict[str, np.ndarray] = {}
    for name in _RESIDUAL_FIELDS:
        v = getattr(sol, name, None)
        if v is None:
            continue
        res[name] = np.broadcast_to(
            np.atleast_1d(_host(v, dtype=np.float64)), (B,)
        )
    status = getattr(sol, "status", None)
    status = (
        np.broadcast_to(np.atleast_1d(_host(status)), (B,))
        if status is not None
        else None
    )
    out: List[Verdict] = []
    for b in range(B):
        it = int(iters[b]) if np.isfinite(iters[b]) else None
        bad_field = next(
            (n for n in _RESIDUAL_FIELDS if n in res and not np.isfinite(res[n][b])),
            None,
        )
        if bad_field is not None or (it is None):
            out.append(Verdict(
                "nonfinite", it, bad_field or "iterations",
                "non-finite end-state (no trace for provenance)",
            ))
            continue
        if conv[b]:
            if budget and it >= SLOW_FRAC * budget:
                out.append(Verdict(
                    "slow", it, "iterations",
                    f"converged but used {it}/{budget} of the budget",
                ))
            else:
                out.append(Verdict("healthy"))
            continue
        # unconverged, finite: blame the largest end-state residual; the
        # IPM's own exit diagnosis (suspected infeasibility) refines it
        block = None
        if res:
            block = max(res, key=lambda n: float(res[n][b]))
        detail = "unconverged (no trace; end-state diagnosis)"
        if status is not None:
            code = int(status[b])
            if code == 2:  # STATUS_PRIMAL_INFEASIBLE
                block, detail = "res_primal", "suspected primal infeasible"
            elif code == 3:  # STATUS_DUAL_INFEASIBLE
                block, detail = "res_dual", "suspected dual infeasible"
        out.append(Verdict("stalled", it, block, detail))
    return out


def health_summary(sol, trace=None, budget: Optional[int] = None) -> Optional[dict]:
    """JSON-safe per-solve health record for journals: verdict counts, the
    worst offender (with its lane index), and per-lane verdicts (capped at
    32 lanes — counts stay complete either way). Returns None when `sol`
    is not solution-shaped."""
    if trace is not None:
        try:
            verdicts = classify_trace(trace, sol=sol)
        except Exception:
            verdicts = classify_solution(sol, budget=budget)
    else:
        verdicts = classify_solution(sol, budget=budget)
    if verdicts is None:
        return None
    counts: Dict[str, int] = {}
    for v in verdicts:
        counts[v.verdict] = counts.get(v.verdict, 0) + 1
    worst_i = int(np.argmax([severity(v.verdict) for v in verdicts]))
    worst = verdicts[worst_i]
    rec: Dict[str, Any] = {
        "counts": counts,
        "n_bad": sum(n for k, n in counts.items() if k != "healthy"),
        "worst": {"lane": worst_i, **worst._asdict()},
    }
    if len(verdicts) <= 32:
        rec["verdicts"] = [v._asdict() for v in verdicts]
    else:
        rec["verdicts_truncated"] = len(verdicts)
    return rec


def verdict_from_stats(stats: dict) -> str:
    """Coarse verdict from a `batch_stats` dict (the sweep runners carry
    these where no solution object survives): nonfinite beats unconverged
    beats healthy."""
    if not isinstance(stats, dict) or not stats:
        return "healthy"
    if stats.get("nonfinite_count"):
        return "nonfinite"
    cf = stats.get("converged_frac")
    if isinstance(cf, (int, float)) and cf < 1.0:
        return "stalled"
    return "healthy"


def note_verdicts(summary_or_counts, solve: str) -> None:
    """Bump `solve_verdict_total{solve=...,verdict=...}` counters from a
    `health_summary` record (or a bare counts dict)."""
    counts = summary_or_counts
    if isinstance(summary_or_counts, dict) and "counts" in summary_or_counts:
        counts = summary_or_counts["counts"]
    if not isinstance(counts, dict):
        return
    for verdict, n in counts.items():
        if isinstance(n, (int, float)) and n:
            _metrics.inc("solve_verdict_total", float(n), solve=solve, verdict=str(verdict))
