"""Latency SLOs, error budgets, and multi-window burn rates (pillar 8b).

Port of `dispatches_tpu/obs/slo.py`: pure Python, copied as it is.

Consumes schema-v3 ``journey`` records (see `obs.reqtrace`) and answers
the operator question "are we eating error budget, and how fast?" in
the standard SRE formulation:

- An :class:`SLO` names a latency objective for a priority class: a
  target fraction (`target`, e.g. 0.99) of requests must complete under
  `latency_s` *and* not be shed / deadline-exceeded.
- The **error budget** is ``1 - target``.
- The **burn rate** over a trailing window is ``bad_fraction /
  error_budget``: 1.0 means the budget is being consumed exactly at the
  sustainable rate; 14.4 over 1h is the classic page-now threshold.

Everything here is plain-Python over journal dicts — no JAX, no clock
reads. "Now" defaults to the latest completion stamp in the data so
evaluation is deterministic for a recorded journal (and under the fake
clocks used in tests).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

#: Terminals that consume error budget regardless of latency.
BAD_TERMINALS = ("shed", "deadline_exceeded")

#: Default trailing windows: (span_seconds, label).
DEFAULT_WINDOWS: Tuple[Tuple[float, str], ...] = (
    (60.0, "1m"), (300.0, "5m"), (3600.0, "1h"),
)


class SLO(NamedTuple):
    """A latency objective: `target` fraction of `priority`-class
    requests (all classes when None) must finish under `latency_s`."""

    name: str
    latency_s: float
    target: float = 0.99
    priority: Optional[str] = None

    @property
    def error_budget(self) -> float:
        return max(1.0 - float(self.target), 1e-12)


#: Per-priority-class defaults, aligned with the serving-tier doc's
#: interactive/normal/batch taxonomy. Report-flavored — gates should
#: pass explicit objectives sized for their environment.
DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO("interactive", 0.050, 0.99, "interactive"),
    SLO("normal", 0.250, 0.99, "normal"),
    SLO("batch", 2.0, 0.95, "batch"),
)


def journey_outcomes(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reduce journal records to SLO-relevant outcomes: completion time
    (``t0 + latency_s``), latency, terminal, priority. Non-journey and
    malformed records are skipped (pre-v3 journals yield [])."""
    out: List[Dict[str, Any]] = []
    for r in records:
        if not isinstance(r, dict) or r.get("kind") != "journey":
            continue
        lat, t0 = r.get("latency_s"), r.get("t0")
        if not isinstance(lat, (int, float)) or not isinstance(t0, (int, float)):
            continue
        out.append({
            "t": float(t0) + float(lat),
            "latency_s": float(lat),
            "terminal": r.get("terminal"),
            "priority": r.get("priority"),
        })
    return out


def burn_rates(
    outcomes: Sequence[Dict[str, Any]],
    slo: SLO,
    windows: Sequence[Tuple[float, str]] = DEFAULT_WINDOWS,
    now: Optional[float] = None,
) -> Dict[str, Dict[str, Any]]:
    """Per-window burn rates for one SLO. `now` anchors the trailing
    windows; defaults to the latest completion stamp (journal clock
    domain — wall or fake, whatever produced the journeys)."""
    mine = [
        o for o in outcomes
        if slo.priority is None or o["priority"] == slo.priority
    ]
    if now is None:
        now = max((o["t"] for o in mine), default=0.0)
    per: Dict[str, Dict[str, Any]] = {}
    for span, label in windows:
        win = [o for o in mine if o["t"] >= now - span]
        bad = sum(
            1 for o in win
            if o["terminal"] in BAD_TERMINALS or o["latency_s"] > slo.latency_s
        )
        n = len(win)
        frac = (bad / n) if n else 0.0
        per[label] = {
            "window_s": span,
            "events": n,
            "bad": bad,
            "bad_frac": frac,
            "burn_rate": frac / slo.error_budget,
        }
    return per


def evaluate(
    records: Iterable[Dict[str, Any]],
    slos: Sequence[SLO] = DEFAULT_SLOS,
    windows: Sequence[Tuple[float, str]] = DEFAULT_WINDOWS,
    now: Optional[float] = None,
) -> Dict[str, Dict[str, Any]]:
    """Full SLO report for a journal: per-SLO objective, per-window burn
    rates, and the worst burn across windows (the gate-able scalar)."""
    outcomes = journey_outcomes(records)
    report: Dict[str, Dict[str, Any]] = {}
    for slo in slos:
        per = burn_rates(outcomes, slo, windows, now)
        report[slo.name] = {
            "objective_latency_s": slo.latency_s,
            "target": slo.target,
            "error_budget": slo.error_budget,
            "priority": slo.priority,
            "windows": per,
            "worst_burn_rate": max(
                (w["burn_rate"] for w in per.values()), default=0.0
            ),
        }
    return report


# qualified-import callers say slo.evaluate(...); the package re-export
# needs an unambiguous name
evaluate_slos = evaluate


def worst_burn_rate(report: Dict[str, Dict[str, Any]]) -> float:
    """Largest burn rate across every SLO and window in a report."""
    return max((s["worst_burn_rate"] for s in report.values()), default=0.0)


def breaches(
    report: Dict[str, Dict[str, Any]], max_burn: float = 1.0
) -> List[Tuple[str, str, float]]:
    """(slo_name, window_label, burn_rate) triples over `max_burn` —
    the alert/gate surface."""
    out: List[Tuple[str, str, float]] = []
    for name, s in sorted(report.items()):
        for label, w in sorted(s["windows"].items()):
            if w["burn_rate"] > max_burn:
                out.append((name, label, w["burn_rate"]))
    return out
