"""Declarative alerting over `obs.timeseries` (pillar 10; port of
`dispatches_tpu/obs/alerts.py`, host-side Python kept line for line).

An `AlertRule` names a condition over retained series; `AlertManager`
evaluates the pack against a `SeriesStore` and owns the
firing→resolved lifecycle:

- **threshold** — a windowed reduction (``last``/``avg``/``max``/...)
  of every matching series compared against ``bound``;
- **rate** — per-second rate of change across the window (counter
  increase / gauge slope), compared against ``bound``;
- **absence** — a series the store has seen before stopped being
  sampled for ``window`` seconds (a dead scrape path, a wedged pump);
- **slo_burn** — the manager's ``slo_fn`` report's worst multi-window
  burn rate compared against ``bound`` (14.4 = the classic fast-burn
  page), with the value mirrored into the ``slo_worst_burn_rate`` gauge
  so the burn history is queryable like any other series.

Every rule carries a ``for_`` hold (the condition must stay true that
long before the alert fires — evaluation noise doesn't page) and a
hysteresis ``clear_bound`` (a firing alert only resolves once the value
crosses the *clear* bound, so a metric oscillating on the threshold
doesn't flap). Transitions emit ``alert`` journal events, increment
``alerts_fired_total{rule,severity}`` / ``alerts_resolved_total{rule}``,
set ``alerts_firing{rule}``, and capture a flight-recorder-style
context bundle (the rule's recent series window + a registry snapshot)
on first firing — what was the fleet doing when this paged?

Alerts are evaluated per matching series (one labeled gauge per shard
means one alert instance per shard), exactly the Prometheus model.
Everything here is host-side, lock-cheap, and off by default: no rule
evaluates until a service is built with ``timeseries=True`` or a tool
constructs an `AlertManager`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from . import metrics as obs_metrics
from .timeseries import SeriesStore

obs_metrics.describe(
    "alerts_fired_total",
    "Alert firing transitions, by rule and severity (an alert that "
    "fires, resolves, and fires again counts twice).",
)
obs_metrics.describe(
    "alerts_resolved_total",
    "Alert resolved transitions, by rule (fired minus resolved equals "
    "the currently-firing count).",
)
obs_metrics.describe(
    "alerts_firing",
    "Alert instances currently firing, by rule (steady state is 0; a "
    "non-zero close snapshot means the run ended degraded).",
)

SEVERITIES = ("info", "warn", "page")
KINDS = ("threshold", "rate", "absence", "slo_burn")


@dataclass(frozen=True)
class AlertRule:
    """One declarative alert condition (see module docstring for kinds).

    ``op`` orients the comparison (``">"`` fires high, ``"<"`` fires
    low); ``clear_bound`` defaults to ``bound`` (no hysteresis) and must
    sit on the non-firing side of ``bound``; ``for_`` is the hold
    duration in seconds (named with the trailing underscore because
    ``for`` is reserved — rule files spell it ``"for"``)."""

    name: str
    series: str
    kind: str = "threshold"
    labels: Optional[Mapping[str, str]] = None
    op: str = ">"
    bound: float = 0.0
    clear_bound: Optional[float] = None
    window: float = 60.0
    agg: str = "last"
    for_: float = 0.0
    severity: str = "warn"
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown alert kind {self.kind!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"alert op must be '>' or '<' (got {self.op!r})")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.clear_bound is not None:
            breached = (
                self.clear_bound > self.bound
                if self.op == ">"
                else self.clear_bound < self.bound
            )
            if breached:
                raise ValueError(
                    f"clear_bound {self.clear_bound} is on the firing side "
                    f"of bound {self.bound} (op {self.op!r})"
                )

    def clear(self) -> float:
        return self.bound if self.clear_bound is None else self.clear_bound

    def breached(self, value: float) -> bool:
        return value > self.bound if self.op == ">" else value < self.bound

    def cleared(self, value: float) -> bool:
        return value <= self.clear() if self.op == ">" else value >= self.clear()

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["for"] = d.pop("for_")
        if d["labels"] is not None:
            d["labels"] = dict(d["labels"])
        return d


def rule_from_dict(d: Mapping[str, Any]) -> AlertRule:
    """Build a rule from its JSON form (`tools/alert_check.py` rule
    files); accepts ``"for"`` for the hold duration."""
    kw = dict(d)
    if "for" in kw:
        kw["for_"] = kw.pop("for")
    unknown = set(kw) - {
        "name", "series", "kind", "labels", "op", "bound", "clear_bound",
        "window", "agg", "for_", "severity", "description",
    }
    if unknown:
        raise ValueError(f"unknown rule fields {sorted(unknown)}")
    return AlertRule(**kw)


def default_fleet_rules(
    *,
    queue_limit: int = 256,
    heartbeat_timeout: float = 5.0,
    slo_fast_burn: float = 14.4,
) -> List[AlertRule]:
    """The rule pack `FleetService` installs under ``timeseries=True``:
    the conditions the chaos legs actually induce, plus the capacity
    plane's saturation early warning (which only evaluates once
    ``capacity=True`` publishes ``capacity_headroom_ratio`` — absent
    series produce no alert instances)."""
    return [
        AlertRule(
            name="shard_down", series="serve_shard_up", kind="threshold",
            op="<", bound=1.0, window=15.0, agg="last", for_=0.0,
            severity="page",
            description="a shard process is down (crashed, wedge-killed, "
            "or backing off before respawn)",
        ),
        AlertRule(
            name="shard_pong_wedge",
            series="serve_shard_last_pong_age_seconds", kind="threshold",
            op=">", bound=0.8 * float(heartbeat_timeout),
            clear_bound=0.4 * float(heartbeat_timeout),
            window=15.0, agg="last", for_=0.0, severity="page",
            description="a shard stopped answering heartbeats (wedge "
            "imminent: supervision kills at heartbeat_timeout)",
        ),
        AlertRule(
            name="queue_saturation", series="serve_queue_depth",
            kind="threshold", op=">", bound=0.8 * float(queue_limit),
            clear_bound=0.5 * float(queue_limit), window=30.0, agg="avg",
            for_=0.0, severity="warn",
            description="admission queue sustained above 80% of "
            "queue_limit (sheds are imminent)",
        ),
        AlertRule(
            name="slo_fast_burn", series="slo_worst_burn_rate",
            kind="slo_burn", op=">", bound=float(slo_fast_burn),
            clear_bound=1.0, window=60.0, for_=0.0, severity="page",
            description="worst multi-window SLO burn rate over the "
            "fast-burn page threshold",
        ),
        AlertRule(
            name="poison_rate", series="poisoned_requests_total",
            kind="rate", op=">", bound=0.0, window=60.0, for_=0.0,
            severity="page",
            description="requests are being quarantined as poisoned "
            "(crash-looping dispatches hit the max_requeues cap)",
        ),
        AlertRule(
            name="saturation_approach", series="capacity_headroom_ratio",
            kind="threshold", op="<", bound=0.15, clear_bound=0.30,
            window=30.0, agg="avg", for_=0.0, severity="warn",
            description="a shard's measured capacity headroom is nearly "
            "exhausted (the fleet is approaching its saturation knee; "
            "scale out before the admission queue starts shedding)",
        ),
    ]


@dataclass
class _AlertState:
    status: str = "inactive"  # inactive | pending | firing
    pending_since: Optional[float] = None
    fired_at: Optional[float] = None
    value: Optional[float] = None
    fired_count: int = 0
    context: Optional[Dict[str, Any]] = field(default=None, repr=False)


class AlertManager:
    """Evaluate a rule pack against a `SeriesStore` and own the alert
    lifecycle. `evaluate()` is idempotent per timestamp and safe to call
    every pump cycle (`maybe_evaluate` rate-limits to `eval_every`,
    default the store's raw resolution)."""

    def __init__(
        self,
        store: SeriesStore,
        rules: Sequence[AlertRule] = (),
        *,
        clock: Optional[Callable[[], float]] = None,
        eval_every: Optional[float] = None,
        slo_fn: Optional[Callable[[], Mapping[str, Any]]] = None,
        journal: bool = True,
        max_history: int = 256,
        max_captures: int = 8,
        context_window: float = 120.0,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.store = store
        self.rules = list(rules)
        self.clock = clock if clock is not None else store.clock
        self.eval_every = (
            float(eval_every) if eval_every is not None
            else store.tiers[0][0]
        )
        self.slo_fn = slo_fn
        self.journal = bool(journal)
        self.context_window = float(context_window)
        self._lock = threading.Lock()
        # state per (rule name, series string); "" = the rule's own key
        # for kinds without a concrete matched series yet
        self._states: Dict[tuple, _AlertState] = {}
        self.history: deque = deque(maxlen=int(max_history))
        self.captures: deque = deque(maxlen=int(max_captures))
        self.evals = 0
        self._last_eval: Optional[float] = None

    # -- evaluation ----------------------------------------------------
    def maybe_evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = self.clock() if now is None else float(now)
        if (
            self._last_eval is not None
            and now - self._last_eval < self.eval_every
        ):
            return []
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the transitions (firing /
        resolved dicts) it produced."""
        now = self.clock() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self._last_eval = now
            self.evals += 1
            for rule in self.rules:
                for series, value in self._targets(rule, now):
                    tr = self._step_locked(rule, series, value, now)
                    if tr is not None:
                        transitions.append(tr)
                self._sync_firing_gauge_locked(rule)
        return transitions

    def _targets(self, rule: AlertRule, now: float):
        """(series, value) pairs the rule evaluates this pass."""
        if rule.kind == "slo_burn":
            burn = 0.0
            if self.slo_fn is not None:
                try:
                    burn = float(
                        (self.slo_fn() or {}).get("worst_burn_rate") or 0.0
                    )
                except Exception:
                    burn = 0.0
            # mirror into the store's registry so the burn history lands
            # in the store on the next sample and /query can draw it
            self.store._registry().set_gauge("slo_worst_burn_rate", burn)
            return [(rule.series, burn)]
        if rule.kind == "absence":
            name = rule.series
            last = self.store.last_seen(name, rule.labels)
            if last is None:
                return []  # never seen: silent, not firing (see docstring)
            return [(obs_metrics.series_name(name, rule.labels or {}),
                     now - last)]
        agg = "rate" if rule.kind == "rate" else rule.agg
        out = []
        for s in self.store.query(
            rule.series, rule.labels, window=rule.window, agg="raw", now=now
        ):
            v = self.store.reduce(
                *obs_metrics.parse_series(s["series"]),
                window=rule.window, agg=agg, now=now,
            )
            if v is not None:
                out.append((s["series"], v))
        return out

    def _breached(self, rule: AlertRule, value: float) -> bool:
        if rule.kind == "absence":
            return value > rule.window
        return rule.breached(value)

    def _cleared(self, rule: AlertRule, value: float) -> bool:
        if rule.kind == "absence":
            return value <= rule.window
        return rule.cleared(value)

    def _step_locked(
        self, rule: AlertRule, series: str, value: float, now: float
    ) -> Optional[Dict[str, Any]]:
        key = (rule.name, series)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _AlertState()
        st.value = value
        if st.status == "firing":
            if self._cleared(rule, value):
                return self._resolve_locked(rule, series, st, now)
            return None
        if self._breached(rule, value):
            if st.pending_since is None:
                st.pending_since = now
                st.status = "pending"
            if now - st.pending_since >= rule.for_:
                return self._fire_locked(rule, series, st, now)
            return None
        st.status = "inactive"
        st.pending_since = None
        return None

    def _fire_locked(
        self, rule: AlertRule, series: str, st: _AlertState, now: float
    ) -> Dict[str, Any]:
        st.status = "firing"
        st.fired_at = now
        st.pending_since = None
        st.fired_count += 1
        self.store._registry().inc(
            "alerts_fired_total", rule=rule.name, severity=rule.severity
        )
        if st.context is None:  # flight-recorder bundle on FIRST firing
            st.context = self._capture(rule, series, now)
            self.captures.append(st.context)
        tr = {
            "phase": "firing",
            "rule": rule.name,
            "series": series,
            "severity": rule.severity,
            "kind": rule.kind,
            "value": st.value,
            "bound": rule.bound,
            "t": now,
        }
        self.history.append(tr)
        if self.journal:
            from .journal import get_tracer

            get_tracer().event(
                "alert", **self._journal_attrs(tr),
                description=rule.description,
            )
        return tr

    def _resolve_locked(
        self, rule: AlertRule, series: str, st: _AlertState, now: float
    ) -> Dict[str, Any]:
        duration = now - (st.fired_at if st.fired_at is not None else now)
        st.status = "inactive"
        st.fired_at = None
        st.pending_since = None
        self.store._registry().inc("alerts_resolved_total", rule=rule.name)
        tr = {
            "phase": "resolved",
            "rule": rule.name,
            "series": series,
            "severity": rule.severity,
            "kind": rule.kind,
            "value": st.value,
            "bound": rule.clear(),
            "duration_s": duration,
            "t": now,
        }
        self.history.append(tr)
        if self.journal:
            from .journal import get_tracer

            get_tracer().event("alert", **self._journal_attrs(tr))
        return tr

    @staticmethod
    def _journal_attrs(tr: Mapping[str, Any]) -> Dict[str, Any]:
        # "kind" must not ride along verbatim: journal records carry
        # their own kind="event" and the rule kind would clobber it,
        # hiding alert events from every kind-based journal filter
        out = {k: v for k, v in tr.items() if k not in ("t", "kind")}
        out["rule_kind"] = tr["kind"]
        return out

    def _sync_firing_gauge_locked(self, rule: AlertRule) -> None:
        n = sum(
            1
            for (rname, _), st in self._states.items()
            if rname == rule.name and st.status == "firing"
        )
        self.store._registry().set_gauge(
            "alerts_firing", float(n), rule=rule.name
        )

    def _capture(
        self, rule: AlertRule, series: str, now: float
    ) -> Dict[str, Any]:
        """The what-was-happening bundle: the rule's recent window plus
        a registry snapshot, keyed for /alerts and offline triage."""
        try:
            window = self.store.query(
                rule.series, rule.labels,
                window=self.context_window, agg="raw", now=now,
            )
        except Exception:
            window = []
        try:
            snap = self.store._registry().snapshot()
        except Exception:
            snap = {}
        return {
            "rule": rule.name,
            "series": series,
            "t": now,
            "window": window,
            "snapshot": snap,
        }

    # -- introspection -------------------------------------------------
    def firing(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {
                    "rule": rname,
                    "series": series,
                    "since": st.fired_at,
                    "value": st.value,
                    "fired_count": st.fired_count,
                }
                for (rname, series), st in sorted(self._states.items())
                if st.status == "firing"
            ]

    def report(self) -> Dict[str, Any]:
        """The ``/alerts`` endpoint body: firing instances, recent
        transitions, and the rule pack (captures are summarized by key —
        full bundles stay in memory for tooling, not on the wire)."""
        firing = self.firing()
        with self._lock:
            return {
                "firing": firing,
                "history": list(self.history),
                "rules": [r.to_dict() for r in self.rules],
                "evals": self.evals,
                "captures": [
                    {"rule": c["rule"], "series": c["series"], "t": c["t"]}
                    for c in self.captures
                ],
            }
