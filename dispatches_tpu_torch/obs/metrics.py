"""Process-wide metrics registry (port of `dispatches_tpu/obs/metrics.py`,
pure Python, copied as it is).

Labelled counters, gauges and histograms in one thread-safe registry:
`inc`, `set_gauge`, `observe`, `describe`, `snapshot`, the journal's span
deltas (`flat_values` / `counter_delta`), and the serving fleet's
telemetry plane: `snapshot_delta` (what a shard child ships),
`MetricsRegistry.merge` (how the parent folds it in under a ``shard``
label), `render_prometheus` (the exporter's ``/metrics``),
`histogram_quantile` and `sum_gauges`.

Host-side only: metric calls take Python numbers, and solver results are
the same with the registry in use. Series identity is ``(name, sorted
labels)``; the snapshot key is the Prometheus-style ``name{k="v",...}``
string, as in the JAX package, so a snapshot from either package merges
into the other.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# Default histogram buckets: wall-clock-seconds flavored (the dominant
# histogram use), spanning sub-ms host ops to multi-minute year solves.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0,
)

_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _series_key(name: str, labels: Mapping[str, Any]) -> _SeriesKey:
    return (str(name), tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double quote, and newline must be escaped inside ``k="v"``."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """# HELP text escaping: only backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def series_name(name: str, labels: Mapping[str, Any]) -> str:
    """Prometheus-style series string, ``name{k="v",...}`` (bare ``name``
    when unlabeled) — the snapshot/journal key format. Label values are
    escaped per the exposition format (``\\``, ``"``, newline)."""
    if not labels:
        return str(name)
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(
        (str(k), str(v)) for k, v in labels.items()
    ))
    return f"{name}{{{inner}}}"


def parse_series(series: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of `series_name`: ``'name{k="v",...}'`` -> ``(name,
    {k: v})`` with exposition-format escapes (``\\\\``, ``\\"``, ``\\n``)
    undone, so a round trip through `series_name` is exact even for
    label values containing quotes or backslashes. Raises ValueError on
    a malformed series string."""
    if "{" not in series:
        return series, {}
    name, rest = series.split("{", 1)
    if not rest.endswith("}"):
        raise ValueError(f"unterminated label block in series {series!r}")
    body = rest[:-1]
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0 or eq + 1 >= n or body[eq + 1] != '"':
            raise ValueError(f"malformed label pair in series {series!r}")
        key = body[i:eq]
        j = eq + 2
        buf = []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                nxt = body[j + 1]
                buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, "\\" + nxt))
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        else:
            raise ValueError(f"unterminated label value in series {series!r}")
        labels[key] = "".join(buf)
        i = j + 1
        if i < n:
            if body[i] != ",":
                raise ValueError(f"malformed label separator in series {series!r}")
            i += 1
    return name, labels


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Thread-safe labeled counters / gauges / histograms.

    One module-level instance (`get_registry()`) serves the process; fresh
    instances are for tests. All mutators accept labels as keyword
    arguments: ``reg.inc("solves_total", solver="solve_lp")``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_SeriesKey, float] = {}
        self._gauges: Dict[_SeriesKey, float] = {}
        self._hists: Dict[_SeriesKey, _Histogram] = {}
        self._help: Dict[str, str] = {}  # metric base name -> HELP text

    # -- mutators ------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        """Add `value` (default 1) to a counter series."""
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set a gauge series to `value` (last-write-wins)."""
        key = _series_key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(
        self,
        name: str,
        value: float,
        buckets: Optional[Sequence[float]] = None,
        **labels: Any,
    ) -> None:
        """Record `value` into a histogram series. `buckets` applies only
        on first observation of a series (upper bounds, ascending)."""
        key = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(buckets or DEFAULT_BUCKETS)
            h.observe(float(value))

    def describe(self, name: str, text: str) -> None:
        """Attach HELP text to a metric base name, emitted as a
        ``# HELP`` line by `render_prometheus`. Idempotent
        (last-write-wins); describing an unused metric is harmless."""
        with self._lock:
            self._help[str(name)] = str(text)

    def reset(self) -> None:
        """Clear all series. Descriptions survive — they are metadata
        registered at import time, not run state."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- readers -------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Full registry state as plain JSON-safe dicts keyed by the
        ``name{labels}`` series string."""
        with self._lock:
            return {
                "counters": {
                    series_name(n, dict(ls)): v
                    for (n, ls), v in self._counters.items()
                },
                "gauges": {
                    series_name(n, dict(ls)): v
                    for (n, ls), v in self._gauges.items()
                },
                "histograms": {
                    series_name(n, dict(ls)): {
                        "count": h.count,
                        "sum": h.sum,
                        "buckets": {
                            (str(b) if i < len(h.buckets) else "+Inf"): c
                            for i, (b, c) in enumerate(
                                zip(h.buckets + (float("inf"),), h.counts)
                            )
                        },
                    }
                    for (n, ls), h in self._hists.items()
                },
            }

    def merge(self, snap: Mapping[str, Any], **labels: Any) -> int:
        """Fold a `snapshot()` (or `snapshot_delta`) from another registry
        into this one, re-labeling every series with the extra `labels`
        (e.g. ``shard="3"``). The cross-process aggregation primitive of
        the fleet telemetry plane:

        - **Counters and histograms are deltas.** Each incoming value is
          *added* to both the re-labeled series and the original
          label-free series, under one lock acquisition — so the fleet
          aggregate equals the sum of the per-shard series by
          construction, and a respawned child shipping from a fresh zero
          baseline can only ever add (monotonicity survives respawn as
          long as the sender ships deltas, which `snapshot_delta`
          guarantees).
        - **Gauges are absolute**, last-write-wins, and get only the
          re-labeled series — a label-free fleet aggregate is NEVER
          written for a gauge, because adding absolute levels from
          different instants is meaningless as a single level. Callers
          that do want "sum of per-shard gauges right now" (fleet
          in-flight lanes, say) must ask for it explicitly via
          `sum_gauges`, which sums the *current* labeled series under
          one lock instead of baking a stale sum into the registry.
        - **Histogram buckets merge bucket-wise** when the bucket ladder
          matches (the common case — both sides use the same describe
          site); mismatched ladders re-bucket each incoming count at its
          upper bound, which is lossy in the same way any histogram is.

        Returns the number of series folded in. Raises ValueError on a
        malformed snapshot (callers own the error accounting)."""
        extra = {str(k): str(v) for k, v in labels.items()}
        merged = 0
        with self._lock:
            for series, v in (snap.get("counters") or {}).items():
                name, ls = parse_series(series)
                v = float(v)
                if not v:
                    continue
                keys = [_series_key(name, {**ls, **extra})]
                if extra:
                    keys.append(_series_key(name, ls))
                for key in keys:
                    self._counters[key] = self._counters.get(key, 0.0) + v
                merged += 1
            for series, v in (snap.get("gauges") or {}).items():
                name, ls = parse_series(series)
                self._gauges[_series_key(name, {**ls, **extra})] = float(v)
                merged += 1
            for series, h in (snap.get("histograms") or {}).items():
                if not h.get("count") and not h.get("sum"):
                    continue
                name, ls = parse_series(series)
                keys = [_series_key(name, {**ls, **extra})]
                if extra:
                    keys.append(_series_key(name, ls))
                for key in keys:
                    self._merge_hist_locked(key, h)
                merged += 1
        return merged

    def _merge_hist_locked(self, key: _SeriesKey, hsnap: Mapping[str, Any]) -> None:
        incoming = sorted(
            (float("inf") if b == "+Inf" else float(b), int(c))
            for b, c in (hsnap.get("buckets") or {}).items()
        )
        bounds = tuple(b for b, _ in incoming if b != float("inf"))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = _Histogram(bounds or DEFAULT_BUCKETS)
        if (
            bounds == h.buckets
            and len(incoming) == len(h.counts)
            and incoming
            and incoming[-1][0] == float("inf")
        ):
            for i, (_, c) in enumerate(incoming):
                h.counts[i] += c
        else:
            for b, c in incoming:  # ladder mismatch: re-bucket by bound
                if not c:
                    continue
                for i, ub in enumerate(h.buckets):
                    if b <= ub:
                        h.counts[i] += c
                        break
                else:
                    h.counts[-1] += c
        h.sum += float(hsnap.get("sum", 0.0))
        h.count += int(hsnap.get("count", 0))

    def histogram_quantile(
        self, name: str, q: float, **labels: Any
    ) -> Optional[float]:
        """Approximate the q-quantile (0..1) of a histogram series from
        its bucket counts — Prometheus-style linear interpolation within
        the containing bucket (lower edge 0 for the first). Observations
        in the +Inf tail clamp to the largest finite bound; returns None
        for an unknown or empty series. Good enough for latency SLO
        reporting (p50/p95/p99), not for exact statistics."""
        key = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None or h.count == 0:
                return None
            rank = q * h.count
            cum = 0.0
            for i, b in enumerate(h.buckets):
                prev = cum
                cum += h.counts[i]
                if cum >= rank:
                    lo = h.buckets[i - 1] if i else 0.0
                    frac = (rank - prev) / h.counts[i] if h.counts[i] else 0.0
                    return lo + (b - lo) * frac
            return h.buckets[-1] if h.buckets else None

    def sum_gauges(self, name: str, **labels: Any) -> Optional[float]:
        """Sum every gauge series named `name` whose labels are a
        superset of `labels` — the explicit cross-shard aggregation for
        gauges, which `merge` deliberately never materializes (see its
        docstring). Returns None when nothing matches, so "no shards
        reporting" stays distinguishable from "zero in flight"."""
        want = {str(k): str(v) for k, v in labels.items()}
        total: Optional[float] = None
        with self._lock:
            for (n, ls), v in self._gauges.items():
                if n != name:
                    continue
                have = dict(ls)
                if all(have.get(k) == s for k, s in want.items()):
                    total = (total or 0.0) + v
        return total

    def flat_values(self) -> Dict[str, float]:
        """Monotone series as one flat {series: value} dict — counters plus
        per-histogram ``_count``/``_sum`` — the delta basis for the
        journal's span-end metrics flush (gauges are excluded: a gauge
        delta over a span is not meaningful)."""
        with self._lock:
            out = {
                series_name(n, dict(ls)): v
                for (n, ls), v in self._counters.items()
            }
            for (n, ls), h in self._hists.items():
                base = series_name(n, dict(ls))
                out[base + "_count"] = float(h.count)
                out[base + "_sum"] = h.sum
            return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of the whole registry:
        ``# HELP`` (for described metrics) + ``# TYPE`` + samples. Label
        values arrive pre-escaped via `series_name`."""
        lines = []
        snap = self.snapshot()
        with self._lock:
            help_text = dict(self._help)
        seen_type: Dict[str, str] = {}

        def type_line(series: str, kind: str):
            base = series.split("{", 1)[0]
            if seen_type.get(base) != kind:
                if base not in seen_type and base in help_text:
                    lines.append(f"# HELP {base} {_escape_help(help_text[base])}")
                seen_type[base] = kind
                lines.append(f"# TYPE {base} {kind}")

        for series, v in sorted(snap["counters"].items()):
            type_line(series, "counter")
            lines.append(f"{series} {_fmt(v)}")
        for series, v in sorted(snap["gauges"].items()):
            type_line(series, "gauge")
            lines.append(f"{series} {_fmt(v)}")
        for series, h in sorted(snap["histograms"].items()):
            type_line(series, "histogram")
            name, labels = _split_series(series)
            cum = 0
            for b, c in h["buckets"].items():
                cum += c
                lines.append(
                    f"{name}_bucket{_merge_labels(labels, le=b)} {cum}"
                )
            lines.append(f"{name}_sum{labels or ''} {_fmt(h['sum'])}")
            lines.append(f"{name}_count{labels or ''} {h['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _split_series(series: str) -> Tuple[str, str]:
    if "{" in series:
        name, rest = series.split("{", 1)
        return name, "{" + rest
    return series, ""


def _merge_labels(labels: str, **extra: str) -> str:
    inner = labels[1:-1] if labels else ""
    add = ",".join(f'{k}="{v}"' for k, v in extra.items())
    inner = f"{inner},{add}" if inner else add
    return "{" + inner + "}"


def counter_delta(
    before: Mapping[str, float], after: Mapping[str, float]
) -> Dict[str, float]:
    """Per-series increase between two `flat_values()` snapshots (nonzero
    entries only)."""
    out: Dict[str, float] = {}
    for series, v in after.items():
        d = v - before.get(series, 0.0)
        if d:
            out[series] = d
    return out


def snapshot_delta(
    before: Mapping[str, Any], after: Mapping[str, Any]
) -> Dict[str, Dict[str, Any]]:
    """Per-series increase between two `snapshot()` dicts, in the same
    shape as a snapshot — the wire unit a shard child ships to its
    parent. Counters and histograms carry deltas (series with no change
    are dropped); gauges carry the absolute `after` value (a gauge delta
    is not meaningful). Feeding the result to `MetricsRegistry.merge`
    keeps fleet aggregates monotone across sender restarts: a fresh
    child's first delta is computed against an empty `before`, so it can
    never go negative."""
    counters: Dict[str, float] = {}
    b_counters = before.get("counters") or {}
    for series, v in (after.get("counters") or {}).items():
        d = float(v) - float(b_counters.get(series, 0.0))
        if d:
            counters[series] = d
    hists: Dict[str, Dict[str, Any]] = {}
    b_hists = before.get("histograms") or {}
    for series, h in (after.get("histograms") or {}).items():
        prev = b_hists.get(series) or {}
        prev_buckets = prev.get("buckets") or {}
        d_count = int(h.get("count", 0)) - int(prev.get("count", 0))
        d_sum = float(h.get("sum", 0.0)) - float(prev.get("sum", 0.0))
        if not d_count and not d_sum:
            continue
        hists[series] = {
            "count": d_count,
            "sum": d_sum,
            "buckets": {
                b: int(c) - int(prev_buckets.get(b, 0))
                for b, c in (h.get("buckets") or {}).items()
            },
        }
    return {
        "counters": counters,
        "gauges": dict(after.get("gauges") or {}),
        "histograms": hists,
    }


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


# module-level conveniences bound to the process registry
def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    _REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    _REGISTRY.set_gauge(name, value, **labels)


def observe(
    name: str, value: float, buckets: Optional[Sequence[float]] = None,
    **labels: Any,
) -> None:
    _REGISTRY.observe(name, value, buckets, **labels)


def describe(name: str, text: str) -> None:
    _REGISTRY.describe(name, text)


def histogram_quantile(name: str, q: float, **labels: Any) -> Optional[float]:
    return _REGISTRY.histogram_quantile(name, q, **labels)


def sum_gauges(name: str, **labels: Any) -> Optional[float]:
    return _REGISTRY.sum_gauges(name, **labels)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def flat_values() -> Dict[str, float]:
    return _REGISTRY.flat_values()


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


def merge_snapshot(snap: Mapping[str, Any], **labels: Any) -> int:
    return _REGISTRY.merge(snap, **labels)


def reset_metrics() -> None:
    _REGISTRY.reset()
