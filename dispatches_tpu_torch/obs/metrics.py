"""Process-wide metrics registry (port of the counters, gauges and
histograms of `dispatches_tpu/obs/metrics.py`: `inc`, `set_gauge`,
`observe`, `describe`, `snapshot`, and the journal's span deltas
`flat_values` / `counter_delta`).

Host-side only: metric calls take Python numbers, and solver results are
the same with the registry in use. Series identity is ``(name, sorted
labels)``; the snapshot key is the Prometheus-style ``name{k="v",...}``
string, as in the JAX package. Its fleet merge and text exposition have
no user in the port yet.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# Default histogram buckets: wall-clock seconds, from sub-ms host work to
# multi-minute year solves (the JAX package's ladder)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0,
)

_SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _series_key(name: str, labels: Mapping[str, Any]) -> _SeriesKey:
    return (str(name), tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def series_name(name: str, labels: Mapping[str, Any]) -> str:
    """``name{k="v",...}`` (bare ``name`` when unlabelled), label values
    escaped as in the exposition format."""
    if not labels:
        return str(name)
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(
        (str(k), str(v)) for k, v in labels.items()
    ))
    return f"{name}{{{inner}}}"


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
    """Thread-safe labelled counters, gauges and histograms. One
    module-level instance serves the process; fresh instances are for
    tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_SeriesKey, float] = {}
        self._gauges: Dict[_SeriesKey, float] = {}
        self._hists: Dict[_SeriesKey, _Histogram] = {}
        self._help: Dict[str, str] = {}

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        """Add `value` (default 1) to a counter series."""
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set a gauge series to `value` (last write wins)."""
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
        """Record `value` into a histogram series. `buckets` (ascending
        upper bounds) applies only on a series' first observation."""
        key = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram(buckets or DEFAULT_BUCKETS)
            h.observe(float(value))

    def describe(self, name: str, text: str) -> None:
        """Attach help text to a metric base name (last write wins)."""
        with self._lock:
            self._help[str(name)] = str(text)

    def reset(self) -> None:
        """Clear all series; descriptions survive."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The registry as plain JSON-safe dicts keyed by series string."""
        with self._lock:
            return {
                "counters": {series_name(n, dict(ls)): v
                             for (n, ls), v in self._counters.items()},
                "gauges": {series_name(n, dict(ls)): v
                           for (n, ls), v in self._gauges.items()},
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

    def flat_values(self) -> Dict[str, float]:
        """Monotone series as one flat {series: value} dict (counters plus
        per-histogram ``_count`` / ``_sum``): the basis of the journal's
        span-end deltas. Gauges are left out: a gauge's change over a span
        means nothing."""
        with self._lock:
            out = {series_name(n, dict(ls)): v for (n, ls), v in self._counters.items()}
            for (n, ls), h in self._hists.items():
                base = series_name(n, dict(ls))
                out[base + "_count"] = float(h.count)
                out[base + "_sum"] = h.sum
            return out


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


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


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


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def flat_values() -> Dict[str, float]:
    return _REGISTRY.flat_values()


def reset_metrics() -> None:
    _REGISTRY.reset()
