"""Process-wide metrics registry (port of the counters of
`dispatches_tpu/obs/metrics.py`: `inc`, `describe`, `snapshot`).

Host-side only: metric calls take Python numbers, and solver results are
the same with the registry in use. Series identity is ``(name, sorted
labels)``; the snapshot key is the Prometheus-style ``name{k="v",...}``
string, as in the JAX package. Its gauges, histograms, fleet merge and
exposition have no user in the port yet.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Tuple

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


class MetricsRegistry:
    """Thread-safe labelled counters. One module-level instance serves the
    process; fresh instances are for tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_SeriesKey, float] = {}
        self._help: Dict[str, str] = {}

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        """Add `value` (default 1) to a counter series."""
        key = _series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def describe(self, name: str, text: str) -> None:
        """Attach help text to a metric base name (last write wins)."""
        with self._lock:
            self._help[str(name)] = str(text)

    def reset(self) -> None:
        """Clear all series; descriptions survive."""
        with self._lock:
            self._counters.clear()

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The registry as plain JSON-safe dicts keyed by series string."""
        with self._lock:
            return {"counters": {series_name(n, dict(ls)): v
                                 for (n, ls), v in self._counters.items()}}


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    _REGISTRY.inc(name, value, **labels)


def describe(name: str, text: str) -> None:
    _REGISTRY.describe(name, text)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def reset_metrics() -> None:
    _REGISTRY.reset()
