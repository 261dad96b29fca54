"""Smoothed control signals over `obs.timeseries` (port of
`dispatches_tpu/obs/signals.py`, host-side Python kept line for line).

A `Signal` gives a stable reading of a noisy retained series:

- ``value() -> Optional[float]``: the EWMA-smoothed current level over
  the signal's window; ``None`` means "no data yet", which a controller
  treats as "hold", never as zero;
- ``trend() -> Optional[float]``: the least-squares slope of the raw
  points over the window, in units per second; ``None`` until two
  points exist.

Both are pull-based (one ring-buffer read a call, no thread),
deterministic under the store's injectable clock and side-effect free.
`ControlSignals` bundles the five signals the capacity plane reads:
``arrival_rate``, ``queue_depth``, ``slo_burn``,
``shard_inflight_utilization`` (occupied lanes over capacity) and
``compile_cache_hit_rate`` (the share of segment calls that were not a
key's first call in the process, `obs.perf`).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as obs_metrics
from .timeseries import SeriesStore


class Signal:
    """One smoothed series reading. See the module docstring for the
    ``value()`` / ``trend()`` contract; construction is cheap and the
    object holds no state beyond its configuration, so controllers may
    keep them or rebuild them freely."""

    def __init__(
        self,
        store: SeriesStore,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        *,
        agg: str = "raw",
        window: float = 60.0,
        half_life: float = 5.0,
        scale: float = 1.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.store = store
        self.name = name
        self.labels = dict(labels) if labels else None
        self.agg = agg
        self.window = float(window)
        self.half_life = float(half_life)
        self.scale = float(scale)
        self.clock = clock if clock is not None else store.clock

    def _points(self, now: float) -> List[Tuple[float, float]]:
        """Matching series merged into one stream: values sharing a
        sample stamp are summed (every track is sampled at the same
        `now`, so cross-series sums stay aligned by construction)."""
        merged: Dict[float, float] = {}
        for s in self.store.query(
            self.name, self.labels, window=self.window, agg=self.agg,
            now=now,
        ):
            for t, v in zip(s["t"], s["v"]):
                merged[t] = merged.get(t, 0.0) + v
        return sorted(merged.items())

    def value(self, now: Optional[float] = None) -> Optional[float]:
        now = self.clock() if now is None else float(now)
        pts = self._points(now)
        if not pts:
            return None
        # time-aware EWMA: alpha follows the gap between samples so a
        # 10s-tier stream and a 1s raw stream smooth to the same horizon
        ewma = pts[0][1]
        for (t0, _), (t1, v) in zip(pts, pts[1:]):
            dt = max(t1 - t0, 0.0)
            alpha = 1.0 - math.exp(-math.log(2.0) * dt / self.half_life) \
                if self.half_life > 0 else 1.0
            ewma += alpha * (v - ewma)
        return ewma * self.scale

    def trend(self, now: Optional[float] = None) -> Optional[float]:
        now = self.clock() if now is None else float(now)
        pts = self._points(now)
        if len(pts) < 2:
            return None
        tm = sum(t for t, _ in pts) / len(pts)
        vm = sum(v for _, v in pts) / len(pts)
        den = sum((t - tm) ** 2 for t, _ in pts)
        if den <= 0.0:
            return None
        num = sum((t - tm) * (v - vm) for t, v in pts)
        return (num / den) * self.scale

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "labels": self.labels,
            "agg": self.agg,
            "window": self.window,
            "half_life": self.half_life,
            "scale": self.scale,
        }


class _RatioSignal(Signal):
    """value = numerator signal / (numerator + denominator) — the
    hit-rate shape. Inherits `trend()` over the numerator stream."""

    def __init__(self, num: Signal, den: Signal):
        self.__dict__.update(num.__dict__)
        self._num = num
        self._den = den

    def value(self, now: Optional[float] = None) -> Optional[float]:
        now = self.clock() if now is None else float(now)
        n = self._num.value(now)
        d = self._den.value(now)
        if n is None and d is None:
            return None
        n = n or 0.0
        d = d or 0.0
        total = n + d
        return n / total if total > 0 else None


class _UtilizationSignal(Signal):
    """Summed in-flight lanes over fleet capacity, smoothed. Falls back
    to the instantaneous `sum_gauges` reading while the store is still
    empty (a controller asking one pump cycle after boot should see the
    truth, not None, when the gauges already exist).

    The denominator is *live*: the static construction-time capacity is
    scaled by the fraction of shards currently up (the latest
    ``serve_shard_up`` sample per shard series), so a crash window reads
    as HIGHER utilization — the surviving shards really are closer to
    saturation — instead of silently undercounting against lanes that
    no longer exist. While the store is too young to have retained any
    ``serve_shard_up`` samples (or every shard is down), the static
    capacity is the fallback."""

    def __init__(self, store, capacity, **kw):
        super().__init__(store, "serve_shard_inflight", **kw)
        self.capacity = float(capacity) if capacity else None

    def _live_capacity(self, now: Optional[float]) -> Optional[float]:
        if not self.capacity:
            return None
        t = self.clock() if now is None else float(now)
        series = self.store.query(
            "serve_shard_up", None, window=self.window, now=t
        )
        series = [s for s in series if s["v"]]
        if not series:
            return self.capacity  # store young: static fallback
        up = sum(s["v"][-1] for s in series)
        if up <= 0:
            return self.capacity  # whole fleet down: avoid a 0 denominator
        return self.capacity * up / len(series)

    def value(self, now: Optional[float] = None) -> Optional[float]:
        v = super().value(now)
        if v is None:
            v = self.store._registry().sum_gauges("serve_shard_inflight")
        cap = self._live_capacity(now)
        if v is None or not cap:
            return v
        return v / cap

    def trend(self, now: Optional[float] = None) -> Optional[float]:
        t = super().trend(now)
        cap = self._live_capacity(now)
        if t is None or not cap:
            return t
        return t / cap


class ControlSignals:
    """The named signal pack for the serving tier. `capacity` is the
    fleet's total lane count (``n_shards × bucket``) and normalizes
    ``shard_inflight_utilization`` to 0..1; without it the signal reads
    absolute lanes."""

    def __init__(
        self,
        store: SeriesStore,
        *,
        capacity: Optional[float] = None,
        window: float = 60.0,
        half_life: float = 5.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.store = store
        self.capacity = capacity
        kw: Dict[str, Any] = dict(
            window=window, half_life=half_life, clock=clock
        )
        self.arrival_rate = Signal(
            store, "serve_requests_total", agg="rate", **kw
        )
        self.queue_depth = Signal(store, "serve_queue_depth", **kw)
        self.slo_burn = Signal(store, "slo_worst_burn_rate", **kw)
        self.shard_inflight_utilization = _UtilizationSignal(
            store, capacity, **kw
        )
        self.compile_cache_hit_rate = _RatioSignal(
            Signal(store, "compile_cache_hit_total", agg="rate", **kw),
            Signal(store, "compile_cache_miss_total", agg="rate", **kw),
        )

    NAMES = (
        "arrival_rate",
        "queue_depth",
        "slo_burn",
        "shard_inflight_utilization",
        "compile_cache_hit_rate",
    )

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """All five signals' current value/trend in one JSON-safe dict —
        what an autoscaler control loop reads per tick (and what tests
        assert against)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in self.NAMES:
            sig: Signal = getattr(self, name)
            out[name] = {"value": sig.value(now), "trend": sig.trend(now)}
        return out
