"""Fixed-memory time-series retention over the metrics registry (port of
`dispatches_tpu/obs/timeseries.py`, host-side Python kept line for line;
observability pillar 10, with `obs.alerts`).

Every scrape surface before this module was point-in-time: ``/metrics``
and ``/snapshot`` answer "what is the value now", never "what happened
over the last five minutes". `SeriesStore` adds the time dimension
without adding a database: it periodically samples a
`MetricsRegistry.snapshot()` into per-series ring buffers —

- **counters** are stored as their cumulative values; per-second rates
  are derived at query time (``agg="rate"``), so a stored counter costs
  the same as a gauge and survives irregular sampling;
- **gauges** are stored as-is;
- **histograms** become retained *quantile tracks*: each histogram
  series contributes ``<name>_p50/_p95/_p99`` gauge tracks (quantiles
  computed from the bucket ladder at sample time) plus ``<name>_count``
  / ``<name>_sum`` counter tracks, so latency percentiles have history
  and request rates can be derived from ``_count``.

Retention is multi-resolution: the raw tier keeps every sample (default
1 s cadence); coarser tiers (10 s, 60 s) hold downsampled points
(gauges fold to the bucket mean, counters to the bucket's last
cumulative value), so a 4-hour queue-depth history costs a few hundred
points, not fourteen thousand. All buffers are fixed-size rings —
memory is bounded by ``tiers × capacity × series`` and a `max_series`
cap, never by uptime.

Design rules, same as the rest of `obs`: host-side only (the sampler
reads registry floats, never traced values — solver results stay
bitwise identical with the store active), cheap when idle, injectable
clocks (`clock=`) so tests drive retention deterministically, and off
by default — nothing samples until a service is built with
``timeseries=True`` or a tool starts a `Sampler` thread.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from . import metrics as obs_metrics

# (resolution_seconds, capacity_points) per tier, finest first. The
# defaults retain ~8.5 min raw @1s, 1 h @10s, and 4 h @60s.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 512), (10.0, 360), (60.0, 240),
)

# quantile tracks retained per histogram series
DEFAULT_QUANTILES: Tuple[Tuple[float, str], ...] = (
    (0.5, "p50"), (0.95, "p95"), (0.99, "p99"),
)


def snapshot_quantile(h: Mapping[str, Any], q: float) -> Optional[float]:
    """`MetricsRegistry.histogram_quantile`, but over one histogram dict
    from a `snapshot()` — the sample-time path from bucket ladder to
    quantile track. Returns None for an empty or all-zero ladder (the
    uniform "no data" the renderers turn into an em dash)."""
    count = int(h.get("count") or 0)
    if count <= 0:
        return None
    items = sorted(
        (float("inf") if b == "+Inf" else float(b), int(c))
        for b, c in (h.get("buckets") or {}).items()
    )
    if not items or not any(c for _, c in items):
        return None
    rank = q * count
    cum = 0.0
    prev_b = 0.0
    for b, c in items:
        prev = cum
        cum += c
        if cum >= rank and c:
            if b == float("inf"):
                return prev_b  # +Inf tail clamps to largest finite bound
            return prev_b + (b - prev_b) * ((rank - prev) / c)
        if b != float("inf"):
            prev_b = b
    return prev_b


class _Ring:
    """Fixed-capacity (t, v) ring buffer."""

    __slots__ = ("cap", "t", "v", "idx", "n")

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.t = [0.0] * self.cap
        self.v = [0.0] * self.cap
        self.idx = 0
        self.n = 0

    def push(self, t: float, v: float) -> None:
        self.t[self.idx] = t
        self.v[self.idx] = v
        self.idx = (self.idx + 1) % self.cap
        self.n = min(self.n + 1, self.cap)

    def points(self) -> List[Tuple[float, float]]:
        """Oldest-to-newest copy."""
        if self.n < self.cap:
            return [(self.t[i], self.v[i]) for i in range(self.n)]
        order = range(self.idx, self.idx + self.cap)
        return [(self.t[i % self.cap], self.v[i % self.cap]) for i in order]


class _Track:
    """One series: a ring per tier plus the coarse-tier accumulators."""

    __slots__ = ("kind", "rings", "acc", "last_t")

    def __init__(self, kind: str, tiers: Sequence[Tuple[float, int]]):
        self.kind = kind  # "counter" | "gauge"
        self.rings = [_Ring(cap) for _, cap in tiers]
        # per coarse tier: [bucket_index, sum, count, last] — emits the
        # completed bucket's aggregate when the sample stream crosses a
        # bucket boundary (deterministic under any injectable clock)
        self.acc: List[Optional[List[float]]] = [None] * len(tiers)
        self.last_t = 0.0


class SeriesStore:
    """Ring-buffer retention for one `MetricsRegistry`.

    `sample()` takes one snapshot and appends a point per live series;
    `maybe_sample()` is the pump-loop form (no-op until the raw tier's
    resolution has elapsed). `query()` reads aligned ``(t, v)`` arrays
    back out; `reduce()` collapses a window to one float (the alert
    evaluation primitive).
    """

    def __init__(
        self,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        *,
        tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
        quantiles: Sequence[Tuple[float, str]] = DEFAULT_QUANTILES,
        clock: Callable[[], float] = time.monotonic,
        max_series: int = 4096,
    ):
        if not tiers:
            raise ValueError("a SeriesStore needs at least one tier")
        self.registry = registry
        self.tiers = tuple((float(r), int(c)) for r, c in tiers)
        if any(r <= 0 or c <= 0 for r, c in self.tiers):
            raise ValueError(f"malformed tiers {tiers!r}")
        self.quantiles = tuple((float(q), str(tag)) for q, tag in quantiles)
        self.clock = clock
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._tracks: Dict[str, _Track] = {}
        self.samples = 0
        self.dropped_series = 0
        self._last_sample: Optional[float] = None

    # -- sampling ------------------------------------------------------
    def _registry(self) -> obs_metrics.MetricsRegistry:
        return self.registry if self.registry is not None else obs_metrics.get_registry()

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Pump-loop hook: sample once the raw tier's resolution has
        elapsed since the last sample. Cheap when it declines (one
        clock read + one comparison)."""
        now = self.clock() if now is None else float(now)
        if (
            self._last_sample is not None
            and now - self._last_sample < self.tiers[0][0]
        ):
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> int:
        """Append one point per live registry series; returns the number
        of tracks written."""
        now = self.clock() if now is None else float(now)
        snap = self._registry().snapshot()
        wrote = 0
        with self._lock:
            self._last_sample = now
            self.samples += 1
            for series, v in (snap.get("counters") or {}).items():
                wrote += self._push_locked(series, "counter", now, float(v))
            for series, v in (snap.get("gauges") or {}).items():
                wrote += self._push_locked(series, "gauge", now, float(v))
            for series, h in (snap.get("histograms") or {}).items():
                name, labels = obs_metrics.parse_series(series)
                wrote += self._push_locked(
                    obs_metrics.series_name(name + "_count", labels),
                    "counter", now, float(h.get("count") or 0),
                )
                wrote += self._push_locked(
                    obs_metrics.series_name(name + "_sum", labels),
                    "counter", now, float(h.get("sum") or 0.0),
                )
                for q, tag in self.quantiles:
                    qv = snapshot_quantile(h, q)
                    if qv is not None:
                        wrote += self._push_locked(
                            obs_metrics.series_name(name + "_" + tag, labels),
                            "gauge", now, float(qv),
                        )
        return wrote

    def _push_locked(self, series: str, kind: str, t: float, v: float) -> int:
        track = self._tracks.get(series)
        if track is None:
            if len(self._tracks) >= self.max_series:
                self.dropped_series += 1
                return 0
            track = self._tracks[series] = _Track(kind, self.tiers)
        track.last_t = t
        track.rings[0].push(t, v)
        for i in range(1, len(self.tiers)):
            res = self.tiers[i][0]
            bucket = t // res
            acc = track.acc[i]
            if acc is None:
                track.acc[i] = [bucket, v, 1.0, v]
                continue
            if bucket != acc[0]:
                # bucket boundary crossed: emit the completed bucket
                agg = acc[3] if kind == "counter" else acc[1] / acc[2]
                track.rings[i].push((acc[0] + 1.0) * res, agg)
                track.acc[i] = [bucket, v, 1.0, v]
            else:
                acc[1] += v
                acc[2] += 1.0
                acc[3] = v
        return 1

    # -- queries -------------------------------------------------------
    def _match_locked(
        self, name: str, labels: Optional[Mapping[str, Any]]
    ) -> List[str]:
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        out = []
        for series in self._tracks:
            n, ls = obs_metrics.parse_series(series)
            if n != name:
                continue
            if all(ls.get(k) == v for k, v in want.items()):
                out.append(series)
        return sorted(out)

    def series(self) -> List[str]:
        with self._lock:
            return sorted(self._tracks)

    def _tier_for(self, window: float) -> int:
        for i, (res, cap) in enumerate(self.tiers):
            if res * cap >= window:
                return i
        return len(self.tiers) - 1

    def query(
        self,
        name: str,
        labels: Optional[Mapping[str, Any]] = None,
        *,
        window: float = 300.0,
        agg: str = "raw",
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Aligned ``(t, v)`` arrays for every series matching `name`
        whose labels are a superset of `labels`. The window picks the
        finest tier that can cover it; ``agg`` is ``"raw"`` (values as
        stored), ``"rate"`` (per-second derivative between consecutive
        points, clamped at 0 so counter resets read as silence, not
        negative traffic), or ``"delta"`` (point-to-point increase).

        Returns ``[{"series", "kind", "t", "v"}, ...]`` — the shape the
        ``/query`` endpoint serves and sparkline renderers consume."""
        if agg not in ("raw", "rate", "delta"):
            raise ValueError(f"unknown agg {agg!r}")
        now = self.clock() if now is None else float(now)
        window = float(window)
        lo = now - window
        out: List[Dict[str, Any]] = []
        with self._lock:
            tier = self._tier_for(window)
            for series in self._match_locked(name, labels):
                track = self._tracks[series]
                pts = [p for p in track.rings[tier].points() if p[0] >= lo]
                if tier and not pts:
                    # coarse tier hasn't completed a bucket yet: fall
                    # back to raw so young stores still answer
                    pts = [p for p in track.rings[0].points() if p[0] >= lo]
                t, v = self._apply_agg(pts, agg)
                out.append(
                    {"series": series, "kind": track.kind, "t": t, "v": v}
                )
        return out

    @staticmethod
    def _apply_agg(
        pts: List[Tuple[float, float]], agg: str
    ) -> Tuple[List[float], List[float]]:
        if agg == "raw":
            return [p[0] for p in pts], [p[1] for p in pts]
        t: List[float] = []
        v: List[float] = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            d = v1 - v0
            if agg == "rate":
                dt = t1 - t0
                d = max(0.0, d) / dt if dt > 0 else 0.0
            else:  # delta
                d = max(0.0, d)
            t.append(t1)
            v.append(d)
        return t, v

    def reduce(
        self,
        name: str,
        labels: Optional[Mapping[str, Any]] = None,
        *,
        window: float = 60.0,
        agg: str = "last",
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Collapse one series' window to a single float — the alert
        evaluation primitive. ``agg``: ``last`` / ``avg`` / ``min`` /
        ``max`` / ``sum`` over raw points, or ``rate`` (increase per
        second across the window, clamped at 0). With several matching
        series, point values are summed per reduction (``last`` sums the
        latest point of each; ``rate`` sums per-series rates). Returns
        None when nothing matched or the window is empty."""
        now = self.clock() if now is None else float(now)
        lo = now - float(window)
        with self._lock:
            tier = self._tier_for(float(window))
            matched = self._match_locked(name, labels)
            per_series: List[float] = []
            for series in matched:
                track = self._tracks[series]
                pts = [p for p in track.rings[tier].points() if p[0] >= lo]
                if tier and not pts:
                    pts = [p for p in track.rings[0].points() if p[0] >= lo]
                if not pts:
                    continue
                vals = [p[1] for p in pts]
                if agg == "last":
                    per_series.append(vals[-1])
                elif agg == "avg":
                    per_series.append(sum(vals) / len(vals))
                elif agg == "min":
                    per_series.append(min(vals))
                elif agg == "max":
                    per_series.append(max(vals))
                elif agg == "sum":
                    per_series.append(sum(vals))
                elif agg == "rate":
                    dt = pts[-1][0] - pts[0][0]
                    if dt > 0:
                        per_series.append(
                            max(0.0, pts[-1][1] - pts[0][1]) / dt
                        )
                    elif len(pts) == 1 and lo <= 0:
                        per_series.append(0.0)
                else:
                    raise ValueError(f"unknown reduce agg {agg!r}")
        if not per_series:
            return None
        return float(sum(per_series))

    def last_seen(
        self, name: str, labels: Optional[Mapping[str, Any]] = None
    ) -> Optional[float]:
        """Latest sample stamp across matching series (None if the
        series has never been sampled) — the absence-rule primitive."""
        with self._lock:
            stamps = [
                self._tracks[s].last_t
                for s in self._match_locked(name, labels)
            ]
        return max(stamps) if stamps else None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._tracks),
                "samples": self.samples,
                "dropped_series": self.dropped_series,
                "tiers": [list(t) for t in self.tiers],
                "last_sample": self._last_sample,
            }


class Sampler:
    """Background sampling thread for processes without a pump loop (the
    exporter-bearing tools). `DispatchService`/`FleetService` do NOT use
    this — they call `store.maybe_sample()` from their own pump cycles so
    fake-clock tests stay deterministic. `callbacks` (e.g. an
    `AlertManager.evaluate`) run after every sample; a raising callback
    is swallowed — telemetry must never take the process down."""

    def __init__(
        self,
        store: SeriesStore,
        *,
        interval: Optional[float] = None,
        callbacks: Sequence[Callable[[], Any]] = (),
    ):
        self.store = store
        self.interval = (
            float(interval) if interval is not None else store.tiers[0][0]
        )
        self.callbacks = tuple(callbacks)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    def start(self) -> "Sampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.is_set():
                self._tick()
                self._stop_evt.wait(self.interval)

        self._thread = threading.Thread(
            target=_loop, name="timeseries-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _tick(self) -> None:
        try:
            self.store.sample()
            for cb in self.callbacks:
                cb()
        except Exception:
            pass

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "Sampler":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.stop()
