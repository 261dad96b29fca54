"""Capacity observatory over `obs.timeseries` (port of
`dispatches_tpu/obs/capacity.py`, host-side Python kept line for line:
the twin draws from a seeded `random.Random` in the same order, so its
replay equals the JAX package's under the same seed and clock).

An autoscaler needs three answers before any actuator exists: how
close is each shard to its saturation knee, how many shards does a given
request rate need at a given p95 target, and when will the current
arrival trend breach the SLO? This module
answers all three from telemetry the serving tier already retains —
no new instrumentation in the hot path, nothing touches a solve.

Three layers, each observable on its own:

**Measured laws** (`CapacityObservatory.estimate`). The service-time
and arrival processes are estimated from the retained tracks
(`serve_latency_seconds_*` quantile/count/sum tracks, the
``serve_queue_depth`` / ``serve_shard_inflight`` gauges, and the
``serve_requests_total`` counter) and cross-checked by the two
conservation laws every queueing system must satisfy:

- Little's law ``L ≈ λ·W``: mean requests in system (queue + busy
  lanes) against completion rate × mean sojourn time. The relative
  residual is published as ``capacity_littles_law_residual``.
- The utilization law ``busy = λ·S``: mean busy lanes against
  completion rate × service time. Service time is estimated two
  independent ways — busy-lane integral over completions
  (``busy/X``) and sojourn minus queue wait (``W − L_q/X``) — and
  their disagreement is ``capacity_utilization_law_residual``.

A broken estimate is therefore itself observable: if the gauges,
counters, and histograms stop agreeing (a wedged sampler, a
mis-merged child registry), the residuals blow up *before* anything
downstream trusts the numbers.

**The fleet twin** (`FleetTwin`). A deterministic discrete-event
replay of an M/G/c queue — Poisson arrivals through a FIFO admission
queue into ``shards × lanes_per_shard`` servers drawing service times
from the *measured* distribution (piecewise-linear inverse CDF through
the retained p50/p95 quantiles, rescaled so its mean equals the
utilization-law service time). Seeded PRNG, no wall clock: the same
inputs always predict the same p50/p95/goodput, so predictions are
reproducible and diffable. The twin is continuously validated against
the fleet's own observed latencies; the predicted-vs-observed p95
error rides ``capacity_model_error_ratio``.

**Forecast & recommendation**. The knee (highest arrival rate the
current fleet serves within the p95 target at ≥ ``goodput_frac``
goodput) comes from a twin rate scan (``capacity_knee_rate_per_sec``);
time-to-SLO-breach extrapolates the `obs.signals` arrival trend to
that knee (``capacity_time_to_breach_seconds``, only published while
finite); and ``fleet_desired_shards`` is the smallest shard count the
twin predicts meets the p95 target at the forecast rate, damped by
hysteresis (scale-up after ``up_hold`` seconds of agreement,
scale-down only after ``down_hold``) so the recommendation cannot
flap on evaluation noise. Per-shard ``capacity_headroom_ratio{shard}``
(1 − measured lane occupancy) is the scale-out early warning the
``saturation_approach`` alert rule watches.

Design rules, same as the rest of `obs`: host-side only, off by
default (nothing runs until a service is built with ``capacity=True``),
pump-driven on the service clock (fake-clock deterministic), and
bitwise-neutral on solver results — every input is a read of already-
retained telemetry.
"""
from __future__ import annotations

import heapq
import math
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import metrics as obs_metrics
from .timeseries import SeriesStore

obs_metrics.describe(
    "capacity_littles_law_residual",
    "Relative residual of Little's law L = lambda*W over the estimator "
    "window (0 = the retained gauges, counters and histograms agree; "
    "above ~0.5 the capacity estimate should not be trusted).",
)
obs_metrics.describe(
    "capacity_utilization_law_residual",
    "Relative disagreement between the two independent service-time "
    "estimates (busy-lane integral vs sojourn minus queue wait); a "
    "broken estimate is itself observable here.",
)
obs_metrics.describe(
    "capacity_model_error_ratio",
    "Relative error of the fleet twin's predicted mean sojourn against "
    "the observed windowed mean at the current operating point (lower "
    "is better).",
)
obs_metrics.describe(
    "capacity_headroom_ratio",
    "Per-shard capacity headroom: 1 - measured lane occupancy "
    "(0 = the shard is saturated, 1 = idle; higher is better).",
)
obs_metrics.describe(
    "fleet_desired_shards",
    "Hysteresis-damped shard-count recommendation: the smallest fleet "
    "the twin predicts meets the p95 target at the forecast arrival "
    "rate (the autoscale actuator input).",
)
obs_metrics.describe(
    "capacity_time_to_breach_seconds",
    "Forecast seconds until the arrival trend crosses the current "
    "fleet's saturation knee (absent while the forecast is infinite).",
)
obs_metrics.describe(
    "capacity_knee_rate_per_sec",
    "Twin-predicted saturation knee of the current fleet: highest "
    "arrival rate served within the p95 target at full goodput.",
)

# below this many mean lanes of activity the conservation-law residuals
# read 0.0: an idle fleet has nothing to conserve, and ratios of two
# near-zero numbers would page on noise
MIN_ACTIVITY_LANES = 0.05


@dataclass
class CapacityEstimate:
    """One windowed read of the measured service laws. ``ok`` is False
    until the window holds enough completions to form the estimates;
    consumers must treat not-ok as "hold", never as zero."""

    ok: bool = False
    t: float = 0.0
    window: float = 0.0
    arrival_rate: float = 0.0        # offered req/s (all statuses)
    throughput: float = 0.0          # solved completions/s (status="ok")
    latency_mean_s: float = 0.0      # mean sojourn W of solved requests
    latency_p50_s: Optional[float] = None
    latency_p95_s: Optional[float] = None
    queue_depth: float = 0.0         # mean L_q over the window
    busy_lanes: float = 0.0          # mean occupied lanes over the window
    service_time_s: float = 0.0      # utilization-law mean S = busy/X
    service_p50_s: Optional[float] = None
    service_p95_s: Optional[float] = None
    littles_residual: float = 0.0
    utilization_residual: float = 0.0
    per_shard: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "t": self.t,
            "window": self.window,
            "arrival_rate_per_sec": self.arrival_rate,
            "throughput_per_sec": self.throughput,
            "latency_mean_s": self.latency_mean_s,
            "latency_p50_s": self.latency_p50_s,
            "latency_p95_s": self.latency_p95_s,
            "queue_depth": self.queue_depth,
            "busy_lanes": self.busy_lanes,
            "service_time_s": self.service_time_s,
            "service_p50_s": self.service_p50_s,
            "service_p95_s": self.service_p95_s,
            "littles_residual": self.littles_residual,
            "utilization_residual": self.utilization_residual,
            "per_shard": {k: dict(v) for k, v in self.per_shard.items()},
        }

    def service_quantiles(self) -> List[Tuple[float, float]]:
        """The measured service-time distribution as sorted (quantile,
        seconds) CDF knots — what `FleetTwin` replays. Shape comes from
        the retained latency quantile tracks, scale from the
        utilization-law mean (sojourn quantiles inflate under load; the
        busy-lane integral does not)."""
        s = max(self.service_time_s, 1e-6)
        p50 = self.service_p50_s if self.service_p50_s else s
        p95 = self.service_p95_s if self.service_p95_s else 2.0 * s
        pts = [
            (0.0, max(1e-6, 0.25 * p50)),
            (0.5, max(1e-6, p50)),
            (0.95, max(1e-6, p95)),
            (1.0, max(1e-6, 1.3 * p95)),
        ]
        # enforce monotone values, then rescale so the piecewise-linear
        # CDF's mean equals the utilization-law mean exactly
        for i in range(1, len(pts)):
            if pts[i][1] <= pts[i - 1][1]:
                pts[i] = (pts[i][0], pts[i - 1][1] * 1.001)
        mean = sum(
            0.5 * (v0 + v1) * (q1 - q0)
            for (q0, v0), (q1, v1) in zip(pts, pts[1:])
        )
        scale = s / mean if mean > 0 else 1.0
        return [(q, v * scale) for q, v in pts]


class FleetTwin:
    """Deterministic discrete-event replay of the fleet as an M/G/c
    queue: Poisson arrivals, one FIFO admission queue bounded at
    ``queue_limit`` (arrivals beyond it shed, exactly the fleet's
    admission behavior), ``shards × lanes_per_shard`` servers, service
    times drawn from a measured quantile CDF by inverse transform with
    a seeded PRNG. Same inputs → bitwise-same prediction."""

    def __init__(
        self,
        service_quantiles: Sequence[Tuple[float, float]],
        *,
        lanes_per_shard: int,
        queue_limit: int = 256,
        seed: int = 0,
    ):
        pts = sorted((float(q), float(v)) for q, v in service_quantiles)
        if len(pts) < 2 or pts[0][0] != 0.0 or pts[-1][0] != 1.0:
            raise ValueError(
                "service_quantiles must span q=0.0..1.0 with >= 2 knots "
                f"(got {pts})"
            )
        self.quantiles = pts
        self.lanes_per_shard = int(lanes_per_shard)
        if self.lanes_per_shard <= 0:
            raise ValueError("lanes_per_shard must be positive")
        self.queue_limit = int(queue_limit)
        self.seed = int(seed)
        self.mean_service_s = sum(
            0.5 * (v0 + v1) * (q1 - q0)
            for (q0, v0), (q1, v1) in zip(pts, pts[1:])
        )

    def _inv_cdf(self, u: float) -> float:
        pts = self.quantiles
        for (q0, v0), (q1, v1) in zip(pts, pts[1:]):
            if u <= q1:
                if q1 <= q0:
                    return v1
                f = (u - q0) / (q1 - q0)
                return v0 + f * (v1 - v0)
        return pts[-1][1]

    def simulate(
        self,
        rate: float,
        shards: int,
        *,
        requests: int = 1500,
        warmup_frac: float = 0.2,
    ) -> Dict[str, float]:
        """Replay `requests` Poisson arrivals at `rate` req/s through a
        `shards`-wide fleet; returns predicted p50/p95 sojourn, goodput,
        shed fraction and utilization (steady-state: the first
        ``warmup_frac`` of arrivals prime the queue and are not
        scored)."""
        rate = float(rate)
        if rate <= 0:
            raise ValueError(f"rate must be positive (got {rate})")
        c = max(1, int(shards)) * self.lanes_per_shard
        mix = self.seed
        for part in (int(shards), int(requests), round(rate * 1e6)):
            mix = mix * 1_000_003 + part
        rng = random.Random(mix)
        free = [0.0] * c  # heap of server-free times
        heapq.heapify(free)
        starts: deque = deque()  # start times of admitted, not-yet-started
        t = 0.0
        warm_n = int(requests * warmup_frac)
        warm_t = None
        done = 0
        shed = 0
        sojourns: List[float] = []
        busy_time = 0.0
        for i in range(int(requests)):
            t += rng.expovariate(rate)
            if i == warm_n:
                warm_t = t
            # admission queue occupancy at this arrival = admitted jobs
            # that have not started service yet
            while starts and starts[0] <= t:
                starts.popleft()
            if len(starts) >= self.queue_limit:
                if i >= warm_n:
                    shed += 1
                continue
            begin = max(t, free[0])
            svc = self._inv_cdf(rng.random())
            heapq.heapreplace(free, begin + svc)
            starts.append(begin)
            if i >= warm_n:
                done += 1
                sojourns.append(begin + svc - t)
                busy_time += svc
        span = max(t - (warm_t if warm_t is not None else 0.0), 1e-9)
        sojourns.sort()

        def _q(q: float) -> float:
            if not sojourns:
                return 0.0
            return sojourns[
                max(0, math.ceil(q * len(sojourns)) - 1)
            ]

        offered = done + shed
        return {
            "rate_per_sec": rate,
            "shards": int(shards),
            "lanes": c,
            "mean_s": (
                sum(sojourns) / len(sojourns) if sojourns else 0.0
            ),
            "p50_s": _q(0.50),
            "p95_s": _q(0.95),
            "goodput_per_sec": done / span,
            "shed_frac": shed / offered if offered else 0.0,
            "utilization": busy_time / (span * c),
        }

    def knee(
        self,
        shards: int,
        *,
        p95_limit: Optional[float] = None,
        goodput_frac: float = 0.85,
        requests: int = 1200,
        steps: int = 12,
    ) -> Dict[str, float]:
        """Locate the saturation knee of a `shards`-wide fleet: the
        highest arrival rate still served with goodput ≥
        ``goodput_frac × rate`` and (when given) p95 ≤ ``p95_limit``.
        Scans a deterministic rate grid up to ~1.5× the theoretical
        service capacity ``c/S``."""
        c = max(1, int(shards)) * self.lanes_per_shard
        cap = c / max(self.mean_service_s, 1e-9)
        rates = [cap * (i + 1) * 1.5 / steps for i in range(steps)]
        knee = None
        at_knee: Optional[Dict[str, float]] = None
        for r in rates:
            sim = self.simulate(r, shards, requests=requests)
            ok = sim["goodput_per_sec"] >= goodput_frac * r
            if ok and p95_limit is not None:
                ok = sim["p95_s"] <= p95_limit
            if ok:
                knee, at_knee = r, sim
            else:
                break
        if knee is None:
            # even the lowest grid rate failed: report it as the knee so
            # callers see "this fleet is already past saturation"
            knee = rates[0]
            at_knee = self.simulate(knee, shards, requests=requests)
        return {
            "knee_rate_per_sec": knee,
            "p95_at_knee_s": at_knee["p95_s"],
            "goodput_at_knee_per_sec": at_knee["goodput_per_sec"],
            "service_capacity_per_sec": cap,
            "shards": int(shards),
        }


class CapacityObservatory:
    """The pump-driven capacity plane: estimate the measured laws,
    validate the twin, publish the forecast and recommendation gauges.
    Construction is cheap; nothing runs until `tick()` is called (the
    service pump does, rate-limited by ``eval_every``; the heavier twin
    refresh runs every ``twin_every`` seconds)."""

    def __init__(
        self,
        store: SeriesStore,
        *,
        lanes_per_shard: int,
        shards: int,
        queue_limit: int = 256,
        clock: Optional[Callable[[], float]] = None,
        window: float = 60.0,
        eval_every: Optional[float] = None,
        twin_every: float = 10.0,
        p95_target: float = 0.25,
        goodput_frac: float = 0.85,
        min_shards: int = 1,
        max_shards: int = 32,
        forecast_lead: float = 30.0,
        up_hold: float = 0.0,
        down_hold: float = 60.0,
        twin_requests: int = 1200,
        up_shards_fn: Optional[Callable[[], int]] = None,
        seed: int = 0,
    ):
        self.store = store
        self.lanes_per_shard = int(lanes_per_shard)
        self.shards = int(shards)
        if self.lanes_per_shard <= 0 or self.shards <= 0:
            raise ValueError("lanes_per_shard and shards must be positive")
        self.queue_limit = int(queue_limit)
        self.clock = clock if clock is not None else store.clock
        self.window = float(window)
        self.eval_every = (
            float(eval_every) if eval_every is not None
            else store.tiers[0][0]
        )
        self.twin_every = float(twin_every)
        self.p95_target = float(p95_target)
        self.goodput_frac = float(goodput_frac)
        self.min_shards = max(1, int(min_shards))
        self.max_shards = max(self.min_shards, int(max_shards))
        self.forecast_lead = float(forecast_lead)
        self.up_hold = float(up_hold)
        self.down_hold = float(down_hold)
        self.twin_requests = int(twin_requests)
        self.up_shards_fn = up_shards_fn
        self.seed = int(seed)
        from .signals import Signal

        self._arrival = Signal(
            store, "serve_requests_total", agg="rate",
            window=self.window, clock=self.clock,
        )
        self.twin: Optional[FleetTwin] = None
        self.last_estimate: Optional[CapacityEstimate] = None
        self._last_tick: Optional[float] = None
        self._twin_due: Optional[float] = None
        self._desired: Optional[int] = None
        self._pending: Optional[Tuple[int, float]] = None
        self._model_error: Optional[float] = None
        self._predicted_p95: Optional[float] = None
        self._knee: Optional[Dict[str, float]] = None
        self._ttb: Optional[float] = None

    # -- the measured laws ---------------------------------------------
    def _reduce(self, name, labels=None, *, agg, now) -> Optional[float]:
        return self.store.reduce(
            name, labels, window=self.window, agg=agg, now=now
        )

    def estimate(self, now: Optional[float] = None) -> CapacityEstimate:
        """One pure read of the retained tracks → `CapacityEstimate`.
        The laws are evaluated over the solved (``status="ok"``) stream:
        cache hits bypass the queue and sheds never enter it, so the
        conservation checks pair like with like."""
        now = self.clock() if now is None else float(now)
        est = CapacityEstimate(t=now, window=self.window)
        ok = {"status": "ok"}
        x = self._reduce("serve_latency_seconds_count", ok, agg="rate", now=now)
        sum_rate = self._reduce(
            "serve_latency_seconds_sum", ok, agg="rate", now=now
        )
        queue = self._reduce("serve_queue_depth", agg="avg", now=now)
        busy = self._reduce("serve_shard_inflight", agg="avg", now=now)
        if busy is None:
            busy = self._reduce("serve_active_lanes", agg="avg", now=now)
        arrival = self._reduce("serve_requests_total", agg="rate", now=now)
        est.arrival_rate = arrival or 0.0
        est.queue_depth = queue or 0.0
        est.busy_lanes = busy or 0.0
        est.latency_p50_s = self._reduce(
            "serve_latency_seconds_p50", ok, agg="avg", now=now
        )
        est.latency_p95_s = self._reduce(
            "serve_latency_seconds_p95", ok, agg="avg", now=now
        )
        if not x or x <= 0.0 or sum_rate is None or busy is None:
            return est  # window too young: ok stays False
        est.ok = True
        est.throughput = x
        w = sum_rate / x
        est.latency_mean_s = w
        # utilization-law service time: busy-lane-seconds per completion
        s_util = est.busy_lanes / x
        # independent estimate: sojourn minus queue wait (Little on the
        # queue alone: W_q = L_q / X)
        s_little = max(w - est.queue_depth / x, 1e-6)
        est.service_time_s = max(s_util, 1e-6)
        activity = max(est.queue_depth + est.busy_lanes, x * w)
        if activity >= MIN_ACTIVITY_LANES:
            l_sys = est.queue_depth + est.busy_lanes
            lw = x * w
            est.littles_residual = abs(l_sys - lw) / max(l_sys, lw, 1e-9)
            est.utilization_residual = abs(s_util - s_little) / max(
                s_util, s_little, 1e-9
            )
        # service-time quantile shape from the sojourn tracks, rescaled
        # to the utilization-law mean in service_quantiles()
        scale = est.service_time_s / w if w > 0 else 1.0
        if est.latency_p50_s is not None:
            est.service_p50_s = est.latency_p50_s * scale
        if est.latency_p95_s is not None:
            est.service_p95_s = est.latency_p95_s * scale
            # the p95 track derives from the CUMULATIVE histogram, so a
            # cold-start compile era pollutes its tail long after the
            # window moved on; the utilization-law mean is history-free,
            # so cap the tail knot at a small multiple of it
            est.service_p95_s = min(
                est.service_p95_s,
                5.0 * max(est.service_time_s, est.service_p50_s or 0.0),
            )
        # per-shard occupancy → headroom (fleet mode; a single service
        # reads as one pseudo-shard "0" over the whole lane budget)
        shard_series = self.store.query(
            "serve_shard_inflight", None, window=self.window, now=now
        )
        if shard_series:
            for s in shard_series:
                _, labels = obs_metrics.parse_series(s["series"])
                shard = labels.get("shard", "?")
                vals = s["v"]
                occ = sum(vals) / len(vals) if vals else 0.0
                rho = occ / self.lanes_per_shard
                est.per_shard[shard] = {
                    "busy_lanes": occ,
                    "utilization": rho,
                    "headroom_ratio": max(0.0, 1.0 - rho),
                }
        else:
            lanes = self.shards * self.lanes_per_shard
            rho = est.busy_lanes / lanes
            est.per_shard["0"] = {
                "busy_lanes": est.busy_lanes,
                "utilization": rho,
                "headroom_ratio": max(0.0, 1.0 - rho),
            }
        return est

    # -- the pump hook -------------------------------------------------
    def up_shards(self) -> int:
        if self.up_shards_fn is not None:
            try:
                return max(1, int(self.up_shards_fn()))
            except Exception:
                return self.shards
        return self.shards

    def tick(self, now: Optional[float] = None, force: bool = False) -> bool:
        """One observatory cycle (rate-limited to ``eval_every``): read
        the laws, publish the residual/headroom gauges, and — every
        ``twin_every`` — refresh the twin, validate it, and update the
        forecast + recommendation gauges. Returns True when a cycle
        ran. Never raises: the capacity plane must not take the pump
        down."""
        now = self.clock() if now is None else float(now)
        if (
            not force
            and self._last_tick is not None
            and now - self._last_tick < self.eval_every
        ):
            return False
        self._last_tick = now
        try:
            est = self.estimate(now)
            self.last_estimate = est
            reg = self.store._registry()
            if est.ok:
                reg.set_gauge(
                    "capacity_littles_law_residual", est.littles_residual
                )
                reg.set_gauge(
                    "capacity_utilization_law_residual",
                    est.utilization_residual,
                )
                for shard, row in est.per_shard.items():
                    reg.set_gauge(
                        "capacity_headroom_ratio", row["headroom_ratio"],
                        shard=shard,
                    )
            if est.ok and (
                force or self._twin_due is None or now >= self._twin_due
            ):
                self._twin_due = now + self.twin_every
                self._refresh_twin(est, now)
        except Exception:
            pass
        return True

    def _refresh_twin(self, est: CapacityEstimate, now: float) -> None:
        reg = self.store._registry()
        self.twin = FleetTwin(
            est.service_quantiles(),
            lanes_per_shard=self.lanes_per_shard,
            queue_limit=self.queue_limit,
            seed=self.seed,
        )
        up = self.up_shards()
        # validate: predicted sojourn at the current operating point vs
        # the observed windowed MEAN (the _sum/_count counter rates are
        # history-free within the window, unlike the cumulative-
        # histogram p95 track)
        if est.throughput > 0 and est.latency_mean_s > 0:
            sim = self.twin.simulate(
                max(est.throughput, 1e-3), up, requests=self.twin_requests
            )
            self._predicted_p95 = sim["p95_s"]
            self._model_error = abs(
                sim["mean_s"] - est.latency_mean_s
            ) / max(est.latency_mean_s, 1e-9)
            reg.set_gauge("capacity_model_error_ratio", self._model_error)
        # the current fleet's knee at the p95 target
        self._knee = self.twin.knee(
            up, p95_limit=self.p95_target,
            goodput_frac=self.goodput_frac, requests=self.twin_requests,
        )
        reg.set_gauge(
            "capacity_knee_rate_per_sec", self._knee["knee_rate_per_sec"]
        )
        # time-to-breach: extrapolate the arrival trend to the knee
        lam = self._arrival.value(now)
        slope = self._arrival.trend(now)
        self._ttb = None
        if lam is not None:
            knee_rate = self._knee["knee_rate_per_sec"]
            if lam >= knee_rate:
                self._ttb = 0.0
            elif slope is not None and slope > 1e-9:
                self._ttb = (knee_rate - lam) / slope
        if self._ttb is not None:
            reg.set_gauge("capacity_time_to_breach_seconds", self._ttb)
        # recommendation: smallest fleet meeting the target at the
        # forecast rate, hysteresis-damped
        lam_f = max(
            lam if lam is not None else est.arrival_rate, est.throughput,
            1e-3,
        )
        if slope is not None and slope > 0:
            lam_f += slope * self.forecast_lead
        raw = self._raw_recommendation(lam_f)
        self._damp(raw, now)
        reg.set_gauge("fleet_desired_shards", float(self._desired))

    def _raw_recommendation(self, rate: float) -> int:
        assert self.twin is not None
        for s in range(self.min_shards, self.max_shards + 1):
            sim = self.twin.simulate(rate, s, requests=self.twin_requests)
            if (
                sim["p95_s"] <= self.p95_target
                and sim["goodput_per_sec"] >= self.goodput_frac * rate
            ):
                return s
        return self.max_shards

    def _damp(self, raw: int, now: float) -> None:
        if self._desired is None:
            self._desired = raw
            return
        if raw == self._desired:
            self._pending = None
            return
        if self._pending is None or self._pending[0] != raw:
            self._pending = (raw, now)
        hold = self.up_hold if raw > self._desired else self.down_hold
        if now - self._pending[1] >= hold:
            self._desired = raw
            self._pending = None

    # -- reporting -----------------------------------------------------
    def what_if(
        self,
        rate: float,
        *,
        p95_target: Optional[float] = None,
        max_shards: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """Answer "how many shards for `rate` req/s at this p95?" from
        the current twin (None until the first twin refresh)."""
        if self.twin is None:
            return None
        target = self.p95_target if p95_target is None else float(p95_target)
        hi = self.max_shards if max_shards is None else int(max_shards)
        for s in range(self.min_shards, hi + 1):
            sim = self.twin.simulate(rate, s, requests=self.twin_requests)
            if (
                sim["p95_s"] <= target
                and sim["goodput_per_sec"] >= self.goodput_frac * rate
            ):
                return {"shards": s, "feasible": True, "predicted": sim}
        return {
            "shards": hi,
            "feasible": False,
            "predicted": self.twin.simulate(
                rate, hi, requests=self.twin_requests
            ),
        }

    def report(self) -> Dict[str, Any]:
        """The ``/capacity`` endpoint payload: the last estimate, the
        twin's validation + knee, the forecast, and the recommendation —
        plus the measured service quantiles so an offline consumer
        (`tools/torch_capacity_plan.py`) can rebuild the twin exactly."""
        est = self.last_estimate
        out: Dict[str, Any] = {
            "config": {
                "lanes_per_shard": self.lanes_per_shard,
                "shards": self.shards,
                "queue_limit": self.queue_limit,
                "window": self.window,
                "p95_target_s": self.p95_target,
                "goodput_frac": self.goodput_frac,
                "twin_every": self.twin_every,
                "up_hold": self.up_hold,
                "down_hold": self.down_hold,
                "seed": self.seed,
            },
            "estimate": est.to_dict() if est is not None else None,
            "service_quantiles": (
                [[q, v] for q, v in est.service_quantiles()]
                if est is not None and est.ok else None
            ),
            "twin": {
                "ready": self.twin is not None,
                "mean_service_s": (
                    self.twin.mean_service_s if self.twin else None
                ),
                "predicted_p95_s": self._predicted_p95,
                "model_error_ratio": self._model_error,
                "knee": self._knee,
            },
            "forecast": {
                "time_to_breach_s": self._ttb,
                "lead_s": self.forecast_lead,
            },
            "recommendation": {
                "desired_shards": self._desired,
                "actual_up_shards": self.up_shards(),
                "pending": (
                    {"shards": self._pending[0], "since": self._pending[1]}
                    if self._pending else None
                ),
            },
        }
        return out


def as_capacity(spec: Any, **defaults: Any) -> CapacityObservatory:
    """Coerce the service-level ``capacity=`` knob: ``True`` builds an
    observatory from the service's own geometry, a mapping overrides
    constructor knobs (``capacity={"p95_target": 0.1}``), and an
    existing `CapacityObservatory` passes through unchanged."""
    if isinstance(spec, CapacityObservatory):
        return spec
    kw = dict(defaults)
    if isinstance(spec, dict):
        kw.update(spec)
    elif spec is not True:
        raise TypeError(
            f"capacity= must be True, a mapping of CapacityObservatory "
            f"knobs, or a CapacityObservatory (got {type(spec).__name__})"
        )
    store = kw.pop("store")
    return CapacityObservatory(store, **kw)
