"""The in-process asynchronous dispatch service (port of
`dispatches_tpu/serve/service.py`).

`DispatchService` glues the pieces together: callers `submit()` problem
rows (or `submit_compiled()` a `CompiledLP` + params) and get a
`Ticket`; requests flow fingerprint-cache -> admission queue ->
`SlotEngine` slots, and completions resolve tickets with numpy-leaf
`SolveResult`s. The solve loop is the engine's continuous batching: one
fixed bucket stays busy while retired lanes' slots are back-filled from
the queue between chunks. The engine runs on the card unless the service
is built with ``device="cpu"``.

Two driving modes share one deterministic core:

- `pump()` runs exactly one cycle (expire queued -> refill slots -> one
  chunk -> harvest -> enforce in-flight deadlines). Tests drive it under
  a fake clock; batch callers loop it via `drain()`.
- `start()` runs `pump()` on a background thread until `stop()` —
  the serving mode `tools/torch_serve_dispatch.py` and
  `tools/torch_loadgen.py` use.

Time is injectable (`clock=`, default `time.monotonic`); request
deadlines live in that clock's domain. Everything the service decides is
observable: `serve_*` counters/gauges/latency histograms through
`obs.metrics`, and shed / deadline / completion records through the
process tracer's journal (`obs.journal.get_tracer()`), with service
verdicts (``shed``, ``deadline_exceeded``) flowing into the same
`solve_verdict_total` counters the solver health engine uses.

Learned warm starts (``warm_model=``), the time-series store
(``timeseries=`` / ``store=``), the lane observatory (``lanes=``), the
capacity plane (``capacity=``, `obs.capacity`) and the performance probe
(``perf=``, `obs.perf`) are opt-in planes that only read the solves: with
them on, every answer is bitwise the one without them (a rejected warm
seed is the cold start).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..obs import health as obs_health
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import reqtrace as obs_reqtrace
from ..obs.journal import get_tracer
from .cache import ResultCache
from .queue import AdmissionQueue
from .request import (
    SolveRequest,
    SolveResult,
    Ticket,
    priority_name,
    priority_value,
)

LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

obs_metrics.describe(
    "serve_requests_total",
    "Requests resolved, by terminal status (ok/cached/shed/deadline_exceeded).",
)
obs_metrics.describe(
    "serve_latency_seconds", "End-to-end request latency, by terminal status.",
)
obs_metrics.describe("serve_queue_depth", "Pending requests in the admission queue.")
obs_metrics.describe("serve_active_lanes", "Engine lanes currently occupied.")
obs_metrics.describe("serve_shed_total", "Requests shed by admission control.")
obs_metrics.describe("serve_deadline_total", "Requests that missed their deadline.")
obs_metrics.describe(
    "serve_mem_watermark_bytes",
    "Peak device memory observed from the service pump loop.",
)


def _service_health(verdict: str, detail: str) -> dict:
    """A health record in `obs.health.health_summary` shape for verdicts
    the SERVICE decides (the trajectory may look fine — the answer was
    late or never attempted)."""
    v = obs_health.Verdict(verdict, None, None, detail)
    return {
        "counts": {verdict: 1},
        "n_bad": 0 if verdict == "healthy" else 1,
        "worst": {"lane": 0, **v._asdict()},
        "verdicts": [v._asdict()],
    }


class DispatchService:
    def __init__(
        self,
        engine,
        *,
        queue_limit: int = 64,
        cache: Optional[ResultCache] = None,
        clock=time.monotonic,
        name: str = "serve",
        reqtrace: bool = False,
        mem_sample_every: int = 32,
        store=None,
        capacity=None,
        lanes=None,
        lane: str = "dense",
    ):
        from ..obs.lanes import as_lanes

        self.engine = engine
        self.queue = AdmissionQueue(queue_limit)
        self.cache = cache
        self.clock = clock
        self.name = name
        self.reqtrace = bool(reqtrace)
        if self.reqtrace:
            # engine chunk-loop boundaries stamp onto request journeys,
            # sharing the service clock; None keeps the hot path untouched
            engine.observer = obs_reqtrace.EngineJourneyObserver(clock)
        self.mem_sample_every = int(mem_sample_every)
        # obs.timeseries.SeriesStore (None = retention off, the default):
        # pump() calls maybe_sample on the service clock; the sampler only
        # reads registry floats
        self.store = store
        # obs.capacity.CapacityObservatory (None = off, the default): tick()
        # runs from pump() after the store sample, reading retained
        # telemetry only
        self.capacity = capacity
        # obs.lanes.LaneObservatory (None = off, the default): every
        # resolved solve journals a lane_decision and may be sampled for a
        # shadow-lane probe; tick() runs the budgeted probes from pump()
        # after primary dispatch (batch priority)
        self.lanes = as_lanes(lanes, clock=clock)
        self.lane = str(lane)
        if self.lanes is not None:
            self.lanes.seed_metrics(self.name, self.lane)
        self._pump_count = 0
        self._lock = threading.RLock()
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.completed = 0
        self.shed_total = 0
        self.deadline_total = 0

    # -- submission ----------------------------------------------------
    def submit(
        self,
        problem: Any,
        *,
        priority="normal",
        deadline: Optional[float] = None,
        timeout: Optional[float] = None,
        fingerprint: Optional[str] = None,
        options: Optional[Dict] = None,
        request_id: Optional[str] = None,
        trace_ctx: Any = None,
    ) -> Ticket:
        """Queue one problem row. `timeout` is seconds-from-now sugar for
        an absolute `deadline`. The returned ticket may already be done:
        cache hits and admission-shed requests resolve synchronously.
        `trace_ctx` (a `TraceContext` or serialized traceparent string)
        parents this request's journey onto a caller span; it is ignored
        unless the service runs with ``reqtrace=True``."""
        now = self.clock()
        if deadline is None and timeout is not None:
            deadline = now + timeout
        req = SolveRequest(
            problem,
            priority=priority_value(priority),
            deadline=deadline,
            fingerprint=self._fingerprint(problem, fingerprint, options),
            request_id=request_id,
        )
        if self.reqtrace:
            req.journey = obs_reqtrace.start_journey(
                trace_ctx, clock=self.clock, t0=now,
                request_id=request_id,
                priority=priority_name(req.priority),
            )
        ticket = Ticket(req)
        with self._lock:
            req.seq = self._seq
            self._seq += 1
            req.submitted_at = now
            if req.journey is not None:
                req.journey.seq = req.seq
            if self.cache is not None:
                hit = self.cache.get(req.fingerprint)
                if hit is not None:
                    self._resolve_cached(req, hit, now)
                    return ticket
            admitted, shed = self.queue.push(req, now=now)
            if shed is not None:
                self._resolve_shed(shed)
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        return ticket

    def submit_compiled(
        self, compiled, params: Dict, *, dtype=None, options=None, **kw
    ) -> Ticket:
        """Instantiate a `CompiledLP` at `params` and submit the result;
        the cache key is `compiled.fingerprint(params, ...)` so repeated
        submissions of the same params never re-instantiate bits."""
        fp = kw.pop("fingerprint", None)
        if fp is None and self.cache is not None:
            fp = compiled.fingerprint(
                params, options=self._fp_options(options)
            )
        kw_i = {} if dtype is None else {"dtype": dtype}
        lp = compiled.instantiate(params, device=self.engine.device, **kw_i)
        return self.submit(lp, fingerprint=fp, options=options, **kw)

    def _fp_options(self, options: Optional[Dict]) -> Dict:
        # solver identity, bucket and device belong in the cache key: the
        # same bytes under different tolerances, at another batch width or
        # on another device are different answers
        out = dict(options or {})
        out["_serve"] = (self.engine.entry, self.engine.bucket,
                         self.engine.opt_key, device_key(self.engine.device))
        return out

    def _fingerprint(self, problem, fingerprint, options) -> Optional[str]:
        if fingerprint is not None or self.cache is None:
            return fingerprint
        from ..core.program import lp_fingerprint

        try:
            return lp_fingerprint(problem, options=self._fp_options(options))
        except Exception:
            return None  # unhashable problem: solve uncached, don't refuse

    # -- the cycle -----------------------------------------------------
    def pump(self) -> int:
        """One deterministic service cycle; returns completions resolved
        this cycle. Safe to call with nothing to do."""
        done = 0
        with self._lock:
            now = self.clock()
            for req in self.queue.remove_expired(now):
                if req.journey is not None:
                    req.journey.mark("dequeued", now)
                self._resolve_deadline(req, solution=None, iterations=None)
                done += 1
            while self.engine.free_slots() and len(self.queue):
                req = self.queue.pop()
                req.started_at = now
                if req.journey is not None:
                    req.journey.mark("slot", now)
                self.engine.admit(req, req.problem)
            if self.engine.active():
                for req, row, stats in self.engine.step():
                    self._resolve_solved(req, row, stats)
                    done += 1
                now = self.clock()
                for req in [
                    r for r in self.engine.active() if r.expired(now)
                ]:
                    row = self.engine.evict(req)
                    if req.journey is not None and row is not None:
                        req.journey.mark("harvest_end")
                    self._resolve_deadline(
                        req, solution=row,
                        iterations=None if row is None
                        else int(row.iterations),
                    )
                    done += 1
            self._pump_count += 1
            if self.mem_sample_every and (
                self._pump_count % self.mem_sample_every
                == 1 % self.mem_sample_every  # first pump, then every Nth
            ):
                # serve-tier OOM drift: watermark gauge lands in the
                # journal close snapshot with the rest of the registry
                wm = obs_memory.memory_watermark_bytes()
                if wm is not None:
                    obs_metrics.set_gauge("serve_mem_watermark_bytes", wm)
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
            obs_metrics.set_gauge(
                "serve_active_lanes", len(self.engine.active())
            )
            if self.store is not None:
                self.store.maybe_sample(self.clock())
            if self.capacity is not None:
                self.capacity.tick(self.clock())
            if self.lanes is not None:
                # shadow-lane probes at batch priority: after every
                # primary dispatch and harvest of this cycle
                self.lanes.tick(self.clock())
        return done

    def drain(
        self, max_cycles: int = 10_000, timeout: Optional[float] = None
    ) -> int:
        """Pump until queue and slots are empty; returns completions.

        With `timeout` (seconds on the service clock), a drain that has
        not converged by the deadline stops pumping and resolves every
        still-queued ticket as ``shed`` (journaled with
        ``detail="drain_timeout"``) instead of blocking forever — the
        shutdown path when the engine is wedged. In-flight lanes are
        evicted with their best iterate as ``deadline_exceeded``."""
        t0 = self.clock()
        total = 0
        for _ in range(max_cycles):
            if not len(self.queue) and not self.engine.active():
                return total
            if timeout is not None and self.clock() - t0 >= timeout:
                return total + self._drain_expire()
            total += self.pump()
        raise RuntimeError(f"drain did not converge in {max_cycles} cycles")

    def _drain_expire(self) -> int:
        """Shed everything still queued and evict everything in flight
        (best iterate, ``deadline_exceeded``) — the drain-timeout path."""
        done = 0
        with self._lock:
            for req in self.queue.pop_all():
                if req.journey is not None:
                    req.journey.mark("dequeued")
                self._resolve_shed(req, detail="drain_timeout")
                done += 1
            for req in list(self.engine.active()):
                row = self.engine.evict(req)
                if req.journey is not None and row is not None:
                    req.journey.mark("harvest_end")
                self._resolve_deadline(
                    req, solution=row,
                    iterations=None if row is None else int(row.iterations),
                )
                done += 1
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        return done

    # -- background mode -----------------------------------------------
    def start(self, idle_sleep: float = 0.001) -> None:
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.is_set():
                with self._lock:
                    busy = len(self.queue) or self.engine.active()
                if busy:
                    self.pump()
                else:
                    self._stop_evt.wait(idle_sleep)

        self._thread = threading.Thread(
            target=_loop, name="dispatch-serve", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        if self._thread is None:
            return
        if drain:
            while True:
                with self._lock:
                    busy = len(self.queue) or self.engine.active()
                if not busy:
                    break
                time.sleep(0.001)
        self._stop_evt.set()
        self._thread.join()
        self._thread = None

    # -- completions ---------------------------------------------------
    def _resolve_cached(self, req, hit: SolveResult, now: float) -> None:
        self.completed += 1
        done_at = self.clock()
        latency = done_at - now
        obs_metrics.inc("serve_requests_total", status="cached")
        obs_metrics.observe(
            "serve_latency_seconds", latency, buckets=LATENCY_BUCKETS,
            status="cached",
        )
        if req.journey is not None:
            req.journey.finish(
                "cache_hit", verdict=hit.verdict,
                iterations=hit.iterations, now=done_at, from_cache=True,
            )
        req.ticket._complete(hit._replace(
            from_cache=True, latency=latency, request_id=req.request_id,
        ))

    def _resolve_solved(self, req, row, stats: dict) -> None:
        self.completed += 1
        now = self.clock()
        latency = now - req.submitted_at
        verdicts = obs_health.classify_solution(row)
        verdict = verdicts[0].verdict if verdicts else "healthy"
        # the engine's remediation ladder (runtime/remedy.py) already ran
        # in the harvest; its outcome rides in `stats`. A recovered row
        # classifies healthy above; an exhausted ladder escalates the
        # verdict to `unrecoverable` so callers and caches can tell
        # "solver struggled" from "the system gave up".
        rinfo = stats.get("remediation")
        health = None
        if rinfo is not None and rinfo.get("verdict") == "unrecoverable":
            verdict = "unrecoverable"
            health = _service_health(
                "unrecoverable",
                f"remediation ladder exhausted "
                f"({rinfo.get('attempts', 0)} attempts, "
                f"original: {rinfo.get('original')})",
            )
        # the conformance plane's certificate check (engine.conformance,
        # obs/conformance.py) rides in `stats` the same way: a failed
        # check upgrades a trajectory-healthy verdict to `inaccurate` —
        # the trajectory looked fine, the answer is wrong
        conf = stats.get("conformance")
        if conf is not None and not conf.get("ok", True):
            from ..obs.conformance import escalate_verdict

            new_verdict = escalate_verdict(verdict, conf)
            if new_verdict != verdict:
                verdict = new_verdict
                health = _service_health(
                    "inaccurate",
                    "KKT certificates exceed the conformance policy "
                    + ", ".join(
                        f"{k}={conf[k]:.2e}"
                        for k in ("res_primal", "res_dual", "comp", "gap")
                        if isinstance(conf.get(k), float)
                    ),
                )
        result = SolveResult(
            solution=row,
            verdict=verdict,
            iterations=stats.get("iterations"),
            latency=latency,
            request_id=req.request_id,
        )
        if self.cache is not None and verdict not in (
            "unrecoverable", "inaccurate"
        ):
            # a ladder-exhausted or policy-failing answer must not become
            # a future cache hit
            self.cache.put(req.fingerprint, result)
        status = (
            verdict if verdict in ("unrecoverable", "inaccurate") else "ok"
        )
        obs_metrics.inc("serve_requests_total", status=status)
        obs_metrics.observe(
            "serve_latency_seconds", latency, buckets=LATENCY_BUCKETS,
            status=status,
        )
        extra = {k: stats[k] for k in ("warm_source", "warm_accepted") if k in stats}
        if rinfo is not None:
            extra["remediation"] = rinfo
        if conf is not None:
            extra["conformance"] = conf
        get_tracer().solve_event(
            self.name, row,
            request_id=req.request_id, seq=req.seq,
            latency_s=latency, iterations=stats.get("iterations"),
            lane=self.lane,
            **({"health": health} if health is not None else {}),
            **extra,
        )
        if self.lanes is not None:
            # the decision record's wall is the request's end-to-end
            # latency; the shadow prober re-measures both lanes on one clock
            self.lanes.note_solve(
                req.problem, self.lane, entry=self.name, wall=latency,
                iterations=stats.get("iterations"), verdict=verdict,
            )
        if req.journey is not None:
            req.journey.finish(
                "complete", verdict=verdict,
                iterations=stats.get("iterations"), now=now,
            )
        req.ticket._complete(result)

    def _resolve_deadline(self, req, solution, iterations) -> None:
        self.completed += 1
        self.deadline_total += 1
        now = self.clock()
        latency = now - req.submitted_at
        obs_metrics.inc("serve_requests_total", status="deadline_exceeded")
        obs_metrics.inc("serve_deadline_total")
        obs_metrics.observe(
            "serve_latency_seconds", latency, buckets=LATENCY_BUCKETS,
            status="deadline_exceeded",
        )
        detail = (
            "deadline passed mid-solve; best iterate returned"
            if solution is not None
            else "deadline passed before the first chunk; no iterate"
        )
        if solution is not None:
            get_tracer().solve_event(
                self.name, solution,
                request_id=req.request_id, seq=req.seq,
                latency_s=latency, iterations=iterations,
                health=_service_health("deadline_exceeded", detail),
            )
        else:
            get_tracer().event(
                "serve_deadline", verdict="deadline_exceeded",
                request_id=req.request_id, seq=req.seq, detail=detail,
            )
            obs_health.note_verdicts(
                {"deadline_exceeded": 1}, solve=self.name
            )
        if req.journey is not None:
            req.journey.finish(
                "deadline_exceeded", verdict="deadline_exceeded",
                iterations=iterations, now=now,
                best_iterate=solution is not None,
            )
        req.ticket._complete(SolveResult(
            solution=solution,
            verdict="deadline_exceeded",
            iterations=iterations,
            latency=latency,
            request_id=req.request_id,
        ))

    def _resolve_shed(self, req, detail: Optional[str] = None) -> None:
        self.completed += 1
        self.shed_total += 1
        now = self.clock()
        latency = now - req.submitted_at
        obs_metrics.inc("serve_requests_total", status="shed")
        obs_metrics.inc("serve_shed_total")
        extra = {} if detail is None else {"detail": detail}
        get_tracer().event(
            "serve_shed", verdict="shed",
            request_id=req.request_id, seq=req.seq, priority=req.priority,
            **extra,
        )
        obs_health.note_verdicts({"shed": 1}, solve=self.name)
        if req.journey is not None:
            # a displaced request's queue residency ends here
            if "enqueued" in req.journey.marks:
                req.journey.mark("dequeued", now)
            req.journey.finish("shed", verdict="shed", now=now)
        req.ticket._complete(SolveResult(
            solution=None,
            verdict="shed",
            latency=latency,
            request_id=req.request_id,
        ))

    # -- introspection -------------------------------------------------
    def conformance_report(self) -> dict:
        """The exporter's ``/conformance`` payload for the in-process
        service: the engine checker's aggregate. Empty when the plane
        is off."""
        with self._lock:
            conf = getattr(self.engine, "conformance", None)
            if conf is None:
                return {}
            return {"conformance": conf.report()}

    def lane_report(self) -> dict:
        """The exporter's ``/lanes`` payload for the in-process service:
        the lane observatory's scoreboard ledger. Empty when the plane
        is off."""
        with self._lock:
            if self.lanes is None:
                return {}
            return self.lanes.report()

    def stats(self) -> dict:
        with self._lock:
            out = {
                "queue_depth": len(self.queue),
                "active_lanes": len(self.engine.active()),
                "free_slots": self.engine.free_slots(),
                "bucket": self.engine.bucket,
                "chunks": self.engine.chunks,
                "refills": self.engine.refills,
                "completed": self.completed,
                "shed": self.shed_total,
                "deadline_exceeded": self.deadline_total,
            }
            if self.cache is not None:
                out["cache"] = self.cache.stats()
            conf = getattr(self.engine, "conformance", None)
            if conf is not None:
                out["conformance"] = conf.report()
            if self.store is not None:
                out["timeseries"] = self.store.stats()
            if self.capacity is not None:
                out["capacity"] = self.capacity.report()
            if self.lanes is not None:
                out["lanes"] = self.lanes.report()
            for status in ("ok", "cached"):
                for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    v = obs_metrics.histogram_quantile(
                        "serve_latency_seconds", q, status=status
                    )
                    if v is not None:
                        out[f"latency_{tag}_{status}"] = v
            return out


def device_key(device) -> str:
    """The device part of a result-cache key: ``"cpu"``, or ``"cuda:"``
    and the card's name (the same request may give other bits on another
    kind of device)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def make_dense_service(
    bucket: int,
    *,
    chunk_iters: int = 8,
    queue_limit: int = 64,
    cache_size: Optional[int] = 256,
    clock=time.monotonic,
    trace: bool = False,
    reqtrace: bool = False,
    timeseries: bool = False,
    perf: bool = False,
    warm_model=None,
    remedy=None,
    conformance=None,
    capacity=None,
    lanes=None,
    device="cuda",
    **solver_kw,
) -> DispatchService:
    """A `DispatchService` over dense `LPData` rows solved by the IPM on
    `device` (the card unless asked otherwise): one `SlotEngine` at
    `bucket` lanes, solver options passed through to `solve_lp_partial`
    (`max_iter` also bounds the engine's per-lane budget). Every submitted
    row must share shapes (M, N) and dtype.

    `remedy` (a `runtime.remedy.RemedyEngine` / `RemedyPolicy` / True;
    default None = untouched harvest) re-solves lanes that retire
    unhealthy up the escalation ladder, bounded by the request's remaining
    deadline on the service clock.

    `conformance` (True / `ConformancePolicy` / `ConformanceChecker`;
    default None = unchecked, the same results) certifies every
    harvested row's KKT conditions at harvest, journals the certificates
    on solve events, and escalates policy failures to the `inaccurate`
    verdict.

    `warm_model` (default None = the cold path) is a learned warm-start
    artifact path / `WarmStartModel` / `WarmStartPredictor`; admitted
    lanes are then seeded through the solver's safeguarded
    ``warm_start=`` plumbing.

    `timeseries=True` attaches an `obs.timeseries.SeriesStore` on the
    service clock, sampled from `pump()`, so ``service.store.query(...)``
    answers over history. `lanes` (True / `obs.lanes.LaneConfig` knobs
    mapping / a `LaneObservatory`) journals a ``lane_decision`` per
    resolved solve and runs budgeted shadow-lane probes from `pump()`.

    `perf=True` attaches an `obs.perf.PerfProbe` on the service clock as
    ``engine.perf``: every chunk gets phase-attributed wall time and every
    segment call first-call (cold / hit) telemetry. `capacity` (True / a
    mapping of `obs.capacity.CapacityObservatory` knobs / an observatory)
    attaches the capacity observatory, ticked from `pump()`: the measured
    service laws, the fleet twin, the ``capacity_headroom_ratio`` and
    ``fleet_desired_shards`` gauges; it implies a `SeriesStore`.

    Each of these planes only reads; the answers are bitwise those
    without them."""
    from ..runtime.adaptive import make_dense_engine

    remedy_engine = None
    if remedy is not None:
        from ..runtime.remedy import as_remedy

        rkw = dict(solver_kw)
        rkw.setdefault("max_iter", 60)
        remedy_engine = as_remedy(
            remedy, solver_kw=rkw, entry="serve_dense", clock=clock
        )
    engine = make_dense_engine(
        bucket, chunk_iters=chunk_iters, trace=trace, remedy=remedy_engine,
        warm_predictor=warm_model, conformance=conformance, device=device,
        **solver_kw
    )
    if engine.conformance is not None:
        engine.conformance.seed_metrics("serve_dense")
    if perf:
        from ..obs.perf import PerfProbe

        # on the service clock: deadlines, journeys and phases share it
        engine.perf = PerfProbe(clock=clock, device=device)
    cache = ResultCache(cache_size) if cache_size else None
    store = None
    capacity_on = capacity is not None and capacity is not False
    if timeseries or capacity_on:
        from ..obs.timeseries import SeriesStore

        store = SeriesStore(clock=clock)
    observatory = None
    if capacity_on:
        from ..obs.capacity import as_capacity

        observatory = as_capacity(
            capacity, store=store, lanes_per_shard=bucket, shards=1,
            queue_limit=queue_limit, clock=clock,
        )
    return DispatchService(
        engine, queue_limit=queue_limit, cache=cache, clock=clock,
        reqtrace=reqtrace, store=store, capacity=observatory, lanes=lanes,
        lane="dense",
    )
