"""Sharded serving fleet: N crash-domain `SlotEngine` shards + a router
(port of `dispatches_tpu/serve/fleet.py`).

`FleetService` is the multi-engine sibling of `DispatchService`: the
same submit/pump/drain/start/stop surface and ticket contract, but the
engines live in child processes (`serve.shard.ShardProcess`), one per
card where the host has enough (`serve.shard.shard_device_env`) and all
on ``cuda:0`` otherwise, each child with its own CUDA context. A crash
takes down one shard, and the fleet's supervision loop turns it into a
respawn plus a requeue instead of an outage.

Per `pump()` cycle (deterministic, lock-held, fake-clock friendly for
everything except process liveness, which runs on the real clock):

1. expire still-queued requests past their deadline;
2. harvest result frames from every shard and resolve tickets (results
   are classified by `obs.health.classify_solution`, cached, and remain
   BITWISE identical to the single-engine service at the same bucket —
   the shard child builds its engine through the same
   `make_dense_engine` and arrays cross the pipe as raw bytes);
3. supervise: heartbeat-ping every shard; a dead process (exit, kill)
   or a wedged one (pings unanswered past ``heartbeat_timeout``) is
   killed, its in-flight lanes are requeued (``requeued_lanes_total``)
   — a requeued lane re-solves from iteration 0, so the bitwise
   contract holds across the crash — and its respawn is scheduled with
   bounded exponential backoff (``shard_respawn_total``); stable uptime
   resets the backoff;
4. dispatch: pop the `FairQueue` (weighted deficit-round-robin across
   tenants, token-bucket rate limits -> ``shed_tenant_quota``), route
   with `serve.router.Router` (queue depth, priority class, fingerprint
   affinity), and send lanes to shards up to each shard's bucket;
5. enforce in-flight deadlines (cross-process lanes are cancelled and
   resolved without a best iterate — the iterate lives in the child).

Zero lost requests is the contract the loadgen chaos leg
(`tools/torch_loadgen.py --shards N --kill-shard`) proves: every ticket
resolves complete / shed / deadline_exceeded across an induced shard
kill. See docs/serving.md "Fleet & crash domains".

The parent's remediation ladder re-solves on the fleet's `device`. The
time-series store and alert manager (``timeseries=``, ``store=``,
``alert_rules=``, ``slo_fn=``), the lane observatory and its routing
policies (``lanes=``, ``lane_policy=``, ``lane_model=``) and learned warm
starts (``warm_model=``) and the capacity plane (``capacity=``,
`obs.capacity`: the measured service laws, the fleet twin, per-shard
``capacity_headroom_ratio``, ``fleet_desired_shards``) are opt-in and
leave the answers bitwise as they are.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..obs import health as obs_health
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import reqtrace as obs_reqtrace
from ..obs.journal import get_tracer
from ..runtime.adaptive import _host_row
from ..runtime.remedy import REMEDIABLE, as_remedy
from .cache import ResultCache
from .queue import FairQueue, TenantConfig
from .request import SolveResult, SolveRequest, Ticket, priority_name, priority_value
from .router import Router
from .service import LATENCY_BUCKETS, device_key
from .shard import ShardProcess, decode_row, shard_device_env

obs_metrics.describe(
    "serve_shard_up",
    "Per-shard liveness gauge: 1 while the shard process serves, 0 while "
    "it is down awaiting respawn.",
)
obs_metrics.describe(
    "shard_respawn_total", "Shard child processes respawned after a crash "
    "or heartbeat-timeout kill.",
)
obs_metrics.describe(
    "requeued_lanes_total",
    "In-flight lanes handed back to the queue by a crashed/wedged shard "
    "(each re-solves from iteration 0 on another shard).",
)
obs_metrics.describe(
    "serve_tenant_shed_total",
    "Requests refused at admission by a tenant's token-bucket rate limit.",
)
obs_metrics.describe(
    "serve_shard_inflight", "Lanes currently dispatched to each shard.",
)
obs_metrics.describe(
    "serve_shard_ping_seconds",
    "Heartbeat round-trip latency per shard (parent send to pong "
    "receipt); the tail of this histogram is the wedge-detection signal.",
)
obs_metrics.describe(
    "serve_shard_last_pong_age_seconds",
    "Seconds since each up shard last answered a heartbeat (real "
    "monotonic clock; ages approaching heartbeat_timeout mean a wedge).",
)
obs_metrics.describe(
    "serve_shard_requests_total",
    "Requests resolved per shard (the per-shard view of "
    "serve_requests_total{status=ok} in fleet mode).",
)
obs_metrics.describe(
    "serve_shard_latency_seconds",
    "End-to-end latency of requests resolved per shard.",
)
obs_metrics.describe(
    "shard_telemetry_frames_total",
    "Telemetry frames merged from shard children into the parent "
    "registry/journal.",
)
obs_metrics.describe(
    "shard_telemetry_errors_total",
    "Telemetry frames dropped because their snapshot failed to merge "
    "(malformed series/buckets).",
)
obs_metrics.describe(
    "poisoned_requests_total",
    "Requests quarantined as `poisoned`: their dispatches kept killing "
    "shards until the max_requeues cap, so the fleet stopped requeueing "
    "them instead of letting one request take every shard down in turn.",
)


class _ShardSlot:
    """Supervision state the fleet keeps per shard (the `ShardProcess`
    itself only knows about one spawn at a time)."""

    __slots__ = ("shard", "state", "respawn_at", "backoff", "respawns")

    def __init__(self, shard: ShardProcess):
        self.shard = shard
        self.state = "down"  # "up" | "down"; spawn() flips to up
        self.respawn_at = 0.0  # monotonic stamp when down
        self.backoff = 0.0  # next respawn delay; set by the fleet
        self.respawns = 0


class FleetService:
    def __init__(
        self,
        shards: List[ShardProcess],
        *,
        queue_limit: int = 256,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        default_tenant: TenantConfig = TenantConfig(),
        router: Optional[Router] = None,
        cache: Optional[ResultCache] = None,
        clock=time.monotonic,
        name: str = "serve_fleet",
        reqtrace: bool = False,
        heartbeat_every: float = 0.5,
        heartbeat_timeout: float = 5.0,
        respawn_backoff: float = 0.25,
        respawn_backoff_cap: float = 30.0,
        stable_after: float = 10.0,
        spawn: bool = True,
        max_requeues: int = 2,
        remedy=None,
        timeseries: bool = False,
        store=None,
        alert_rules=None,
        slo_fn=None,
        conformance=None,
        canary=None,
        capacity=None,
        lanes=None,
        lane_policy=None,
        lane_model=None,
        device="cuda",
    ):
        if not shards:
            raise ValueError("a fleet needs at least one shard")
        self._slots = [_ShardSlot(s) for s in shards]
        self.queue = FairQueue(
            queue_limit, tenants=tenants, default=default_tenant
        )
        self.router = router or Router(clock=clock)
        self.cache = cache
        self.clock = clock
        self.name = name
        self.reqtrace = bool(reqtrace)
        self.heartbeat_every = float(heartbeat_every)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.respawn_backoff = float(respawn_backoff)
        self.respawn_backoff_cap = float(respawn_backoff_cap)
        self.stable_after = float(stable_after)
        # cache-key identity of the solves every shard runs (entry, bucket,
        # solver opt key, device) — same contract as DispatchService
        from ..runtime.adaptive import _opt_key

        ref = shards[0]
        self.device = torch.device(device)
        self._fp_serve = ("serve_dense", ref.bucket, _opt_key(ref.solver_kw),
                          device_key(self.device))
        # poison quarantine: a request may be crash-requeued at most this
        # many times before it resolves as `poisoned` instead of getting
        # yet another shard to kill (see _fail_shard)
        self.max_requeues = int(max_requeues)
        # parent-side remediation ladder (runtime/remedy.py): shard
        # children stay remedy-free — the parent owns the deadline clock
        # and the journal, so an unhealthy harvested row re-solves here
        self.remedy = as_remedy(
            remedy, solver_kw=ref.solver_kw, entry="serve_fleet",
            clock=clock,
        )
        # numerical conformance plane: shard children compute KKT
        # certificates at harvest and ship the four scalars in result
        # frames; the parent re-observes them here so the residual
        # histograms live in ONE registry. The canary scheduler
        # injects golden problems through the full submit->router->shard
        # path from pump() (re-entrant under self._lock).
        self.conformance = None
        if conformance is not None and conformance is not False:
            from ..obs.conformance import as_conformance

            self.conformance = as_conformance(conformance)
            self.conformance.seed_metrics(name)
        self.canary = None
        if canary is not None and canary is not False:
            from .canary import as_canary

            self.canary = as_canary(canary, clock=clock, service=self)
        # lane observatory: the parent owns every request's problem row,
        # so decision records, shadow-lane probes and scoreboards all run
        # parent-side (shard children stay lane-free); probes tick from
        # pump() after primary dispatch, never on the request path
        self.lanes = None
        if lanes is not None and lanes is not False:
            from ..obs.lanes import as_lanes

            self.lanes = as_lanes(
                lanes, clock=clock, conformance=self.conformance,
                solver_kw=ref.solver_kw,
            )
            self.lanes.seed_metrics(name, "dense")
        # opt-in advice consumption: "advice" routes fingerprint-affine
        # dispatches by the observatory's settled route_advice, "model"
        # consults the trained lane-portfolio artifact first and degrades
        # to the scoreboards; "static" and None never consult
        if lane_policy not in (None, "static", "advice", "model"):
            raise ValueError(
                f"unknown lane_policy {lane_policy!r} "
                "(expected None, 'static', 'advice', or 'model')"
            )
        self.lane_policy = lane_policy
        self.lane_model = None
        if lane_policy == "advice" and self.lanes is not None:
            self.router.advice_fn = self.lanes.advice
        elif lane_policy == "model":
            from ..learn.laneroute import LaneRouter, as_laneroute

            fb = self.lanes.advice if self.lanes is not None else None
            self.lane_model = (
                as_laneroute(lane_model, fallback=fb, device=self.device)
                or LaneRouter(fallback=fb)
            )
            self.router.advice_fn = self.lane_model.advice
        # time-series retention + alerting plane (off by default; it only
        # reads registry floats): pump() samples the store on the service
        # clock and evaluates the rule pack after every fresh sample; a
        # shard's down / respawn forces a sample so the flip is captured
        self.store = store
        self.alerts = None
        self._ts_force = False
        capacity_on = capacity is not None and capacity is not False
        if (timeseries or capacity_on) and self.store is None:
            from ..obs.timeseries import SeriesStore

            self.store = SeriesStore(clock=clock)
        if self.store is not None:
            from ..obs.alerts import AlertManager, default_fleet_rules

            rules = (
                default_fleet_rules(
                    queue_limit=queue_limit,
                    heartbeat_timeout=self.heartbeat_timeout,
                )
                if alert_rules is None
                else list(alert_rules)
            )
            if alert_rules is None and (
                self.conformance is not None or self.canary is not None
            ):
                from ..obs.conformance import default_conformance_rules

                rules = list(rules) + default_conformance_rules()
            if alert_rules is None and self.lanes is not None:
                from ..obs.lanes import default_lane_rules

                rules = list(rules) + default_lane_rules()
            self.alerts = AlertManager(
                self.store, rules, clock=clock, slo_fn=slo_fn
            )
            # zero-seed so the first poison produces a computable rate
            self.store._registry().inc("poisoned_requests_total", 0)
        # capacity observatory: the measured service laws and the fleet
        # twin, ticked from pump() after each fresh store sample; it reads
        # retained telemetry only
        self.capacity = None
        if capacity_on:
            from ..obs.capacity import as_capacity

            self.capacity = as_capacity(
                capacity, store=self.store, lanes_per_shard=ref.bucket,
                shards=len(shards), queue_limit=queue_limit, clock=clock,
                up_shards_fn=lambda: sum(1 for s in self._slots if s.state == "up"),
            )
        self._lock = threading.RLock()
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.completed = 0
        self.shed_total = 0
        self.deadline_total = 0
        self.respawn_total = 0
        self.requeued_total = 0
        self.poisoned_total = 0
        self.tenant_shed: Dict[str, int] = {}
        # per-shard completion tallies (the loadgen's per-shard rows)
        self.per_shard: Dict[int, Dict[str, float]] = {}
        self.telemetry_frames = 0
        self.telemetry_errors = 0
        if spawn:
            for slot in self._slots:
                self._spawn_slot(slot)

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
        tenant: str = "default",
        trace_ctx: Any = None,
        fault: Optional[str] = None,
    ) -> Ticket:
        """Queue one problem row; same contract as
        `DispatchService.submit` plus `tenant` (fairness/rate-limit id).
        A request over its tenant's token-bucket rate resolves
        synchronously with the ``shed_tenant_quota`` verdict. `fault` is
        the chaos hook: a payload riding the dispatch frame into the
        shard child (``"exit"`` kills the worker mid-dispatch) — the
        loadgen/test plumbing that exercises the poison quarantine."""
        now = self.clock()
        if deadline is None and timeout is not None:
            deadline = now + timeout
        req = SolveRequest(
            problem,
            priority=priority_value(priority),
            deadline=deadline,
            fingerprint=self._fingerprint(problem, fingerprint, options),
            request_id=request_id,
            tenant=tenant,
            fault=fault,
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
            admitted, shed, reason = self.queue.push(req, now=now)
            if shed is not None:
                if reason == "tenant_quota":
                    self._resolve_shed(
                        shed, verdict="shed_tenant_quota",
                        detail=f"tenant {shed.tenant!r} over rate limit",
                    )
                else:
                    self._resolve_shed(shed, detail=reason)
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        return ticket

    def _fp_options(self, options: Optional[Dict]) -> Dict:
        out = dict(options or {})
        out["_serve"] = self._fp_serve
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
        """One supervision + dispatch cycle; returns tickets resolved."""
        done = 0
        with self._lock:
            now = self.clock()
            for req in self.queue.remove_expired(now):
                if req.journey is not None:
                    req.journey.mark("dequeued", now)
                self._resolve_deadline(req)
                done += 1
            done += self._harvest()
            self._supervise()
            self._respawn_due()
            if self.canary is not None:
                # score last round's harvested probes, inject the next
                # when due; submit() re-enters self._lock (RLock), and
                # injecting before _dispatch puts fresh probes on a
                # shard this same cycle
                self.canary.tick(now)
            self._dispatch(self.clock())
            done += self._enforce_inflight_deadlines()
            if self.lanes is not None:
                # shadow-lane probes at batch priority: after this cycle's
                # primary dispatch and harvests
                self.lanes.tick(self.clock())
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
            mono = time.monotonic()
            for slot in self._slots:
                obs_metrics.set_gauge(
                    "serve_shard_inflight", slot.shard.inflight(),
                    shard=str(slot.shard.shard_id),
                )
                if slot.state == "up" and slot.shard.last_pong:
                    obs_metrics.set_gauge(
                        "serve_shard_last_pong_age_seconds",
                        max(0.0, mono - slot.shard.last_pong),
                        shard=str(slot.shard.shard_id),
                    )
            if self.store is not None:
                t = self.clock()
                sampled = (
                    self.store.sample(t) if self._ts_force
                    else self.store.maybe_sample(t)
                )
                self._ts_force = False
                if sampled and self.alerts is not None:
                    self.alerts.evaluate(t)
                if sampled and self.capacity is not None:
                    self.capacity.tick(t)
        return done

    def _harvest(self) -> int:
        """Resolve every result frame that arrived since the last cycle.
        Runs BEFORE supervision on purpose: a lane whose answer landed
        just ahead of its shard's crash must resolve, not re-solve."""
        done = 0
        for slot in self._slots:
            for msg in slot.shard.poll():
                if msg.get("op") == "telemetry":
                    self._merge_telemetry(slot, msg)
                    continue
                req = slot.shard.lanes.pop(msg.get("lane"), None)
                if req is None:
                    continue  # already expired/requeued; ticket is done
                row = decode_row(msg["row"])
                self._resolve_solved(
                    req, row, msg.get("iterations"),
                    shard=slot.shard.shard_id, child_slot=msg.get("slot"),
                    journey=msg.get("journey"),
                    warm_attrs={
                        k: msg[k]
                        for k in ("warm_source", "warm_accepted") if k in msg
                    },
                    conformance=msg.get("conformance"),
                )
                done += 1
        return done

    def _merge_telemetry(self, slot: _ShardSlot, msg: dict) -> None:
        """Fold one child telemetry frame into the parent's registry and
        journal. Metric deltas merge under a ``shard`` label AND into the
        label-free aggregate (`MetricsRegistry.merge`), so fleet totals
        equal the sum of per-shard series by construction; journal
        records re-emit verbatim with shard provenance. A malformed
        frame is counted and dropped — telemetry must never take the
        pump loop down."""
        shard_id = slot.shard.shard_id
        try:
            obs_metrics.get_registry().merge(
                msg.get("metrics") or {}, shard=str(shard_id)
            )
        except Exception as e:
            self.telemetry_errors += 1
            obs_metrics.inc(
                "shard_telemetry_errors_total", shard=str(shard_id)
            )
            get_tracer().event(
                "shard_telemetry_error", shard=shard_id,
                error=f"{type(e).__name__}: {e}"[:300],
            )
            return
        self.telemetry_frames += 1
        obs_metrics.inc("shard_telemetry_frames_total", shard=str(shard_id))
        emit = getattr(get_tracer(), "_emit", None)
        if emit is not None:
            for rec in msg.get("journal") or ():
                if isinstance(rec, dict):
                    rec.setdefault("shard", shard_id)
                    rec["forwarded"] = True
                    emit(rec)

    def _supervise(self) -> None:
        mono = time.monotonic()
        for slot in self._slots:
            if slot.state != "up":
                continue
            shard = slot.shard
            if not shard.alive():
                self._fail_shard(
                    slot, reason="exited", exit_code=shard.exit_code(),
                )
            elif shard.wedged(self.heartbeat_timeout):
                self._fail_shard(slot, reason="heartbeat_timeout")
            else:
                # re-ping only once the previous ping was answered — an
                # outstanding ping's stamp is the wedge timer, and
                # re-stamping it would reset the timeout forever
                answered = (
                    shard.last_ping is None
                    or shard.last_pong >= shard.last_ping
                )
                if answered and (
                    shard.last_ping is None
                    or mono - shard.last_ping >= self.heartbeat_every
                ):
                    shard.ping()
                if (
                    slot.backoff != self.respawn_backoff
                    and mono - shard.spawned_at >= self.stable_after
                ):
                    slot.backoff = self.respawn_backoff  # earned its reset

    def _fail_shard(self, slot: _ShardSlot, reason: str, exit_code=None) -> None:
        """Down a shard: requeue its in-flight lanes, schedule the
        respawn with the current backoff, double the backoff (capped).

        The crash is attributed to every in-flight ticket: a request
        already crash-requeued `max_requeues` times is quarantined as
        ``poisoned`` instead of requeued — one poison payload must not
        get to kill every respawn in turn."""
        shard = slot.shard
        inflight = list(shard.lanes.values())
        shard.lanes.clear()
        shard.kill()
        n = 0
        for req in inflight:
            if req.requeues >= self.max_requeues:
                self._resolve_poisoned(req, shard=shard.shard_id, reason=reason)
                continue
            self.queue.requeue(req)  # increments req.requeues
            n += 1
        if n:
            self.requeued_total += n
            obs_metrics.inc(
                "requeued_lanes_total", n, shard=str(shard.shard_id)
            )
        self.router.forget_shard(shard.shard_id)
        slot.state = "down"
        slot.respawn_at = time.monotonic() + slot.backoff
        slot.backoff = min(slot.backoff * 2.0, self.respawn_backoff_cap)
        obs_metrics.set_gauge(
            "serve_shard_up", 0.0, shard=str(shard.shard_id)
        )
        get_tracer().event(
            "shard_down", shard=shard.shard_id, reason=reason,
            exit_code=exit_code, requeued_lanes=n,
            poisoned_lanes=len(inflight) - n,
            respawn_in_s=round(slot.respawn_at - time.monotonic(), 3),
        )
        self._ts_force = True  # the down gauge must reach the store now

    def _spawn_slot(self, slot: _ShardSlot) -> bool:
        try:
            slot.shard.spawn()
        except OSError as e:
            slot.respawn_at = time.monotonic() + max(slot.backoff, 0.05)
            slot.backoff = min(
                max(slot.backoff, self.respawn_backoff) * 2.0,
                self.respawn_backoff_cap,
            )
            get_tracer().event(
                "shard_spawn_failed", shard=slot.shard.shard_id,
                error=str(e)[:500],
            )
            return False
        slot.state = "up"
        if slot.backoff == 0.0:
            slot.backoff = self.respawn_backoff
        obs_metrics.set_gauge(
            "serve_shard_up", 1.0, shard=str(slot.shard.shard_id)
        )
        return True

    def _respawn_due(self) -> None:
        mono = time.monotonic()
        for slot in self._slots:
            if slot.state == "down" and mono >= slot.respawn_at:
                backoff_was = slot.backoff
                if self._spawn_slot(slot):
                    slot.respawns += 1
                    self.respawn_total += 1
                    obs_metrics.inc(
                        "shard_respawn_total",
                        shard=str(slot.shard.shard_id),
                    )
                    get_tracer().event(
                        "shard_respawn", shard=slot.shard.shard_id,
                        respawn=slot.respawns, backoff_s=backoff_was,
                    )
                    self._ts_force = True  # capture the up flip promptly

    def _dispatch(self, now: float) -> None:
        up = [s.shard for s in self._slots if s.state == "up"]
        while len(self.queue):
            if not any(s.inflight() < s.bucket for s in up):
                return  # all lanes busy (or no shard up): stay queued
            req = self.queue.pop()
            shard = self.router.pick(req, up)
            if shard is None:  # raced to capacity; put it back
                self.queue.requeue(req)
                req.requeues -= 1  # not a crash requeue; keep the count honest
                return
            if not shard.solve(req.seq, req):
                # pipe already dead: supervision will down the shard next
                # cycle; the request goes straight back to the queue
                self.queue.requeue(req)
                req.requeues -= 1
                return
            req.started_at = now
            if req.journey is not None:
                req.journey.mark("slot", now)
                req.journey.shard = shard.shard_id
            self.router.note_dispatch(req, shard)

    def _enforce_inflight_deadlines(self) -> int:
        done = 0
        now = self.clock()
        for slot in self._slots:
            shard = slot.shard
            for lane, req in list(shard.lanes.items()):
                if req.expired(now):
                    shard.cancel(lane)
                    self._resolve_deadline(req, inflight=True)
                    done += 1
        return done

    def drain(
        self, max_cycles: int = 100_000, timeout: Optional[float] = None
    ) -> int:
        """Pump until nothing is queued or in flight. With `timeout`
        (real seconds), a drain still busy at the deadline sheds every
        queued ticket (``detail="drain_timeout"``) and resolves in-flight
        lanes as ``deadline_exceeded`` (no best iterate crosses the
        process boundary) instead of blocking on a wedged shard."""
        t0 = time.monotonic()
        total = 0
        for _ in range(max_cycles):
            with self._lock:
                busy = len(self.queue) or self._inflight()
            if not busy:
                return total
            if timeout is not None and time.monotonic() - t0 >= timeout:
                return total + self._drain_expire()
            n = self.pump()
            total += n
            if not n:
                time.sleep(0.002)  # real time: child solves take real time
        raise RuntimeError(f"drain did not converge in {max_cycles} cycles")

    def _drain_expire(self) -> int:
        done = 0
        with self._lock:
            for req in self.queue.pop_all():
                if req.journey is not None:
                    req.journey.mark("dequeued")
                self._resolve_shed(req, detail="drain_timeout")
                done += 1
            for slot in self._slots:
                for lane, req in list(slot.shard.lanes.items()):
                    slot.shard.cancel(lane)
                    self._resolve_deadline(req, inflight=True)
                    done += 1
            obs_metrics.set_gauge("serve_queue_depth", len(self.queue))
        return done

    def _inflight(self) -> int:
        return sum(slot.shard.inflight() for slot in self._slots)

    # -- background mode -----------------------------------------------
    def start(self, idle_sleep: float = 0.002) -> None:
        if self._thread is not None:
            raise RuntimeError("fleet already started")
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.is_set():
                self.pump()  # supervision must run even when idle
                self._stop_evt.wait(idle_sleep)

        self._thread = threading.Thread(
            target=_loop, name="fleet-serve", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        if self._thread is None:
            return
        if drain:
            t0 = time.monotonic()
            while True:
                with self._lock:
                    busy = len(self.queue) or self._inflight()
                if not busy:
                    break
                if timeout is not None and time.monotonic() - t0 >= timeout:
                    self._drain_expire()
                    break
                time.sleep(0.002)
        self._stop_evt.set()
        self._thread.join()
        self._thread = None

    def close(self) -> None:
        """Tear the fleet down: stop the pump thread and kill every
        shard. Outstanding tickets are shed (never leaked)."""
        self.stop(drain=False)
        with self._lock:
            self._drain_expire()
            for slot in self._slots:
                slot.state = "down"
                slot.shard.kill()
                obs_metrics.set_gauge(
                    "serve_shard_up", 0.0, shard=str(slot.shard.shard_id)
                )

    # -- chaos hooks (tests + tools/loadgen.py --kill-shard) -----------
    def kill_shard(self, shard_id: int) -> None:
        """SIGKILL a shard's child process WITHOUT telling the fleet —
        exactly what a real crash looks like; supervision must notice,
        requeue, and respawn on its own."""
        for slot in self._slots:
            if slot.shard.shard_id == shard_id and slot.shard.proc is not None:
                slot.shard.proc.kill()
                return
        raise ValueError(f"no running shard {shard_id}")

    def inject_fault(self, shard_id: int, mode: str) -> None:
        """Forward a fault op (``exit``/``hang``/``nan``) to a shard."""
        for slot in self._slots:
            if slot.shard.shard_id == shard_id:
                slot.shard.inject_fault(mode)
                return
        raise ValueError(f"no shard {shard_id}")

    def shard_states(self) -> Dict[int, dict]:
        with self._lock:
            return {
                slot.shard.shard_id: {
                    "state": slot.state,
                    "inflight": slot.shard.inflight(),
                    "respawns": slot.respawns,
                    "spawn_count": slot.shard.spawn_count,
                    "backoff_s": slot.backoff,
                }
                for slot in self._slots
            }

    def health(self) -> dict:
        """Liveness summary for the `/healthz` endpoint: overall ``ok``
        is False while ANY shard is down (crashed, wedge-killed, or
        backing off before its respawn) — the exporter maps that to a
        non-200 so an external prober sees a degraded fleet the same
        cycle supervision does. Ages are on the real monotonic clock,
        the same one supervision runs on."""
        with self._lock:
            mono = time.monotonic()
            shards: Dict[str, dict] = {}
            ok = True
            for slot in self._slots:
                sh = slot.shard
                up = slot.state == "up"
                entry: Dict[str, Any] = {
                    "up": up,
                    "inflight": sh.inflight(),
                    "respawns": slot.respawns,
                    "backoff_s": slot.backoff,
                    "last_pong_age_s": (
                        round(max(0.0, mono - sh.last_pong), 6)
                        if up and sh.last_pong else None
                    ),
                }
                if not up:
                    ok = False
                    entry["respawn_in_s"] = round(
                        max(0.0, slot.respawn_at - mono), 6
                    )
                shards[str(sh.shard_id)] = entry
            return {
                "ok": ok,
                "queue_depth": len(self.queue),
                "inflight": self._inflight(),
                "shards": shards,
            }

    # -- completions ---------------------------------------------------
    def _finish_extra(self, req) -> dict:
        return {"requeues": req.requeues} if req.requeues else {}

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

    def _resolve_solved(
        self, req, row, iterations, *, shard: int, child_slot, journey=None,
        warm_attrs=None, conformance=None,
    ) -> None:
        self.completed += 1
        now = self.clock()
        latency = now - req.submitted_at
        ps = self.per_shard.setdefault(
            int(shard), {"completed": 0, "latency_sum": 0.0, "iterations": 0}
        )
        ps["completed"] += 1
        ps["latency_sum"] += latency
        ps["iterations"] += int(iterations or 0)
        obs_metrics.inc("serve_shard_requests_total", shard=str(shard))
        obs_metrics.observe(
            "serve_shard_latency_seconds", latency, buckets=LATENCY_BUCKETS,
            shard=str(shard),
        )
        verdicts = obs_health.classify_solution(row)
        verdict = verdicts[0].verdict if verdicts else "healthy"
        rinfo = None
        if self.remedy is not None and verdict in REMEDIABLE:
            # parent-side ladder: the child's row came back unhealthy, so
            # re-solve here where the deadline clock and journal live.
            # `budget` is the shard engines' shared iteration cap.
            row, rinfo = self.remedy.remediate_solution_row(
                _on_device(req.problem, self.device), row,
                budget=self._slots[0].shard.solver_kw.get("max_iter", 60),
                deadline=req.deadline, request_id=req.request_id,
            )
            if rinfo is not None:
                row = _host_row(row)
                verdict = rinfo["verdict"]
        conf = None
        if self.conformance is not None:
            from ..obs.conformance import escalate_verdict

            if rinfo is not None:
                # the parent ladder re-solved this row, so the child's
                # certificates describe a superseded solution — re-check
                # the row callers actually receive
                conf = self.conformance.check_row(
                    req.problem, row, entry=self.name
                )
            elif conformance is not None:
                # re-observe the child-computed certificates parent-side
                # so the accuracy alert pack and retained residual
                # tracks see them in this registry
                conf = self.conformance.note(conformance, entry=self.name)
            verdict = escalate_verdict(verdict, conf)
        result = SolveResult(
            solution=row,
            verdict=verdict,
            iterations=iterations,
            latency=latency,
            request_id=req.request_id,
        )
        if self.cache is not None and verdict in ("healthy", "slow"):
            # ladder-exhausted (`unrecoverable`) and conformance-failed
            # (`inaccurate`) rows never enter the cache: a bad answer
            # must not become a future cache hit
            self.cache.put(req.fingerprint, result)
        status = (
            verdict if verdict in ("unrecoverable", "inaccurate") else "ok"
        )
        obs_metrics.inc("serve_requests_total", status=status)
        obs_metrics.observe(
            "serve_latency_seconds", latency, buckets=LATENCY_BUCKETS,
            status=status,
        )
        extra = {"remediation": rinfo} if rinfo is not None else {}
        if conf is not None:
            extra["conformance"] = conf
        get_tracer().solve_event(
            self.name, row,
            request_id=req.request_id, seq=req.seq,
            latency_s=latency, iterations=iterations, shard=shard,
            lane="dense",
            **(warm_attrs or {}), **extra,
        )
        if self.lanes is not None:
            # parent-side decision record: the fleet's shard engines are
            # all dense; the wall is the end-to-end latency (the prober
            # re-measures both lanes before scoring)
            self.lanes.note_solve(
                req.problem, "dense", entry=self.name, wall=latency,
                iterations=iterations, verdict=verdict,
            )
        if req.journey is not None:
            # started_at re-stamps on every dispatch, so a requeued
            # lane's marks cover only the attempt that answered
            start = req.started_at
            if start is None:
                start = req.journey.marks.get("slot", now)
            marks = (journey or {}).get("marks") or {}
            if marks.get("compute_end") is not None:
                # shard-aware attribution: the child's chunk-loop marks
                # arrive as seconds relative to ITS receipt of the solve
                # op; re-anchor them on the dispatch stamp and clamp to
                # arrival so the boundary order (and the exact phase-sum
                # contract) survives clock domains — including a fake
                # service clock, where everything clamps to `now` and
                # respond_s absorbs the whole segment
                def _at(rel) -> float:
                    return min(start + float(rel), now)

                if "first_chunk" in marks:
                    req.journey.mark("first_chunk", _at(marks["first_chunk"]))
                for c in (journey or {}).get("chunks") or ():
                    try:
                        r0, r1, it0, it1, cslot = c
                    except (TypeError, ValueError):
                        continue
                    req.journey.note_chunk(
                        _at(r0), _at(r1), int(it0), int(it1), int(cslot),
                        shard=shard,
                    )
                req.journey.marks["compute_end"] = _at(marks["compute_end"])
                if "harvest_end" in marks:
                    req.journey.mark("harvest_end", _at(marks["harvest_end"]))
            else:
                # child ran without --reqtrace: one cross-process segment,
                # dispatch -> result arrival (pipe transfer is honestly
                # part of compute)
                req.journey.note_chunk(
                    start, now, 0, int(iterations or 0),
                    int(child_slot) if child_slot is not None else -1,
                    shard=shard,
                )
                req.journey.marks["compute_end"] = now
            req.journey.shard = int(shard)
            req.journey.finish(
                "complete", verdict=verdict, iterations=iterations,
                now=now, **self._finish_extra(req),
            )
        req.ticket._complete(result)

    def _resolve_deadline(self, req, inflight: bool = False) -> None:
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
            "deadline passed mid-solve on a shard; iterate stays in the child"
            if inflight
            else "deadline passed before dispatch; no iterate"
        )
        get_tracer().event(
            "serve_deadline", verdict="deadline_exceeded",
            request_id=req.request_id, seq=req.seq, detail=detail,
        )
        obs_health.note_verdicts({"deadline_exceeded": 1}, solve=self.name)
        if req.journey is not None:
            req.journey.finish(
                "deadline_exceeded", verdict="deadline_exceeded",
                now=now, best_iterate=False, **self._finish_extra(req),
            )
        req.ticket._complete(SolveResult(
            solution=None,
            verdict="deadline_exceeded",
            latency=latency,
            request_id=req.request_id,
        ))

    def _resolve_shed(
        self, req, verdict: str = "shed", detail: Optional[str] = None
    ) -> None:
        self.completed += 1
        self.shed_total += 1
        now = self.clock()
        latency = now - req.submitted_at
        obs_metrics.inc("serve_requests_total", status=verdict)
        obs_metrics.inc("serve_shed_total")
        if verdict == "shed_tenant_quota":
            self.tenant_shed[req.tenant] = (
                self.tenant_shed.get(req.tenant, 0) + 1
            )
            obs_metrics.inc("serve_tenant_shed_total", tenant=req.tenant)
        extra = {} if detail is None else {"detail": detail}
        get_tracer().event(
            "serve_shed", verdict=verdict,
            request_id=req.request_id, seq=req.seq, priority=req.priority,
            tenant=req.tenant, **extra,
        )
        obs_health.note_verdicts({verdict: 1}, solve=self.name)
        if req.journey is not None:
            if "enqueued" in req.journey.marks:
                req.journey.mark("dequeued", now)
            req.journey.finish(
                "shed", verdict=verdict, now=now, **self._finish_extra(req),
            )
        req.ticket._complete(SolveResult(
            solution=None,
            verdict=verdict,
            latency=latency,
            request_id=req.request_id,
        ))

    def _resolve_poisoned(self, req, *, shard: int, reason: str) -> None:
        """Quarantine one request whose dispatches keep downing shards:
        it resolves as ``poisoned`` (no solution — its iterate died with
        the shard every time) instead of going back to the queue. A
        flight-recorder capture keeps the problem for offline triage."""
        self.completed += 1
        self.poisoned_total += 1
        now = self.clock()
        latency = now - req.submitted_at
        obs_metrics.inc("serve_requests_total", status="poisoned")
        obs_metrics.inc("poisoned_requests_total")
        detail = (
            f"quarantined after {req.requeues} crash requeues "
            f"(max_requeues={self.max_requeues}); last shard {shard} "
            f"down: {reason}"
        )
        get_tracer().event(
            "serve_poisoned", verdict="poisoned",
            request_id=req.request_id, seq=req.seq, tenant=req.tenant,
            shard=shard, requeues=req.requeues, detail=detail,
        )
        obs_health.note_verdicts({"poisoned": 1}, solve=self.name)
        obs_recorder.maybe_capture(
            self.name,
            verdict=obs_health.Verdict("poisoned", None, None, detail),
            problem=req.problem,
            extra={"request_id": req.request_id, "requeues": req.requeues},
        )
        if req.journey is not None:
            req.journey.finish(
                "poisoned", verdict="poisoned", now=now,
                **self._finish_extra(req),
            )
        req.ticket._complete(SolveResult(
            solution=None,
            verdict="poisoned",
            latency=latency,
            request_id=req.request_id,
        ))

    # -- introspection -------------------------------------------------
    def conformance_report(self) -> dict:
        """The exporter's ``/conformance`` payload: the checker's
        aggregate (policy, outcome counts, worst certificates per entry)
        plus the canary scheduler's per-golden last scores. Empty when
        the plane is off."""
        out: dict = {}
        with self._lock:
            if self.conformance is not None:
                out["conformance"] = self.conformance.report()
            if self.canary is not None:
                out["canary"] = self.canary.report()
        return out

    def capacity_report(self) -> dict:
        """The exporter's ``/capacity`` payload: the measured service
        laws, the twin's validation and knee, the breach forecast and the
        damped shard recommendation. Empty when the plane is off."""
        with self._lock:
            if self.capacity is None:
                return {}
            return self.capacity.report()

    def lane_report(self) -> dict:
        """The exporter's ``/lanes`` payload: the lane observatory's
        scoreboards and route advice. Empty when the plane is off."""
        with self._lock:
            if self.lanes is None:
                return {}
            return self.lanes.report()

    def stats(self) -> dict:
        with self._lock:
            out = {
                "queue_depth": len(self.queue),
                "inflight": self._inflight(),
                "shards": self.shard_states(),
                "completed": self.completed,
                "shed": self.shed_total,
                "deadline_exceeded": self.deadline_total,
                "respawns": self.respawn_total,
                "requeued_lanes": self.requeued_total,
                "poisoned": self.poisoned_total,
                "tenant_shed": dict(self.tenant_shed),
                "telemetry_frames": self.telemetry_frames,
                "telemetry_errors": self.telemetry_errors,
                "per_shard": {
                    str(k): {
                        "completed": int(v["completed"]),
                        "iterations": int(v["iterations"]),
                        "latency_mean": (
                            v["latency_sum"] / v["completed"]
                            if v["completed"] else None
                        ),
                        "latency_p95": obs_metrics.histogram_quantile(
                            "serve_shard_latency_seconds", 0.95, shard=str(k)
                        ),
                        "ping_p95": obs_metrics.histogram_quantile(
                            "serve_shard_ping_seconds", 0.95, shard=str(k)
                        ),
                    }
                    for k, v in sorted(self.per_shard.items())
                },
            }
            if self.cache is not None:
                out["cache"] = self.cache.stats()
            if self.conformance is not None:
                out["conformance"] = self.conformance.report()
            if self.canary is not None:
                out["canary"] = self.canary.report()
            if self.store is not None:
                out["timeseries"] = self.store.stats()
            if self.alerts is not None:
                out["alerts_firing"] = self.alerts.firing()
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


def _on_device(problem, device):
    """A problem row (arrays or tensors) as tensors on `device`."""
    return type(problem)(*(torch.as_tensor(a, device=device) for a in problem))


def make_dense_fleet(
    n_shards: int,
    bucket: int,
    *,
    chunk_iters: int = 8,
    queue_limit: int = 256,
    cache_size: Optional[int] = 256,
    tenants: Optional[Dict[str, TenantConfig]] = None,
    clock=time.monotonic,
    reqtrace: bool = False,
    telemetry: bool = False,
    timeseries: bool = False,
    stderr_dir: Optional[str] = None,
    spawn: bool = True,
    warm_model: Optional[str] = None,
    conformance=None,
    canary=None,
    capacity=None,
    lanes=None,
    lane_policy=None,
    lane_model=None,
    device="cuda",
    **fleet_kw,
) -> FleetService:
    """A `FleetService` of `n_shards` dense-LP shard processes, each
    running `make_dense_engine(bucket, ...)` with identical solver
    options. On the card (the default `device`) shard i runs on ``cuda:i``
    when the host has enough cards, and every shard shares ``cuda:0``
    otherwise (`serve.shard.shard_device_env`); ``device="cpu"`` puts
    every child on the CPU. `fleet_kw` passes through to `FleetService`
    (heartbeats, backoff, tenants, the ``max_requeues`` poison cap, the
    ``remedy=`` ladder, which re-solves in this process on `device`...);
    solver options ride ``fleet_kw.pop('solver_kw')``.
    ``telemetry=True`` spawns children with ``--telemetry`` (metrics and
    journal deltas ride the heartbeat back into the parent registry);
    ``reqtrace=True`` makes children attach chunk-loop journey marks to
    result frames; ``conformance`` (True / a `ConformancePolicy` / a
    mapping of bounds) spawns children with ``--conformance`` (each shard
    engine certifies its rows, the parent re-observes the certificates and
    escalates failures to ``inaccurate``); ``canary`` (a goldens ``.npz``
    path, a golden list, or a `serve.canary.CanaryScheduler`) injects
    certified golden problems through the router and shard path from
    ``pump()``. ``timeseries=True`` attaches an `obs.timeseries.SeriesStore`
    and the `obs.alerts.default_fleet_rules` pack, sampled and evaluated
    from ``pump()`` (``fleet.store.query(...)``, ``fleet.alerts.firing()``,
    the exporter's ``/query`` and ``/alerts``). `warm_model` (an artifact
    path from tools/torch_train_warmstart.py) makes every child seed its
    admitted lanes through the safeguarded learned warm start. ``lanes``
    (True / a mapping of `obs.lanes.LaneConfig` knobs / a
    `LaneObservatory`) journals a ``lane_decision`` per completed solve
    and re-solves a sampled fraction on the alternate IPM<->PDHG lane from
    ``pump()``; ``lane_policy="advice"`` lets the router's affinity stage
    consult its damped ``route_advice``, ``"model"`` the trained
    lane-portfolio artifact (``lane_model``) first. ``capacity`` (True / a
    mapping of `obs.capacity.CapacityObservatory` knobs / an observatory)
    attaches the capacity plane, ticked from ``pump()`` after each store
    sample (it implies a `SeriesStore`; ``fleet.capacity_report()`` is the
    exporter's ``/capacity``). All off by default and neutral for solve
    results."""
    import os

    from ..runtime.adaptive import _require_device

    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive (got {n_shards})")
    _require_device(device)  # before any child is spawned
    solver_kw = dict(fleet_kw.pop("solver_kw", None) or {})
    solver_kw.setdefault("max_iter", 60)
    device_envs = shard_device_env(n_shards, device)
    shards = [
        ShardProcess(
            i, bucket=bucket, chunk_iters=chunk_iters, solver_kw=solver_kw,
            device_env=device_envs[i],
            stderr_path=(
                os.path.join(stderr_dir, f"shard{i}.stderr.log")
                if stderr_dir else None
            ),
            telemetry=telemetry,
            reqtrace=reqtrace,
            warm_model=warm_model,
            conformance=conformance is not None and conformance is not False,
        )
        for i in range(n_shards)
    ]
    cache = ResultCache(cache_size) if cache_size else None
    return FleetService(
        shards, queue_limit=queue_limit, tenants=tenants, cache=cache,
        clock=clock, reqtrace=reqtrace, spawn=spawn, timeseries=timeseries,
        conformance=conformance, canary=canary, capacity=capacity, lanes=lanes,
        lane_policy=lane_policy, lane_model=lane_model, device=device,
        **fleet_kw,
    )
