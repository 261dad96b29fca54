"""Request-journey tracing for the serving tier (port of
`dispatches_tpu/obs/reqtrace.py`: pure Python, copied as it is).

The serving tier's latency histograms tell a p95, not *where* the time
went. This module attributes every request's wall clock to causal phases:

    admit -> queue_wait -> slot_admit -> chunk[k] segments
          -> harvest -> respond

with ``shed`` / ``deadline_exceeded`` / ``cache_hit`` terminal paths,
and stitches requests across process boundaries with a
W3C-traceparent-style :class:`TraceContext` (trace_id / span_id /
parent_span_id). Journeys land in the run journal as schema-v3
``journey`` records and feed three per-priority phase histograms:

- ``serve_queue_wait_seconds``  — admission queue residency
- ``serve_compute_seconds``    — engine residency (cold dispatch + chunks)
- ``serve_transfer_seconds``   — harvest device->host transfer

Design rules, same as the rest of `obs`:

- **Off by default, bitwise-neutral when off.** The service only builds
  journeys when constructed with ``reqtrace=True``; the `SlotEngine`
  observer hook is ``None`` otherwise and the chunk loop is untouched.
- **Host-side only.** Every stamp is a plain float from the *service
  clock* (injectable; `FakeClock` in tests), so phase durations sum to
  the reported request latency exactly — that sum is the contract, the
  individual stamps are best-effort under CUDA's asynchronous launches
  (device compute time is observed at the blocking ``done``-flag
  transfer).
- **Cheap.** A journey is one small object and a handful of dict writes
  per request; no device interaction, no extra synchronization (the
  service lock already covers every mutation).

Phase attribution walks ordered boundary marks; only boundaries that
were actually crossed produce a phase, and the trailing segment is
always ``respond_s``, so ``sum(phases) == latency_s`` for *every*
terminal (a cache hit is a single ``respond_s`` phase; a shed request
that never reached a slot has ``admit``/``queue_wait``/``respond``).
"""
from __future__ import annotations

import os
import re
import uuid
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

from . import metrics as obs_metrics

# Environment variable carrying a serialized TraceContext across process
# boundaries (callers of tools/torch_serve_dispatch.py; the JAX package
# reads the same name, so a traceparent crosses between the two).
# Parsed into the journal manifest by `journal.build_manifest`.
TRACEPARENT_ENV = "DISPATCHES_TPU_TRACEPARENT"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

#: Journey terminals (the ``terminal`` field of a journey record).
TERMINALS = ("complete", "cache_hit", "shed", "deadline_exceeded")

# Phase boundaries in causal order. Each entry is (phase_name, candidate
# boundary marks); the first present mark closes the phase. A journey
# only emits phases whose boundary was crossed; the segment from the
# last crossed boundary to `responded` is always `respond_s`.
_BOUNDARIES = (
    ("admit", ("enqueued",)),
    ("queue_wait", ("slot", "dequeued")),
    ("slot_admit", ("first_chunk",)),
    ("compute", ("compute_end",)),
    ("harvest", ("harvest_end",)),
)

# Finer-than-default buckets for the phase histograms: queue waits and
# transfers live in the sub-millisecond to low-seconds range.
PHASE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

obs_metrics.describe(
    "serve_queue_wait_seconds",
    "Request time spent in the admission queue, by priority class.",
)
obs_metrics.describe(
    "serve_compute_seconds",
    "Request engine residency (cold dispatch + chunk compute), by priority class.",
)
obs_metrics.describe(
    "serve_transfer_seconds",
    "Harvest device-to-host transfer time, by priority class.",
)


class TraceContext(NamedTuple):
    """W3C-traceparent-style identity: which distributed request journey
    a unit of work belongs to (`trace_id`), which span it is
    (`span_id`), and whose child it is (`parent_span_id`)."""

    trace_id: str                      # 32 lowercase hex chars
    span_id: str                       # 16 lowercase hex chars
    parent_span_id: Optional[str] = None

    @classmethod
    def new(cls) -> "TraceContext":
        """Fresh root context (no parent)."""
        return cls(uuid.uuid4().hex, uuid.uuid4().hex[:16], None)

    def child(self) -> "TraceContext":
        """New span in the same trace, parented on this one."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:16], self.span_id)

    def to_traceparent(self) -> str:
        """Serialize as a W3C ``traceparent`` header value
        (``00-{trace_id}-{span_id}-01``)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: Any) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` value; None on anything malformed
        (wrong length, non-hex, all-zero ids)."""
        if not isinstance(header, str):
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if not m:
            return None
        _, trace_id, span_id, _ = m.groups()
        if set(trace_id) == {"0"} or set(span_id) == {"0"}:
            return None
        return cls(trace_id, span_id, None)

    @classmethod
    def from_environ(cls, environ: Optional[Dict[str, str]] = None) -> Optional["TraceContext"]:
        """Context inherited from a parent process via `TRACEPARENT_ENV`."""
        env = os.environ if environ is None else environ
        return cls.from_traceparent(env.get(TRACEPARENT_ENV))


def coerce_context(value: Any) -> Optional[TraceContext]:
    """Accept a TraceContext or a traceparent string; None otherwise."""
    if isinstance(value, TraceContext):
        return value
    return TraceContext.from_traceparent(value)


class Journey:
    """Mutable per-request journey: boundary marks + chunk segments,
    finished exactly once into a schema-v3 ``journey`` journal record.

    All mutation happens under the owning service's lock with stamps
    from the service clock. `finish` is idempotent (first call wins) so
    racy terminal paths (deadline vs. solve) can't double-emit.
    """

    __slots__ = (
        "ctx", "request_id", "seq", "priority", "clock", "t0",
        "marks", "chunks", "slot", "shard", "terminal",
    )

    def __init__(
        self,
        ctx: TraceContext,
        *,
        clock: Callable[[], float],
        t0: float,
        request_id: Optional[str] = None,
        priority: str = "normal",
        seq: Optional[int] = None,
    ):
        self.ctx = ctx
        self.request_id = request_id
        self.seq = seq
        self.priority = str(priority)
        self.clock = clock
        self.t0 = float(t0)
        self.marks: Dict[str, float] = {}
        self.chunks: List[Dict[str, Any]] = []
        self.slot: Optional[int] = None
        self.shard: Optional[int] = None  # fleet-served requests only
        self.terminal: Optional[str] = None

    def mark(self, name: str, t: Optional[float] = None) -> None:
        """Stamp a boundary once (first stamp wins — boundaries are
        crossed once; re-stamps from retries must not rewrite history)."""
        if name not in self.marks:
            self.marks[name] = self.clock() if t is None else float(t)

    def note_chunk(
        self, t0: float, t1: float, it0: int, it1: int, slot: int,
        shard: Optional[int] = None,
    ) -> None:
        """Record one engine chunk segment this request participated in.
        `shard` names the fleet shard whose engine ran the segment (None
        for the in-process single-engine service)."""
        seg = {
            "t": float(t0), "t1": float(t1),
            "it0": int(it0), "it1": int(it1), "slot": int(slot),
        }
        if shard is not None:
            seg["shard"] = int(shard)
            self.shard = int(shard)
        self.chunks.append(seg)
        self.slot = int(slot)

    def phase_durations(self, responded: float) -> Dict[str, float]:
        """Walk the boundary order; consecutive crossed boundaries define
        phases, the tail is ``respond_s``. Sums to ``responded - t0``
        exactly by construction."""
        out: Dict[str, float] = {}
        prev = self.t0
        for phase, names in _BOUNDARIES:
            t = None
            for n in names:
                if n in self.marks:
                    t = self.marks[n]
                    break
            if t is not None:
                out[phase + "_s"] = t - prev
                prev = t
        out["respond_s"] = responded - prev
        return out

    def finish(
        self,
        terminal: str,
        *,
        verdict: Optional[str] = None,
        iterations: Optional[int] = None,
        now: Optional[float] = None,
        **extra: Any,
    ) -> Optional[Dict[str, Any]]:
        """Close the journey: compute phases, emit the journal record,
        feed the phase histograms. Returns the record (None if already
        finished). `now` should be the same stamp used for the request's
        reported latency so the two agree exactly."""
        if self.terminal is not None:
            return None
        self.terminal = str(terminal)
        responded = self.clock() if now is None else float(now)
        phases = self.phase_durations(responded)
        rec: Dict[str, Any] = {
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "parent_span_id": self.ctx.parent_span_id,
            "request_id": self.request_id,
            "seq": self.seq,
            "priority": self.priority,
            "terminal": self.terminal,
            "verdict": verdict,
            "iterations": iterations,
            "t0": self.t0,
            "latency_s": responded - self.t0,
            "phases": phases,
            "chunks": [
                {
                    "t": c["t"] - self.t0, "dur": c["t1"] - c["t"],
                    "it0": c["it0"], "it1": c["it1"], "slot": c["slot"],
                    **({"shard": c["shard"]} if "shard" in c else {}),
                }
                for c in self.chunks
            ],
            "slot": self.slot,
            "shard": self.shard,
        }
        rec.update(extra)
        from .journal import get_tracer  # lazy: journal imports us for the manifest

        get_tracer().journey(**rec)
        if "queue_wait_s" in phases:
            obs_metrics.observe(
                "serve_queue_wait_seconds", phases["queue_wait_s"],
                buckets=PHASE_BUCKETS, priority=self.priority,
            )
        compute = phases.get("slot_admit_s", 0.0) + phases.get("compute_s", 0.0)
        if "compute_s" in phases or "slot_admit_s" in phases:
            obs_metrics.observe(
                "serve_compute_seconds", compute,
                buckets=PHASE_BUCKETS, priority=self.priority,
            )
        if "harvest_s" in phases:
            obs_metrics.observe(
                "serve_transfer_seconds", phases["harvest_s"],
                buckets=PHASE_BUCKETS, priority=self.priority,
            )
        return rec


def start_journey(
    trace_ctx: Any,
    *,
    clock: Callable[[], float],
    t0: float,
    request_id: Optional[str] = None,
    priority: str = "normal",
) -> Journey:
    """Open a journey for a freshly submitted request. An incoming
    context (TraceContext or traceparent string) is child()-ed so the
    request's own span parents onto the caller's; otherwise a new root
    trace is started."""
    ctx = coerce_context(trace_ctx)
    ctx = ctx.child() if ctx is not None else TraceContext.new()
    return Journey(ctx, clock=clock, t0=t0, request_id=request_id, priority=priority)


class EngineJourneyObserver:
    """`SlotEngine.observer` implementation: stamps chunk-loop boundaries
    onto lane tokens' journeys. The engine invokes these synchronously
    from `step()` (under the service lock); `clock` is the service
    clock, so engine stamps and service stamps share one time base.

    Hooks (all no-ops for tokens without a `journey` attribute):

    - ``chunk_begin(tokens)``          — chunk wall start
    - ``cold_end(tokens, fresh)``      — after fresh-lane cold dispatch +
      scatter; stamps ``first_chunk`` on fresh lanes (slot_admit covers
      the cold-dispatch cost)
    - ``compute_end(tokens, it0, it1)`` — after the blocking done-flag
      transfer; records a chunk segment per active lane
    - ``harvest_end(tokens)``          — after the harvest row transfer
    """

    __slots__ = ("clock", "_t_chunk")

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self._t_chunk = 0.0

    def chunk_begin(self, tokens: Sequence[Any]) -> None:
        self._t_chunk = self.clock()

    def cold_end(self, tokens: Sequence[Any], fresh: Sequence[bool]) -> None:
        t = self.clock()
        for tok, f in zip(tokens, fresh):
            j = getattr(tok, "journey", None) if tok is not None else None
            if f and j is not None:
                j.mark("first_chunk", t)

    def compute_end(self, tokens: Sequence[Any], it0: Any, it1: Any) -> None:
        t = self.clock()
        for i, tok in enumerate(tokens):
            j = getattr(tok, "journey", None) if tok is not None else None
            if j is None:
                continue
            j.mark("first_chunk", self._t_chunk)
            start = self._t_chunk if j.chunks else j.marks["first_chunk"]
            j.note_chunk(start, t, int(it0[i]), int(it1[i]), i)
            j.marks["compute_end"] = t  # rolls forward every chunk

    def harvest_end(self, tokens: Sequence[Any]) -> None:
        t = self.clock()
        for tok in tokens:
            j = getattr(tok, "journey", None) if tok is not None else None
            if j is not None:
                j.mark("harvest_end", t)
