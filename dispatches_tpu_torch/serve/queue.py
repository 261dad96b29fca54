"""Bounded priority queues with load-shedding admission control.

Port of `dispatches_tpu/serve/queue.py`: pure Python, copied as it is.

`AdmissionQueue` (the single-engine service's queue): ordering is
``(priority, seq)`` — strict priority classes, FIFO within a class. When
the queue is full, admission control compares the newcomer against the
WORST pending request: a more-urgent newcomer displaces it (the
displaced request is shed — lowest priority goes first, per the
backpressure contract), an equal-or-less-urgent newcomer is itself
rejected. Either way exactly one request is shed and the bound holds.

`FairQueue` (the fleet's queue) adds per-tenant fairness on top of the
same per-tenant ordering: dispatch order across tenants is weighted
deficit round robin (each visit credits a tenant ``weight`` units; one
unit buys one dispatch, so long-run service is proportional to weight),
with interactive-class requests bypassing DRR entirely (strict priority
across tenants — fairness shapes throughput classes, not latency
classes). Tenants may also carry a token-bucket rate limit; a request
over quota is refused at the door with reason ``tenant_quota`` and the
fleet resolves it with the ``shed_tenant_quota`` verdict.

Kept as sorted lists: admission/shedding needs both ends plus arbitrary
removal (deadline expiry), and service queues are bounded-small by
design, so O(n) inserts beat heap bookkeeping for clarity.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

from .request import SolveRequest


class AdmissionQueue:
    def __init__(self, limit: int = 64):
        if limit <= 0:
            raise ValueError(f"queue limit must be positive (got {limit})")
        self.limit = int(limit)
        self._q: List[Tuple[tuple, SolveRequest]] = []

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return (req for _, req in self._q)

    def push(
        self, req: SolveRequest, now: Optional[float] = None
    ) -> Tuple[bool, Optional[SolveRequest]]:
        """Try to enqueue. Returns ``(admitted, shed)``: `shed` is the
        displaced lowest-priority request when the newcomer bumped one
        out, or `req` itself when it was rejected at the door. `now`
        stamps the admitted request's journey ``enqueued`` boundary (a
        rejected newcomer never entered the queue, so it gets none)."""
        if len(self._q) < self.limit:
            self._insort(req, now)
            return True, None
        worst_key, worst = self._q[-1]
        if req.sort_key() < worst_key:
            self._q.pop()
            self._insort(req, now)
            return True, worst
        return False, req

    def _insort(self, req: SolveRequest, now: Optional[float]) -> None:
        if req.journey is not None and now is not None:
            req.journey.mark("enqueued", now)
        bisect.insort(self._q, (req.sort_key(), req))

    def pop(self) -> Optional[SolveRequest]:
        """Most-urgent pending request, or None when empty."""
        if not self._q:
            return None
        return self._q.pop(0)[1]

    def remove_expired(self, now: float) -> List[SolveRequest]:
        """Pull out every pending request whose deadline has passed (they
        never reach a solver slot; the service resolves them as
        ``deadline_exceeded`` with no solution)."""
        expired = [(k, r) for k, r in self._q if r.expired(now)]
        if expired:
            self._q = [(k, r) for k, r in self._q if not r.expired(now)]
        return [r for _, r in expired]

    def pop_all(self) -> List[SolveRequest]:
        """Empty the queue, returning every pending request in dispatch
        order (the drain-timeout shed path)."""
        out = [r for _, r in self._q]
        self._q = []
        return out


# ---------------------------------------------------------------------------
# per-tenant fairness (the fleet's front queue)


class TenantConfig(NamedTuple):
    """Fairness knobs for one tenant id.

    `weight` scales the tenant's DRR credit per scheduling round (long-run
    dispatch share is weight-proportional under contention). `rate`/`burst`
    configure an optional token bucket in requests/second: None disables
    rate limiting for the tenant entirely."""

    weight: float = 1.0
    rate: Optional[float] = None
    burst: float = 8.0


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill toward `burst`; one
    request costs one token. Time is injected per call (the service owns
    the clock), so fake-clock tests drive it deterministically."""

    __slots__ = ("rate", "burst", "tokens", "stamped")

    def __init__(self, rate: float, burst: float = 8.0):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"token bucket wants positive rate/burst (got {rate}/{burst})"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamped: Optional[float] = None

    def allow(self, now: float) -> bool:
        if self.stamped is not None:
            self.tokens = min(
                self.burst, self.tokens + (now - self.stamped) * self.rate
            )
        self.stamped = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class FairQueue:
    """Bounded multi-tenant queue: per-tenant ``(priority, seq)`` sublists,
    weighted deficit-round-robin dispatch across tenants, optional
    per-tenant token-bucket admission, and the same displace-worst global
    backpressure contract as `AdmissionQueue`."""

    def __init__(
        self,
        limit: int = 64,
        *,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        default: TenantConfig = TenantConfig(),
    ):
        if limit <= 0:
            raise ValueError(f"queue limit must be positive (got {limit})")
        self.limit = int(limit)
        self._cfg: Dict[str, TenantConfig] = dict(tenants or {})
        for t, cfg in self._cfg.items():
            if cfg.weight <= 0:
                raise ValueError(f"tenant {t!r} weight must be positive")
        self._default = default
        self._sub: Dict[str, List[Tuple[tuple, SolveRequest]]] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._ring: List[str] = []  # DRR visit order over tenants with work
        self._deficit: Dict[str, float] = {}
        self._n = 0

    def config(self, tenant: str) -> TenantConfig:
        return self._cfg.get(tenant, self._default)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return (
            req for t in sorted(self._sub) for _, req in self._sub[t]
        )

    def push(
        self, req: SolveRequest, now: Optional[float] = None
    ) -> Tuple[bool, Optional[SolveRequest], Optional[str]]:
        """Try to enqueue. Returns ``(admitted, shed, reason)``:

        - admitted with nothing shed -> ``(True, None, None)``
        - over the tenant's token-bucket rate ->
          ``(False, req, "tenant_quota")`` (the fleet's
          ``shed_tenant_quota`` verdict)
        - queue full, newcomer displaced the globally-worst pending
          request -> ``(True, worst, "displaced")``
        - queue full, newcomer not more urgent -> ``(False, req,
          "rejected")``
        """
        cfg = self.config(req.tenant)
        if cfg.rate is not None and now is not None:
            bucket = self._buckets.get(req.tenant)
            if bucket is None:
                bucket = self._buckets[req.tenant] = TokenBucket(
                    cfg.rate, cfg.burst
                )
            if not bucket.allow(now):
                return False, req, "tenant_quota"
        if self._n < self.limit:
            self._insort(req, now)
            return True, None, None
        worst_tenant = max(
            (t for t, q in self._sub.items() if q),
            key=lambda t: self._sub[t][-1][0],
        )
        worst_key, worst = self._sub[worst_tenant][-1]
        if req.sort_key() < worst_key:
            self._sub[worst_tenant].pop()
            self._n -= 1
            self._insort(req, now)
            return True, worst, "displaced"
        return False, req, "rejected"

    def requeue(self, req: SolveRequest) -> None:
        """Put a previously dispatched request back (its shard crashed
        mid-solve). Bypasses the token bucket AND the queue bound — the
        request was already admitted once, and the zero-lost-work
        guarantee forbids shedding it here; the bound may transiently
        overshoot by up to one shard's in-flight lanes."""
        req.requeues += 1
        self._insort(req, None)

    def _insort(self, req: SolveRequest, now: Optional[float]) -> None:
        if req.journey is not None and now is not None:
            req.journey.mark("enqueued", now)
        sub = self._sub.get(req.tenant)
        if sub is None:
            sub = self._sub[req.tenant] = []
        if req.tenant not in self._ring:
            self._ring.append(req.tenant)
            self._deficit.setdefault(req.tenant, 0.0)
        bisect.insort(sub, (req.sort_key(), req))
        self._n += 1

    def pop(self) -> Optional[SolveRequest]:
        """Next request to dispatch, or None when empty.

        Interactive-class heads (priority 0) bypass DRR: the most urgent
        one across all tenants goes first. Everything else is weighted
        deficit round robin: visiting a tenant credits it `weight`; one
        credit buys one dispatch; an empty tenant leaves the ring and
        forfeits its credit (standard DRR, so idle tenants cannot bank
        unbounded burst)."""
        if self._n == 0:
            return None
        best = None
        for t, q in self._sub.items():
            if q and q[0][0][0] <= 0:
                if best is None or q[0][0] < best[0]:
                    best = (q[0][0], t)
        if best is not None:
            return self._take(best[1])
        while True:
            t = self._ring[0]
            q = self._sub.get(t)
            if not q:
                self._ring.pop(0)
                self._deficit[t] = 0.0
                continue
            if self._deficit[t] >= 1.0:
                self._deficit[t] -= 1.0
                return self._take(t)
            self._deficit[t] += self.config(t).weight
            self._ring.append(self._ring.pop(0))

    def _take(self, tenant: str) -> SolveRequest:
        req = self._sub[tenant].pop(0)[1]
        self._n -= 1
        return req

    def remove_expired(self, now: float) -> List[SolveRequest]:
        """Same contract as `AdmissionQueue.remove_expired`, across every
        tenant sublist."""
        out: List[SolveRequest] = []
        for t, q in self._sub.items():
            expired = [(k, r) for k, r in q if r.expired(now)]
            if expired:
                self._sub[t] = [(k, r) for k, r in q if not r.expired(now)]
                self._n -= len(expired)
                out.extend(r for _, r in expired)
        return out

    def pop_all(self) -> List[SolveRequest]:
        """Empty every tenant sublist (drain-timeout shed path)."""
        out = [r for t in sorted(self._sub) for _, r in self._sub[t]]
        self._sub = {}
        self._ring = []
        self._deficit = {}
        self._n = 0
        return out
