"""Request/result types for the in-process dispatch service.

Port of `dispatches_tpu/serve/request.py`: pure Python, copied as it is.

A `SolveRequest` wraps ONE problem row (an unbatched `LPData` / banded /
PDHG NamedTuple — every request to a given service must share the
shapes its `SlotEngine` was built for), a priority class, and an
optional absolute deadline in the service's clock domain. The caller
holds a `Ticket` — a thread-safe future resolved exactly once with a
`SolveResult`, whether the request was solved, served from cache,
returned late with its best iterate, or shed at admission.
"""

from __future__ import annotations

import threading
from typing import Any, NamedTuple, Optional

# lower value = more urgent; ints outside the table are accepted as-is
PRIORITY_CLASSES = {"interactive": 0, "normal": 1, "batch": 2}


def priority_value(priority) -> int:
    if isinstance(priority, str):
        try:
            return PRIORITY_CLASSES[priority]
        except KeyError:
            raise ValueError(
                f"unknown priority class {priority!r} "
                f"(known: {sorted(PRIORITY_CLASSES)})"
            ) from None
    return int(priority)


_PRIORITY_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


def priority_name(priority: int) -> str:
    """Class name for a priority value (journey/metric label); ints
    outside the table render as their decimal string."""
    return _PRIORITY_NAMES.get(int(priority), str(int(priority)))


class SolveResult(NamedTuple):
    """What a `Ticket` resolves to.

    `solution` is a solution-row NamedTuple with numpy leaves (bitwise
    what `solve_lp_batch` would return for this lane at the service's
    bucket size), or None when the request was shed / expired before its
    first chunk. `verdict` follows `obs.health.SEVERITY` — the service
    adds ``deadline_exceeded`` (late; `solution` holds the best iterate
    the solver had, when any), ``shed`` (never attempted), ``poisoned``
    (quarantined by the fleet after repeated crash-correlated dispatches;
    no solution), and ``unrecoverable`` (the remediation ladder gave up;
    `solution` holds the original unhealthy iterate)."""

    solution: Any
    verdict: str
    from_cache: bool = False
    iterations: Optional[int] = None
    latency: Optional[float] = None
    request_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.solution is not None and self.verdict not in (
            "shed", "deadline_exceeded", "poisoned", "unrecoverable",
        )


class SolveRequest:
    __slots__ = (
        "problem", "priority", "deadline", "fingerprint", "request_id",
        "seq", "submitted_at", "started_at", "ticket", "journey",
        "tenant", "requeues", "fault",
    )

    def __init__(
        self,
        problem: Any,
        *,
        priority: int = 1,
        deadline: Optional[float] = None,
        fingerprint: Optional[str] = None,
        request_id: Optional[str] = None,
        tenant: str = "default",
        fault: Optional[str] = None,
    ):
        self.problem = problem
        self.priority = int(priority)
        self.deadline = deadline
        self.fingerprint = fingerprint
        self.request_id = request_id
        self.tenant = str(tenant)
        self.seq: int = -1  # assigned by the service at submit
        self.submitted_at: Optional[float] = None
        self.started_at: Optional[float] = None
        self.ticket: Optional["Ticket"] = None
        # obs.reqtrace.Journey when the service runs with reqtrace=True;
        # None otherwise (the off path never touches it)
        self.journey: Optional[Any] = None
        # times a crashed/wedged shard handed this request back to the
        # queue (fleet bookkeeping; a requeued lane re-solves from
        # iteration 0, so its result stays bitwise-identical). Capped by
        # FleetService.max_requeues — a request whose dispatches keep
        # killing shards is quarantined as `poisoned` instead.
        self.requeues: int = 0
        # chaos hook: a fault-injection payload riding the solve frame to
        # the shard child ("exit" kills the worker mid-dispatch). Test
        # plumbing for the poison-quarantine path; never set in production
        self.fault = fault

    def sort_key(self):
        # FIFO within a priority class; seq is service-assigned and unique
        return (self.priority, self.seq)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class Ticket:
    """Thread-safe one-shot future for a submitted request."""

    def __init__(self, request: SolveRequest):
        self.request = request
        self._event = threading.Event()
        self._result: Optional[SolveResult] = None
        request.ticket = self

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SolveResult:
        """Block until resolved (forever by default). TimeoutError when
        `timeout` seconds pass first — the request stays in flight."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id or self.request.seq} "
                "not complete"
            )
        return self._result

    def _complete(self, result: SolveResult) -> None:
        if self._event.is_set():  # first resolution wins; late paths no-op
            return
        self._result = result
        self._event.set()
