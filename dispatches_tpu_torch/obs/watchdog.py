"""Hang guard for device-touching thunks (port of
`dispatches_tpu/obs/watchdog.py`).

A hung device call blocks forever; `with_watchdog` runs the thunk in a
daemon thread and waits on its result with a timeout. The stuck thread
cannot be killed, but the caller gets a `WatchdogTimeout`, the journal a
``hang`` event with an all-thread stack dump, and
``solve_verdict_total{verdict="hang"}`` a count, so a hung driver leaves
the same trail as a diverged solve.

CUDA work is asynchronous: a thunk must synchronize (``.cpu()``,
``.item()`` or `torch.cuda.synchronize()`) before it returns, or the
watchdog returns before the device work is done.
"""
from __future__ import annotations

import faulthandler
import queue
import tempfile
import threading
from typing import Any, Callable, Optional

from . import metrics as _metrics
from .journal import get_tracer

DEFAULT_TIMEOUT_S = 600.0

# keep the dump small enough to live inside a JSONL journal record
_MAX_STACK_CHARS = 8000


class WatchdogTimeout(TimeoutError):
    """Raised when the guarded thunk exceeds its wall-clock budget."""


def _dump_stacks() -> str:
    """All-thread stack dump through faulthandler (which needs a real file
    descriptor, hence a temporary file)."""
    try:
        with tempfile.TemporaryFile("w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            return fh.read()[-_MAX_STACK_CHARS:]
    except OSError:
        return ""


def with_watchdog(
    fn: Callable[[], Any],
    timeout_s: float = DEFAULT_TIMEOUT_S,
    stage: Optional[str] = None,
) -> Any:
    """Run `fn()` in a daemon thread; raise :class:`WatchdogTimeout` if no
    result lands within `timeout_s` (after journaling a ``hang`` event
    with the stage, budget and stack dump). Exceptions from `fn` re-raise
    unchanged."""
    q: "queue.Queue" = queue.Queue()

    def worker():
        try:
            q.put(("ok", fn()))
        except BaseException as exc:  # noqa: BLE001 - handed to the caller
            q.put(("err", exc))

    threading.Thread(target=worker, daemon=True).start()
    try:
        kind, val = q.get(timeout=timeout_s)
    except queue.Empty:
        get_tracer().event("hang", stage=stage, timeout_s=float(timeout_s),
                           verdict="hang", stacks=_dump_stacks())
        _metrics.inc("solve_verdict_total", verdict="hang")
        raise WatchdogTimeout(
            f"{'stage ' + repr(stage) + ' ' if stage else ''}device call "
            f"hung > {timeout_s:.0f}s"
        ) from None
    if kind == "err":
        raise val
    return val
