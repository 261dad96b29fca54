"""Opt-in `torch.profiler` capture (port of `dispatches_tpu/obs/profile.py`).

Journals say *when* a span ran and how long it took; a profile says *what
the device did* inside it. `profile_capture(dir)` records host and CUDA
activity for the duration of a block and writes a Chrome trace
(``trace-<pid>.json``, loadable in Perfetto or ``chrome://tracing``) into
the directory; while it is open, every `Tracer.span` body runs under
``torch.profiler.record_function(<span path>)``, so the timeline's rows
and the journal's span tree line up by name.

With no capture open, `annotation(name)` is a shared no-op context
manager. Capture is opt-in (``--profile-dir`` on the workflow CLI):
profiling changes timings and writes large files. `profile_capture(None)`
is inert, so callers can pass the flag's value through unconditionally:

    with profile_capture("runs/profile"):
        run_year_sweep(...)
"""
from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from typing import Iterator, Optional

import torch

# live captures (an int: captures could nest across threads); annotation()
# is a no-op whenever this is zero
_ACTIVE = 0

_NULL_CM = nullcontext()


def annotation(name: str):
    """``torch.profiler.record_function(name)`` while a capture is open,
    else a shared no-op context manager."""
    if _ACTIVE <= 0:
        return _NULL_CM
    return torch.profiler.record_function(str(name))


@contextmanager
def profile_capture(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block (CPU activity, and CUDA activity when a card is
    present) and write its Chrome trace into `log_dir`; yields the
    directory, or None (inert) when `log_dir` is falsy."""
    global _ACTIVE
    if not log_dir:
        yield None
        return
    log_dir = str(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _ACTIVE += 1
    try:
        yield log_dir
    finally:
        _ACTIVE -= 1
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
