"""Span-based run journal (port of `dispatches_tpu/obs/journal.py`).

A :class:`Tracer` writes append-only JSONL. The first record of every run
is a **manifest** (git SHA, torch and CUDA versions, the card's name and
count, the float32 matmul precision and TF32 flags), so a sweep's results
can be traced back to what produced them. Work is structured as nested
spans::

    tracer = Tracer("runs/year.jsonl")
    with tracer.span("year_sweep"):
        with tracer.span("batch_0", scenarios=[0, 1]):
            ...

Each span close records its wall-clock seconds, the metrics-counter deltas
seen inside it and, once CUDA is initialized, the device-memory watermark.
Solve results go through :meth:`Tracer.solve_event`, which embeds the
`batch_stats` summary and the health verdicts.

The records, their kinds and keys are the JAX package's (schema 8), so
`tools/trace_summary.py` reads a port journal unchanged. Two differences:

- ``retraces`` in ``span_end`` and ``retrace_totals`` in ``close`` are
  always ``{}``: they count jit retraces (`obs/retrace.py`), which eager
  PyTorch does not have.
- ``compile_event`` records (`obs.perf`) mark a key's first segment call
  in the process: eager PyTorch compiles nothing, but that call carries
  the first use of the linear-algebra libraries' handles.

A manifest carries ``trace_id`` / ``parent_span_id`` when the process was
started with a traceparent in `obs.reqtrace.TRACEPARENT_ENV`, and the
serving tier writes one ``journey`` record per request
(`obs.reqtrace.Journey.finish`).

Records are appended and flushed one at a time, so a killed run leaves a
readable prefix. Library code calls `get_tracer()` and journals
unconditionally: with no tracer installed it gets a `NullTracer`.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import threading
import time
import uuid
import warnings
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from . import memory as _memory
from . import metrics as _metrics

# the JAX package's schema version: the port writes a subset of its records
_SCHEMA_VERSION = 8


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=5,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _versions() -> Dict[str, Any]:
    import numpy

    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
    }


def _device_info() -> Dict[str, Any]:
    """The card's name, the platform and the device count when CUDA is
    available; else None in each field and no platform, as the JAX
    package's manifest has it without a backend."""
    if not torch.cuda.is_available():
        return {"device_kind": None, "device_count": None, "mesh_shape": None}
    n = torch.cuda.device_count()
    return {
        "device_kind": torch.cuda.get_device_name(0),
        "platform": "gpu",
        "device_count": n,
        "mesh_shape": [n],
    }


def _precision_env() -> Dict[str, Any]:
    env = {k: os.environ[k] for k in ("CUDA_VISIBLE_DEVICES",) if k in os.environ}
    env["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    env["cuda_matmul_allow_tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    env["cudnn_allow_tf32"] = bool(torch.backends.cudnn.allow_tf32)
    return env


def build_manifest(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    m: Dict[str, Any] = {
        "kind": "manifest",
        "schema": _SCHEMA_VERSION,
        "schema_version": _SCHEMA_VERSION,
        # span durations come from time.perf_counter(), never wall-clock
        "clock": "perf_counter",
        "ts": time.time(),
        "run_id": uuid.uuid4().hex[:12],
        "git_sha": _git_sha(),
        "argv": list(sys.argv),
        "host": platform.node(),
        "os": platform.platform(),
        "versions": _versions(),
        "precision": _precision_env(),
    }
    m.update(_device_info())
    # a parent process (callers of tools/torch_serve_dispatch.py) hands its
    # trace identity down through the environment; recording it parents
    # this whole journal onto the caller's span
    from .reqtrace import TraceContext

    ctx = TraceContext.from_environ()
    if ctx is not None:
        m["trace_id"] = ctx.trace_id
        m["parent_span_id"] = ctx.span_id
    if extra:
        m.update(extra)
    return m


class Tracer:
    """Append-only JSONL run journal with nested spans.

    `path=None` keeps events in memory only (`self.events`)."""

    def __init__(self, path: Optional[str] = None, manifest_extra: Optional[dict] = None):
        self.path = str(path) if path else None
        self.events: List[dict] = []
        self._lock = threading.RLock()
        self._stack: List[str] = []
        self._fh = None
        if self.path:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self.manifest = build_manifest(manifest_extra)
        self._emit(self.manifest)

    # -- plumbing ------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        with self._lock:
            self.events.append(rec)
            if self._fh is not None:
                json.dump(rec, self._fh, default=_json_default)
                self._fh.write("\n")
                self._fh.flush()

    def _span_path(self, name: str) -> str:
        return "/".join(self._stack + [name]) if self._stack else name

    def _where(self) -> Optional[str]:
        return "/".join(self._stack) or None

    # -- public API ----------------------------------------------------
    @contextmanager
    def span(self, name: str, **attrs: Any):
        """Nested span context. Emits `span_start` and `span_end` records;
        the end record carries wall_s (monotonic-clock duration), ok, the
        metrics-counter deltas seen inside the span and the device-memory
        watermark when CUDA is initialized. While a profiler capture is
        open (`obs.profile.profile_capture`), the body runs under
        ``record_function(<span path>)``."""
        from . import profile as _profile

        with self._lock:
            path = self._span_path(name)
            self._stack.append(name)
        t0 = time.perf_counter()
        self._emit({"kind": "span_start", "ts": time.time(), "mono": t0, "span": path, **attrs})
        m_before = _metrics.flat_values()
        ok = True
        try:
            with _profile.annotation(path):
                yield self
        except BaseException:
            ok = False
            raise
        finally:
            t1 = time.perf_counter()
            rec = {
                "kind": "span_end",
                "ts": time.time(),
                "mono": t1,
                "span": path,
                "wall_s": t1 - t0,
                "ok": ok,
                "retraces": {},
            }
            m_delta = _metrics.counter_delta(m_before, _metrics.flat_values())
            if m_delta:
                rec["metrics"] = m_delta
            wm = _memory.memory_watermark_bytes()
            if wm is not None:
                rec["mem_watermark_bytes"] = wm
            self._emit(rec)
            with self._lock:
                if self._stack and self._stack[-1] == name:
                    self._stack.pop()

    def event(self, name: str, **attrs: Any) -> None:
        self._emit({"kind": "event", "ts": time.time(), "name": name,
                    "span": self._where(), **attrs})

    def metric(self, name: str, value: Any, **attrs: Any) -> None:
        self._emit({"kind": "metric", "ts": time.time(), "name": name, "value": value,
                    "span": self._where(), **attrs})

    def compile_event(self, **fields: Any) -> None:
        """Record one cold segment call (`obs.perf.PerfProbe.note_compile`):
        key, entry, elapsed seconds, hit or cold and, with size capture,
        its counted cost. "Cold" is the key's first call in the process."""
        self._emit({"kind": "compile_event", "ts": time.time(), "span": self._where(),
                    **fields})

    def solve_event(self, name: str, sol: Any, trace: Any = None, **attrs: Any) -> None:
        """Record a solve result: the `batch_stats` summary of `sol`, its
        trajectory stats when a `SolveTrace` is supplied, and its health
        verdicts (a caller's own ``health=`` summary is counted as given).
        A failure to summarize is recorded, never raised."""
        from ..runtime.telemetry import batch_stats
        from . import health as _health
        from .trace import trace_stats

        rec: Dict[str, Any] = {"kind": "solve", "ts": time.time(), "name": name,
                               "span": self._where(), **attrs}
        try:
            rec["stats"] = batch_stats(sol)
        except Exception as e:  # stats must never kill the run they document
            rec["stats_error"] = f"{type(e).__name__}: {e}"
        if trace is not None:
            try:
                rec["trace"] = trace_stats(trace)
            except Exception as e:
                rec["trace_error"] = f"{type(e).__name__}: {e}"
        try:
            if "health" in rec:
                _health.note_verdicts(rec["health"], solve=name)
            else:
                summary = _health.health_summary(sol, trace=trace)
                if summary is not None:
                    rec["health"] = summary
                    _health.note_verdicts(summary, solve=name)
        except Exception as e:  # diagnosis must never kill the run
            rec["health_error"] = f"{type(e).__name__}: {e}"
        self._emit(rec)

    def journey(self, **fields: Any) -> None:
        """Record a finished request journey (`obs.reqtrace`): trace ids,
        terminal, phase durations, chunk segments; one per request."""
        self._emit({"kind": "journey", "ts": time.time(), **fields})

    def close(self) -> None:
        """Emit a final record with the metrics-registry snapshot, then
        close the file. Idempotent."""
        with self._lock:
            if self._fh is None and any(e.get("kind") == "close" for e in self.events):
                return
        rec = {"kind": "close", "ts": time.time(), "retrace_totals": {}}
        snap = _metrics.snapshot()
        if any(snap.values()):
            rec["metrics"] = snap
        self._emit(rec)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracer:
    """Inert stand-in so library code can journal unconditionally."""

    path = None
    events: List[dict] = []
    manifest: Dict[str, Any] = {}

    @contextmanager
    def span(self, name: str, **attrs: Any):
        yield self

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def metric(self, name: str, value: Any, **attrs: Any) -> None:
        pass

    def solve_event(self, name: str, sol: Any, trace: Any = None, **attrs: Any) -> None:
        pass

    def journey(self, **fields: Any) -> None:
        pass

    def compile_event(self, **fields: Any) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullTracer":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = NullTracer()
_CURRENT: Any = _NULL


def get_tracer():
    """The process-wide tracer (a NullTracer when none is installed)."""
    return _CURRENT


def set_tracer(tracer) -> Any:
    """Install `tracer` (None restores the NullTracer); returns the
    previous one so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else _NULL
    return prev


@contextmanager
def use_tracer(tracer):
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


def read_journal(path: str) -> List[dict]:
    """Parse a JSONL journal, skipping torn lines (a killed run may leave a
    partial final record, which can even parse as non-dict JSON or end
    mid-UTF-8-sequence). A journal of a newer schema than this reader
    knows gives a warning, never an exception."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    for rec in out:
        if rec.get("kind") == "manifest":
            ver = rec.get("schema_version", rec.get("schema"))
            if isinstance(ver, (int, float)) and ver > _SCHEMA_VERSION:
                warnings.warn(
                    f"{path}: journal schema_version {ver} is newer than this "
                    f"reader (knows <= {_SCHEMA_VERSION}); unknown record "
                    "fields will be ignored",
                    stacklevel=2,
                )
                break
    return out


def _json_default(o: Any):
    """Fallback serializer: numpy scalars and arrays, tensors -> Python."""
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if hasattr(o, "tolist"):
        return o.tolist()
    return repr(o)
