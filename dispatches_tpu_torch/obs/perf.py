"""Measured-performance probe (port of `dispatches_tpu/obs/perf.py`).

A `PerfProbe` instruments `runtime.adaptive`'s chunk loops, the
`SlotEngine` serving loop and the three adaptive entry points, with
host-clock boundary stamps:

    SlotEngine.step():   transfer -> cold -> compute -> harvest -> host
    _adaptive_drive():   dispatch -> compute -> harvest -> host

- ``transfer``: the admitted rows copied from the host mirror to the
  device batch;
- ``cold`` / ``dispatch``: the segment call. The port's IPM loop reads
  the card once an iteration, so in eager PyTorch this call runs most of
  the chunk's iterations (JAX dispatches asynchronously and only traces,
  compiles or looks up its executable here);
- ``compute``: up to the chunk's one host read of every lane's stop flag
  and iteration (what is still in flight on the card lands here);
- ``harvest``: the device-to-host copy of the finished lanes' rows;
- ``host``: the rest of the loop's bookkeeping (retirement,
  compaction), and ``conformance`` when the engine certifies rows.

**Exact-sum contract**: a chunk record's ``wall_s`` is the telescoped sum
of its phase durations in phase order, so ``sum(phases.values()) ==
wall_s`` holds bitwise for every chunk.

**Neutral**: the probe reads the host clock and writes registry floats;
probe-on results are bitwise probe-off. Off by default everywhere
(``SlotEngine.perf`` is None, the adaptive entries take ``perf=None``).

**Cold and hit.** Eager PyTorch compiles nothing, so a segment call is
"cold" when it is the first call of its ``(entry, bucket, kind)`` key that
a probe times in the process (`first_call`): in a process that solves
under a probe from its start, that call carries the first use of the
cuBLAS, cuSOLVER and MAGMA handles and the caching allocator's growth.
Every timed segment call feeds ``compile_seconds{entry=,cache="hit"|
"cold"}`` and ``compile_cache_hit_total`` / ``compile_cache_miss_total``,
and a cold one writes a ``compile_event`` journal record (as the JAX
package's; `tools/trace_summary.py` reads both).

With ``capture_sizes=True`` the cold call runs under `obs.cost`'s counter
(slower, so opt-in even inside the opt-in probe): its executed FLOPs are
recorded on the ``compile_event``, and divided by the loop iterations
that call ran they give the key's FLOPs an iteration. Every chunk of the
key is credited that rate times the loop iterations it ran itself (lanes
retire, so later chunks run fewer), which gives each chunk a roofline
point against the card's measured peak (`obs.cost.chip_peak_tflops`).
The counted chunk's own wall ran under the counter: its record says so
(``wall_basis: "counted"``). The
``perf_mxu_utilization`` / ``perf_achieved_tflops`` gauges keep the JAX
package's names, which the tools read. There are no executable sizes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as obs_metrics
from .cost import CostCounter, chip_peak_tflops

# Sub-millisecond..seconds ladder, with a tail for a cold first call
PERF_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

obs_metrics.describe(
    "perf_chunk_seconds",
    "Measured chunk wall time per adaptive entry (PerfProbe).",
)
obs_metrics.describe(
    "perf_phase_seconds",
    "Measured chunk time attributed to one phase (transfer/cold/dispatch/"
    "compute/harvest/host), per adaptive entry.",
)
obs_metrics.describe(
    "compile_seconds",
    "Segment-call latency split by the key's first use in the process: "
    "cold = the key's first call (library handles, allocator growth), "
    "hit = every later call.",
)
obs_metrics.describe(
    "perf_chunks_total", "Chunks measured by the PerfProbe, per entry.",
)
obs_metrics.describe(
    "perf_model_flops_total",
    "Executed FLOPs (obs.cost's counter) credited to measured chunks.",
)
obs_metrics.describe(
    "perf_mxu_utilization",
    "Last measured-roofline utilization per entry: executed FLOPs / "
    "measured chunk wall against the card's measured peak.",
)
obs_metrics.describe(
    "perf_achieved_tflops",
    "Last measured achieved TFLOP/s per entry (executed FLOPs / chunk wall).",
)

# keys whose first segment call this process has made
_SEEN: set = set()


def first_call(key) -> bool:
    """Record one segment call of `key`; True when it is a hit (not the
    key's first call in the process)."""
    hit = key in _SEEN
    if hit:
        obs_metrics.inc("compile_cache_hit_total", entry=key[0])
    else:
        _SEEN.add(key)
        obs_metrics.inc("compile_cache_miss_total", entry=key[0])
    return hit


def _key_str(key: Any) -> str:
    """Stable JSON-safe rendering of a key tuple."""
    try:
        return repr(tuple(key))
    except Exception:
        return repr(key)


class _Chunk:
    """One in-flight chunk measurement: boundary marks in causal order,
    finished once by `done()`. `mark(name)` closes the phase `name` at the
    current (or given) clock stamp; repeated marks of a name extend it."""

    __slots__ = ("probe", "entry", "t0", "marks", "flops", "counted", "_done")

    def __init__(self, probe: "PerfProbe", entry: str, t0: float):
        self.probe = probe
        self.entry = entry
        self.t0 = float(t0)
        self.marks: List[Tuple[str, float]] = []
        self.flops: Optional[float] = None
        self.counted = False  # a segment call of this chunk ran under the counter
        self._done = False

    def mark(self, phase: str, t: Optional[float] = None) -> None:
        t = self.probe.clock() if t is None else float(t)
        self.marks.append((str(phase), t))

    def add_flops(self, flops: Optional[float]) -> None:
        """Accumulate the FLOPs of one segment run of this chunk (None =
        unknown, ignored)."""
        if flops is not None:
            self.flops = (self.flops or 0.0) + float(flops)

    def done(self, **extra: Any) -> Optional[Dict[str, Any]]:
        """Close the chunk: derive the phase durations, feed the histograms
        and roofline gauges, return (and keep) the record. Idempotent."""
        if self._done:
            return None
        self._done = True
        return self.probe._finish_chunk(self, extra)


class PerfProbe:
    """Opt-in measured-phase instrument for the chunked solve loops.

    Attach as ``engine.perf = PerfProbe()`` or pass ``perf=probe`` to the
    adaptive entry points. `clock` is injectable (fake clocks in tests);
    it should be the service clock when phases line up with request
    journeys. ``capture_sizes=True`` counts the executed FLOPs of each
    key's cold call (see the module docstring). `device` names the card
    whose peak anchors the roofline (default: the current CUDA device
    when there is one; none on the CPU)."""

    def __init__(
        self,
        *,
        clock=time.perf_counter,
        capture_sizes: bool = False,
        journal_hits: bool = False,
        peak_tflops: Optional[float] = None,
        device=None,
        max_records: int = 256,
    ):
        self.clock = clock
        self.capture_sizes = bool(capture_sizes)
        self.journal_hits = bool(journal_hits)
        if peak_tflops is not None:
            self.peak_tflops: Optional[float] = float(peak_tflops)
            self.peak_source = "explicit"
        else:
            self.peak_tflops, self.peak_source = chip_peak_tflops(device)
        self.max_records = int(max_records)
        self.records: List[Dict[str, Any]] = []  # recent chunk records
        self.compile_records: List[Dict[str, Any]] = []
        self.chunks = 0
        self.compiles = {"hit": 0, "cold": 0}
        self._per_iter: Dict[Any, float] = {}  # key -> FLOPs a loop iteration
        self._pending: Dict[Any, float] = {}  # key -> its counted call's FLOPs
        self._model_flops: Dict[str, float] = {}  # entry-level fallback
        self._captured: Optional[Dict[str, Any]] = None
        # host seconds the probe spent in its own bookkeeping (chunk records,
        # histograms, journal records; a counted call's run is not in it)
        self.own_s = 0.0

    # -- chunk lifecycle ----------------------------------------------
    def chunk(self, entry: str) -> _Chunk:
        """Open a chunk measurement at the current clock stamp."""
        return _Chunk(self, entry, self.clock())

    def set_model_flops(self, entry: str, flops: float) -> None:
        """Entry-level FLOP anchor for rooflines when size capture is off
        (e.g. from a one-time `obs.cost` count)."""
        self._model_flops[str(entry)] = float(flops)

    def credit(self, chunk: _Chunk, key: Any, iters: int,
               entry: Optional[str] = None) -> None:
        """Credit `chunk` with the FLOPs of a segment run of `key` that ran
        `iters` loop iterations: the key's counted rate an iteration times
        `iters` (the counted call itself sets the rate, from the iterations
        it ran), else the entry-level anchor a segment run."""
        counted = self._pending.pop(key, None)
        if counted is not None:
            chunk.counted = True
            if iters > 0:
                self._per_iter[key] = counted / iters
        per = self._per_iter.get(key)
        if per is not None:
            chunk.add_flops(per * iters)
        elif entry is not None:
            chunk.add_flops(self._model_flops.get(str(entry)))

    def _finish_chunk(self, chunk: _Chunk, extra: Dict[str, Any]) -> Dict[str, Any]:
        t_end = self.clock()
        t_own = time.perf_counter()
        phases: Dict[str, float] = {}
        prev = chunk.t0
        for name, t in chunk.marks:
            phases[name] = phases.get(name, 0.0) + (t - prev)
            prev = t
        phases["host"] = t_end - prev
        # wall is the telescoped phase sum in insertion order: the
        # exact-sum contract of the module docstring
        wall = sum(phases.values())
        entry = chunk.entry
        for name, dur in phases.items():
            obs_metrics.observe("perf_phase_seconds", dur, buckets=PERF_BUCKETS,
                                entry=entry, phase=name)
        obs_metrics.observe("perf_chunk_seconds", wall, buckets=PERF_BUCKETS, entry=entry)
        obs_metrics.inc("perf_chunks_total", entry=entry)
        rec: Dict[str, Any] = {"entry": entry, "wall_s": wall, "phases": phases, **extra}
        if chunk.counted:
            rec["wall_basis"] = "counted"
        if chunk.flops is not None:
            rec["flops"] = chunk.flops
            obs_metrics.inc("perf_model_flops_total", chunk.flops, entry=entry)
            if wall > 0:
                achieved = chunk.flops / wall / 1e12
                rec["achieved_tflops"] = achieved
                obs_metrics.set_gauge("perf_achieved_tflops", achieved, entry=entry)
                if self.peak_tflops:
                    rec["utilization"] = achieved / self.peak_tflops
                    rec["peak_source"] = self.peak_source
                    obs_metrics.set_gauge("perf_mxu_utilization", rec["utilization"],
                                          entry=entry)
        self.chunks += 1
        self.records.append(rec)
        del self.records[: -self.max_records]
        self.own_s += time.perf_counter() - t_own
        return rec

    # -- segment calls -------------------------------------------------
    def capture(self, key: Any, hit: bool, device=None):
        """Context for one segment call: on a cold key with
        ``capture_sizes`` it runs under `obs.cost.CostCounter`, whose
        record the next `note_compile` attaches; else a no-op."""
        if hit or not self.capture_sizes:
            return contextlib.nullcontext()
        return self._capturing(key, device)

    @contextlib.contextmanager
    def _capturing(self, key, device):
        counter = CostCounter(device)
        with counter:
            yield
        rec = counter.record()
        self._pending[key] = rec["flops"]
        self._captured = {k: rec[k] for k in ("flops", "bytes_accessed", "flops_basis",
                                              "chain_sweep_launches") if k in rec}
        if "peak_bytes" in rec:
            self._captured["peak_bytes"] = rec["peak_bytes"]

    def note_compile(self, entry: str, key: Any, hit: bool, elapsed_s: float, *,
                     kind: Optional[str] = None) -> Dict[str, Any]:
        """Record one timed segment call: the `compile_seconds` histogram
        split hit/cold, a ``compile_event`` journal record per cold call
        (per hit too with ``journal_hits=True``), and the counted cost of
        a captured cold call."""
        t_own = time.perf_counter()
        cache = "hit" if hit else "cold"
        self.compiles[cache] += 1
        obs_metrics.observe("compile_seconds", float(elapsed_s), buckets=PERF_BUCKETS,
                            entry=entry, cache=cache)
        rec: Dict[str, Any] = {
            "entry": entry,
            "key": _key_str(key),
            "cache": cache,
            "elapsed_s": float(elapsed_s),
        }
        if kind is not None:
            # "compile_kind", not "kind": the journal record's own kind is
            # "compile_event"
            rec["compile_kind"] = str(kind)
        try:
            bucket = key[1]
            if isinstance(bucket, int):
                rec["bucket"] = bucket
        except Exception:
            pass
        if not hit:
            rec["persistent_cache"] = None  # eager PyTorch keeps no executables
            if self._captured is not None:
                rec.update(self._captured)
                self._captured = None
        if not hit or self.journal_hits:
            from .journal import get_tracer

            get_tracer().compile_event(**rec)
        self.compile_records.append(rec)
        del self.compile_records[: -self.max_records]
        self.own_s += time.perf_counter() - t_own
        return rec

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "chunks": self.chunks,
            "compiles": dict(self.compiles),
            "peak_tflops": self.peak_tflops,
            "peak_source": self.peak_source,
            "executables_costed": len(self._per_iter),
            "own_seconds": self.own_s,
        }
