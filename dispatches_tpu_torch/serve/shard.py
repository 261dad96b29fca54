"""Crash-domain shard: a `SlotEngine` in its own child process (port of
`dispatches_tpu/serve/shard.py`).

The serving tier's fault-isolation unit: the fleet (`serve/fleet.py`)
runs every engine behind a process boundary, so a crash takes down one
shard, which the fleet respawns. On one card every child holds its own
CUDA context. This module is both halves of that boundary:

- the CHILD (spawned through `_BOOTSTRAP`, which loads this file by path
  so nothing heavy imports first): a reader thread that answers
  heartbeat pings comes up within milliseconds, and only then does the
  child import torch and build one dense `SlotEngine` through
  `runtime.adaptive.make_dense_engine` (the same solves as the in-process
  service, so the bitwise contract holds across the pipe) on the device
  the parent names in `DEVICE_ENV`. It speaks the frame protocol below
  over stdin/stdout, and never imports jax.
- the PARENT handle (`ShardProcess`): spawn/kill lifecycle, non-blocking
  result polling, heartbeat bookkeeping, and the in-flight lane map the
  fleet requeues from when the child dies.

Wire protocol: length-prefixed JSON frames — an ASCII decimal byte
count, ``\\n``, then exactly that many bytes of UTF-8 JSON. Length
prefixes (not bare JSONL) because frames embed base64 array payloads
that routinely exceed pipe atomicity, and a torn frame must fail the
read, not desynchronize the stream. Arrays travel as raw little-endian
bytes (base64) + dtype + shape, so a problem row and its solution
round-trip BITWISE — float repr would quietly break the identity
contract the whole serving tier is tested against. The protocol and the
codec are the JAX package's byte for byte, so a frame either package
writes decodes bitwise in the other. Rows cross as numpy: a solution on
the card is copied to the host before it is encoded, and the engine
stacks decoded rows onto its own device.

Frames parent -> child::

    {"op": "ping", "seq": n}
    {"op": "solve", "lane": id, "problem": <row>}
    {"op": "cancel", "lane": id}
    {"op": "fault", "mode": "exit" | "hang" | "nan"}   # test/chaos hook
    {"op": "shutdown"}

Frames child -> parent::

    {"op": "pong", "seq": n}
    {"op": "result", "lane": id, "slot": s, "iterations": k,
     "row": <row>, "journey": <marks>?, "conformance": <certs>?}
    {"op": "telemetry", "shard": k, "seq": n,
     "metrics": <snapshot delta>, "journal": [<records>]}

The ``telemetry`` frame (child spawned with ``--telemetry 1``; off by
default) piggybacks on the heartbeat: each ping answered also ships the
child registry's `snapshot_delta` since the previous ship plus any
journal records buffered since — the parent folds the delta into its
own registry under a ``shard`` label (`MetricsRegistry.merge`) and
re-emits the records with shard provenance. Deltas, not absolutes, so a
respawned child restarting from zero can only ever ADD to fleet
aggregates. With ``--reqtrace 1`` each result frame also carries the
lane's chunk-loop journey marks (seconds relative to the child's
receipt of the solve op), which the parent maps into the request's
`obs.reqtrace` journey so compute time is attributed to the shard that
did the work. With ``--conformance 1`` the engine computes per-row KKT
certificates at harvest (`obs.conformance`) and each result frame
carries the four scalars + outcome, which the parent re-observes into
its own registry and escalates on (docs/observability.md §12). With
``--warm-model PATH`` the engine seeds every admitted lane from the
learned warm-start artifact (`learn.WarmStartPredictor`, loaded on the
child's device), and each result frame carries the lane's
``warm_source`` / ``warm_accepted``.

The ``fault`` op is the fault-injection surface `tests/test_torch_serve_fleet.py`,
`chip_smoke.py` serve (d) and the loadgen chaos leg drive: ``exit`` dies
immediately (os._exit),
``hang`` wedges the child (no pongs, no results, process stays alive —
the heartbeat-timeout path), ``nan`` poisons subsequent solution rows
with NaNs (the nonfinite-verdict path). `DIE_ON_START_ENV` makes a
freshly spawned child exit before serving anything — the
respawn-backoff test knob.
"""
from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import threading
import time
from queue import Empty, Queue
from typing import Any, Dict, IO, List, Optional, Tuple

#: child exits immediately at startup when this env var is "1"
#: (fleet respawn-backoff tests; cleared by the fleet on respawn unless
#: the test keeps injecting it)
DIE_ON_START_ENV = "DISPATCHES_TPU_SHARD_DIE_ON_START"
#: the child's torch device ("cuda:1", "cpu", ...), set by the fleet from
#: `shard_device_env`; "cuda" when unset
DEVICE_ENV = "DISPATCHES_TPU_TORCH_SHARD_DEVICE"

_MAX_FRAME = 256 * 1024 * 1024  # refuse absurd lengths: torn stream, not data

# heartbeat round-trip buckets (serve_shard_ping_seconds): pings cross
# two pipes and a thread wakeup, so sub-ms to low-seconds is the range;
# anything near the heartbeat timeout is the wedge-detection signal
PING_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)

#: child bootstrap: load THIS file as a standalone module (stdlib-only
#: top level) instead of ``-m dispatches_tpu_torch.serve.shard``: the
#: ``-m`` path imports the package (and torch) BEFORE worker_main can
#: start its ping-answering reader thread, so a fleet with a short
#: heartbeat timeout would declare a freshly respawned child wedged
#: mid-import. The bootstrap gets the reader up within milliseconds;
#: torch imports after, under heartbeat cover.
_BOOTSTRAP = (
    "import importlib.util, sys; "
    "spec = importlib.util.spec_from_file_location('dispatches_tpu_torch_shard_child', sys.argv[1]); "
    "mod = importlib.util.module_from_spec(spec); "
    "spec.loader.exec_module(mod); "
    "sys.exit(mod.worker_main(sys.argv[2:]))"
)


# ---------------------------------------------------------------------------
# framing + array codec


def write_frame(fh: IO[bytes], obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    fh.write(b"%d\n" % len(payload))
    fh.write(payload)
    fh.flush()


def read_frame(fh: IO[bytes]) -> Optional[dict]:
    """One frame, or None on EOF / torn stream (callers treat both as
    the peer going away)."""
    header = fh.readline()
    if not header:
        return None
    try:
        n = int(header)
    except ValueError:
        return None
    if n < 0 or n > _MAX_FRAME:
        return None
    payload = fh.read(n)
    if payload is None or len(payload) < n:
        return None
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    return obj if isinstance(obj, dict) else None


def encode_array(a) -> dict:
    import numpy as np

    a = np.asarray(a)
    shape = list(a.shape)  # BEFORE ascontiguousarray: it promotes 0-d to 1-d
    a = np.ascontiguousarray(a)
    return {
        "dtype": a.dtype.str,  # byte-order-qualified: '<f8', not 'float64'
        "shape": shape,
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def decode_array(spec: dict):
    import numpy as np

    a = np.frombuffer(
        base64.b64decode(spec["b64"]), dtype=np.dtype(spec["dtype"])
    )
    return a.reshape(tuple(spec["shape"]))


def encode_row(row) -> dict:
    """A problem/solution NamedTuple with array leaves -> one frame-able
    dict (class name + ordered field names + encoded leaves)."""
    return {
        "cls": type(row).__name__,
        "names": list(row._fields),
        "leaves": [encode_array(leaf) for leaf in row],
    }


def _row_cls(name: str, fields: Tuple[str, ...]):
    """Resolve a row class by name; unknown names degrade to an ad-hoc
    namedtuple with the sender's field order (the fleet only reads
    fields by name, so results stay usable)."""
    # absolute imports: this module also runs standalone in the child
    # (loaded by file path via _BOOTSTRAP, outside the package)
    if name == "LPData":
        from dispatches_tpu_torch.core.program import LPData

        if LPData._fields == fields:
            return LPData
    if name == "IPMSolution":
        from dispatches_tpu_torch.solvers.ipm import IPMSolution

        if IPMSolution._fields == fields:
            return IPMSolution
    import collections

    return collections.namedtuple(name, fields)


def decode_row(spec: dict):
    fields = tuple(spec["names"])
    cls = _row_cls(spec["cls"], fields)
    return cls(*(decode_array(leaf) for leaf in spec["leaves"]))


# ---------------------------------------------------------------------------
# the child worker


class _LaneJourneys:
    """Child half of the shard-aware journey: a `SlotEngine.observer`
    (chunk_begin / cold_end / compute_end / harvest_end duck type) whose
    tokens are lane ids, recording each lane's chunk-loop marks as
    seconds RELATIVE to the child's receipt of its solve op. Relative,
    because the parent's service clock may be fake (tests) or skewed —
    the parent re-anchors the marks onto its own dispatch stamp and
    clamps to the result-arrival stamp, so phase sums stay exact."""

    __slots__ = ("data", "_chunk_t")

    def __init__(self):
        self.data: Dict[Any, dict] = {}
        self._chunk_t = 0.0

    def begin(self, lane) -> None:
        self.data[lane] = {"t0": time.monotonic(), "marks": {}, "chunks": []}

    def forget(self, lane) -> None:
        self.data.pop(lane, None)

    def pop(self, lane) -> Optional[dict]:
        d = self.data.pop(lane, None)
        if d is None:
            return None
        return {"marks": d["marks"], "chunks": d["chunks"]}

    # -- SlotEngine observer hooks --
    def chunk_begin(self, tokens) -> None:
        self._chunk_t = time.monotonic()

    def cold_end(self, tokens, fresh) -> None:
        t = time.monotonic()
        for tok, f in zip(tokens, fresh):
            d = self.data.get(tok) if tok is not None else None
            if f and d is not None:
                d["marks"].setdefault("first_chunk", t - d["t0"])

    def compute_end(self, tokens, it0, it1) -> None:
        t = time.monotonic()
        for i, tok in enumerate(tokens):
            d = self.data.get(tok) if tok is not None else None
            if d is None:
                continue
            d["marks"].setdefault("first_chunk", self._chunk_t - d["t0"])
            start = (
                self._chunk_t - d["t0"] if d["chunks"]
                else d["marks"]["first_chunk"]
            )
            d["chunks"].append([start, t - d["t0"], int(it0[i]), int(it1[i]), i])
            d["marks"]["compute_end"] = t - d["t0"]  # rolls forward per chunk

    def harvest_end(self, tokens) -> None:
        t = time.monotonic()
        for tok in tokens:
            d = self.data.get(tok) if tok is not None else None
            if d is not None:
                d["marks"].setdefault("harvest_end", t - d["t0"])


def worker_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of the shard child (``python -m
    dispatches_tpu_torch.serve.shard`` by hand)."""
    import argparse

    ap = argparse.ArgumentParser(prog="dispatches_tpu_torch.serve.shard")
    ap.add_argument("--bucket", type=int, required=True)
    ap.add_argument("--chunk-iters", type=int, default=8)
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (the parent's count: CPU "
                    "products may round differently at another count)")
    ap.add_argument("--solver-kw", default="{}",
                    help="JSON dict forwarded to solve_lp_partial")
    ap.add_argument("--telemetry", type=int, default=0,
                    help="ship metrics/journal deltas on heartbeat pongs")
    ap.add_argument("--reqtrace", type=int, default=0,
                    help="attach chunk-loop journey marks to result frames")
    ap.add_argument("--conformance", type=int, default=0,
                    help="compute per-row KKT certificates at harvest "
                         "and ship them in result frames")
    ap.add_argument("--warm-model", default=None,
                    help="learned warm-start artifact (learn/) seeding "
                         "the engine's admitted lanes")
    args = ap.parse_args(argv)

    if os.environ.get(DIE_ON_START_ENV) == "1":
        return 3

    inp = sys.stdin.buffer
    outp = sys.stdout.buffer
    # stray prints (library warnings, debuggers) must not corrupt the
    # frame stream: from here on, "stdout" is stderr
    sys.stdout = sys.stderr

    out_lock = threading.Lock()
    inbox: Queue = Queue()
    fault = {"hang": False, "nan": False}
    # telemetry shipper, installed by the main loop once obs imports are
    # safe (the reader starts before torch; importing the package here
    # would stall the very pings this thread exists to answer)
    telem = {"ship": None}

    def _send(obj: dict) -> None:
        with out_lock:
            write_frame(outp, obj)

    def _reader() -> None:
        # pings answered HERE, synchronously, while torch imports and the
        # CUDA context starts — a busy shard heartbeats, a wedged one doesn't
        while True:
            msg = read_frame(inp)
            if msg is None:
                inbox.put(None)
                return
            op = msg.get("op")
            if op == "ping":
                if not fault["hang"]:
                    _send({"op": "pong", "seq": msg.get("seq")})
                    ship = telem["ship"]
                    if ship is not None:
                        try:
                            ship()
                        except Exception:
                            pass  # telemetry must never take the shard down
            elif op == "fault":
                mode = msg.get("mode")
                if mode == "exit":
                    os._exit(13)
                elif mode in fault:
                    fault[mode] = True
            else:
                inbox.put(msg)

    threading.Thread(target=_reader, name="shard-reader", daemon=True).start()

    import numpy as np
    import torch

    from dispatches_tpu_torch.runtime.adaptive import make_dense_engine

    if args.threads > 0:
        torch.set_num_threads(args.threads)

    solver_kw = json.loads(args.solver_kw)
    engine = make_dense_engine(
        args.bucket, chunk_iters=args.chunk_iters,
        warm_predictor=args.warm_model,
        conformance=bool(args.conformance) or None,
        device=os.environ.get(DEVICE_ENV, "cuda"), **solver_kw
    )
    if engine.device.type == "cuda":
        # start the CUDA context now, under heartbeat cover, rather than
        # inside the first solve
        torch.zeros((), device=engine.device)

    journeys: Optional[_LaneJourneys] = None
    if args.reqtrace:
        journeys = _LaneJourneys()
        engine.observer = journeys

    tracer = None
    if args.telemetry:
        from dispatches_tpu_torch.obs import journal as obs_journal
        from dispatches_tpu_torch.obs import metrics as obs_metrics

        # in-memory tracer: child-side journal records (solve_event
        # health verdicts, watchdog hangs, ...) buffer here and ride the
        # telemetry frames to the parent journal with shard provenance
        tracer = obs_journal.Tracer()
        obs_journal.set_tracer(tracer)
        ship_state = {"snap": {}, "seq": 0, "sent": 0}

        def _ship() -> None:
            snap = obs_metrics.snapshot()
            delta = obs_metrics.snapshot_delta(ship_state["snap"], snap)
            with tracer._lock:
                batch = list(tracer.events[ship_state["sent"]:])
                ship_state["sent"] = len(tracer.events)
                if ship_state["sent"] > 4096:  # bound the buffer's growth
                    del tracer.events[:ship_state["sent"]]
                    ship_state["sent"] = 0
            records = []
            for rec in batch:
                if rec.get("kind") == "manifest":
                    # the parent journal already has ITS manifest; the
                    # child's becomes a provenance event (device, run id)
                    rec = {
                        "kind": "event", "name": "shard_manifest",
                        "ts": rec.get("ts"), "run_id": rec.get("run_id"),
                        "device_kind": rec.get("device_kind"),
                        "platform": rec.get("platform"),
                        "device_count": rec.get("device_count"),
                    }
                records.append(rec)
            changed = (
                bool(delta["counters"]) or bool(delta["histograms"])
                or delta["gauges"] != (ship_state["snap"].get("gauges") or {})
            )
            if not records and not changed:
                return  # idle shard: nothing to say this heartbeat
            ship_state["snap"] = snap
            ship_state["seq"] += 1
            _send({
                "op": "telemetry", "shard": args.shard_id,
                "seq": ship_state["seq"], "metrics": delta,
                "journal": records,
            })

        telem["ship"] = _ship

    pending: List[dict] = []
    slots: Dict[Any, int] = {}  # lane id -> engine slot, for result frames
    while True:
        if fault["hang"]:
            # wedged on purpose: alive, silent — the parent's heartbeat
            # timeout is the only way out
            time.sleep(0.05)
            continue
        busy = bool(pending) or bool(engine.active())
        drained: List[Optional[dict]] = []
        if busy:
            while True:
                try:
                    drained.append(inbox.get_nowait())
                except Empty:
                    break
        else:
            drained.append(inbox.get())  # idle: block for work
        stop = False
        for msg in drained:
            if msg is None or msg.get("op") == "shutdown":
                stop = True
                break
            op = msg.get("op")
            if op == "solve":
                pending.append(msg)
                if journeys is not None:
                    journeys.begin(msg.get("lane"))  # receipt anchors marks
            elif op == "cancel":
                # fully handled here: the lane leaves pending/engine, so
                # no result frame can be emitted for it afterwards (a
                # result already in flight resolves first at the parent's
                # one-shot ticket and this cancel is a no-op there)
                lane = msg.get("lane")
                pending = [m for m in pending if m.get("lane") != lane]
                slots.pop(lane, None)
                if journeys is not None:
                    journeys.forget(lane)
                if lane in engine.active():
                    engine.evict(lane)
        if stop:
            return 0
        while pending and engine.free_slots():
            msg = pending.pop(0)
            if msg.get("fault") == "exit":
                # poison payload: die mid-dispatch, after accepting the
                # frame but before any result can be produced — the parent
                # sees a crash with this lane in flight and attributes it
                os._exit(13)
            row = decode_row(msg["problem"])
            slots[msg["lane"]] = engine.admit(msg["lane"], row)
        for lane, row, stats in engine.step() if engine.active() else ():
            slot = slots.pop(lane, -1)
            if fault["nan"]:
                row = type(row)(*(
                    np.full_like(leaf, np.nan)
                    if np.asarray(leaf).dtype.kind == "f" else leaf
                    for leaf in row
                ))
            warm_attrs = {
                k: stats[k] for k in ("warm_source", "warm_accepted") if k in stats
            }
            if tracer is not None:
                # child-side health verdict with shard provenance; rides
                # the next telemetry frame into the parent journal
                tracer.solve_event(
                    "shard_engine", row, lane=lane,
                    iterations=stats.get("iterations"),
                    shard=args.shard_id, **warm_attrs,
                )
            frame = {
                "op": "result",
                "lane": lane,
                "slot": slot,
                "iterations": stats.get("iterations"),
                "row": encode_row(row),
                **warm_attrs,
            }
            conf = stats.get("conformance")
            if conf is not None:
                # four scalars + outcome, already plain floats/strs:
                # the parent re-observes these into ITS registry so the
                # accuracy alert pack sees them without telemetry on
                frame["conformance"] = conf
            if journeys is not None:
                j = journeys.pop(lane)
                if j is not None:
                    frame["journey"] = j
            _send(frame)


# ---------------------------------------------------------------------------
# the parent-side handle


class ShardProcess:
    """One crash domain, as the fleet sees it.

    Owns the child's lifecycle (spawn/kill), the write side of the pipe,
    a reader thread draining results, heartbeat stamps on the REAL clock
    (`time.monotonic` — liveness is wall-clock even when the service
    runs a fake clock), and the ``lanes`` map (lane id -> SolveRequest)
    the fleet requeues from on failure. Not thread-safe beyond the
    reader/send split; the fleet calls everything else under its lock.
    """

    def __init__(
        self,
        shard_id: int,
        *,
        bucket: int,
        chunk_iters: int = 8,
        solver_kw: Optional[dict] = None,
        device_env: Optional[Dict[str, str]] = None,
        extra_env: Optional[Dict[str, str]] = None,
        stderr_path: Optional[str] = None,
        telemetry: bool = False,
        reqtrace: bool = False,
        warm_model: Optional[str] = None,
        conformance: bool = False,
    ):
        self.shard_id = int(shard_id)
        self.bucket = int(bucket)
        self.chunk_iters = int(chunk_iters)
        self.solver_kw = dict(solver_kw or {})
        self.device_env = dict(device_env or {})
        self.extra_env = dict(extra_env or {})
        self.stderr_path = stderr_path
        self.telemetry = bool(telemetry)
        self.reqtrace = bool(reqtrace)
        self.warm_model = warm_model
        self.conformance = bool(conformance)
        self.proc: Optional[subprocess.Popen] = None
        self.lanes: Dict[Any, Any] = {}  # lane id -> SolveRequest
        self.last_ping: Optional[float] = None
        self.last_pong: float = 0.0
        self.spawned_at: float = 0.0
        # this spawn's first pong and first result frame (monotonic stamps,
        # None until they arrive) and its slowest ping round trip: the
        # child's start-up cost, read by chip_smoke.py serve (d)
        self.first_pong_at: Optional[float] = None
        self.first_result_at: Optional[float] = None
        self.ping_max = 0.0
        self.spawn_count = 0
        self._results: Queue = Queue()
        self._eof = False
        self._send_lock = threading.Lock()
        self._ping_seq = 0
        self._ping_sent: Dict[int, float] = {}  # seq -> stamp, until ponged
        self._stderr_fh = None

    # -- lifecycle -----------------------------------------------------
    def spawn(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            raise RuntimeError(f"shard {self.shard_id} already running")
        # _BOOTSTRAP, not ``-m dispatches_tpu_torch.serve.shard``: -m
        # imports the package (torch, seconds) before worker_main can
        # answer pings, so a respawn under a tight heartbeat_timeout
        # would be killed as wedged before it ever speaks
        import torch

        cmd = [
            sys.executable, "-c", _BOOTSTRAP, os.path.abspath(__file__),
            "--bucket", str(self.bucket),
            "--chunk-iters", str(self.chunk_iters),
            "--shard-id", str(self.shard_id),
            "--threads", str(torch.get_num_threads()),
            "--solver-kw", json.dumps(self.solver_kw),
            "--telemetry", "1" if self.telemetry else "0",
            "--reqtrace", "1" if self.reqtrace else "0",
            "--conformance", "1" if self.conformance else "0",
        ]
        if self.warm_model:
            cmd += ["--warm-model", os.path.abspath(self.warm_model)]
        env = dict(os.environ)
        # the child must import dispatches_tpu_torch whatever the parent's cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env.update(self.device_env)
        env.update(self.extra_env)
        stderr = subprocess.DEVNULL
        if self.stderr_path:
            self._stderr_fh = open(self.stderr_path, "ab")
            stderr = self._stderr_fh
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr, env=env,
        )
        self.spawn_count += 1
        self._eof = False
        self._results = Queue()
        now = time.monotonic()
        self.spawned_at = now
        self.first_pong_at = self.first_result_at = None
        self.ping_max = 0.0
        self.last_ping = None
        self.last_pong = now  # spawn grace: no wedge verdict before a ping
        self._ping_sent.clear()  # stale seqs must not match a fresh child
        threading.Thread(
            target=self._reader, args=(self.proc, self._results),
            name=f"shard-{self.shard_id}-reader", daemon=True,
        ).start()

    def _reader(self, proc: subprocess.Popen, results: Queue) -> None:
        while True:
            msg = read_frame(proc.stdout)
            if msg is None:
                if proc is self.proc:
                    self._eof = True
                return
            if msg.get("op") == "pong":
                if proc is self.proc:
                    now = time.monotonic()
                    self.last_pong = now
                    if self.first_pong_at is None:
                        self.first_pong_at = now
                    sent = self._ping_sent.pop(msg.get("seq"), None)
                    if sent is not None:
                        self.ping_max = max(self.ping_max, now - sent)
                        # lazy import: the CHILD executes this module's
                        # top level standalone and must stay stdlib-only
                        from ..obs import metrics as obs_metrics

                        obs_metrics.observe(
                            "serve_shard_ping_seconds", now - sent,
                            buckets=PING_BUCKETS,
                            shard=str(self.shard_id),
                        )
            else:
                if (msg.get("op") == "result" and proc is self.proc
                        and self.first_result_at is None):
                    self.first_result_at = time.monotonic()
                results.put(msg)

    def kill(self) -> None:
        """SIGKILL + reap. Idempotent; never raises on an already-dead
        child."""
        proc, self.proc = self.proc, None
        if proc is not None:
            try:
                proc.kill()
            except OSError:
                pass
            try:
                proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
            for fh in (proc.stdin, proc.stdout):
                try:
                    if fh is not None:
                        fh.close()
                except OSError:
                    pass
        if self._stderr_fh is not None:
            try:
                self._stderr_fh.close()
            except OSError:
                pass
            self._stderr_fh = None

    # -- protocol ------------------------------------------------------
    def _send(self, obj: dict) -> bool:
        proc = self.proc
        if proc is None or proc.stdin is None:
            return False
        try:
            with self._send_lock:
                write_frame(proc.stdin, obj)
            return True
        except (OSError, ValueError):  # broken pipe / closed file
            return False

    def solve(self, lane, req) -> bool:
        """Dispatch one request; tracks it in `lanes` until a result
        arrives or the fleet requeues it. Returns False (without
        tracking) when the pipe is already dead."""
        frame = {
            "op": "solve", "lane": lane, "problem": encode_row(req.problem),
        }
        if getattr(req, "fault", None):
            frame["fault"] = req.fault  # chaos payload rides the dispatch
        ok = self._send(frame)
        if ok:
            self.lanes[lane] = req
        return ok

    def cancel(self, lane) -> None:
        self.lanes.pop(lane, None)
        self._send({"op": "cancel", "lane": lane})

    def inject_fault(self, mode: str) -> bool:
        """Chaos hook: forward a fault op (``exit``/``hang``/``nan``)."""
        return self._send({"op": "fault", "mode": mode})

    def ping(self) -> None:
        self._ping_seq += 1
        # stamp BEFORE the send: a fast child's pong can land (and stamp
        # last_pong) before a post-send stamp would run, leaving
        # last_pong < last_ping forever — supervision then never re-pings
        # and kills a healthy shard when the wedge timer expires
        stamp = time.monotonic()
        self._ping_sent[self._ping_seq] = stamp
        if self._send({"op": "ping", "seq": self._ping_seq}):
            self.last_ping = stamp
        else:
            self._ping_sent.pop(self._ping_seq, None)

    def poll(self) -> List[dict]:
        """Drain every result frame received so far (non-blocking)."""
        out: List[dict] = []
        while True:
            try:
                out.append(self._results.get_nowait())
            except Empty:
                return out

    # -- liveness ------------------------------------------------------
    def alive(self) -> bool:
        return (
            self.proc is not None
            and self.proc.poll() is None
            and not self._eof
        )

    def exit_code(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def wedged(self, heartbeat_timeout: float) -> bool:
        """True when a ping has gone unanswered past the timeout — the
        process is alive but the protocol loop is not (hang fault, stuck
        device call). A shard that was never pinged is never wedged."""
        if self.last_ping is None or self.last_pong >= self.last_ping:
            return False
        return time.monotonic() - self.last_ping > heartbeat_timeout

    def inflight(self) -> int:
        return len(self.lanes)


def shard_device_env(n_shards: int, device="cuda") -> list:
    """Per-shard child environments (the port's counterpart of the JAX
    package's `parallel.mesh.shard_device_env`): on a CUDA `device`, shard
    i runs on ``cuda:i`` when the host has at least `n_shards` cards, and
    otherwise every shard shares ``cuda:0``, each child with its own CUDA
    context; a CPU `device` puts every child on the CPU. The parent
    decides placement; the child reads `DEVICE_ENV`."""
    kind = str(device).split(":")[0]
    if kind != "cuda":
        return [{DEVICE_ENV: kind} for _ in range(n_shards)]
    import torch

    n_dev = torch.cuda.device_count()
    if n_shards > 1 and n_dev >= n_shards:
        return [{DEVICE_ENV: f"cuda:{i}"} for i in range(n_shards)]
    return [{DEVICE_ENV: "cuda:0"} for _ in range(n_shards)]


if __name__ == "__main__":
    sys.exit(worker_main())
