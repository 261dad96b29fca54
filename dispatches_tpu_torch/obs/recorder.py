"""Failure flight recorder: capture the LP that broke (port of
`dispatches_tpu/obs/recorder.py`, numpy only).

The recorder snapshots a failed solve's whole instance on any
non-``healthy`` verdict: the problem's arrays via ``np.savez``, the solver
entry point's name and options, an optional warm start, the observed
solution, and a manifest from `obs.journal.build_manifest`, into a
**capped ring-buffer** directory, so a long sweep cannot fill a disk with
its own post-mortems.

Capture layout (one directory per capture, lexically sorted = age sorted),
the JAX package's byte for byte::

    <dir>/cap-000017-solve_lp/
        arrays.npz    # problem.<field>, sol.<field>, warm.<k>, extra.<k>
        meta.json     # solver, problem_type, options, verdict, manifest

Tensors are copied to the host as numpy arrays, so a capture the port
writes loads in the JAX package's `load_capture` and the other way round.
Nothing records until a recorder is installed (`set_recorder`, or the
workflow CLI's ``--record-failures DIR``); `tools/torch_replay_solve.py`
reruns a capture's solver entry point and compares the result bitwise.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

# ring-buffer caps: captures beyond either evict oldest-first. A weekly
# LPData at T=168 is ~15 MiB in f64 and a year BandedLP batch ~100 MiB, so
# the byte cap is the binding one for year-scale captures
DEFAULT_MAX_CAPTURES = 50
DEFAULT_MAX_BYTES = 256 * 2**20

# the entry points whose problems the replay tool rebuilds; other problem
# types (BandedLP, whose static structure is not serialized) capture for
# offline analysis
REPLAYABLE = ("solve_lp", "solve_lp_pdhg")


def _np(v) -> np.ndarray:
    """`v` (a tensor on any device, an array or a number) as numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _json_safe(obj: Any) -> Any:
    """Options may carry numpy scalars or torch dtypes; meta.json keeps
    them as plain JSON (dtypes as strings)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, bool, int, float)) or obj is None:
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return str(obj)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class FlightRecorder:
    """Capped ring-buffer capture directory. A capture is written under a
    temporary name and renamed, so a reader never sees a torn one."""

    def __init__(
        self,
        directory: str,
        max_captures: int = DEFAULT_MAX_CAPTURES,
        max_bytes: int = DEFAULT_MAX_BYTES,
    ):
        self.directory = os.path.abspath(directory)
        self.max_captures = int(max_captures)
        self.max_bytes = int(max_bytes)
        os.makedirs(self.directory, exist_ok=True)

    # -- internals -----------------------------------------------------
    def _captures(self):
        try:
            names = sorted(n for n in os.listdir(self.directory) if n.startswith("cap-"))
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    def _next_seq(self) -> int:
        seq = 0
        for p in self._captures():
            try:
                seq = max(seq, int(os.path.basename(p).split("-")[1]))
            except (IndexError, ValueError):
                pass
        return seq + 1

    def _enforce_caps(self) -> None:
        caps = self._captures()
        while caps and len(caps) > self.max_captures:
            shutil.rmtree(caps.pop(0), ignore_errors=True)
        total = sum(_dir_bytes(p) for p in caps)
        while caps and len(caps) > 1 and total > self.max_bytes:
            victim = caps.pop(0)
            total -= _dir_bytes(victim)
            shutil.rmtree(victim, ignore_errors=True)

    # -- public API ----------------------------------------------------
    def capture(
        self,
        solver: str,
        problem: Any = None,
        options: Optional[dict] = None,
        verdict: Any = None,
        warm_start: Optional[Dict[str, Any]] = None,
        solution: Any = None,
        arrays: Optional[Dict[str, Any]] = None,
        extra: Optional[dict] = None,
    ) -> Optional[str]:
        """Snapshot one failed solve; returns the capture directory, or
        None when writing failed (recording must never kill the run it
        documents). `problem` and `solution` are NamedTuples of tensors or
        arrays (`LPData`, `SparseLP`, `BandedLP`; an `IPMSolution` or a
        `PDHGSolution`); `arrays` holds any other array bundle."""
        from .journal import build_manifest, get_tracer

        tmp = None
        try:
            payload: Dict[str, np.ndarray] = {}
            problem_type = None
            if problem is not None and hasattr(problem, "_fields"):
                problem_type = type(problem).__name__
                for f in problem._fields:
                    payload[f"problem.{f}"] = _np(getattr(problem, f))
            if solution is not None and hasattr(solution, "_fields"):
                for f in solution._fields:
                    payload[f"sol.{f}"] = _np(getattr(solution, f))
            for prefix, bundle in (("warm", warm_start), ("extra", arrays)):
                for k, v in (bundle or {}).items():
                    payload[f"{prefix}.{k}"] = _np(v)

            meta = {
                "solver": solver,
                "problem_type": problem_type,
                "device": _device_type(problem),
                "replayable": solver in REPLAYABLE and problem_type is not None,
                "options": _json_safe(options or {}),
                "verdict": _json_safe(
                    verdict._asdict() if hasattr(verdict, "_asdict") else verdict
                ),
                "ts": time.time(),
                "manifest": build_manifest({"tool": "flight_recorder"}),
                "extra": _json_safe(extra or {}),
            }

            name = f"cap-{self._next_seq():06d}-{solver.replace('/', '_')}"
            final = os.path.join(self.directory, name)
            tmp = f"{final}.{os.getpid()}.tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **payload)
            with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as fh:
                json.dump(meta, fh, indent=1)
            os.replace(tmp, final)
        except Exception:  # noqa: BLE001 - the recorder's boundary
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
            return None
        self._enforce_caps()
        v = meta["verdict"]
        get_tracer().event("capture", solver=solver, path=final,
                           verdict=v.get("verdict") if isinstance(v, dict) else v)
        return final


def _device_type(problem: Any) -> Optional[str]:
    """The device type ("cuda", "cpu") of the problem's first tensor field:
    where the captured solve ran, so a replay can run there too. None for
    numpy fields or no problem."""
    if not hasattr(problem, "_fields"):
        return None
    for v in problem:
        dev = getattr(getattr(v, "device", None), "type", None)
        if isinstance(dev, str):
            return dev
    return None


_WARM_PARTS = {4: ("x", "y", "zl", "zu"), 2: ("x", "y")}


def warm_bundle(problem: Any, warm_start: Any) -> Optional[Dict[str, Any]]:
    """Capture bundle of a solver's warm seed: the RAW parts (``x`` /
    ``y`` / ``zl`` / ``zu``, or ``x`` / ``y`` for PDHG), which replay feeds
    back through ``warm_start=`` (the solver re-applies its own safeguard).
    For a single dense LP it also records the seed the safeguard applied
    and its verdict (``applied_*``, ``accepted``), through
    `solvers.ipm.apply_warm_safeguard`. None for no warm start."""
    if warm_start is None:
        return None
    if isinstance(warm_start, dict):
        return {str(k): _np(v) for k, v in warm_start.items()}
    parts = _WARM_PARTS.get(len(warm_start))
    if parts is None:
        return {f"part{i}": _np(v) for i, v in enumerate(warm_start)}
    bundle = {k: _np(v) for k, v in zip(parts, warm_start)}
    if (type(problem).__name__ == "LPData" and len(warm_start) == 4
            and bundle["x"].ndim <= 1):
        from ..solvers.ipm import apply_warm_safeguard

        applied, ok = apply_warm_safeguard(problem, warm_start)
        for k, v in zip(parts, applied):
            bundle[f"applied_{k}"] = _np(v)
        bundle["accepted"] = _np(ok)
    return bundle


def load_capture(path: str) -> dict:
    """Reload a capture: meta.json plus the arrays (numpy), with the problem
    NamedTuple rebuilt (numpy fields) when its type is known. `path` may
    be the capture directory or its arrays.npz."""
    if path.endswith(".npz"):
        path = os.path.dirname(path)
    with open(os.path.join(path, "meta.json"), "r", encoding="utf-8") as fh:
        meta = json.load(fh)
    with np.load(os.path.join(path, "arrays.npz")) as dat:
        arrays = {k: np.asarray(dat[k]) for k in dat.files}

    def part(prefix):
        return {k.split(".", 1)[1]: v for k, v in arrays.items() if k.startswith(prefix)}

    out = {
        "path": path,
        "meta": meta,
        "arrays": arrays,
        "problem": None,
        "solution": part("sol."),
        "warm_start": part("warm."),
    }
    ptype = meta.get("problem_type")
    pfields = part("problem.")
    if ptype and pfields:
        cls = None
        if ptype in ("LPData", "SparseLP"):
            from ..core import program as _program

            cls = getattr(_program, ptype, None)
        elif ptype == "BandedLP":
            from ..solvers import structured as _structured

            cls = getattr(_structured, ptype, None)
        if cls is not None and set(cls._fields) <= set(pfields):
            out["problem"] = cls(**{f: pfields[f] for f in cls._fields})
        else:
            out["problem"] = pfields
    return out


# ---------------------------------------------------------------------------
# the process-wide recorder (None means off)
# ---------------------------------------------------------------------------
_RECORDER: Optional[FlightRecorder] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def set_recorder(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install `rec` (None disables recording); returns the previous one."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


def maybe_capture(solver: str, verdict: Any = None, **kw) -> Optional[str]:
    """Capture through the installed recorder, but only for a non-healthy
    verdict (None counts as non-healthy: a failure record has no verdict
    object). No-op when no recorder is installed."""
    rec = _RECORDER
    if rec is None:
        return None
    if getattr(verdict, "verdict", verdict) == "healthy":
        return None
    return rec.capture(solver, verdict=verdict, **kw)
