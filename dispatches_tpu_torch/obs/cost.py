"""Measured cost records of a solve (the port's counterpart of
`dispatches_tpu/obs/cost.py`).

The JAX module reads XLA's static cost model of a compiled executable and
parses its HLO text into a per-op ledger. Eager PyTorch has neither, so
this module counts what a solve executes instead:

- **FLOPs** by the formulas of `torch.utils.flop_counter` (its
  `flop_registry`: the matrix products ``aten.mm``, ``bmm``, ...), to
  which `LINALG_FLOPS` adds the linear algebra the IPMs call, which the
  registry counts as 0: a Cholesky factor n^3/3 a matrix, a triangular
  solve n^2 k, ``cholesky_solve`` twice that (a forward and a backward
  solve). The formulas run in one dispatch mode of this module's
  (`_CountMode`), not in `FlopCounterMode`, which tries to decompose
  every operation outside its registry: on the card that tripled a
  counted year batch's wall (PERF.md §6).
- **Bytes** from the shapes: every operation that is not a view reads
  each tensor argument once and writes its output once.
- **The hand-written kernel.** `chain_sweep` launches through ctypes, out
  of the dispatcher's sight: each launch adds its FLOPs and bytes from
  its shapes (`solvers.chain_sweep.sweep_work`, which a test holds equal
  to the formulas `chip_smoke.py` bounds the kernel with), and the ledger
  carries it as one entry.
- **Peak device memory** from ``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats`` at the start of the measured call, on the
  card only.

Counting semantics differ from the JAX package's: the port counts
**executed** work, every iteration of every loop, where XLA's model
counts a loop body once. Every record says so (``flops_basis:
"executed"``). The counter intercepts every operation in Python, so the
measured call runs slower: `CostCounter` stays opt-in (``cost=True`` on
`run_year_sweep`, ``capture_sizes=True`` on `obs.perf.PerfProbe`). It
only counts; the solve's results are bitwise those without it.

`chip_peak_tflops` is the roofline's denominator: on the card it times a
large f64 and f32 product once a process (TF32 off, as in every solver
path) and names the card and its power limit in the source string; on
the CPU it returns ``(None, reason)``. The TPU anchors of the JAX package
(``MATMUL_PEAK.json``, ``BASELINE_HOST.json``) are not read.
"""
from __future__ import annotations

import math
import subprocess
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, shape_wrapper

aten = torch.ops.aten


def _batch(shape) -> int:
    return math.prod(shape[:-2]) if len(shape) > 2 else 1


def _cholesky_flops(A_shape, *args, out_shape=None, **kwargs) -> int:
    n = A_shape[-1]
    return _batch(A_shape) * n ** 3 // 3


def _solve_triangular_flops(A_shape, B_shape, *args, out_shape=None, **kwargs) -> int:
    # n^2 per right-hand side; left or right, the output has B's shape
    return math.prod(out_shape) * A_shape[-1]


def _cholesky_solve_flops(B_shape, L_shape, *args, out_shape=None, **kwargs) -> int:
    # a forward and a backward triangular solve per right-hand side
    n = L_shape[-1]
    return 2 * math.prod(out_shape) * n


# formulas for the linear algebra FlopCounterMode counts as 0
LINALG_FLOPS: Dict[Any, Callable] = {
    aten.linalg_cholesky_ex: _cholesky_flops,
    aten.linalg_solve_triangular: _solve_triangular_flops,
    aten.cholesky_solve: _cholesky_solve_flops,
}


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(a) for a in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(a) for a in obj.values())
    return 0


# FlopCounterMode's formulas (shape-wrapped) and ours
_FORMULAS = {**flop_registry, **{k: shape_wrapper(v) for k, v in LINALG_FLOPS.items()}}


class _CountMode(TorchDispatchMode):
    """FLOPs, bytes and calls by aten op: the FLOPs by `_FORMULAS`, the
    bytes of a non-view op its tensor arguments read once and its output
    written once. It only counts; each op runs as it would without it."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)
        self.calls: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = str(packet)
        self.calls[name] += 1
        formula = _FORMULAS.get(packet)
        if formula is not None:
            self.flops[name] += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes[name] += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def _cuda_of(device) -> Optional[torch.device]:
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class CostCounter:
    """Count one call's executed work::

        with CostCounter(device) as cc:
            sol = solve(...)
        rec = cc.record()

    `device` (a CUDA device) adds the peak device memory of the call; the
    card is synchronized at both ends, so `wall_s` is the device's."""

    def __init__(self, device=None):
        self.device = _cuda_of(device)
        self.mode: Optional[_CountMode] = None
        self.wall_s: Optional[float] = None
        self.peak_bytes: Optional[int] = None
        self._sweep0 = (0, 0, 0)

    @staticmethod
    def _sweep_totals():
        from ..solvers.chain_sweep import chain_sweep

        return chain_sweep.launches, chain_sweep.flops, chain_sweep.bytes

    def __enter__(self) -> "CostCounter":
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._sweep0 = self._sweep_totals()
        self.mode = _CountMode()
        self.mode.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.mode.__exit__(*exc)
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        self.wall_s = time.perf_counter() - self._t0

    def ledger(self, top_k: int = 10) -> Dict[str, Any]:
        """The executed work by aten op (FLOPs, bytes and calls), plus one
        ``chain_sweep`` entry for the kernel's launches; ranked by FLOPs,
        then bytes."""
        m = self.mode
        rows: Dict[str, Dict[str, Any]] = {
            name: {"op": name, "count": n, "flops": m.flops.get(name, 0),
                   "bytes": m.bytes.get(name, 0)}
            for name, n in m.calls.items()
        }
        launches, sflops, sbytes = (a - b for a, b in zip(self._sweep_totals(), self._sweep0))
        if launches:
            rows["chain_sweep"] = {"op": "chain_sweep", "count": launches,
                                   "flops": sflops, "bytes": sbytes}
        total_flops = sum(r["flops"] for r in rows.values())
        total_bytes = sum(r["bytes"] for r in rows.values())
        for r in rows.values():
            r["flops_share"] = r["flops"] / total_flops if total_flops else 0.0
        rank = sorted(rows.values(), key=lambda r: (-r["flops"], -r["bytes"], r["op"]))
        return {
            "by_op": rank[: max(0, int(top_k))] if top_k is not None else rank,
            "total_flops": total_flops,
            "total_bytes": total_bytes,
            "op_count": sum(r["count"] for r in rows.values()),
            "chain_sweep_launches": launches,
        }

    def record(self, top_k: int = 10) -> Dict[str, Any]:
        """The cost record: ``flops`` and ``bytes_accessed`` (executed),
        ``flops_basis``, the ledger, ``wall_s`` of the counted call and,
        on the card, ``peak_bytes``."""
        led = self.ledger(top_k)
        rec: Dict[str, Any] = {
            "flops": float(led["total_flops"]),
            "bytes_accessed": float(led["total_bytes"]),
            "flops_basis": "executed",
            "chain_sweep_launches": led["chain_sweep_launches"],
            "wall_s": self.wall_s,
            "ledger": led,
        }
        if self.peak_bytes is not None:
            rec["peak_bytes"] = self.peak_bytes
        return rec


def call_cost(fn: Callable, *args, device=None, top_k: int = 10, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a `CostCounter`; returns
    ``(result, record)``."""
    with CostCounter(device) as cc:
        out = fn(*args, **kwargs)
    return out, cc.record(top_k)


# -- roofline ----------------------------------------------------------

_PEAKS: Dict[Any, Tuple[float, str]] = {}
PEAK_N = 8192


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()
        return out[0].split(",")[-1].strip() if out else "power limit unknown"
    except Exception:
        return "power limit unknown"


def _gemm_tflops(dtype, device, n: int, reps: int = 5) -> float:
    a = torch.randn(n, n, dtype=dtype, device=device)
    b = torch.randn(n, n, dtype=dtype, device=device)
    for _ in range(2):
        a @ b
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        a @ b
    stop.record()
    torch.cuda.synchronize(device)
    return 2.0 * n ** 3 * reps / (start.elapsed_time(stop) * 1e-3) / 1e12


def chip_peak_tflops(device=None) -> Tuple[Optional[float], str]:
    """The roofline's denominator, ``(tflops, source)``: on the card the
    larger of a timed f64 and f32 `PEAK_N`-square product (TF32 off),
    measured once a process and device; on the CPU ``(None, reason)``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None, "not measured: no CUDA device (the peak is measured on the card)"
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index in _PEAKS:
        return _PEAKS[device.index]
    from ..solvers.ipm import pin_matmul_precision

    pin_matmul_precision()
    f64 = _gemm_tflops(torch.float64, device, PEAK_N)
    f32 = _gemm_tflops(torch.float32, device, PEAK_N)
    source = (f"measured: {torch.cuda.get_device_name(device)}, {_power_limit()}: "
              f"f64 {f64:.2f}, f32 {f32:.2f} TFLOP/s ({PEAK_N}^3 products, TF32 off)")
    _PEAKS[device.index] = (max(f64, f32), source)
    return _PEAKS[device.index]


def roofline(flops: Optional[float], wall_s: Optional[float],
             peak_tflops: Optional[float] = None, device=None) -> Dict[str, Any]:
    """Executed FLOPs over the measured wall as a share of the measured
    peak. NaN-safe: ``achieved_tflops`` without ``utilization`` when no
    peak is known."""
    rec: Dict[str, Any] = {}
    source = None
    if peak_tflops is None:
        peak_tflops, source = chip_peak_tflops(device)
    if peak_tflops is not None:
        rec["peak_tflops"] = float(peak_tflops)
    if source:
        rec["peak_source"] = source
    if flops is not None and wall_s is not None and wall_s > 0:
        achieved = float(flops) / float(wall_s) / 1e12
        rec["achieved_tflops"] = achieved
        if peak_tflops:
            rec["utilization"] = achieved / float(peak_tflops)
    return rec


def with_roofline(cost: Dict[str, Any], wall_s: Optional[float], device=None,
                  wall_basis: Optional[str] = None) -> Dict[str, Any]:
    """`cost` with a ``roofline`` sub-record from its ``flops`` and the
    measured `wall_s`; `wall_basis` says what that wall is (``"counted"``:
    the call ran under the counter, which slows it, so the achieved rate
    and the share are lower than an uncounted call's)."""
    out = dict(cost)
    rl = roofline(out.get("flops"), wall_s, device=device)
    if rl and wall_basis is not None:
        rl["wall_basis"] = wall_basis
    if rl:
        out["roofline"] = rl
    return out
