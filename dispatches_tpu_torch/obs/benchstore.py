"""Append-only bench history with a trend-aware regression gate (port of
`dispatches_tpu/obs/benchstore.py`, host-side Python kept line for line).

Every bench run appends one JSONL entry: a timestamp, a label, the
host/device fingerprint (`obs.journal`'s manifest helpers: the card's
name from ``torch.cuda.get_device_name``) and the flattened numeric
metrics. `trend_gate` judges a new entry against the median of the last
K comparable entries (same label, same device kind: an H100 entry never
gates against a TPU or CPU one) with a MAD-scaled threshold
``max(nmad * 1.4826 * MAD, rel_floor * |median|, abs_floor)``; the
direction of "worse" per metric comes from `lower_is_better` (the CLI
passes `journal_diff`'s inference).

Verdicts per metric: ``ok`` / ``regression`` / ``improved`` / ``new``
(no comparable history) / ``insufficient`` (fewer than `min_points`
comparable points). The entries keep the JAX package's keys, so a
history file crosses between the two packages both ways. Rendering, CLI
gating and the self-check live in `tools/torch_bench_history.py`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

# mirrors tools/journal_diff.py's _HIGHER_IS_BETTER closely enough for
# standalone use; the CLI injects the real one so the two gates can
# never disagree when both are installed
_HIGHER_IS_BETTER_FALLBACK = (
    "per_sec", "per_chip", "converged", "mfu", "tflops", "utilization",
    "throughput", "goodput", "cache_hit", "iters_saved",
)


def default_lower_is_better(metric: str) -> bool:
    m = metric.lower()
    return not any(pat in m for pat in _HIGHER_IS_BETTER_FALLBACK)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def flatten_metrics(obj: Any, prefix: str = "") -> Dict[str, float]:
    """All numeric leaves of a nested dict/list as {slash/path: value}
    (same path scheme as journal_diff.flatten_numeric, so a history row
    and a journal diff name the same quantity identically)."""
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(
                flatten_metrics(v, f"{prefix}/{k}" if prefix else str(k))
            )
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(
                flatten_metrics(v, f"{prefix}/{i}" if prefix else str(i))
            )
    elif _is_num(obj):
        out[prefix] = float(obj)
    return out


def fingerprint() -> Dict[str, Any]:
    """Host/device identity of this run — what decides which history
    entries are comparable. Built from `obs.journal`'s manifest helpers:
    ``device_kind`` is the card's name when CUDA is available, else
    None."""
    import platform

    from .journal import _device_info, _git_sha, _versions

    fp: Dict[str, Any] = {
        "host": platform.node(),
        "os": platform.platform(),
        "git_sha": _git_sha(),
        "versions": _versions(),
    }
    fp.update(_device_info())
    return fp


def make_entry(
    label: str,
    metrics: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
    ts: Optional[float] = None,
) -> Dict[str, Any]:
    """One history row: `metrics` may be nested (flattened here) or
    already flat."""
    flat = flatten_metrics(metrics)
    entry: Dict[str, Any] = {
        "ts": time.time() if ts is None else float(ts),
        "label": str(label),
        "fingerprint": fingerprint(),
        "metrics": flat,
    }
    if extra:
        entry.update(extra)
    return entry


def append_entry(path: str, entry: Dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        json.dump(entry, fh, sort_keys=True)
        fh.write("\n")


def read_history(path: str) -> List[Dict[str, Any]]:
    """Parse a history file, skipping torn lines (a SIGKILL'd bench may
    leave a partial final record — same tolerance as the journals)."""
    out: List[Dict[str, Any]] = []
    try:
        fh = open(path, "r", encoding="utf-8", errors="replace")
    except OSError:
        return out
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and isinstance(rec.get("metrics"), dict):
                out.append(rec)
    return out


def comparable(entry: Dict[str, Any], other: Dict[str, Any]) -> bool:
    """History rows gate against each other only when they measured the
    same thing on the same class of hardware: same label, same device
    kind (None matches None — two host-only runs compare fine)."""
    if entry.get("label") != other.get("label"):
        return False
    fa = entry.get("fingerprint") or {}
    fb = other.get("fingerprint") or {}
    return fa.get("device_kind") == fb.get("device_kind")


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def trend_gate(
    history: List[Dict[str, Any]],
    entry: Dict[str, Any],
    *,
    k: int = 5,
    nmad: float = 4.0,
    rel_floor: float = 0.05,
    abs_floor: float = 1e-9,
    min_points: int = 3,
    lower_is_better: Optional[Callable[[str], bool]] = None,
) -> Dict[str, Any]:
    """Judge `entry` against the trailing history. Returns
    ``{"rows": [...], "regressions": [...], "ok": bool, "baseline_n"}``;
    each row carries metric / value / median / mad / threshold / delta /
    direction / verdict."""
    lib = lower_is_better or default_lower_is_better
    base = [h for h in history if comparable(entry, h)][-int(k):]
    rows: List[Dict[str, Any]] = []
    for metric in sorted(entry.get("metrics") or {}):
        value = entry["metrics"][metric]
        vals = [
            h["metrics"][metric] for h in base
            if _is_num(h["metrics"].get(metric))
        ]
        row: Dict[str, Any] = {
            "metric": metric,
            "value": value,
            "n": len(vals),
            "direction": (
                "lower_is_better" if lib(metric) else "higher_is_better"
            ),
        }
        if not vals:
            row["verdict"] = "new"
        elif len(vals) < int(min_points):
            row["verdict"] = "insufficient"
        else:
            med = _median(vals)
            mad = _median([abs(v - med) for v in vals])
            thr = max(
                float(nmad) * 1.4826 * mad,
                float(rel_floor) * abs(med),
                float(abs_floor),
            )
            delta = value - med
            worse = delta > thr if lib(metric) else delta < -thr
            better = delta < -thr if lib(metric) else delta > thr
            row.update(median=med, mad=mad, threshold=thr, delta=delta)
            row["verdict"] = (
                "regression" if worse else "improved" if better else "ok"
            )
        rows.append(row)
    regressions = [r for r in rows if r["verdict"] == "regression"]
    return {
        "rows": rows,
        "regressions": regressions,
        "ok": not regressions,
        "baseline_n": len(base),
    }
