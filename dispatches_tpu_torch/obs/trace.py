"""Per-iteration solver traces (port of `dispatches_tpu/obs/trace.py`).

A :class:`SolveTrace` holds per-iteration arrays — primal/dual residuals,
duality gap and step sizes — recorded inside the IPM loop when the caller
passes ``trace=True``. Buffers are padded to ``max_iter`` with NaN, one row
per batch lane (shape ``(B, max_iter)`` batched, ``(max_iter,)`` for an
unbatched solve), the shapes the JAX package returns. The host-side
readers (`recorded_iterations`, `flag_divergent`, `trace_stats`) are the
JAX package's, on numpy copies.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolveTrace(NamedTuple):
    """Per-iteration trajectories, NaN past each lane's iteration count."""

    res_primal: torch.Tensor  # relative primal residual per iteration
    res_dual: torch.Tensor  # relative dual residual per iteration
    gap: torch.Tensor  # relative complementarity gap
    step_primal: torch.Tensor  # primal step size taken (alpha_p)
    step_dual: torch.Tensor  # dual step size taken (alpha_d)


def empty_trace(length: int, dtype=torch.float32, batch=(), device="cuda") -> SolveTrace:
    """NaN-filled trace buffers of shape (*batch, length)."""
    return SolveTrace(
        *(torch.full((*batch, length), float("nan"), dtype=dtype, device=device)
          for _ in range(5))
    )


def record(tr: SolveTrace, it, rp, rd, gap, ap, ad) -> SolveTrace:
    """Write one iteration's per-lane scalars at per-lane index `it` (B,)."""
    length = tr.res_primal.shape[-1]
    if length == 0:
        return tr
    # an index past the end (a finished lane) lands on the last slot; the
    # IPM loop discards finished lanes' updates
    slot = torch.nn.functional.one_hot(
        it.clamp(0, length - 1).long(), length
    ).bool()
    return SolveTrace(*(
        torch.where(slot, v.to(buf.dtype)[..., None], buf)
        for buf, v in zip(tr, (rp, rd, gap, ap, ad))
    ))


# ----------------------------------------------------------------------
# Host-side readers
# ----------------------------------------------------------------------
def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def recorded_iterations(tr: SolveTrace) -> np.ndarray:
    """Number of recorded entries per trajectory (finite-prefix length of
    `res_primal` along the last axis). Shape () unbatched, (B,) batched."""
    return np.isfinite(_host(tr.res_primal)).sum(axis=-1)


def flag_divergent(tr: SolveTrace, blowup: float = 1e3) -> np.ndarray:
    """Boolean per-trajectory flag: the gap trajectory ends more than
    `blowup` x above its smallest positive value, or a non-finite value
    appears *before* the last recorded entry (mid-solve breakdown). NaN
    padding after the last entry is normal and not flagged."""
    gap = _host(tr.gap)
    gap2 = np.atleast_2d(gap)
    n_rec = np.isfinite(np.atleast_2d(_host(tr.res_primal))).sum(axis=-1)
    out = np.zeros(gap2.shape[0], dtype=bool)
    for b in range(gap2.shape[0]):
        g = gap2[b, : max(int(n_rec[b]), 0)]
        fin = g[np.isfinite(g)]
        if len(g) == 0:
            continue
        if len(fin) < len(g):  # non-finite inside the recorded region
            out[b] = True
            continue
        # an exact-zero entry (a PDLP restart can equalize the objectives)
        # is no floor to blow up from
        pos = fin[fin > 0.0]
        if len(pos) and fin[-1] > blowup * pos.min():
            out[b] = True
    return out if gap.ndim > 1 else out[0]


def trace_stats(tr: SolveTrace) -> dict:
    """Compact host-side summary of a (possibly batched) trace: recorded
    lengths, final residuals/gap per trajectory, divergence flags, and the
    primal step's first and final values with its count of changes."""
    n_rec = np.atleast_1d(recorded_iterations(tr))
    gap = np.atleast_2d(_host(tr.gap))
    rp = np.atleast_2d(_host(tr.res_primal))
    rd = np.atleast_2d(_host(tr.res_dual))
    B = gap.shape[0]
    fin_gap, fin_rp, fin_rd = [], [], []
    for b in range(B):
        k = max(int(n_rec[b]) - 1, 0)
        fin_gap.append(float(gap[b, k]) if gap.shape[1] else float("nan"))
        fin_rp.append(float(rp[b, k]) if rp.shape[1] else float("nan"))
        fin_rd.append(float(rd[b, k]) if rd.shape[1] else float("nan"))
    div = np.atleast_1d(flag_divergent(tr))
    out = {
        "batch": int(B),
        "recorded_iterations": [int(v) for v in n_rec],
        "final_gap": fin_gap,
        "final_res_primal": fin_rp,
        "final_res_dual": fin_rd,
        "divergent": [bool(v) for v in div],
        "n_divergent": int(div.sum()),
    }
    sp = np.atleast_2d(_host(tr.step_primal))
    s_first, s_final, s_changes = [], [], []
    for b in range(B):
        s = sp[b, : max(int(n_rec[b]), 0)]
        s = s[np.isfinite(s)]
        if s.size == 0:
            s_first.append(float("nan"))
            s_final.append(float("nan"))
            s_changes.append(0)
            continue
        s_first.append(float(s[0]))
        s_final.append(float(s[-1]))
        s_changes.append(int((np.abs(np.diff(s)) > 1e-12 * np.abs(s[:-1])).sum()))
    out["step_primal"] = {"first": s_first, "final": s_final, "changes": s_changes}
    return out
