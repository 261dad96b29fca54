"""Per-iteration solver traces (port of `dispatches_tpu/obs/trace.py`).

A :class:`SolveTrace` holds per-iteration arrays — primal/dual residuals,
duality gap and step sizes — recorded inside the IPM loop when the caller
passes ``trace=True``. Buffers are padded to ``max_iter`` with NaN, one row
per batch lane (shape ``(B, max_iter)`` batched, ``(max_iter,)`` for an
unbatched solve), the shapes the JAX package returns.
"""
from __future__ import annotations

from typing import NamedTuple

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
