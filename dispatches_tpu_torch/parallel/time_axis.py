"""Time-axis (horizon) decomposition by consensus ADMM (port of
`dispatches_tpu/parallel/time_axis.py`).

The dispatch horizon (8,760 hourly blocks chained by storage state) is
split into D chunks. Each chunk is the same LP with free boundary-state
variables (e.g. battery SoC and throughput at the chunk's edges); the
chunks reach consensus on the boundary states by scaled ADMM:

    chunk solve:  min  c.x + (rho/2)|x_in - (z_prev - u_in)|^2
                       + (rho/2)|x_out - (z_self - u_out)|^2
                  s.t. A x = b,  l <= x <= u
    consensus:    z_b = 0.5 (out_b + u_out_b + in_{b+1} + u_in_{b+1})
    duals:        u_out += out - z_self ; u_in += in - z_prev

The JAX package runs the D chunk solves one a device over `shard_map`,
the boundary exchange a `ppermute` around the device ring, or as a
`vmap` on one device. The port runs them on one card as the D lanes of
one batch: each ADMM sweep is one `solve_lp_batch(..., q=)` (the
diagonal-QP IPM; ``A`` stays shared when no parameter enters it), the
ring exchange a `torch.roll` of the boundary states over the chunk axis,
and the global sums plain reductions. The JAX `fori_loop` is a Python
loop that reads nothing on the host inside a sweep beyond the IPM's own
per-iteration read; each sweep's convergence, finiteness and iterations
are read after the loop (`HorizonSolution.stats`).

`z_fixed` pins the consensus state of the wrap boundary (chunk D-1's end
is chunk 0's start), the reference's fixed-initial-SoC + periodic idiom;
`wrap_free` marks cumulative boundary coordinates (throughput), whose
final end copy is left unpenalized. The wind + battery case (the chunk
LP, the coarse warm start) is `case_studies/renewables/horizon.py`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.program import CompiledLP, LPData
from ..solvers.ipm import solve_lp_batch


class HorizonSolution:
    """``x`` (D, n) the chunk solutions, ``z`` (D, k) the boundary
    consensus states, ``primal_residual`` the largest boundary mismatch
    over the coupled boundaries, ``obj`` the summed chunk objective.
    ``stats`` holds, per ADMM sweep and for the final solve, the largest
    IPM iteration count, whether every lane converged with finite values,
    and the boundary mismatch of that solve (read once, after the
    loop)."""

    def __init__(self, x, z, primal_residual, obj, stats=None):
        self.x = x
        self.z = z
        self.primal_residual = primal_residual
        self.obj = obj
        self.stats = stats or {}


def _local_solve(lp: LPData, idx, a, w, tol, iters):
    """The D chunks' augmented-Lagrangian subproblems as one batch: each
    chunk LP plus the diagonal quadratic boundary penalty (w/2)|x_S - a|^2
    (per-coordinate weights; 0 = uncoupled copy), expanded into a
    diagonal-Q term and a linear shift and solved exactly by the
    diagonal-QP IPM (`solve_lp_batch(..., q=)`). `a`, `w`: (D, |idx|)."""
    D = a.shape[0]
    c = lp.c.expand(D, lp.c.shape[-1])
    qv = torch.zeros_like(c).index_add_(1, idx, w)
    c_mod = c.index_add(1, idx, -(w * a))
    sol = solve_lp_batch(lp._replace(c=c_mod), tol=tol, max_iter=iters, q=qv)
    return sol


def solve_horizon_admm(
    prog: CompiledLP,
    chunk_params: Dict[str, torch.Tensor],  # each (D, ...) chunk-stacked
    idx_in: np.ndarray,
    idx_out: np.ndarray,
    rho: float = 1e-5,
    admm_iters: int = 20,
    z_fixed=None,  # (k,) pin the wrap boundary
    wrap_free: Optional[np.ndarray] = None,  # (k,) bool: cumulative states
    z0=None,  # (D, k) consensus warm start
    adapt_rho: bool = True,
    nlp_tol: float = 1e-8,
    nlp_iters: int = 60,
    dtype=torch.float64,
    device="cuda",
) -> HorizonSolution:
    """Ring ADMM over the horizon's chunks, the D chunks the lanes of one
    batch on `device` (the card unless asked otherwise). Arguments as in
    the JAX package (which also takes a mesh; the port runs on one
    device): `z_fixed` pins the wrap boundary's consensus state,
    `wrap_free` leaves the final chunk's end copy of cumulative
    coordinates unpenalized, `z0` warm-starts the consensus states (pass
    boundary states from a coarse monolithic solve for storage arbitrage:
    averaging cannot find cross-chunk patterns from a cold start), and
    `adapt_rho` balances the residuals by rescaling rho (Boyd et al.
    §3.4.1; off with a good `z0`)."""
    device = torch.device(device)
    D = next(iter(chunk_params.values())).shape[0]
    k = len(idx_in)
    # when no parameter enters A (prices and capacity factors land in b and
    # c), A, l and u stay unbatched and only b, c and c0 carry the chunk
    # axis, as in the JAX package
    lp_b = prog.instantiate(chunk_params, dtype=dtype, device=device)
    idx_in_t = torch.as_tensor(np.asarray(idx_in), dtype=torch.long, device=device)
    idx_out_t = torch.as_tensor(np.asarray(idx_out), dtype=torch.long, device=device)
    idx = torch.cat([idx_in_t, idx_out_t])

    mask_np = np.ones((D, k), bool)
    if wrap_free is not None:
        if z_fixed is None:
            raise ValueError("wrap_free requires z_fixed (a pinned start state)")
        mask_np[D - 1, np.asarray(wrap_free)] = False
    mask = torch.as_tensor(mask_np, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    z = (torch.zeros((D, k), dtype=dtype, device=device) if z0 is None
         else torch.as_tensor(np.asarray(z0) if not torch.is_tensor(z0) else z0,
                              dtype=dtype, device=device).clone())
    pin = None if z_fixed is None else torch.as_tensor(
        np.asarray(z_fixed) if not torch.is_tensor(z_fixed) else z_fixed,
        dtype=dtype, device=device)

    def local_solves(a_in, a_out, rho_t):
        w_in = torch.full(a_in.shape, 1.0, dtype=dtype, device=device) * rho_t
        w_out = torch.where(mask, rho_t, zero)
        return _local_solve(lp_b, idx, torch.cat([a_in, a_out], 1),
                            torch.cat([w_in, w_out], 1), nlp_tol, nlp_iters)

    def mismatch(xs):
        # boundary mismatch over coupled boundaries only (wrap-free
        # coordinates are discontinuous at the wrap by design)
        outs, ins = xs[:, idx_out_t], xs[:, idx_in_t]
        return torch.where(mask, (outs - torch.roll(ins, -1, 0)).abs(), zero).max()

    def note(sol):
        # device-side per-sweep health, read once after the loop
        ok = sol.converged.all() & torch.isfinite(sol.x).all()
        return ok, sol.iterations.max(), mismatch(sol.x)

    u_in = torch.zeros_like(z)
    u_out = torch.zeros_like(z)
    rho_t = torch.as_tensor(rho, dtype=dtype, device=device)
    health = []
    for _ in range(int(admm_iters)):
        z_prev = torch.roll(z, 1, 0)
        sol = local_solves(z_prev - u_in, z - u_out, rho_t)
        health.append(note(sol))
        xs = sol.x
        outs = xs[:, idx_out_t]
        ins = xs[:, idx_in_t]
        z_new = 0.5 * (outs + u_out + torch.roll(ins + u_in, -1, 0))
        if pin is not None:
            z_new = torch.cat([z_new[:-1], pin[None, :]], 0)
        z_prev_new = torch.roll(z_new, 1, 0)
        u_out = torch.where(mask, u_out + outs - z_new, zero)
        u_in = u_in + ins - z_prev_new
        # residual-balancing adaptive rho: the boundary states are scaled
        # 1e4-1e5 kWh while objective sensitivities are ~1e-6/kWh
        r = torch.sqrt(torch.where(mask, (outs - z_new) ** 2, zero).sum()
                       + ((ins - z_prev_new) ** 2).sum())
        s = rho_t * torch.sqrt(((z_new - z) ** 2).sum())
        if adapt_rho:
            f = torch.where(r > 10.0 * s, 2.0, torch.where(s > 10.0 * r, 0.5, 1.0)).to(dtype)
            u_in, u_out, rho_t = u_in / f, u_out / f, rho_t * f
        z = z_new
    sol = local_solves(torch.roll(z, 1, 0) - u_in, z - u_out, rho_t)
    health.append(note(sol))
    xs = sol.x

    res = health[-1][2]
    cb = lp_b.c.expand_as(xs)
    obj = (cb * xs).sum() + lp_b.c0.sum()
    ok, its, mis = (torch.stack(v).cpu().tolist() for v in zip(*health))
    stats = {"sweeps": int(admm_iters), "ipm_iterations": [int(i) for i in its],
             "converged_finite": [bool(o) for o in ok], "residuals": mis}
    return HorizonSolution(xs, z, res, obj, stats)
