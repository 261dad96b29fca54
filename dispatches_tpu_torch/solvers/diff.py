"""Differentiable optimization: design gradients through LP solves (PyTorch).

Port of `dispatches_tpu/solvers/diff.py`. `solve_lp_diff` is a
`torch.autograd.Function` around the interior-point solve, so autograd
flows through ``params -> instantiate -> solve -> objective / solution``
and design sizing becomes gradient-based, where the reference re-solves
the whole Pyomo model per design point (`wind_battery_LMP.py:172-267`).

Two gradient paths, both exact at the optimum:

* **Optimal value (envelope theorem).** For ``V = min c.x + c0 s.t. Ax = b,
  l <= x <= u`` with optimal primal ``x*`` and duals ``(y*, zl*, zu*)``,
  ``dV = x*.dc + dc0 + y*.db - y*.dA.x* + zl*.dl - zu*.du``.

* **Solution sensitivity (implicit function theorem).** The reverse-mode
  adjoint of the barrier KKT system at the solution solves one extra
  system with the normal-equations matrix the IPM factorizes:
      D lam + A' nu = xbar,   A lam = -ybar
  with ``D = zl/(x-l) + zu/(u-x) + reg``.

Cotangents on ``obj`` use the envelope; cotangents on ``x``/``y`` use the
adjoint solve, which is skipped when neither has one (the `optimal_value`
path never builds or factors the normal-equations matrix).

Batch-first, as the port's IPM is: an `LPData` with a leading scenario
axis on any field solves every lane in one call, and backward gives each
lane its own gradient (the port's form of ``jax.vmap(jax.grad(...))``).
The IPM runs inside `forward`, where autograd records nothing.
"""
from __future__ import annotations

import torch

from ..core.program import LPData
from .ipm import IPMSolution, _broadcast_batch, _solve_lp_inner, pin_matmul_precision

_LP_NDIM = {"A": 2, "b": 1, "c": 1, "l": 1, "u": 1, "c0": 0}
# outputs a cotangent may not reach (bound duals at an LP vertex are
# set-valued; the residuals are diagnostics)
_NOT_DIFFERENTIABLE = ("zl", "zu", "res_primal", "res_dual", "gap")


class _SolveLPDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, opts, *fields):
        tol, max_iter, refine_steps, bwd_reg = opts
        lp = LPData(*fields)
        lpb, batch = _broadcast_batch(lp, _LP_NDIM)
        if batch is None:
            lpb = LPData(*(a.unsqueeze(0) for a in lp))
        pin_matmul_precision()
        sol, _ = _solve_lp_inner(lpb, tol=tol, max_iter=max_iter,
                                 refine_steps=refine_steps)
        ctx.set_materialize_grads(False)
        ctx.batched = batch is not None
        ctx.lane_dims = [a.dim() > _LP_NDIM[n] for n, a in zip(LPData._fields, lp)]
        ctx.bwd_reg = bwd_reg
        ctx.save_for_backward(*lpb, sol.x, sol.y, sol.zl, sol.zu)
        if batch is None:
            sol = IPMSolution(*(a[0] for a in sol))
        ctx.mark_non_differentiable(sol.converged, sol.iterations, sol.status)
        return tuple(sol)

    @staticmethod
    def backward(ctx, *cts):
        ct = IPMSolution(*cts)
        for name in _NOT_DIFFERENTIABLE:
            if getattr(ct, name) is not None:
                raise NotImplementedError(
                    f"solve_lp_diff: cotangent on IPMSolution.{name} is not "
                    "supported (only obj, x, y are differentiable)"
                )
        A, b, c, l, u, c0, x, y, zl, zu = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]  # A, b, c, l, u, c0
        dtype = A.dtype
        reg = ctx.bwd_reg
        if reg is None:
            reg = 1e-11 if dtype == torch.float64 else 1e-7

        def lanes(v):  # a cotangent with the batch axis the solve used
            return v if ctx.batched else v.unsqueeze(0)

        # an A every lane shared gets the lanes' outer products summed in one
        # contraction, never as a (lanes, M, N) stack
        sum_A = ctx.batched and not ctx.lane_dims[0]

        def outer(p, q):
            return torch.einsum("bm,bn->mn" if sum_A else "bm,bn->bmn", p, q)

        g = [None] * 6

        def add(i, v):
            g[i] = v if g[i] is None else g[i] + v

        fl, fu = torch.isfinite(l), torch.isfinite(u)
        zero = torch.zeros((), dtype=dtype, device=A.device)
        # envelope contribution (cotangent on the optimal value)
        if ct.obj is not None:
            objbar = lanes(ct.obj.to(dtype))
            ob = objbar[:, None]
            if need[0]:
                add(0, -outer(ob * y, x))
            if need[1]:
                add(1, ob * y)
            if need[2]:
                add(2, ob * x)
            if need[3]:
                add(3, ob * torch.where(fl, zl, zero))
            if need[4]:
                add(4, -ob * torch.where(fu, zu, zero))
            if need[5]:
                add(5, objbar)

        # adjoint-KKT contribution (cotangents on x and/or y)
        if (ct.x is not None or ct.y is not None) and any(need[:5]):
            xbar = torch.zeros_like(c) if ct.x is None else lanes(ct.x.to(dtype))
            ybar = torch.zeros_like(b) if ct.y is None else lanes(ct.y.to(dtype))
            xl = torch.where(fl, x - l, 1.0)
            xu = torch.where(fu, u - x, 1.0)
            dl_w = torch.where(fl, zl / torch.clamp(xl, min=1e-300), zero)
            du_w = torch.where(fu, zu / torch.clamp(xu, min=1e-300), zero)
            w = 1.0 / (dl_w + du_w + reg)
            K = (A * w[:, None, :]) @ A.transpose(-1, -2)
            K = K + reg * torch.eye(A.shape[-2], dtype=dtype, device=A.device)
            L = torch.linalg.cholesky(K)
            rhs = (A @ (w * xbar)[..., None])[..., 0] + ybar
            nu = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            lam = w * (xbar - (A.transpose(-1, -2) @ nu[..., None])[..., 0])
            if need[0]:
                add(0, outer(y, lam) - outer(nu, x))
            if need[1]:
                add(1, nu)
            if need[2]:
                add(2, -lam)
            if need[3]:
                add(3, dl_w * lam)
            if need[4]:
                add(4, du_w * lam)

        grads = []
        for i, (gi, has_lane) in enumerate(zip(g, ctx.lane_dims)):
            if gi is not None and not (i == 0 and sum_A):
                if not ctx.batched:
                    gi = gi[0]
                elif not has_lane:  # a field every lane shared
                    gi = gi.sum(0)
            grads.append(gi)
        return (None, *grads)


def solve_lp_diff(
    lp: LPData,
    tol: float = 1e-8,
    max_iter: int = 60,
    refine_steps: int = 2,
    bwd_reg: float = None,
) -> IPMSolution:
    """`solve_lp` / `solve_lp_batch` with an envelope + adjoint-KKT
    backward: differentiable in ``lp`` (and hence in any parameters that
    built it through `CompiledLP.instantiate`). ``bwd_reg`` (default 1e-11
    in f64, 1e-7 in f32) regularizes the adjoint solve. A cotangent on
    ``zl``, ``zu``, ``res_primal``, ``res_dual`` or ``gap`` raises
    NotImplementedError; ``converged``, ``iterations`` and ``status`` are
    not differentiable."""
    out = _SolveLPDiff.apply((tol, max_iter, refine_steps, bwd_reg), *lp)
    return IPMSolution(*out)


# ----------------------------------------------------------------------
# High-level front-ends over a CompiledLP
# ----------------------------------------------------------------------
def optimal_value(prog, params, dtype=torch.float64, device="cuda", **solver_kw):
    """Differentiable optimal objective value, in the *model's* sense (a
    maximized objective returns the maximum). Autograd w.r.t. any entry of
    `params` uses the envelope theorem: one solve, no resolve loop.
    Parameters with a leading batch axis give one value per lane."""
    lp = prog.instantiate(params, dtype=dtype, device=device)
    sol = solve_lp_diff(lp, **solver_kw)
    return prog.obj_sense * sol.obj


def optimal_solution(prog, params, dtype=torch.float64, device="cuda", **solver_kw):
    """Differentiable (solution, duals): the IPMSolution whose ``x``/``y``
    carry implicit-function-theorem gradients, so downstream scalars (e.g.
    ``prog.eval_expr('NPV', sol.x, params)``) are differentiable."""
    lp = prog.instantiate(params, dtype=dtype, device=device)
    return solve_lp_diff(lp, **solver_kw)
