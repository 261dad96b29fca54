"""Batched primal-dual interior-point solver for smooth NLPs (port of
`dispatches_tpu/solvers/nlp.py`).

The replacement for the reference's IPOPT solves of flowsheet NLPs.
Problems are given functionally, a torch objective and equality-constraint
function, and autodiff supplies exact gradients, Jacobians and Lagrangian
Hessians (``torch.func.grad`` / ``jacfwd`` / ``hessian``, the forward-over-
reverse choices the JAX package makes):

    min  f(x, p)
    s.t. c(x, p) = 0
         l <= x <= u        (entries may be +-inf)

Algorithm: monotone-barrier primal-dual Newton (Fiacco-McCormick mu
schedule, fraction-to-boundary rule, Armijo backtracking on an l1-penalty
barrier merit function, dual regularization by a ladder of Hessian shifts)
with fixed maximum iteration counts, masked infinite bounds and an LU
factorization of the regularized KKT system.

Execution. The solver is batch-first: every lane (`solve_nlp_batch`'s
leading axis; `solve_nlp` is one lane) carries its own state, and a lane
freezes once it is done, as the JAX package's vmapped while-loop does, so
each lane's `iterations` is its own. The loop runs on the host with one
read of the lanes' done flags per iteration. The six shifts of the
regularization ladder are one batched ``lu_factor_ex`` + ``lu_solve``: a
singular shift gives non-finite values there (as JAX's solve does) and
the step selects on finiteness, with no error check that would read the
device. The 25 Armijo trial steps are independent, so their merits are
one batched evaluation (``torch.func.vmap`` over the trials), and the
first accepted trial is taken, the line-search scan's rule.

Also provides `solve_square`: damped Newton for square nonlinear systems,
the analogue of the reference's flowsheet initialization square solves.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..obs.trace import empty_trace, record


class NLPSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor  # equality-constraint multipliers
    zl: torch.Tensor  # lower-bound duals (0 where bound infinite)
    zu: torch.Tensor  # upper-bound duals
    obj: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor  # max(dual inf, primal inf, complementarity)


# the regularization ladder for inertia correction: when the Lagrangian
# Hessian is indefinite the Newton direction may be ascent; all shifts are
# factored at once and the first descent direction is taken
DELTAS = (1e-8, 1e-4, 1e-2, 1e0, 1e2, 1e4)
TAU = 0.995  # fraction to the boundary
KAPPA_MU, THETA_MU = 0.2, 1.5  # barrier decrease
NU_PEN = 1e2  # l1 penalty weight in the merit function


def _as_tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _kkt_components(grad_L, c, x, zl, zu, l, u, finl, finu, mu):
    """Per lane (dual inf, primal inf, complementarity), the pieces of E_mu."""
    dual = grad_L.abs().amax(-1)
    primal = c.abs().amax(-1) if c.shape[-1] else torch.zeros_like(dual)
    mu = mu[..., None] if isinstance(mu, torch.Tensor) else mu
    compl_l = torch.where(finl, (x - l) * zl - mu, 0.0)
    compl_u = torch.where(finu, (u - x) * zu - mu, 0.0)
    comp = torch.maximum(compl_l.abs(), compl_u.abs()).amax(-1)
    return dual, primal, comp


def _kkt_error(*args):
    """IPOPT's E_mu (scaled residuals omitted: problems here are prescaled)."""
    dual, primal, comp = _kkt_components(*args)
    return torch.maximum(dual, torch.maximum(primal, comp))


def _fraction_to_boundary(d, s, tau):
    """Per lane, max alpha in (0,1] with s + alpha*d >= (1-tau)*s."""
    bad = d < 0
    ratio = torch.where(bad, -tau * s / torch.where(bad, d, -1.0), torch.inf)
    return torch.clamp(ratio.amin(-1), max=1.0)


def lu_factor(K):
    """LU with partial pivoting of a stack of matrices: ``(LU, pivots)``,
    no error check (a singular matrix gives non-finite solves). On the
    CPU each matrix is factored alone: this build's batched CPU
    factorization (MKL's) hangs for n >~ 100 with more than one thread."""
    if K.device.type != "cpu" or K.dim() == 2:
        LU, piv, _ = torch.linalg.lu_factor_ex(K)
        return LU, piv
    parts = [torch.linalg.lu_factor_ex(a)[:2] for a in K.reshape(-1, *K.shape[-2:])]
    return (torch.stack([p[0] for p in parts]).reshape(K.shape),
            torch.stack([p[1] for p in parts]).reshape(K.shape[:-1]))


def _first(mask):
    """Index of the first True along the last axis (0 when there is none)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _solve_lanes(f_obj, c_eq, x0, l, u, params, p_axis, tol, max_iter, mu0,
                 ls_steps, trace):
    B, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    l = torch.broadcast_to(_as_tensor(l, dev, dtype), (n,))
    u = torch.broadcast_to(_as_tensor(u, dev, dtype), (n,))
    # variables fixed via equal bounds (the reference's fix-DoF idiom) get a
    # tiny relaxed box so the log barrier stays finite
    fixed = torch.isfinite(l) & torch.isfinite(u) & (u - l <= 0)
    l = torch.where(fixed, l - 1e-8 * (1.0 + l.abs()), l)
    u = torch.where(fixed, u + 1e-8 * (1.0 + u.abs()), u)
    finl, finu = torch.isfinite(l), torch.isfinite(u)

    f_v = vmap(f_obj, in_dims=(0, p_axis))
    c_v = vmap(c_eq, in_dims=(0, p_axis))
    grad_f = vmap(grad(f_obj), in_dims=(0, p_axis))

    # interior start: push x0 strictly inside its box (IPOPT's kappa_1 rule)
    span = torch.where(finl & finu, u - l, 1.0)
    pad = 1e-2 * torch.clamp(span, max=1.0)
    x = torch.clamp(x0, torch.where(finl, l + pad, -torch.inf),
                    torch.where(finu, u - pad, torch.inf))
    cx = c_v(x, params)
    m = cx.shape[-1]
    jac_c = vmap(jacfwd(c_eq), in_dims=(0, p_axis)) if m else None

    def lagrangian(x1, y1, p):
        return f_obj(x1, p) + (torch.dot(y1, c_eq(x1, p)) if m else 0.0)

    hess_L = vmap(hessian(lagrangian, argnums=0), in_dims=(0, 0, p_axis))

    def merit1(x1, mu, p):
        sl = torch.where(finl, x1 - l, 1.0)
        su = torch.where(finu, u - x1, 1.0)
        bar = -mu * (
            torch.sum(torch.where(finl, torch.log(torch.clamp(sl, min=1e-300)), 0.0))
            + torch.sum(torch.where(finu, torch.log(torch.clamp(su, min=1e-300)), 0.0))
        )
        viol = torch.sum(torch.abs(c_eq(x1, p))) if m else 0.0
        return f_obj(x1, p) + bar + NU_PEN * viol

    merit = vmap(merit1, in_dims=(0, 0, p_axis))
    merit_trials = vmap(vmap(merit1, in_dims=(0, None, None)), in_dims=(0, 0, p_axis))

    sl0 = torch.where(finl, x - l, 1.0)
    su0 = torch.where(finu, u - x, 1.0)
    y = torch.zeros((B, m), dtype=dtype, device=dev)
    zl = torch.where(finl, mu0 / sl0, 0.0)
    zu = torch.where(finu, mu0 / su0, 0.0)
    mu = torch.full((B,), mu0, dtype=dtype, device=dev)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    gf = grad_f(x, params)
    J = jac_c(x, params) if m else torch.zeros((B, 0, n), dtype=dtype, device=dev)
    tr = empty_trace(max_iter if trace else 0, dtype, batch=(B,), device=dev)

    deltas = torch.tensor(DELTAS, dtype=dtype, device=dev)
    nd = len(DELTAS)
    shift = torch.diag_embed(torch.cat([torch.ones(n, dtype=dtype, device=dev),
                                        torch.zeros(m, dtype=dtype, device=dev)]))
    shifts = deltas[:, None, None] * shift  # (nd, n+m, n+m)
    lower_right = -1e-8 * torch.eye(m, dtype=dtype, device=dev)
    halves = 0.5 ** torch.arange(ls_steps, dtype=dtype, device=dev)
    lanes = torch.arange(B, device=dev)

    def JT(J, v):
        return (J.transpose(-1, -2) @ v[..., None])[..., 0] if m else 0.0

    while True:
        active = (~done) & (it < max_iter)
        if not bool(active.any()):  # the loop's one read of the device
            break
        sl = torch.where(finl, x - l, 1.0)
        su = torch.where(finu, u - x, 1.0)
        H = hess_L(x, y, params)

        # primal-dual Sigma; zero where no bound
        sigma = torch.where(finl, zl / sl, 0.0) + torch.where(finu, zu / su, 0.0)
        bar_l = torch.where(finl, mu[:, None] / sl, 0.0)
        bar_u = torch.where(finu, mu[:, None] / su, 0.0)
        # condensed dual residual after eliminating the bound duals:
        #   (H + Sigma) dx + J^T dy = -(gf + J^T y - mu/sl + mu/su)
        rhs_x = gf + JT(J, y) - bar_l + bar_u
        Hs = H + torch.diag_embed(sigma)
        if m:
            K = torch.cat([
                torch.cat([Hs, J.transpose(-1, -2)], -1),
                torch.cat([J, lower_right.expand(B, m, m)], -1),
            ], -2)
        else:
            K = Hs
        rhs = torch.cat([-rhs_x, -cx], -1)
        Ks = K[:, None] + shifts[None]
        LU, piv = lu_factor(Ks)
        sols = torch.linalg.lu_solve(
            LU, piv, rhs[:, None, :, None].expand(B, nd, n + m, 1))[..., 0]

        # gradient of the smooth part of the merit (f + barrier) at x
        g_smooth = gf - bar_l + bar_u
        cl1 = cx.abs().sum(-1) if m else torch.zeros((B,), dtype=dtype, device=dev)
        dirderivs = (sols[..., :n] @ g_smooth[..., None])[..., 0] - NU_PEN * cl1[:, None]
        finite = torch.isfinite(sols).all(-1)
        good = finite & (dirderivs < 0)
        # first good candidate; if none, the most-regularized finite one
        fallback = torch.where(finite.any(-1), nd - 1 - _first(finite.flip(-1)), 0)
        idx = torch.where(good.any(-1), _first(good), fallback)
        sol = sols[lanes, idx]
        descent = -torch.cat([g_smooth, torch.zeros((B, m), dtype=dtype, device=dev)], -1) * 1e-3
        sol = torch.where(torch.isfinite(sol).all(-1, keepdim=True), sol, descent)
        dx, dy = sol[:, :n], sol[:, n:]
        D = torch.clamp((dx[:, None, :] @ g_smooth[..., None])[:, 0, 0] - NU_PEN * cl1,
                        max=-0.0)

        dzl = torch.where(finl, (mu[:, None] - zl * sl) / sl - zl / sl * dx, 0.0)
        dzu = torch.where(finu, (mu[:, None] - zu * su) / su + zu / su * dx, 0.0)

        # fraction-to-boundary on primal slacks and duals
        alpha_max = torch.minimum(
            _fraction_to_boundary(dx, torch.where(finl, sl, torch.inf), TAU),
            _fraction_to_boundary(-dx, torch.where(finu, su, torch.inf), TAU))
        alpha_z = torch.minimum(
            _fraction_to_boundary(dzl, torch.where(finl, zl, torch.inf), TAU),
            _fraction_to_boundary(dzu, torch.where(finu, zu, torch.inf), TAU))

        # Armijo backtracking on the merit function with the true directional
        # derivative: all trial steps at once, the first accepted one taken
        phi0 = merit(x, mu, params)
        a_try = alpha_max[:, None] * halves
        phi = merit_trials(x[:, None, :] + a_try[..., None] * dx[:, None, :], mu, params)
        ok = phi <= phi0[:, None] + 1e-4 * a_try * D[:, None]
        alpha = torch.where(ok.any(-1), a_try.gather(-1, _first(ok)[:, None])[:, 0],
                            alpha_max * 0.5**ls_steps)

        x_new = x + alpha[:, None] * dx
        y_new = y + alpha[:, None] * dy
        zl_new = torch.where(finl, torch.clamp(zl + alpha_z[:, None] * dzl, 1e-12, 1e16), 0.0)
        zu_new = torch.where(finu, torch.clamp(zu + alpha_z[:, None] * dzu, 1e-12, 1e16), 0.0)

        # convergence + barrier update
        gfn = grad_f(x_new, params)
        cn = c_v(x_new, params)
        Jn = jac_c(x_new, params) if m else J
        gL = gfn + JT(Jn, y_new) - zl_new + zu_new
        e_mu = _kkt_error(gL, cn, x_new, zl_new, zu_new, l, u, finl, finu, mu)
        d0, p0, comp0 = _kkt_components(gL, cn, x_new, zl_new, zu_new, l, u, finl, finu, 0.0)
        e_0 = torch.maximum(d0, torch.maximum(p0, comp0))
        mu_new = torch.where(
            e_mu < 10.0 * mu,
            torch.clamp(torch.minimum(KAPPA_MU * mu, mu**THETA_MU), min=tol / 10.0),
            mu,
        )
        if trace:
            tr_new = record(tr, it, p0, d0, comp0, alpha, alpha_z)
            tr = type(tr)(*(torch.where(active[:, None], a, b) for a, b in zip(tr_new, tr)))

        # a finished lane keeps its state (the vmapped while-loop's select)
        a1 = active[:, None]
        x, y = torch.where(a1, x_new, x), torch.where(a1, y_new, y)
        zl, zu = torch.where(a1, zl_new, zl), torch.where(a1, zu_new, zu)
        gf, cx = torch.where(a1, gfn, gf), torch.where(a1, cn, cx)
        J = torch.where(active[:, None, None], Jn, J)
        mu = torch.where(active, mu_new, mu)
        done = torch.where(active, e_0 < tol, done)
        it = it + active.to(it.dtype)

    gLF = gf + JT(J, y) - zl + zu
    e0 = _kkt_error(gLF, cx, x, zl, zu, l, u, finl, finu, 0.0)
    out = NLPSolution(x=x, y=y, zl=zl, zu=zu, obj=f_v(x, params),
                      converged=e0 < 10 * tol, iterations=it, kkt_error=e0)
    return out, tr


def _device_of(x0, device):
    if device is not None:
        return torch.device(device)
    return x0.device if isinstance(x0, torch.Tensor) else torch.device("cuda")


def solve_nlp(
    f_obj: Callable,
    c_eq: Callable,
    x0,
    l,
    u,
    params=None,
    tol: float = 1e-8,
    max_iter: int = 100,
    mu0: float = 1e-1,
    ls_steps: int = 25,
    trace: bool = False,
    device=None,
    dtype=torch.float64,
) -> NLPSolution:
    """Solve min f(x,p) s.t. c(x,p)=0, l<=x<=u from start point x0.

    `f_obj(x, params) -> scalar`, `c_eq(x, params) -> (m,)` must be smooth
    torch functions of one point (m may be 0 via an empty tensor), written
    so that ``torch.func`` transforms pass through them. Infinite bounds
    are handled by masking. The solve runs on `device`: x0's device when
    it is a tensor, else the card; `params` must lie there too.

    `trace=True` returns ``(NLPSolution, SolveTrace)`` with per-iteration
    primal/dual infeasibility, complementarity (the `gap` field), and
    primal/dual step sizes, NaN-padded to `max_iter`. Tracing off gives
    the same iterates."""
    dev = _device_of(x0, device)
    x0 = _as_tensor(x0, dev, dtype)
    out, tr = _solve_lanes(f_obj, c_eq, x0[None], l, u, params, None, tol,
                           max_iter, mu0, ls_steps, trace)
    out = NLPSolution(*(v[0] for v in out))
    return (out, type(tr)(*(v[0] for v in tr))) if trace else out


def solve_nlp_batch(
    f_obj: Callable,
    c_eq: Callable,
    x0_batch,
    l,
    u,
    params_batch=None,
    tol: float = 1e-8,
    max_iter: int = 100,
    mu0: float = 1e-1,
    ls_steps: int = 25,
    trace: bool = False,
    device=None,
    dtype=torch.float64,
):
    """`solve_nlp` over a leading scenario axis of `x0_batch` and of every
    leaf of `params_batch` (None: no parameters): all lanes in one loop,
    each frozen once done, so lane i gives what `solve_nlp` of lane i
    gives. `l`, `u` are shared."""
    x0 = _as_tensor(x0_batch, _device_of(x0_batch, device), dtype)
    out, tr = _solve_lanes(f_obj, c_eq, x0, l, u, params_batch,
                           None if params_batch is None else 0, tol, max_iter, mu0,
                           ls_steps, trace)
    return (out, tr) if trace else out


def solve_square(
    F: Callable,
    x0,
    params=None,
    tol: float = 1e-10,
    max_iter: int = 50,
    damping: float = 1e-10,
    device=None,
    dtype=torch.float64,
) -> NLPSolution:
    """Damped Newton for a square system F(x, p) = 0 (n equations, n vars).

    The analogue of the reference's zero-degree-of-freedom flowsheet solves
    (IPOPT square solve after `fix_dof_and_initialize`). Steps solve
    (J + damping*I) dx = -r with a halving line search on the residual
    norm (the first of 20 halvings that lowers it); a non-finite direction
    falls back to a small steepest-descent step on ||F||^2.

    Per iteration: one Jacobian (``jacfwd``) and one batched evaluation of
    F at the 20 trial points plus the fallback point x + 1e-4 dx, whose
    selected row is F at the new iterate; one host read of the residual."""
    dev = _device_of(x0, device)
    x = _as_tensor(x0, dev, dtype)
    n = x.shape[0]

    def Ffun(x1):
        return F(x1, params)

    Jfun = jacfwd(Ffun)
    F_rows = vmap(Ffun)
    eye = torch.eye(n, dtype=dtype, device=dev)
    steps = torch.cat([0.5 ** torch.arange(20, dtype=dtype, device=dev),
                       torch.tensor([1e-4], dtype=dtype, device=dev)])
    r = Ffun(x)
    res = r.abs().amax()
    it = 0
    while it < max_iter and bool(res > tol):  # the loop's one read
        J = Jfun(x)
        LU, piv = lu_factor(J + damping * eye)
        dx = torch.linalg.lu_solve(LU, piv, -r[:, None])[:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, -(J.T @ r) * 1e-6)
        nr0 = torch.linalg.vector_norm(r)
        trials = x[None] + steps[:, None] * dx[None]
        rows = F_rows(trials)
        ok = torch.linalg.vector_norm(rows[:20], dim=-1) < nr0
        k = torch.where(ok.any(), _first(ok), 20)
        x, r = trials[k], rows[k]
        res = r.abs().amax()
        it += 1
    zeros = torch.zeros((0,), dtype=dtype, device=dev)
    return NLPSolution(
        x=x,
        y=zeros,
        zl=torch.zeros_like(x),
        zu=torch.zeros_like(x),
        obj=torch.zeros((), dtype=dtype, device=dev),
        converged=res <= tol,
        iterations=torch.tensor(it, dtype=torch.int32),
        kkt_error=res,
    )
