"""Batched dense interior-point LP solver (Mehrotra predictor-corrector).

Port of `dispatches_tpu/solvers/ipm.py`. The KKT system is reduced to
regularized normal equations ``(A W A^T + δI) Δy = r``, factored by
``torch.linalg.cholesky`` and solved by ``torch.cholesky_solve``.

Standard form: min c.x  s.t.  A x = b,  l <= x <= u  (bounds may be ±inf).

Batch-first: every tensor of the iteration carries a leading scenario axis
and an unbatched solve is a batch of one. The JAX package vmaps a
``lax.while_loop``, so every lane runs until the slowest is done and a
finished lane's state is frozen; here the loop keeps an ``active`` mask and
updates each lane with ``torch.where``, which gives each lane the iterate
sequence its unbatched solve takes. The Python ``while`` reads
``active.any()`` on the host once per iteration.

Segmented solves (`solve_lp_partial`) stop each lane at an iteration mark
and return its `IPMState`; fed back with the same LP, the state resumes
the iterate sequence bit for bit. Warm starts (``warm_start=``) seed the
loop from a solution-frame iterate through a per-lane safeguard. Both
serve `runtime/adaptive.py`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.program import LPData
from ..obs.trace import SolveTrace, empty_trace as _empty_trace, record as _tr_record

STATUS_OPTIMAL = 0
STATUS_STALLED = 1  # hit max_iter / numerical breakdown, no diagnosis
STATUS_PRIMAL_INFEASIBLE = 2  # suspected: constraints inconsistent
STATUS_DUAL_INFEASIBLE = 3  # suspected: objective unbounded below
_STATUS_NAMES = {
    STATUS_OPTIMAL: "optimal",
    STATUS_STALLED: "stalled",
    STATUS_PRIMAL_INFEASIBLE: "suspected_primal_infeasible",
    STATUS_DUAL_INFEASIBLE: "suspected_dual_infeasible",
}


def status_name(code) -> str:
    return _STATUS_NAMES[int(code)]


class IPMSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor  # equality duals
    zl: torch.Tensor  # lower-bound duals (0 where bound infinite)
    zu: torch.Tensor  # upper-bound duals
    obj: torch.Tensor  # c.x + c0 (+ 1/2 x.diag(q).x when q given)
    converged: torch.Tensor  # bool
    iterations: torch.Tensor
    res_primal: torch.Tensor
    res_dual: torch.Tensor
    gap: torch.Tensor
    status: torch.Tensor  # STATUS_* code (see status_name)


class IPMState(NamedTuple):
    """Resumable loop state of a segmented solve (`solve_lp_partial`,
    ``return_state=True`` on the banded solvers), one row per lane.

    Every field lives in the solver's scaled frame (Ruiz + norm scaling),
    which each call recomputes from the lane's own data alone: fed back
    with the same LP, the state resumes the exact iterate sequence, so a
    chunked solve is bitwise the one-shot solve. Treat the fields as
    opaque; `it` (iterations done) and `done` (the loop's own stop flag:
    converged, breakdown, divergence or stall) are the ones a caller reads
    to retire lanes."""

    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    best_merit: torch.Tensor
    best_x: torch.Tensor
    best_y: torch.Tensor
    best_zl: torch.Tensor
    best_zu: torch.Tensor
    best_it: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: SolveTrace


def pin_matmul_precision() -> None:
    """Full-f32 products everywhere a solver runs: TF32 keeps ~3 digits,
    which breaks the normal-equations Cholesky (the JAX package forces
    ``default_matmul_precision("highest")`` for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _chol(K: torch.Tensor, symmetrize: bool = True) -> torch.Tensor:
    """Lower Cholesky factor of each matrix in `K`; NaN where a matrix is not
    positive definite (XLA's convention, which the breakdown guards rely
    on). `symmetrize` averages K with its transpose first, as
    ``jnp.linalg.cholesky`` does."""
    if symmetrize:
        K = 0.5 * (K + K.transpose(-1, -2))
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _lane(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-lane (B,) tensor against a (B, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _sel(mask, a, b):
    return torch.where(_lane(mask, a), a, b)


def _max_step(v, dv, mask):
    """Largest alpha in (0, 1] with v + alpha*dv >= 0 over masked entries,
    per lane."""
    neg = (dv < 0) & mask
    ratios = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                         torch.full_like(v, float("inf")))
    return torch.clamp(ratios.amin(-1), max=1.0)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _tree_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, whose length is a power of two, by halving:
    the same order of adds for every lane, batch size and device."""
    w = t.shape[-1]
    while w > 1:
        w //= 2
        t = t[..., :w] + t[..., w:]
    return t[..., 0]


def _vsum(v: torch.Tensor) -> torch.Tensor:
    """`_tree_sum` over a last axis of any length (zero-padded)."""
    n = v.shape[-1]
    p = _pow2(n)
    return _tree_sum(F.pad(v, (0, p - n)) if p != n else v)


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Per-lane sum over the last axis. On the card a fixed-order halving
    sum: CUDA's reduction kernels add a row in an order that depends on
    the row's address alignment, so one lane gave other bits at another
    position of the batch (`sum` and `vector_norm` over rows of 1,681 or
    2,355 f64, `tools/torch_serve_lanes.py`), and the serving engine puts
    a lane in whatever slot is free. The CPU's sum does not depend on the
    position, and stays."""
    return _vsum(v) if v.is_cuda else v.sum(-1)


def _lane_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-lane 2-norm over the last axis, position-independent as
    `_lane_sum`."""
    return torch.sqrt(_vsum(v * v)) if v.is_cuda else torch.linalg.vector_norm(v, dim=-1)


def _max0(x: torch.Tensor) -> torch.Tensor:
    """Per-lane max over the last axis with initial 0 (``initial=0.0``)."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.clamp(x.amax(-1), min=0.0)


def _ruiz_scaling(A, iters: int = 8):
    """Ruiz equilibration of each (M, N) matrix in the batch: diagonal R, C
    with R A C having ~unit row/col infinity norms."""
    r = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    cs = torch.ones(A.shape[:-2] + A.shape[-1:], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        As = A * r[..., :, None] * cs[..., None, :]
        rmax = As.abs().amax(-1)
        r = r / torch.sqrt(torch.where(rmax > 0, rmax, torch.ones_like(rmax)))
        As = A * r[..., :, None] * cs[..., None, :]
        cmax = As.abs().amax(-2)
        cs = cs / torch.sqrt(torch.where(cmax > 0, cmax, torch.ones_like(cmax)))
    return r, cs


def _broadcast_batch(lp, base_ndim):
    """Give every field of a NamedTuple problem the leading batch axis that
    some fields carry (fields without it are broadcast, as ``vmap`` with
    ``in_axes=None`` does). Returns (batched problem, batch or None)."""
    batch = None
    for name, arr in zip(lp._fields, lp):
        nd = base_ndim[name]
        if arr.dim() == nd + 1:
            batch = arr.shape[0]
        elif arr.dim() != nd:
            raise ValueError(
                f"bad ndim for {type(lp).__name__}.{name}: {arr.dim()} "
                f"(expected {nd} or {nd + 1})"
            )
    if batch is None:
        return lp, None
    return type(lp)(*(
        arr if arr.dim() == base_ndim[name] + 1
        else arr.unsqueeze(0).expand(batch, *arr.shape)
        for name, arr in zip(lp._fields, lp)
    )), batch


_LP_NDIM = {"A": 2, "b": 1, "c": 1, "l": 1, "u": 1, "c0": 0}


def _tree_map(fn, obj):
    """`fn` applied to every leaf of a (nested) tuple / NamedTuple."""
    if isinstance(obj, tuple):
        items = [_tree_map(fn, o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return fn(obj)


def _squeeze_lane(out):
    """Lane 0 of a batch-of-one result (IPMSolution, SolveTrace, IPMState,
    or a tuple of them)."""
    return _tree_map(lambda a: a[0], out)


def _unsqueeze_lane(obj):
    """A batch of one from an unbatched warm start or `IPMState`."""
    return None if obj is None else _tree_map(lambda a: a.unsqueeze(0), obj)


def _warm_tensors(warm_start, like):
    """A warm start ``(x, y, zl, zu)`` (tensors or arrays) as tensors of
    `like`'s dtype on its device; None stays None."""
    if warm_start is None:
        return None
    return tuple(torch.as_tensor(w, dtype=like.dtype, device=like.device)
                 for w in warm_start)


def solve_lp(
    lp: LPData,
    tol: float = 1e-8,
    max_iter: int = 60,
    reg_p: float = None,
    reg_d: float = None,
    refine_steps: int = 2,
    q: torch.Tensor = None,
    stall_limit: int = None,
    correctors: int = 0,
    trace: bool = False,
    warm_start=None,
):
    """Scale (Ruiz + norm), solve, unscale; one LP. The solve runs on the
    device the LP's tensors live on. `trace=True` returns
    ``(IPMSolution, SolveTrace)``. `warm_start` (optional ``(x, y, zl,
    zu)`` in the solution frame, e.g. a neighbouring point's
    `IPMSolution` fields) seeds the iteration after the safeguard of
    `_warm_safeguard`; a rejected seed gives the cold solve bit for bit.
    See `_solve_scaled` for the core."""
    pin_matmul_precision()
    lpb = LPData(*(a.unsqueeze(0) for a in lp))
    qb = None if q is None else torch.as_tensor(q).unsqueeze(0)
    out = _solve_lp_inner(
        lpb, tol, max_iter, reg_p, reg_d, refine_steps, qb, stall_limit,
        correctors, trace,
        warm_start=_unsqueeze_lane(_warm_tensors(warm_start, lp.b)),
    )
    out = _squeeze_lane(out)
    return out if trace else out[0]


def solve_lp_partial(
    lp: LPData,
    tol: float = 1e-8,
    max_iter: int = 60,
    reg_p: float = None,
    reg_d: float = None,
    refine_steps: int = 2,
    q: torch.Tensor = None,
    stall_limit: int = None,
    correctors: int = 0,
    trace: bool = False,
    warm_start=None,
    state: IPMState = None,
    it_stop=None,
):
    """Segmented solve: run the Mehrotra loop up to iteration ``it_stop``
    and return ``(IPMSolution, IPMState)``. Feed ``state`` back with the
    SAME `lp` to resume where the segment stopped; the chunked iterate
    sequence is bitwise the one-shot solve's. The solution is final only
    for lanes whose ``state.done`` is set or whose ``state.it`` reached
    ``max_iter``; for the others it reports the best iterate so far. With
    ``trace=True`` the trace rides in ``state.trace``. Batched like
    `solve_lp_batch` (a leading axis on any field, ``warm_start`` and
    ``state`` per lane) or one LP. The engine primitive of
    `runtime/adaptive.py`."""
    pin_matmul_precision()
    lpb, batch = _broadcast_batch(lp, _LP_NDIM)
    warm = _warm_tensors(warm_start, lp.b)
    if batch is None:
        lpb = LPData(*(a.unsqueeze(0) for a in lp))
        warm, state = _unsqueeze_lane(warm), _unsqueeze_lane(state)
    if q is not None:
        q = torch.as_tensor(q).to(lpb.b).expand_as(lpb.c)
    sol, _tr, st = _solve_lp_inner(
        lpb, tol, max_iter, reg_p, reg_d, refine_steps, q, stall_limit,
        correctors, trace, warm_start=warm, state0=state, it_stop=it_stop,
        return_state=True,
    )
    return (sol, st) if batch is not None else _squeeze_lane((sol, st))


def _scaling(A0, b0, c0v, l0, u0):
    """Ruiz + norm scaling of each lane, from that lane's data alone:
    ``(r, cs, b, c, l, u, sig_c, sig_b)`` with the scaled b, c and bounds
    (before the division by sig) and sig_* of shape (B, 1)."""
    r, cs = _ruiz_scaling(A0)
    b = b0 * r
    # variable substitution x = diag(cs) x~ -> bounds divide by cs
    l = l0 / cs
    u = u0 / cs
    c = c0v * cs
    sig_c = torch.clamp(c.abs().amax(-1), min=1.0)[:, None]
    sig_b = torch.clamp(
        torch.maximum(
            _max0(b.abs()),
            torch.where(torch.isfinite(l), l.abs(), torch.zeros_like(l)).amax(-1),
        ),
        min=1.0,
    )[:, None]
    return r, cs, b, c, l, u, sig_c, sig_b


def _solve_lp_inner(lp, tol=1e-8, max_iter=60, reg_p=None, reg_d=None,
                    refine_steps=2, q=None, stall_limit=None, correctors=0,
                    trace=False, warm_start=None, state0=None, it_stop=None,
                    return_state=False):
    A0, b0, c0v, l0, u0, off0 = lp
    dtype = A0.dtype
    if reg_p is None:
        reg_p = 1e-13 if dtype == torch.float64 else 1e-8
    if reg_d is None:
        reg_d = 1e-12 if dtype == torch.float64 else 1e-7
    r, cs, b, c, l, u, sig_c, sig_b = _scaling(A0, b0, c0v, l0, u0)
    A = A0 * r[..., :, None] * cs[..., None, :]
    q0 = torch.zeros_like(c0v) if q is None else q.to(c0v)
    q_s = q0 * cs * cs * sig_b / sig_c
    warm_s = None
    if warm_start is not None:
        # the solution-frame seed in the scaled frame (the inverse of the
        # unscaling below); the safeguard runs in _solve_scaled
        warm_s = _warm_scaled(warm_start, r, cs, sig_c, sig_b)
    out = _solve_scaled(
        LPData(A, b / sig_b, c / sig_c, l / sig_b, u / sig_b, torch.zeros_like(off0)),
        tol, max_iter, reg_p, reg_d, refine_steps, q_s,
        stall_limit=stall_limit, correctors=correctors, trace=trace,
        warm=warm_s, state0=state0, it_stop=it_stop, return_state=return_state,
    )
    sol = out[0]
    # unscale: x = cs * x~ * sig_b ; y = sig_c * r * y~ ; z = sig_c/cs * z~
    x = sol.x * cs * sig_b
    y = sol.y * r * sig_c
    zl = sol.zl / cs * sig_c
    zu = sol.zu / cs * sig_c
    obj = _lane_sum(c0v * x) + 0.5 * _lane_sum((q0 * x) * x) + off0
    return (sol._replace(x=x, y=y, zl=zl, zu=zu, obj=obj), *out[1:])


def _warm_scaled(warm, r, cs, sig_c, sig_b):
    """A solution-frame warm iterate in the scaled frame."""
    xw, yw, zlw, zuw = warm
    return xw / (cs * sig_b), yw / (r * sig_c), zlw * cs / sig_c, zuw * cs / sig_c


def _warm_safeguard(warm, fl, fu, l_s, u_s):
    """Safeguarded warm start, per lane, in the scaled frame: clip the seed
    strictly interior, then reject it whole when clipping moved any
    coordinate by more than 10% of its bound range (relative for
    one-sided bounds) or the seed is not finite: such a shift means the
    seeding solution's active set disagrees, and the cold start converges
    faster. Returns the clipped pieces and the per-lane accept flag; the
    caller blends with the cold start."""
    both = fl & fu
    xw, yw, zlw, zuw = warm
    width = u_s - l_s
    marg = torch.where(both, torch.clamp(0.25 * width, max=1e-4),
                       torch.full_like(width, 1e-4))
    inf = torch.full_like(width, float("inf"))
    lo = torch.where(fl, l_s + marg, -inf)
    hi = torch.where(fu, u_s - marg, inf)
    x_w = torch.minimum(torch.maximum(xw, lo), hi)
    zero = torch.zeros_like(width)
    zl_w = torch.where(fl, torch.clamp(zlw, min=1e-4), zero)
    zu_w = torch.where(fu, torch.clamp(zuw, min=1e-4), zero)
    denom = torch.where(both, torch.clamp(width, min=1e-8), 1.0 + xw.abs())
    shifted = torch.where(fl | fu, (x_w - xw).abs() / denom, zero)
    finite_w = (
        torch.isfinite(xw).all(-1)
        & torch.isfinite(yw).all(-1)
        & torch.isfinite(zl_w).all(-1)
        & torch.isfinite(zu_w).all(-1)
    )
    ok_w = finite_w & (_max0(shifted) <= 0.1)
    return x_w, yw, zl_w, zu_w, ok_w


def _warm_replay(lp, warm_start):
    """The scaling prologue of `_solve_lp_inner` and `_warm_safeguard` on a
    (possibly batched) LP: ``(scaling, safeguard output, batched?)``."""
    lpb, batch = _broadcast_batch(lp, _LP_NDIM)
    warm = _warm_tensors(warm_start, lp.b)
    if batch is None:
        lpb = LPData(*(a.unsqueeze(0) for a in lp))
        warm = _unsqueeze_lane(warm)
    A0, b0, c0v, l0, u0, _ = lpb
    scal = _scaling(A0, b0, c0v, l0, u0)
    r, cs, _b, _c, l, u, sig_c, sig_b = scal
    l_sc, u_sc = l / sig_b, u / sig_b
    fl, fu = torch.isfinite(l_sc), torch.isfinite(u_sc)
    zero = torch.zeros_like(l_sc)
    guard = _warm_safeguard(
        _warm_scaled(warm, r, cs, sig_c, sig_b), fl, fu,
        torch.where(fl, l_sc, zero), torch.where(fu, u_sc, zero),
    )
    return scal, guard, batch is not None


def warm_start_accept(lp, warm_start):
    """Would the safeguard ACCEPT this solution-frame seed for this LP?
    Replays the scaling prologue and the clip / reject test and returns
    the flag the solver itself computes, without iterating. One LP, or a
    batch (leading axis on the LP and on the seed) with one flag a lane."""
    _, guard, batched = _warm_replay(lp, warm_start)
    return guard[-1] if batched else guard[-1][0]


def apply_warm_safeguard(lp, warm_start):
    """The seed the solver starts from when it accepts: ``((x, y, zl, zu),
    accepted)``, the clipped / floored iterate mapped back to the solution
    frame. One LP or a batch, as `warm_start_accept`."""
    (r, cs, *_, sig_c, sig_b), (x_w, yw, zl_w, zu_w, ok_w), batched = \
        _warm_replay(lp, warm_start)
    applied = (x_w * cs * sig_b, yw * r * sig_c, zl_w / cs * sig_c, zu_w / cs * sig_c)
    out = (applied, ok_w)
    return out if batched else _squeeze_lane(out)


def _solve_scaled(
    lp: LPData,
    tol: float = 1e-8,
    max_iter: int = 60,
    reg_p: float = 1e-9,
    reg_d: float = 1e-9,
    refine_steps: int = 1,
    q: torch.Tensor = None,
    ops=None,
    d_cap: float = None,
    stall_limit: int = None,
    correctors: int = 0,
    trace: bool = False,
    warm: tuple = None,
    state0: IPMState = None,
    it_stop=None,
    return_state: bool = False,
):
    """Core Mehrotra iteration over a batch of lanes. Returns
    ``(IPMSolution, SolveTrace)``; the trace holds per-iteration relative
    residuals/gap/steps when ``trace=True`` and has length 0 otherwise.

    `ops`, when given, abstracts the linear algebra so structured solvers
    (`solvers/structured.py`) reuse this exact loop:
      ops = (matvec, rmatvec, make_kkt_solver) with
        matvec(x) = A x ; rmatvec(y) = A^T y ;
        make_kkt_solver(d) -> solve(r) approximating (A diag(1/d) A^T)^-1 r
    all on (B, ·) tensors. Default: dense A of shape (B, M, N).

    `d_cap` caps the barrier weight z/x of near-active variables (long f32
    banded factorization chains need it; the dense path must not cap).

    `warm` = (x, y, zl, zu) per lane in the SCALED frame replaces the cold
    start after `_warm_safeguard`; a lane whose seed it rejects starts
    cold. `state0` resumes a previous segment's `IPMState` verbatim;
    `it_stop` (an int or a per-lane tensor) stops each lane at that
    iteration count, without setting its `done`, so a host-side loop can
    retire and compact lanes between segments; `return_state` appends the
    `IPMState` to the return value. With all four at their defaults the
    loop is bit for bit the one without them."""
    A, b, c, l, u, c0 = lp
    dtype, device = b.dtype, b.device
    B, M = b.shape
    q = torch.zeros_like(c) if q is None else q
    if ops is None:
        At = A.transpose(-1, -2)

        def matvec(x):
            return (A @ x[..., None])[..., 0]

        def rmatvec(y):
            return (At @ y[..., None])[..., 0]

        eye = torch.eye(M, dtype=dtype, device=device)

        def make_kkt_solver(d):
            K = (A * (1.0 / d)[:, None, :]) @ At + reg_d * eye
            L = _chol(K, symmetrize=False)
            return lambda r: torch.cholesky_solve(r[..., None], L)[..., 0]
    else:
        matvec, rmatvec, make_kkt_solver = ops
    zero = torch.zeros((), dtype=dtype, device=device)
    fl = torch.isfinite(l)
    fu = torch.isfinite(u)
    nlu = torch.clamp((fl.sum(-1) + fu.sum(-1)).to(dtype), min=1.0)
    l_s = torch.where(fl, l, zero)
    u_s = torch.where(fu, u, zero)

    bnorm = 1.0 + _lane_norm(b)
    cnorm = 1.0 + _lane_norm(c)

    # -- starting point ------------------------------------------------
    both = fl & fu
    x0 = torch.where(
        both,
        0.5 * (l_s + u_s),
        torch.where(fl, l_s + 1.0, torch.where(fu, u_s - 1.0, zero)),
    )
    x0 = torch.where(both & (u_s - l_s < 2e-8), 0.5 * (l_s + u_s), x0)
    y0 = torch.zeros((B, M), dtype=dtype, device=device)
    z0l = fl.to(dtype)
    z0u = fu.to(dtype)
    if warm is not None:
        x_w, yw, zl_w, zu_w, ok_w = _warm_safeguard(warm, fl, fu, l_s, u_s)
        x0, y0 = _sel(ok_w, x_w, x0), _sel(ok_w, yw, y0)
        z0l, z0u = _sel(ok_w, zl_w, z0l), _sel(ok_w, zu_w, z0u)

    def dot(a, v):
        return _lane_sum(a * v)

    def residuals(x, y, zl, zu):
        rp = b - matvec(x)
        rd = c + q * x - rmatvec(y) - zl + zu
        xl = torch.where(fl, x - l_s, 1.0)
        xu = torch.where(fu, u_s - x, 1.0)
        comp = _lane_sum(torch.where(fl, xl * zl, zero)) + _lane_sum(
            torch.where(fu, xu * zu, zero)
        )
        return rp, rd, comp

    def merit_of(rp, rd, comp, x):
        return torch.maximum(
            torch.maximum(
                _lane_norm(rp) / bnorm,
                _lane_norm(rd) / cnorm,
            ),
            comp / (1.0 + dot(c, x).abs()),
        )

    def body(x, y, zl, zu, best, it, tr):
        xl = torch.where(fl, x - l_s, 1.0)
        xu = torch.where(fu, u_s - x, 1.0)
        zl_s = torch.where(fl, zl, zero)
        zu_s = torch.where(fu, zu, zero)
        rp = b - matvec(x)
        rd = c + q * x - rmatvec(y) - zl_s + zu_s
        mu = (
            _lane_sum(torch.where(fl, xl * zl, zero))
            + _lane_sum(torch.where(fu, xu * zu, zero))
        ) / nlu

        d = (
            torch.where(fl, zl / xl, zero)
            + torch.where(fu, zu / xu, zero)
            + q
            + reg_p
        )
        if d_cap is not None:
            d = torch.clamp(d, max=d_cap)
        w = 1.0 / d
        ksolve = make_kkt_solver(d)

        def kkt_solve_res(rp_, rd_, rcl, rcu):
            rhat = (
                rd_ - torch.where(fl, rcl / xl, zero)
                + torch.where(fu, rcu / xu, zero)
            )
            rhs = rp_ + matvec(w * rhat)
            dy = ksolve(rhs)
            dx = w * (rmatvec(dy) - rhat)
            # primal-residual correction (see the JAX package's comment):
            # restores A dx ~= rp lost to cancellation near active bounds
            for _ in range(refine_steps):
                err = rp_ - matvec(dx)
                dy2 = ksolve(err)
                dy = dy + dy2
                dx = dx + w * rmatvec(dy2)
            dzl = torch.where(fl, (rcl - zl_s * dx) / xl, zero)
            dzu = torch.where(fu, (rcu + zu_s * dx) / xu, zero)
            return dx, dy, dzl, dzu

        def steps(dx, dzl, dzu):
            ap = torch.minimum(_max_step(xl, dx, fl), _max_step(xu, -dx, fu))
            ad = torch.minimum(_max_step(zl, dzl, fl), _max_step(zu, dzu, fu))
            return ap, ad

        # predictor (affine scaling)
        rcl_a = torch.where(fl, -xl * zl, zero)
        rcu_a = torch.where(fu, -xu * zu, zero)
        dx_a, dy_a, dzl_a, dzu_a = kkt_solve_res(rp, rd, rcl_a, rcu_a)
        ap, ad = steps(dx_a, dzl_a, dzu_a)
        apc, adc = ap[:, None], ad[:, None]
        mu_aff = (
            _lane_sum(torch.where(fl, (xl + apc * dx_a) * (zl + adc * dzl_a), zero))
            + _lane_sum(torch.where(fu, (xu - apc * dx_a) * (zu + adc * dzu_a), zero))
        ) / nlu
        sigma = torch.clamp((mu_aff / (mu + 1e-300)) ** 3, 0.0, 1.0)
        smu = (sigma * mu)[:, None]

        # corrector
        rcl = torch.where(fl, smu - xl * zl - dx_a * dzl_a, zero)
        rcu = torch.where(fu, smu - xu * zu + dx_a * dzu_a, zero)
        dx, dy, dzl, dzu = kkt_solve_res(rp, rd, rcl, rcu)

        frac = 0.9995
        ap, ad = steps(dx, dzl, dzu)
        ap, ad = frac * ap, frac * ad

        # Gondzio multiple centrality correctors (each lane keeps a
        # corrected direction only if it enlarges that lane's step; a lane
        # stops at its first failed corrector, as under vmap in JAX)
        bmin, bmax, enlarge, gain = 0.1, 10.0, 0.1, 0.01
        live = torch.ones(B, dtype=torch.bool, device=device)
        for _ in range(correctors):
            apt = torch.clamp(ap + enlarge, max=1.0)[:, None]
            adt = torch.clamp(ad + enlarge, max=1.0)[:, None]
            vl = (xl + apt * dx) * (zl + adt * dzl)
            vu = (xu - apt * dx) * (zu + adt * dzu)
            tgt = smu
            tl = torch.where(fl, torch.clamp(vl, bmin * tgt, bmax * tgt) - vl, zero)
            tu = torch.where(fu, torch.clamp(vu, bmin * tgt, bmax * tgt) - vu, zero)
            dmx, dmy, dmzl, dmzu = (
                _sel(live, v, torch.zeros_like(v))
                for v in kkt_solve_res(torch.zeros_like(rp), torch.zeros_like(rd), tl, tu)
            )
            dx2, dy2 = dx + dmx, dy + dmy
            dzl2, dzu2 = dzl + dmzl, dzu + dmzu
            ap2, ad2 = steps(dx2, dzl2, dzu2)
            ap2, ad2 = frac * ap2, frac * ad2
            ok_c = live & (ap2 + ad2 > ap + ad + gain)
            dx, dy = _sel(ok_c, dx2, dx), _sel(ok_c, dy2, dy)
            dzl, dzu = _sel(ok_c, dzl2, dzl), _sel(ok_c, dzu2, dzu)
            ap, ad = _sel(ok_c, ap2, ap), _sel(ok_c, ad2, ad)
            live = ok_c

        apc, adc = ap[:, None], ad[:, None]
        x_n = x + apc * dx
        y_n = y + adc * dy
        zl_n = torch.where(fl, zl + adc * dzl, zero)
        zu_n = torch.where(fu, zu + adc * dzu, zero)

        # numerical-breakdown guard: keep the previous iterate and stop
        ok = (
            torch.isfinite(x_n).all(-1)
            & torch.isfinite(y_n).all(-1)
            & torch.isfinite(zl_n).all(-1)
            & torch.isfinite(zu_n).all(-1)
        )
        x_n = _sel(ok, x_n, x)
        y_n = _sel(ok, y_n, y)
        zl_n = _sel(ok, zl_n, zl)
        zu_n = _sel(ok, zu_n, zu)

        rp_n, rd_n, comp_n = residuals(x_n, y_n, zl_n, zu_n)
        m_n = merit_of(rp_n, rd_n, comp_n, x_n)
        best_m, bx, by, bzl, bzu, best_it = best
        improved = m_n < best_m
        best = (
            torch.where(improved, m_n, best_m),
            _sel(improved, x_n, bx),
            _sel(improved, y_n, by),
            _sel(improved, zl_n, bzl),
            _sel(improved, zu_n, bzu),
            torch.where(improved, it + 1, best_it),
        )
        # stop on convergence, numerical breakdown, clear divergence, or
        # (opt-in) a merit plateau
        diverged = m_n > 1e4 * torch.clamp(best_m, min=tol)
        done = (m_n < tol) | (~ok) | diverged
        if stall_limit is not None:
            done = done | ((it + 1 - best[5]) >= stall_limit)
        if trace:
            tr = _tr_record(
                tr, it,
                _lane_norm(rp_n) / bnorm,
                _lane_norm(rd_n) / cnorm,
                comp_n / (1.0 + dot(c, x_n).abs()),
                ap, ad,
            )
        return x_n, y_n, zl_n, zu_n, best, it + 1, done, tr

    if state0 is None:
        rp0, rd0, comp0 = residuals(x0, y0, z0l, z0u)
        it = torch.zeros(B, dtype=torch.int64, device=device)
        best = (merit_of(rp0, rd0, comp0, x0), x0, y0, z0l, z0u, it)
        tr = _empty_trace(max_iter if trace else 0, dtype, (B,), device)
        x, y, zl, zu = x0, y0, z0l, z0u
        done = torch.zeros(B, dtype=torch.bool, device=device)
    else:
        x, y, zl, zu = state0.x, state0.y, state0.zl, state0.zu
        best = (state0.best_merit, state0.best_x, state0.best_y,
                state0.best_zl, state0.best_zu, state0.best_it)
        it, done, tr = state0.it, state0.done, state0.trace
    it_cap = max_iter
    if it_stop is not None:
        it_cap = torch.clamp(torch.as_tensor(it_stop, device=device), max=max_iter)
    active = (it < it_cap) & ~done
    while bool(active.any()):
        xn, yn, zln, zun, bestn, itn, donen, trn = body(x, y, zl, zu, best, it, tr)
        x, y = _sel(active, xn, x), _sel(active, yn, y)
        zl, zu = _sel(active, zln, zl), _sel(active, zun, zu)
        best = tuple(_sel(active, n, o) for n, o in zip(bestn, best))
        it = _sel(active, itn, it)
        done = _sel(active, donen, done)
        tr = SolveTrace(*(_sel(active, n, o) for n, o in zip(trn, tr)))
        active = (it < it_cap) & ~done
    state = None
    if return_state:
        state = IPMState(x, y, zl, zu, *best, it=it, done=done, trace=tr)
    _, x, y, zl, zu, _ = best
    rp, rd, comp = residuals(x, y, zl, zu)
    # convergence from the final residuals, at 100x tol (breakdown can stop
    # the loop a hair early); the same residuals feed the status
    rp_rel = _lane_norm(rp) / bnorm
    rd_rel = _lane_norm(rd) / cnorm
    gap_rel = comp / (1.0 + dot(c, x).abs())
    conv = (rp_rel < 100 * tol) & (rd_rel < 100 * tol) & (gap_rel < 100 * tol)
    sol = IPMSolution(
        x=x,
        y=y,
        zl=zl,
        zu=zu,
        obj=dot(c, x) + c0,
        converged=conv,
        iterations=it,
        res_primal=rp_rel,
        res_dual=rd_rel,
        gap=gap_rel,
        status=_classify_exit(conv, rp_rel, rd_rel),
    )
    return (sol, tr, state) if return_state else (sol, tr)


def _classify_exit(conv, rp_rel, rd_rel):
    """Termination diagnosis from the exit residual signature (heuristic,
    not a certificate; see the JAX package)."""
    suspicious = 1e-3
    return torch.where(
        conv,
        STATUS_OPTIMAL,
        torch.where(
            rp_rel > suspicious,
            STATUS_PRIMAL_INFEASIBLE,
            torch.where(rd_rel > suspicious, STATUS_DUAL_INFEASIBLE, STATUS_STALLED),
        ),
    )


def solve_lp_batch(lp: LPData, warm_start=None, **kw):
    """Solve a batch of LPs given by a leading axis on any LP field; fields
    without it are shared by every lane (e.g. one A with per-scenario b/c).
    Lane ``i`` gives what `solve_lp` of lane ``i`` gives. `warm_start`,
    when given, is a per-lane ``(x, y, zl, zu)`` (leading axis = batch),
    safeguarded per lane as in `solve_lp`."""
    lpb, batch = _broadcast_batch(lp, _LP_NDIM)
    if batch is None:
        return solve_lp(lp, warm_start=warm_start, **kw)
    pin_matmul_precision()
    q = kw.pop("q", None)
    if q is not None:
        q = torch.as_tensor(q).to(lpb.b).expand_as(lpb.c)
    out = _solve_lp_inner(lpb, q=q, warm_start=_warm_tensors(warm_start, lp.b), **kw)
    trace = kw.get("trace", False)
    return out if trace else out[0]
