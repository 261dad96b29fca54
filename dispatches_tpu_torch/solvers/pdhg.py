"""Matrix-free restarted PDHG (PDLP) for large time-structured LPs (port of
`dispatches_tpu/solvers/pdhg.py`).

A stays in COO form (`core.program.SparseLP`) and each iteration is two
sparse products. Algorithm, as in the JAX package: primal-dual hybrid
gradient with Ruiz prescaling, restarts to the running average at each
convergence check, and a primal-weight balance, plus the four PDLP
controls, all default-off (module docstring of the JAX package):
``adaptive_restarts`` (restart on KKT-score decay), ``primal_weight``
(rebalance omega at restarts), ``linesearch`` (Malitsky-Pock adaptive
step) and ``polish`` (a feasibility epilogue on the output only).

Batch-first, like the port's IPM: b/c/l/u/c0 (and `vals` when A is
parametric) may carry a leading scenario axis over one shared pattern.
Every lane runs whole check periods of `check_every` iterations; after
each, a lane that is done or has reached its own `it_stop` keeps its
state untouched while the rest run on, as under the JAX package's
vmapped ``while_loop``. The host reads the lanes' flags once per check
period, never inside one.

Determinism. The products and every per-lane reduction are fixed-order
sums of elementwise adds (`_tree_sum`): the entries of a row (for A x) or
a column (for Aᵀ y) are laid out in a padded table whose width is a power
of two, and the table is halved until one column is left. No atomics and
no library reduction whose order could depend on the batch size, so a
lane gives the same bits in any batch, on every call: chunked resume is
bitwise the one-shot solve and compaction moves no bits. The columns are
bucketed by their count (one table per power of two above the light
bucket), so the design LP's two dense columns (504 entries at T = 168,
26,280 at 8,760 h) do not pad every column to their length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import SparseLP
from ..obs.trace import SolveTrace, empty_trace as _empty_trace, record as _tr_record
from .ipm import _pow2, _sel, _squeeze_lane, _tree_sum, _unsqueeze_lane, _vsum

# restart-scheme constants (PDLP's defaults, arXiv:2106.04756 §4.3.2)
_RESTART_SUFFICIENT = 0.2
_RESTART_NECESSARY = 0.8
_RESTART_ARTIFICIAL = 0.36
_POLISH_SWEEPS = 40
# columns with at most this many entries share one table
_LIGHT_WIDTH = 8
# a narrower bucket joins the next wider one when the padding this adds
# is at most this share of the pattern's entries (one launch chain less)
_MERGE_SHARE = 0.25

_SPARSE_NDIM = {"rows": 1, "cols": 1, "vals": 1, "b": 1, "c": 1, "l": 1, "u": 1, "c0": 0}


class PDHGSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    obj: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    res_primal: torch.Tensor  # original frame, as the certificates
    res_dual: torch.Tensor
    restarts: torch.Tensor


class PDHGState(NamedTuple):
    """Resumable loop state of a segmented PDHG solve, one row per lane:
    the iterate in the solver's scaled frame, the counters, the trace, and
    the PDLP bookkeeping (running sums since the last restart, the step
    and weight, the restart anchor and its score; carried inertly when the
    controls are off). Fed back with the same LP and controls it resumes
    the exact iterate sequence. `it` and `done` are the fields a caller
    reads to retire lanes."""

    x: torch.Tensor
    y: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    trace: SolveTrace
    xs: torch.Tensor
    ys: torch.Tensor
    cnt: torch.Tensor
    eta: torch.Tensor
    omega: torch.Tensor
    x_r: torch.Tensor
    y_r: torch.Tensor
    score_r: torch.Tensor
    score_prev: torch.Tensor
    restarts: torch.Tensor


def _dot(a, b):
    return _vsum(a * b)


def _nrm(v):
    return torch.sqrt(_vsum(v * v))


def _dots(*pairs):
    """Several per-lane dot products in one halving pass: each product
    fills a row of one zero-padded (B, k, P) buffer (zeros add exactly,
    so each sum is the one `_dot` gives, up to the sign of a zero)."""
    a0 = pairs[0][0]
    p = _pow2(max(a.shape[-1] for a, _ in pairs))
    buf = torch.zeros(a0.shape[0], len(pairs), p, dtype=a0.dtype, device=a0.device)
    for i, (a, b) in enumerate(pairs):
        torch.mul(a, b, out=buf[:, i, :a.shape[-1]])
    return _tree_sum(buf).unbind(-1)


def _groups(seg: np.ndarray, n: int):
    """Entries grouped by segment id, in entry order: (order, counts,
    starts) with ``order`` the stable sort of the entries by segment."""
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return order, counts, starts


def _table(order, counts, starts, segs, width, sentinel):
    """(len(segs), width) table of the entry indices of each segment,
    padded with `sentinel` (an entry whose value is 0)."""
    tab = np.full((len(segs), width), sentinel, np.int64)
    k = counts[segs]
    seg = np.repeat(np.arange(len(segs)), k)
    j = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    tab[seg, j] = order[np.repeat(starts[segs], k) + j]
    return tab


def _pow2s(counts: np.ndarray) -> np.ndarray:
    """The power of two at or above each count (1 for 0)."""
    return 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)


class _Pattern:
    """Padded gather tables of one sparsity pattern, built once per solve.

    A x: every row's entries in a (M, Wr) table, Wr the power of two at
    or above the longest row. Aᵀ y: the columns bucketed by count, the
    light ones (at most `_LIGHT_WIDTH` entries) in one table and each
    longer power of two in its own, with the permutation that puts the
    buckets' results back in column order. Pad slots point at entry nnz,
    whose value is 0 (`_Op` appends it)."""

    def __init__(self, rows, cols, M: int, N: int, device):
        rows = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows, np.int64)
        cols = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor) else cols, np.int64)
        nnz = rows.shape[0]
        self.M, self.N, self.nnz = M, N, nnz
        rows_x = np.concatenate([rows, [0]])
        cols_x = np.concatenate([cols, [0]])

        def dev(a):
            return torch.as_tensor(a, device=device)

        order, counts, starts = _groups(rows, M)
        wr = _pow2(max(int(counts.max(initial=0)), 1))
        r_ent = _table(order, counts, starts, np.arange(M), wr, nnz)
        self.r_ent = dev(r_ent)
        self.r_col = dev(cols_x[r_ent].reshape(-1))
        self.rows = dev(rows)
        self.cols = dev(cols)

        order, counts, starts = _groups(cols, N)
        width = _pow2s(counts)
        light = width <= _LIGHT_WIDTH
        if light.any():
            width[light] = width[light].max()
        ws = sorted(set(width.tolist()), reverse=True)
        cur = ws[0]
        for w in ws[1:]:
            moved = width == w
            if moved.sum() * (cur - w) <= _MERGE_SHARE * nnz:
                width[moved] = cur
            else:
                cur = w
        self.c_ent, self.c_row, perm = [], [], []
        for w in sorted(set(width.tolist())):
            segs = np.nonzero(width == w)[0]
            ent = _table(order, counts, starts, segs, w, nnz)
            self.c_ent.append(dev(ent))
            self.c_row.append(dev(rows_x[ent].reshape(-1)))
            perm.append(segs)
        self.c_inv = dev(np.argsort(np.concatenate(perm)))


class _Op:
    """A x and Aᵀ y for one set of values (shape (Bv, nnz), Bv 1 or the
    batch) on (B, N) / (B, M) tensors."""

    def __init__(self, pat: _Pattern, vals: torch.Tensor):
        self.pat = pat
        vx = F.pad(vals, (0, 1))
        self.v_r = vx[:, pat.r_ent]
        self.v_c = [vx[:, e] for e in pat.c_ent]

    def mv(self, x):
        p = self.pat
        g = x.index_select(-1, p.r_col).view(x.shape[0], p.M, -1)
        return _tree_sum(self.v_r * g)

    def rmv(self, y):
        p = self.pat
        parts = [
            _tree_sum(v * y.index_select(-1, r).view(y.shape[0], v.shape[1], v.shape[2]))
            for v, r in zip(self.v_c, p.c_row)
        ]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        return out.index_select(-1, p.c_inv)


def _seg_amax(v, idx, n):
    """Per-lane maximum of `v` (Bv, nnz) over each segment of `idx`, from
    0 (``.at[].max`` on zeros in the JAX package)."""
    out = torch.zeros(v.shape[0], n, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(1, idx.expand(v.shape[0], -1), v, "amax")


def _ruiz_sparse(pat: _Pattern, vals, iters=10):
    Bv = vals.shape[0]
    r = torch.ones(Bv, pat.M, dtype=vals.dtype, device=vals.device)
    c = torch.ones(Bv, pat.N, dtype=vals.dtype, device=vals.device)
    for _ in range(iters):
        v = vals * r[:, pat.rows] * c[:, pat.cols]
        rmax = _seg_amax(v.abs(), pat.rows, pat.M)
        r = r / torch.sqrt(torch.where(rmax > 0, rmax, 1.0))
        v = vals * r[:, pat.rows] * c[:, pat.cols]
        cmax = _seg_amax(v.abs(), pat.cols, pat.N)
        c = c / torch.sqrt(torch.where(cmax > 0, cmax, 1.0))
    return r, c


def _lanes(lp: SparseLP):
    """(batched LP, batch or None): b/c/l/u/c0 with a leading lane axis,
    `vals` as (Bv, nnz) with Bv 1 when shared, the pattern unbatched."""
    batch = None
    for name, arr in zip(lp._fields, lp):
        nd = _SPARSE_NDIM[name]
        if arr.dim() == nd + 1:
            if name in ("rows", "cols"):
                raise ValueError(
                    "solve_lp_pdhg needs one shared sparsity pattern (unbatched "
                    "rows/cols); batch vals/b/c/l/u instead")
            batch = arr.shape[0]
        elif arr.dim() != nd:
            raise ValueError(f"bad ndim for SparseLP.{name}: {arr.dim()}")
    B = batch or 1

    def lane(name, arr):
        if name in ("rows", "cols"):
            return arr
        if name == "vals":
            return arr if arr.dim() == 2 else arr.unsqueeze(0)
        if arr.dim() == _SPARSE_NDIM[name] + 1:
            return arr
        return arr.unsqueeze(0).expand(B, *arr.shape)

    return SparseLP(*(lane(n, a) for n, a in zip(lp._fields, lp))), batch


def solve_lp_pdhg(
    lp: SparseLP,
    tol: float = 1e-6,
    max_iter: int = 100_000,
    check_every: int = 200,
    trace: bool = False,
    warm_start=None,
    state: PDHGState = None,
    it_stop=None,
    return_state: bool = False,
    adaptive_restarts: bool = False,
    primal_weight: bool = False,
    linesearch: bool = False,
    polish: bool = False,
):
    """Solve one LP, or a batch over a leading axis, by restarted PDHG on
    the device its tensors live on.

    `trace=True` returns ``(PDHGSolution, SolveTrace)`` with one entry per
    convergence check (``ceil(max_iter / check_every)`` slots): relative
    KKT residuals, a duality-gap estimate and the primal/dual steps.
    `warm_start` = (x, y) in the solution frame seeds the iteration (the
    primal projected into the box; a lane with a nonfinite seed starts
    cold). `state` / `it_stop` / `return_state` are the segmented-solve
    primitive of `runtime/adaptive.py`: run each lane until its iteration
    count reaches ``it_stop`` (an int or a per-lane tensor; a multiple of
    `check_every`, as the loop only stops between checks), return the
    resumable `PDHGState` after the solution (and trace), and feed it back
    with the same LP and controls to continue the exact iterate sequence.
    The PDLP controls are described in the module docstring. The final
    `res_primal` / `res_dual` are in the original problem frame, as
    `obs.conformance.kkt_certificates` computes them; the loop's own test
    runs in the scaled frame."""
    lpb, batch = _lanes(lp)
    rows, cols, vals0, b0, c0v, l0, u0, off = lpb
    B, M = b0.shape
    N = c0v.shape[-1]
    dtype, device = b0.dtype, b0.device
    pdlp = adaptive_restarts or primal_weight or linesearch
    if batch is None:
        state = _unsqueeze_lane(state)
        if warm_start is not None:
            warm_start = tuple(torch.as_tensor(w).unsqueeze(0) for w in warm_start)

    pat = _Pattern(rows, cols, M, N, device)
    # Ruiz equilibration + norm scaling (x = C x~, row scale R)
    r, cs = _ruiz_sparse(pat, vals0)
    vals = vals0 * r[:, pat.rows] * cs[:, pat.cols]
    op = _Op(pat, vals)
    b = b0 * r
    l = l0 / cs
    u = u0 / cs
    c = c0v * cs
    sig_c = torch.clamp(c.abs().amax(-1), min=1.0)[:, None]
    sig_b = torch.clamp(b.abs().amax(-1), min=1.0)
    fin_l = torch.isfinite(l)
    sig_b = torch.maximum(sig_b, torch.where(fin_l, l.abs(), 0.0).amax(-1))[:, None]
    c = c / sig_c
    b = b / sig_b
    l = l / sig_b
    u = u / sig_b
    fin_l, fin_u = torch.isfinite(l), torch.isfinite(u)

    # spectral norm estimate by power iteration on AᵀA (once per value set)
    v = torch.full((vals.shape[0], N), 1.0 / math.sqrt(N), dtype=dtype, device=device)
    for _ in range(30):
        v2 = op.rmv(op.mv(v))
        v = v2 / (_nrm(v2) + 1e-30)[:, None]
    Anorm = (_nrm(op.mv(v)) / (_nrm(v) + 1e-30)).expand(B)
    eta = 0.9 / torch.clamp(Anorm, min=1e-12)
    omega = torch.clamp((1.0 + _nrm(c)) / (1.0 + _nrm(b)), 1e-4, 1e4)
    tau = (eta * omega)[:, None]  # primal step
    sig = (eta / omega)[:, None]  # dual step
    nb1 = 1.0 + _nrm(b)

    def proj(x):
        return torch.clamp(x, l, u)

    def kkt(x, y):
        rp = _nrm(op.mv(x) - b) / nb1
        z = c - op.rmv(y)
        rd = _nrm(x - proj(x - z)) / (1.0 + _nrm(x))
        return rp, rd, z

    def gap_of(x, y, z):
        # primal objective vs the bound-aware dual one (infinite-bound
        # contributions masked to 0)
        contrib = torch.where(
            z > 0,
            torch.where(fin_l, l * z, 0.0),
            torch.where(fin_u, u * z, 0.0),
        )
        pobj = _dot(c, x)
        dobj = _dot(b, y) + _vsum(contrib)
        return (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())

    def score_of(x, y):
        rp, rd, z = kkt(x, y)
        return rp, rd, rp + rd + gap_of(x, y, z)

    x0 = proj(torch.zeros(B, N, dtype=dtype, device=device))
    y0 = torch.zeros(B, M, dtype=dtype, device=device)
    if warm_start is not None:
        # solution frame -> scaled frame; a nonfinite seed starts cold
        xw, yw = (torch.as_tensor(w, dtype=dtype, device=device) for w in warm_start)
        xw = xw / (cs * sig_b)
        yw = yw / (r * sig_c)
        ok_w = torch.isfinite(xw).all(-1) & torch.isfinite(yw).all(-1)
        x0 = _sel(ok_w, proj(xw), x0)
        y0 = _sel(ok_w, yw, y0)

    def body(st):
        x, y, it, _, tr = st[:5]
        xs, ys = torch.zeros_like(x), torch.zeros_like(y)
        for _ in range(check_every):
            z = c - op.rmv(y)
            xn = proj(x - tau * z)
            axe = op.mv(2.0 * xn - x)
            y = y + sig * (b - axe)
            x = xn
            xs = xs + x
            ys = ys + y
        cnt = float(check_every)
        xa, ya = xs / cnt, ys / cnt
        rp_k, rd_k, _ = kkt(x, y)
        rp_a, rd_a, _ = kkt(xa, ya)
        use_avg = (rp_a + rd_a) < (rp_k + rd_k)
        x_new, y_new = _sel(use_avg, xa, x), _sel(use_avg, ya, y)
        rp = torch.where(use_avg, rp_a, rp_k)
        rd = torch.where(use_avg, rd_a, rd_k)
        done = (rp < tol) & (rd < tol)
        if trace:
            z = c - op.rmv(y_new)
            tr = _tr_record(tr, it // check_every, rp, rd, gap_of(x_new, y_new, z),
                            tau[:, 0], sig[:, 0])
        return (x_new, y_new, it + check_every, done, tr)

    def body_pdlp(st):
        # the running average accumulates since the last restart (across
        # check periods); eta and omega live in the state
        (x, y, it, _, tr, xs, ys, cnt, eta_c, om,
         x_r, y_r, score_r, score_prev, rst) = st
        ax = op.mv(x)
        k = it.to(dtype)
        for _ in range(check_every):
            z = c - op.rmv(y)
            xn = proj(x - (eta_c * om)[:, None] * z)
            axn = op.mv(xn)
            yn = y + (eta_c / om)[:, None] * (b - (2.0 * axn - ax))
            if linesearch:
                dx = xn - x
                dy = yn - y
                d_inter, d_xx, d_yy = _dots((dy, axn - ax), (dx, dx), (dy, dy))
                inter = d_inter.abs()
                move = d_xx / om + om * d_yy
                eta_bar = move / (2.0 * inter + 1e-30)
                accept = (eta_c <= eta_bar) | (move <= 1e-30)
                kp = k + 1.0
                eta_n = torch.minimum(
                    (1.0 - kp ** -0.3) * eta_bar,
                    (1.0 + kp ** -0.6) * eta_c,
                )
                ok_eta = torch.isfinite(eta_n) & (eta_n > 0.0)
                eta_c = torch.where(ok_eta, eta_n, eta_c)
                w = accept.to(dtype)
                x = _sel(accept, xn, x)
                y = _sel(accept, yn, y)
                ax = _sel(accept, axn, ax)
                xs = xs + w[:, None] * x
                ys = ys + w[:, None] * y
                cnt = cnt + w
                k = kp
            else:
                x, y, ax = xn, yn, axn
                xs = xs + x
                ys = ys + y
                cnt = cnt + 1.0
                k = k + 1.0
        cnt_safe = torch.clamp(cnt, min=1.0)[:, None]
        has = cnt > 0
        xa = _sel(has, xs / cnt_safe, x)
        ya = _sel(has, ys / cnt_safe, y)
        rp_k, rd_k, sc_k = score_of(x, y)
        rp_a, rd_a, sc_a = score_of(xa, ya)
        # restart candidate: the better of current and running average
        use_avg = sc_a < sc_k
        xc, yc = _sel(use_avg, xa, x), _sel(use_avg, ya, y)
        rp = torch.where(use_avg, rp_a, rp_k)
        rd = torch.where(use_avg, rd_a, rd_k)
        sc = torch.where(use_avg, sc_a, sc_k)
        done = (rp < tol) & (rd < tol)
        if adaptive_restarts:
            suff = sc <= _RESTART_SUFFICIENT * score_r
            necc = (sc >= _RESTART_NECESSARY * score_r) & (sc > score_prev)
            total = (it + check_every).to(dtype)
            long_ = cnt >= _RESTART_ARTIFICIAL * torch.clamp(total, min=1.0)
            restart = suff | necc | long_ | done
        else:
            restart = torch.ones_like(done)
        if primal_weight:
            # balancing weight om* = |dx| / |dy| in this solver's convention
            # (tau = eta * om, sig = eta / om)
            dx_m = _nrm(xc - x_r)
            dy_m = _nrm(yc - y_r)
            om_new = torch.exp(
                0.5 * torch.log(dx_m / torch.clamp(dy_m, min=1e-30))
                + 0.5 * torch.log(om)
            )
            om_new = torch.clamp(om_new, 1e-4, 1e4)
            ok_om = torch.isfinite(om_new) & (dx_m > 0.0) & (dy_m > 0.0)
            om = torch.where(restart & ok_om, om_new, om)
        x_new, y_new = _sel(restart, xc, x), _sel(restart, yc, y)
        xs = _sel(restart, torch.zeros_like(xs), xs)
        ys = _sel(restart, torch.zeros_like(ys), ys)
        cnt = torch.where(restart, 0.0, cnt)
        x_r, y_r = _sel(restart, xc, x_r), _sel(restart, yc, y_r)
        score_r = torch.where(restart, sc, score_r)
        rst = rst + restart.to(rst.dtype)
        if trace:
            z = c - op.rmv(y_new)
            tr = _tr_record(tr, it // check_every, rp, rd, gap_of(x_new, y_new, z),
                            eta_c * om, eta_c / om)
        return (x_new, y_new, it + check_every, done, tr,
                xs, ys, cnt, eta_c, om, x_r, y_r, score_r, sc, rst)

    n_checks = -(-max_iter // check_every)
    if state is None:
        it0 = torch.zeros(B, dtype=torch.int64, device=device)
        done0 = torch.zeros(B, dtype=torch.bool, device=device)
        tr0 = _empty_trace(n_checks if trace else 0, dtype, (B,), device)
        carry = (x0, y0, it0, done0, tr0)
        if pdlp:
            _, _, sc0 = score_of(x0, y0)
            carry += (torch.zeros_like(x0), torch.zeros_like(y0),
                      torch.zeros(B, dtype=dtype, device=device), eta, omega,
                      x0, y0, sc0, sc0, torch.zeros(B, dtype=torch.int32, device=device))
    else:
        carry = tuple(state) if pdlp else tuple(state[:5])
    step = body_pdlp if pdlp else body
    it_cap = max_iter
    if it_stop is not None:
        it_cap = torch.clamp(torch.as_tensor(it_stop, device=device), max=max_iter)
    active = (carry[2] < it_cap) & ~carry[3]
    while bool(active.any()):  # one host read per check period
        new = step(carry)
        carry = tuple(
            SolveTrace(*(_sel(active, a, o) for a, o in zip(n, c_)))
            if isinstance(n, SolveTrace) else _sel(active, n, c_)
            for n, c_ in zip(new, carry)
        )
        active = (carry[2] < it_cap) & ~carry[3]
    if pdlp:
        st_out = PDHGState(*carry)
    else:
        x, y, it, done, tr = carry
        inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
        st_out = PDHGState(
            x=x, y=y, it=it, done=done, trace=tr,
            xs=torch.zeros_like(x), ys=torch.zeros_like(y),
            cnt=torch.zeros(B, dtype=dtype, device=device), eta=eta, omega=omega,
            x_r=x, y_r=y, score_r=inf, score_prev=inf,
            restarts=torch.zeros(B, dtype=torch.int32, device=device),
        )
    x, y, it, done, tr_out = st_out[:5]

    if polish:
        # feasibility polish on the output only (the state above is sealed,
        # so chunked resume stays bitwise): pin the box faces the reduced
        # costs' signs imply, run projected Landweber sweeps on A x = b over
        # the free coordinates, keep the result only where it strictly
        # lowers the primal residual without raising the KKT sum
        z_f = c - op.rmv(y)
        pin_lo = fin_l & (z_f > 0)
        pin_hi = fin_u & (z_f < 0)
        free = torch.where(pin_lo | pin_hi, 0.0, 1.0).to(dtype)
        x_pin = torch.where(pin_lo, l, torch.where(pin_hi, u, x))
        alpha = (1.0 / torch.clamp(Anorm * Anorm, min=1e-30))[:, None]
        x_p = x_pin
        for _ in range(_POLISH_SWEEPS):
            g = op.rmv(b - op.mv(x_p))
            x_p = proj(x_p + alpha * free * g)
        rp_old, rd_old, _ = kkt(x, y)
        rp_new, rd_new, _ = kkt(x_p, y)
        ok_p = (
            torch.isfinite(x_p).all(-1)
            & (rp_new < rp_old)
            & (rp_new + rd_new < rp_old + rd_old)
        )
        x = _sel(ok_p, x_p, x)

    # unscale; the final residuals in the original frame
    x_out = x * cs * sig_b
    y_out = y * r * sig_c
    rp_f, rd_f = _residuals(_Op(pat, vals0), b0, c0v, l0, u0, x_out, y_out)
    sol = PDHGSolution(
        x=x_out,
        y=y_out,
        obj=_dot(c0v, x_out) + off,
        converged=done,
        iterations=it,
        res_primal=rp_f,
        res_dual=rd_f,
        restarts=st_out.restarts,
    )
    out = (sol, tr_out, st_out) if return_state else (sol, tr_out)
    if batch is None:
        out = _squeeze_lane(out)
    if return_state:
        return out if trace else (out[0], out[2])
    return out if trace else out[0]


def _residuals(op: _Op, b, c, l, u, x, y):
    """Relative primal residual ‖Ax − b‖/(1 + ‖b‖) and projected-gradient
    dual residual ‖x − Π[l,u](x − (c − Aᵀy))‖/(1 + ‖x‖) per lane."""
    rp = _nrm(op.mv(x) - b) / (1.0 + _nrm(b))
    z = c - op.rmv(y)
    rd = _nrm(x - torch.clamp(x - z, l, u)) / (1.0 + _nrm(x))
    return rp, rd
