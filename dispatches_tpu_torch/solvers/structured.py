"""Block-tridiagonal (time-banded) interior-point LP solver (PyTorch).

Port of `dispatches_tpu/solvers/structured.py`. Ordering rows/columns by
time makes the IPM's normal-equations matrix ``K = A W A^T`` block
tridiagonal plus a low-rank border from the few design columns that touch
every period. The factorization is a loop of small per-block Cholesky
factors, O(T · mB^3), with the border handled by a Woodbury correction of
rank p. The Mehrotra iteration is `ipm._solve_scaled`, shared with the
dense solver.

With ``sweep_backend="fused"`` (the counterpart of the JAX package's
``"pallas"``) every KKT sweep chain runs through the hand-written CUDA
kernel of `solvers/chain_sweep.py`; ``"scan"`` (the counterpart of
``"xla"``) runs the sweeps as a loop of batched PyTorch products.

Batch-first: every banded field carries a leading scenario axis inside the
solver, so a block array is (B, Tb, m, m) and the time axis is -3.

Pipeline:
  meta = extract_time_structure(prog, T, block_hours)   # host, once
  blp  = meta.instantiate(params, device=...)           # device scatter
  sol  = solve_lp_banded(meta, blp)                     # sol.x in prog order
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..core.program import CompiledLP, LPData, _ParamSource, _scatter_add
from .chain_sweep import chain_solve, sweep_factors
from .ipm import (
    _broadcast_batch,
    _chol,
    _lane,
    _max0,
    _solve_scaled,
    _squeeze_lane,
    _unsqueeze_lane,
    _warm_safeguard,
    _warm_tensors,
    pin_matmul_precision,
)

SWEEP_BACKENDS = ("scan", "fused")


class BandedLP(NamedTuple):
    """Time-banded standard-form LP tensors.

    Row/col layout: Tb super-blocks of (mB rows, nB cols) plus p border
    columns. ``As[t]`` couples block-t rows to block-(t-1) columns
    (``As[0] = 0``). Any field may carry a leading batch axis."""

    Ad: torch.Tensor  # (Tb, mB, nB) diagonal blocks
    As: torch.Tensor  # (Tb, mB, nB) sub-diagonal blocks
    Bb: torch.Tensor  # (Tb, mB, p) border columns
    b: torch.Tensor  # (Tb, mB)
    c: torch.Tensor  # (Tb, nB)
    cb: torch.Tensor  # (p,)
    l: torch.Tensor  # (Tb, nB)
    u: torch.Tensor  # (Tb, nB)
    lb: torch.Tensor  # (p,)
    ub: torch.Tensor  # (p,)
    c0: torch.Tensor  # ()


_BASE_NDIM = {
    "Ad": 3, "As": 3, "Bb": 3, "b": 2, "c": 2, "cb": 1,
    "l": 2, "u": 2, "lb": 1, "ub": 1, "c0": 0,
}


@dataclasses.dataclass(eq=False)
class TimeStructure:
    """Host-side scatter metadata lowering a CompiledLP into banded form.

    `p` is always >= 1: a problem with no border columns gets one synthetic
    inert column (all-zero B, bounds [0, 1], zero cost)."""

    prog: CompiledLP
    T: int
    block_hours: int
    Tb: int
    mB: int
    nB: int
    p: int
    diag_idx: np.ndarray
    diag_vals: np.ndarray
    sub_idx: np.ndarray
    sub_vals: np.ndarray
    bord_idx: np.ndarray
    bord_vals: np.ndarray
    a_pgroups: list  # (dest, name, flat_idx, scale, pidx)
    b_idx: np.ndarray
    b_vals: np.ndarray
    b_pgroups: dict
    c_idx: np.ndarray
    c_vals: np.ndarray
    cb_idx: np.ndarray
    cb_vals: np.ndarray
    c_pgroups: list  # (is_border, name, flat_idx, scale, pidx)
    l_t: np.ndarray
    u_t: np.ndarray
    l_b: np.ndarray
    u_b: np.ndarray
    col_pos: np.ndarray  # reduced col -> flat position in [t-part | border]
    row_pos_flat: np.ndarray  # original row -> flat position in (Tb*mB)
    pad_rows: np.ndarray  # (Tb, mB) bool: padding rows (all-zero, b=0)
    # (Tb, mB) bool: rows on border columns alone (no banded entry)
    border_rows: np.ndarray = None

    # ------------------------------------------------------------------
    def instantiate(self, params: Dict, dtype=torch.float64, device="cuda") -> BandedLP:
        """Banded analogue of `CompiledLP.instantiate`: pure scatter-adds on
        `device`. Parameters with leading batch axes give batched fields
        (the structure's bounds stay unbatched)."""
        prog = self.prog
        src = _ParamSource(params, prog.param_shapes, dtype, device)
        lead = src.lead
        Tb, mB, nB, p = self.Tb, self.mB, self.nB, self.p

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def fill(shape, idx, vals, pgroups):
            a = torch.zeros(int(np.prod(shape)), dtype=dtype, device=device)
            _scatter_add(a, idx, t(vals))
            if pgroups:
                a = a.expand(*lead, a.numel()).clone() if lead else a
            for name, scale, pidx, gi in pgroups:
                _scatter_add(a, gi, t(scale) * src.take(name, pidx))
            return a.reshape(*a.shape[:-1], *shape)

        def groups(dest):
            return [(k, s, pi, gi) for (d, k, gi, s, pi) in self.a_pgroups if d == dest]

        Ad = fill((Tb, mB, nB), self.diag_idx, self.diag_vals, groups("diag"))
        As = fill((Tb, mB, nB), self.sub_idx, self.sub_vals, groups("sub"))
        Bb = fill((Tb, mB, max(p, 1)), self.bord_idx, self.bord_vals, groups("bord"))
        b = fill(
            (Tb, mB), self.b_idx, self.b_vals,
            [(k, s, pi, gi) for k, (gi, s, pi) in self.b_pgroups.items()],
        )
        c = fill(
            (Tb, nB), self.c_idx, self.c_vals,
            [(k, s, pi, gi) for (ib, k, gi, s, pi) in self.c_pgroups if not ib],
        )
        cb = fill(
            (max(p, 1),), self.cb_idx, self.cb_vals,
            [(k, s, pi, gi) for (ib, k, gi, s, pi) in self.c_pgroups if ib],
        )
        c0 = torch.full(lead, prog.c0_val, dtype=dtype, device=device)
        for k, (scale, pidx) in prog.c0_pgroups.items():
            c0 = c0 + torch.sum(t(scale) * src.take(k, pidx), dim=-1)
        return BandedLP(
            Ad=Ad, As=As, Bb=Bb, b=b, c=c, cb=cb,
            l=t(self.l_t), u=t(self.u_t), lb=t(self.l_b), ub=t(self.u_b), c0=c0,
        )


def extract_time_structure(
    prog: CompiledLP, T: int, block_hours: int = 24
) -> TimeStructure:
    """Detect the time-banded structure of a lowered LP and build the
    scatter metadata (host numpy; identical to the JAX package's). Columns
    of (T, ...)-shaped variables go to their time block; scalar variables
    become border columns. Every row must touch at most two adjacent
    column blocks (raises otherwise)."""
    L = block_hours
    if T % L:
        raise ValueError(f"T={T} must be a multiple of block_hours={L}")
    Tb = T // L
    n_keep = len(prog._keep_cols)
    N, M = prog.N, prog.M
    Mi = prog.n_slack
    Me = M - Mi

    # ---- column blocks -------------------------------------------------
    col_tb = np.full(N, -2, dtype=np.int64)  # -1 = border
    for name, vm in prog._vars.items():
        full_cols = np.arange(vm.start, vm.start + vm.size)
        red = np.searchsorted(prog._keep_cols, full_cols)
        ok = red < n_keep
        ok[ok] = prog._keep_cols[red[ok]] == full_cols[ok]
        offs = np.arange(vm.size)
        if vm.shape and vm.shape[0] == T:
            per_t = vm.size // T
            tb = (offs // per_t) // L
        else:
            tb = np.full(vm.size, -1)
        col_tb[red[ok]] = tb[ok]

    # ---- row blocks ----------------------------------------------------
    pat_r = [np.asarray(prog.A_rows)]
    pat_c = [np.asarray(prog.A_cols)]
    for rows, cols, _, _ in prog.A_pgroups.values():
        pat_r.append(np.asarray(rows))
        pat_c.append(np.asarray(cols))
    pr = np.concatenate(pat_r)
    pc = np.concatenate(pat_c)
    keep = (pc < n_keep) & (col_tb[pc] >= 0)  # non-slack, non-border
    row_min = np.full(M, np.iinfo(np.int64).max)
    row_max = np.full(M, -1)
    np.minimum.at(row_min, pr[keep], col_tb[pc[keep]])
    np.maximum.at(row_max, pr[keep], col_tb[pc[keep]])
    untouched = row_max < 0
    row_min[untouched] = 0
    row_max[untouched] = 0
    if np.any(row_max - row_min > 1):
        bad = np.where(row_max - row_min > 1)[0][:5]
        raise ValueError(
            f"rows {bad} span non-adjacent time blocks "
            f"(e.g. {row_min[bad[0]]}..{row_max[bad[0]]}) — not time-banded "
            "at this block size"
        )
    row_tb = row_max
    # slack columns inherit their row's block; a row on border columns
    # alone takes its slack to the border too, so that its banded row is
    # empty (see `border_rows` below)
    col_tb[n_keep + np.arange(Mi)] = np.where(untouched[Me:], -1, row_tb[Me:])
    assert not np.any(col_tb == -2), "unassigned columns"

    # ---- positions & padding ------------------------------------------
    def positions(blocks, num):
        """Per-element position within its block + per-block counts."""
        pos = np.zeros(len(blocks), dtype=np.int64)
        order = np.argsort(blocks, kind="stable")
        sorted_b = blocks[order]
        starts = np.searchsorted(sorted_b, np.arange(num))
        ends = np.searchsorted(sorted_b, np.arange(num), side="right")
        counts = ends - starts
        within = np.arange(len(blocks)) - starts[sorted_b]
        pos[order] = within
        return pos, counts

    row_pos, row_counts = positions(row_tb, Tb)
    mB = int(row_counts.max())
    tcols = np.where(col_tb >= 0)[0]
    bcols = np.where(col_tb == -1)[0]
    tpos, col_counts = positions(col_tb[tcols], Tb)
    col_pos_in_block = np.zeros(N, dtype=np.int64)
    col_pos_in_block[tcols] = tpos
    nB = int(col_counts.max())
    p = len(bcols)
    bpos = np.zeros(N, dtype=np.int64)
    bpos[bcols] = np.arange(p)

    col_pos = np.zeros(N, dtype=np.int64)
    col_pos[tcols] = col_tb[tcols] * nB + col_pos_in_block[tcols]
    col_pos[bcols] = Tb * nB + bpos[bcols]
    row_pos_flat = row_tb * mB + row_pos

    # ---- A scatter targets --------------------------------------------
    def a_targets(rows, cols):
        """(dest_code, flat_idx): 0=diag, 1=sub, 2=border."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        tb_r = row_tb[rows]
        i = row_pos[rows]
        dest = np.full(len(rows), -1, dtype=np.int64)
        flat = np.zeros(len(rows), dtype=np.int64)
        isb = col_tb[cols] == -1
        dest[isb] = 2
        flat[isb] = (tb_r[isb] * mB + i[isb]) * max(p, 1) + bpos[cols[isb]]
        isd = ~isb & (col_tb[cols] == tb_r)
        dest[isd] = 0
        flat[isd] = (tb_r[isd] * mB + i[isd]) * nB + col_pos_in_block[cols[isd]]
        iss = ~isb & (col_tb[cols] == tb_r - 1)
        dest[iss] = 1
        flat[iss] = (tb_r[iss] * mB + i[iss]) * nB + col_pos_in_block[cols[iss]]
        if np.any(dest < 0):
            raise ValueError("A entry below the sub-diagonal block band")
        return dest, flat

    dest, flat = a_targets(prog.A_rows, prog.A_cols)
    vals = np.asarray(prog.A_vals)
    diag_idx, diag_vals = flat[dest == 0], vals[dest == 0]
    sub_idx, sub_vals = flat[dest == 1], vals[dest == 1]
    bord_idx, bord_vals = flat[dest == 2], vals[dest == 2]

    a_pgroups = []
    for k, (rows, cols, scale, pidx) in prog.A_pgroups.items():
        d, f = a_targets(rows, cols)
        scale = np.asarray(scale)
        pidx = np.asarray(pidx)
        for code, name in [(0, "diag"), (1, "sub"), (2, "bord")]:
            m = d == code
            if m.any():
                a_pgroups.append((name, k, f[m], scale[m], pidx[m]))

    # ---- b / c targets -------------------------------------------------
    b_idx = row_pos_flat[np.asarray(prog.b_rows)]
    b_vals = np.asarray(prog.b_vals)
    b_pgroups = {
        k: (row_pos_flat[np.asarray(rows)], np.asarray(scale), np.asarray(pidx))
        for k, (rows, scale, pidx) in prog.b_pgroups.items()
    }

    cc = np.asarray(prog.c_cols)
    cv = np.asarray(prog.c_vals)
    cisb = col_tb[cc] == -1
    c_idx = col_tb[cc[~cisb]] * nB + col_pos_in_block[cc[~cisb]]
    c_vals = cv[~cisb]
    cb_idx = bpos[cc[cisb]]
    cb_vals = cv[cisb]
    c_pgroups = []
    for k, (cols, scale, pidx) in prog.c_pgroups.items():
        cols = np.asarray(cols)
        scale = np.asarray(scale)
        pidx = np.asarray(pidx)
        isb = col_tb[cols] == -1
        if (~isb).any():
            c_pgroups.append(
                (False, k, col_tb[cols[~isb]] * nB + col_pos_in_block[cols[~isb]],
                 scale[~isb], pidx[~isb])
            )
        if isb.any():
            c_pgroups.append((True, k, bpos[cols[isb]], scale[isb], pidx[isb]))

    # ---- bounds (pad columns get the inert box [0, 1]) -----------------
    l_t = np.zeros((Tb, nB))
    u_t = np.ones((Tb, nB))
    l_t[col_tb[tcols], col_pos_in_block[tcols]] = prog.lb[tcols]
    u_t[col_tb[tcols], col_pos_in_block[tcols]] = prog.ub[tcols]
    l_b = prog.lb[bcols]
    u_b = prog.ub[bcols]
    if p == 0:
        p = 1
        l_b = np.zeros(1)
        u_b = np.ones(1)

    pad_rows = np.arange(mB)[None, :] >= row_counts[:, None]
    # rows that touch no time-block column (a design variable pinned to a
    # parameter, a ratio between two capacities) have no entry in the
    # banded blocks
    border_rows = np.zeros(Tb * mB, dtype=bool)
    border_rows[row_pos_flat[np.nonzero(untouched)[0]]] = True
    border_rows = border_rows.reshape(Tb, mB)

    return TimeStructure(
        prog=prog, T=T, block_hours=L, Tb=Tb, mB=mB, nB=nB, p=p,
        diag_idx=diag_idx, diag_vals=diag_vals, sub_idx=sub_idx,
        sub_vals=sub_vals, bord_idx=bord_idx, bord_vals=bord_vals,
        a_pgroups=a_pgroups, b_idx=b_idx, b_vals=b_vals, b_pgroups=b_pgroups,
        c_idx=c_idx, c_vals=c_vals, cb_idx=cb_idx, cb_vals=cb_vals,
        c_pgroups=c_pgroups, l_t=l_t, u_t=u_t, l_b=l_b, u_b=u_b,
        col_pos=col_pos, row_pos_flat=row_pos_flat, pad_rows=pad_rows,
        border_rows=border_rows,
    )


# ----------------------------------------------------------------------
# Block-tridiagonal Cholesky + sweeps (time axis -3, any leading axes)
# ----------------------------------------------------------------------
def _shift_down(a, dim):
    """out[t] = a[t-1] along `dim`, out[0] = 0."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([z, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def _shift_up(a, dim):
    """out[t] = a[t+1] along `dim`, out[-1] = 0."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([a.narrow(dim, 1, a.shape[dim] - 1), z], dim=dim)


def _block_chol(Ds, Es, inv=False):
    """Factor the block-tridiagonal SPD matrix with diagonal blocks `Ds`
    and sub-diagonal blocks `Es` (both (..., Tb, m, m); Es[0] ignored) as
    L_blk L_blk^T: D_t = C_t C_t^T + L_t L_t^T, E_t = C_t L_{t-1}^T.

    With ``inv=True`` the first return holds the inverses L_t^{-1} (one
    triangular solve against the identity per block), so C = E Lprev^{-T}
    is a product and every sweep step applies factors by product, the
    form the fused sweep kernel takes."""
    Tb, m = Ds.shape[-3], Ds.shape[-1]
    Ls = torch.empty(Ds.shape, dtype=Ds.dtype, device=Ds.device)
    Cs = torch.zeros(Es.shape, dtype=Es.dtype, device=Es.device)
    if inv:
        eye = torch.eye(m, dtype=Ds.dtype, device=Ds.device)

        def tinv(L):
            return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)

        J = tinv(_chol(Ds[..., 0, :, :]))
        Ls[..., 0, :, :] = J
        for t in range(1, Tb):
            C = Es[..., t, :, :] @ J.transpose(-1, -2)  # = E Lprev^{-T}
            J = tinv(_chol(Ds[..., t, :, :] - C @ C.transpose(-1, -2)))
            Ls[..., t, :, :] = J
            Cs[..., t, :, :] = C
    else:
        L = _chol(Ds[..., 0, :, :])
        Ls[..., 0, :, :] = L
        for t in range(1, Tb):
            # C = E Lprev^{-T}: C Lprev^T = E
            C = torch.linalg.solve_triangular(
                L.transpose(-1, -2), Es[..., t, :, :], upper=True, left=False
            )
            L = _chol(Ds[..., t, :, :] - C @ C.transpose(-1, -2))
            Ls[..., t, :, :] = L
            Cs[..., t, :, :] = C
    return Ls, Cs


def _bt_solve(Ls, Cs, r, inv=False):
    """Solve the factored block-tridiagonal system. Ls, Cs: (..., Tb, m, m);
    r: (..., Tb, m) or (..., Tb, m, k). `inv` says `Ls` holds L_t^{-1}
    (see `_block_chol`): sweep steps are then products, not triangular
    solves. This is the loop the JAX package runs as `lax.scan`."""
    vec = r.dim() == Ls.dim() - 1
    if vec:
        r = r[..., None]
    Tb = r.shape[-3]
    vs = torch.empty_like(r)
    v = torch.zeros_like(r[..., 0, :, :])
    for t in range(Tb):
        rhs = r[..., t, :, :] - Cs[..., t, :, :] @ v
        if inv:
            v = Ls[..., t, :, :] @ rhs
        else:
            v = torch.linalg.solve_triangular(Ls[..., t, :, :], rhs, upper=False)
        vs[..., t, :, :] = v
    xs = torch.empty_like(r)
    x = torch.zeros_like(v)
    for t in range(Tb - 1, -1, -1):
        rhs = vs[..., t, :, :]
        if t + 1 < Tb:  # C_Tb = 0 and x = 0 at the last block
            rhs = rhs - Cs[..., t + 1, :, :].transpose(-1, -2) @ x
        Lt = Ls[..., t, :, :].transpose(-1, -2)
        if inv:
            x = Lt @ rhs
        else:
            x = torch.linalg.solve_triangular(Lt, rhs, upper=True)
        xs[..., t, :, :] = x
    return xs[..., 0] if vec else xs


# ----------------------------------------------------------------------
# Substructured (SPIKE) block-tridiagonal solve
# ----------------------------------------------------------------------
class _SlabFactors(NamedTuple):
    Ls_int: torch.Tensor  # (..., D, S-1, m, m) interior chain Cholesky diag
    Cs_int: torch.Tensor  # (..., D, S-1, m, m) interior chain sub-diag
    X: torch.Tensor  # (..., D, S-1, m, m) K_int^-1 F_prev
    Y: torch.Tensor  # (..., D, S-1, m, m) K_int^-1 F_self
    Ls_schur: torch.Tensor  # (..., D, m, m) interface Schur Cholesky diag
    Cs_schur: torch.Tensor  # (..., D, m, m) interface Schur sub-diag
    E_prev: torch.Tensor  # (..., D, m, m) E at each slab's first block
    E_self: torch.Tensor  # (..., D, m, m) E at each slab's interface block


def _slab_split(Ds, Es, D):
    """(..., Tb, m, m) block arrays -> interior (..., D, S-1, m, m), interface
    diagonal (..., D, m, m), and the two coupling E blocks per slab."""
    *lead, Tb, m, _ = Ds.shape
    S = Tb // D
    Dr = Ds.reshape(*lead, D, S, m, m)
    Er = Es.reshape(*lead, D, S, m, m)
    D_int = Dr[..., : S - 1, :, :]
    D_ifc = Dr[..., S - 1, :, :]
    E_int = Er[..., : S - 1, :, :]
    E_self = Er[..., S - 1, :, :]  # rows I_d, cols interior block S-2
    E_prev = E_int[..., 0, :, :]  # couples slab d's first block to I_{d-1}
    E_chain = E_int.clone()  # interior chains must not see the slab crossing
    E_chain[..., 0, :, :] = 0.0
    return S, D_int, D_ifc, E_chain, E_prev, E_self


def _slab_chol(Ds, Es, D, inv=False) -> _SlabFactors:
    """Factor by substructuring: interior chains (batched `_block_chol`
    over slabs) + interface Schur complement."""
    S, D_int, D_ifc, E_chain, E_prev, E_self = _slab_split(Ds, Es, D)
    m = Ds.shape[-1]
    Ls_int, Cs_int = _block_chol(D_int, E_chain, inv=inv)
    # spikes: K_int^-1 applied to both coupling column groups in one solve
    F_prev = torch.zeros_like(D_int)
    F_prev[..., 0, :, :] = E_prev
    F_self = torch.zeros_like(D_int)
    F_self[..., S - 2, :, :] = E_self.transpose(-1, -2)
    XY = _bt_solve(Ls_int, Cs_int, torch.cat([F_prev, F_self], dim=-1), inv=inv)
    X, Y = XY[..., :m], XY[..., m:]
    t_self = E_self @ Y[..., S - 2, :, :]
    t_prev = E_prev.transpose(-1, -2) @ X[..., 0, :, :]  # lands at d-1
    S_diag = D_ifc - t_self - _shift_up(t_prev, -3)
    S_sub = -(E_self @ X[..., S - 2, :, :])
    S_sub[..., 0, :, :] = 0.0
    Ls_schur, Cs_schur = _block_chol(S_diag, S_sub, inv=inv)
    return _SlabFactors(Ls_int, Cs_int, X, Y, Ls_schur, Cs_schur, E_prev, E_self)


def _slab_solve(f: _SlabFactors, r, inv=False, chain_int=None, chain_schur=None):
    """Solve using `_slab_chol` factors; r is (..., Tb, m) or (..., Tb, m, k).
    `chain_int` / `chain_schur` (callables taking a chain RHS and returning
    its solution) override the interior / interface sweeps — the hook the
    fused kernel plugs into; default is the `_bt_solve` loop."""
    vec = r.dim() == f.Ls_schur.dim() - 1
    if vec:
        r = r[..., None]
    *lead, Tb, m, k = r.shape
    D = f.X.shape[-4]
    S = Tb // D
    rr = r.reshape(*lead, D, S, m, k)
    r_int, r_ifc = rr[..., : S - 1, :, :], rr[..., S - 1, :, :]
    if chain_int is not None:
        h = chain_int(r_int)
    else:
        h = _bt_solve(f.Ls_int, f.Cs_int, r_int, inv=inv)
    # g_d = r_I[d] - E_self[d] h[d, S-2] - E_prev[d+1]^T h[d+1, 0]
    g = r_ifc - f.E_self @ h[..., S - 2, :, :]
    g = g - _shift_up(f.E_prev.transpose(-1, -2) @ h[..., 0, :, :], -3)
    if chain_schur is not None:
        x_ifc = chain_schur(g)
    else:
        x_ifc = _bt_solve(f.Ls_schur, f.Cs_schur, g, inv=inv)
    # back-substitute: x_int = h - X x_I[d-1] - Y x_I[d]
    x_prev = _shift_down(x_ifc, -3)
    x_int = h - f.X @ x_prev[..., None, :, :] - f.Y @ x_ifc[..., None, :, :]
    out = torch.cat([x_int, x_ifc[..., None, :, :]], dim=-3).reshape(*lead, Tb, m, k)
    return out[..., 0] if vec else out


def _banded_ops(
    Ad, As, Bb, Tb, mB, nB, p, reg_d, pad_rows=None, slabs=None,
    chol_dtype=None, kkt_refine=0, fac_d_cap=None, inv_factors=False,
    sweep_backend="scan", factor_dtype=None, border_rows=None,
):
    """(matvec, rmatvec, make_kkt_solver) for `ipm._solve_scaled` over a
    batch: Ad, As (B, Tb, mB, nB), Bb (B, Tb, mB, p); flat vectors laid out
    (B, [Tb*nB time-cols | p border-cols]) and (B, Tb*mB).

    `slabs=D` switches the KKT factorization to the substructured (SPIKE)
    decomposition. `pad_rows` (Tb, mB) marks all-zero padding rows, which
    get a unit diagonal. Mixed precision: with `chol_dtype` below the data
    dtype the normal-equations build, block Cholesky and sweeps run in
    `chol_dtype`, and `kkt_refine` steps of iterative refinement with the
    banded K product in the full dtype recover full-dtype directions (a
    step that raises the residual is rejected per lane). `fac_d_cap` caps
    the barrier weights only inside the factorized preconditioner.
    `factor_dtype` (default `chol_dtype`) is the dtype the normal equations
    are built and factored in; the factors are then stored and swept in
    `chol_dtype`.

    `border_rows` (Tb, mB) marks rows on border columns alone (their
    slacks included). The banded part of K is zero there, and a Woodbury
    update around its reg_d diagonal would divide by reg_d: such a row
    gets a unit diagonal in the banded factorization (as a padding row
    does), the Woodbury update sees only the other rows' border entries,
    and the rows themselves are solved last, through an r x r system in
    the border columns' capacitance (r the number of such rows). Without
    them the solve is the plain Woodbury one."""
    dtype, device = Ad.dtype, Ad.device
    B = Ad.shape[0]
    nt = Tb * nB
    diag_vec = torch.full((Tb, mB), float(reg_d), dtype=dtype, device=device)
    if pad_rows is not None:
        diag_vec = diag_vec + torch.as_tensor(np.asarray(pad_rows), dtype=dtype, device=device)
    rows_R = None
    if border_rows is not None and np.asarray(border_rows).any():
        diag_vec = diag_vec + torch.as_tensor(np.asarray(border_rows), dtype=dtype, device=device)
        rows_R = torch.as_tensor(np.nonzero(np.asarray(border_rows).reshape(-1))[0],
                                 device=device)
        Bb_T = Bb.clone()
        Bb_T.reshape(B, Tb * mB, p)[:, rows_R] = 0.0
        B_R = Bb.reshape(B, Tb * mB, p)[:, rows_R]  # (B, r, p)
    else:
        Bb_T = Bb
    AdT, AsT = Ad.transpose(-1, -2), As.transpose(-1, -2)

    def matvec(x):
        xt = x[:, :nt].reshape(B, Tb, nB, 1)
        xb = x[:, nt:]
        y = Ad @ xt + As @ _shift_down(xt, 1) + Bb @ xb[:, None, :, None]
        return y.reshape(B, Tb * mB)

    def rmatvec(y):
        yt = y.reshape(B, Tb, mB, 1)
        xt = AdT @ yt + _shift_up(AsT @ yt, 1)
        xb = (Bb * yt).sum(dim=(1, 2))
        return torch.cat([xt.reshape(B, nt), xb], dim=-1)

    cd = chol_dtype or dtype
    fd = factor_dtype or cd
    Ad_c, As_c = Ad.to(fd), As.to(fd)
    Ad_prev_c = _shift_down(Ad_c, 1)
    use_fused = sweep_backend == "fused"
    inv = inv_factors or use_fused  # the fused sweeps need inverse factors

    def lane_sum(a):
        return a.reshape(a.shape[0], -1).sum(-1)

    def make_kkt_solver(d):
        w = 1.0 / d
        wt = w[:, :nt].reshape(B, Tb, nB)
        db = d[:, nt:]
        # the factorization sees capped weights; K_mul sees the true ones
        d_fac = d if fac_d_cap is None else torch.clamp(d, max=fac_d_cap)
        wt_f = (1.0 / d_fac)[:, :nt].reshape(B, Tb, nB)
        wt_c, wprev_c = wt_f.to(fd), _shift_down(wt_f, 1).to(fd)
        AsW = As_c * wprev_c[..., None, :]
        Ds = (Ad_c * wt_c[..., None, :]) @ Ad_c.transpose(-1, -2)
        Ds = Ds + AsW @ As_c.transpose(-1, -2)
        Ds = Ds + torch.diag_embed(diag_vec.to(fd))
        Es = AsW @ Ad_prev_c.transpose(-1, -2)
        if slabs:
            raw = _slab_chol(Ds, Es, slabs, inv=inv)
            swept = ("Ls_int", "Cs_int", "Ls_schur", "Cs_schur") if use_fused else ()
            fac = _SlabFactors(*(
                sweep_factors(a, cd) if name in swept else a.to(cd)
                for name, a in zip(raw._fields, raw)
            ))
            if use_fused:
                def chain_int(rr):
                    return chain_solve(fac.Ls_int, fac.Cs_int, rr)

                def chain_schur(g):
                    return chain_solve(fac.Ls_schur, fac.Cs_schur, g)
            else:
                chain_int = chain_schur = None

            def chol_base(rt):
                return _slab_solve(
                    fac, rt.to(cd), inv=inv,
                    chain_int=chain_int, chain_schur=chain_schur,
                ).to(dtype)
        else:
            cast = sweep_factors if use_fused else torch.Tensor.to
            Ls, Cs = (cast(a, cd) for a in _block_chol(Ds, Es, inv=inv))
            if use_fused:
                def chol_base(rt):
                    return chain_solve(Ls, Cs, rt.to(cd)).to(dtype)
            else:
                def chol_base(rt):
                    return _bt_solve(Ls, Cs, rt.to(cd), inv=inv).to(dtype)

        if kkt_refine and cd != dtype:
            # K y = A_t W_t A_t^T y + diag_shift y in the full dtype
            def K_mul(y):
                y3 = y[..., None] if y.dim() == 3 else y
                xt = AdT @ y3 + _shift_up(AsT @ y3, 1)
                xt = xt * wt[..., None]
                out = Ad @ xt + As @ _shift_down(xt, 1)
                out = out + diag_vec[..., None] * y3
                return out[..., 0] if y.dim() == 3 else out

            def base(rt):
                x = chol_base(rt)
                res = rt - K_mul(x)
                for _ in range(kkt_refine):
                    x_try = x + chol_base(res)
                    res_try = rt - K_mul(x_try)
                    # reject steps past the f32 factor's conditioning limit
                    better = lane_sum(res_try * res_try) < lane_sum(res * res)
                    x = torch.where(_lane(better, x), x_try, x)
                    res = torch.where(_lane(better, res), res_try, res)
                return x
        else:
            base = chol_base

        # Woodbury: K = Kb + B diag(wb) B^T
        Z = base(Bb_T)  # (B, Tb, mB, p) = Kb^{-1} B
        Sm = torch.diag_embed(db) + (
            Bb_T.reshape(B, Tb * mB, p).transpose(-1, -2) @ Z.reshape(B, Tb * mB, p)
        )
        S_L = _chol(Sm, symmetrize=False)

        if rows_R is None:
            def solve(r):
                rt = r.reshape(B, Tb, mB)
                Fr = base(rt)
                rhs = (Bb * Fr[..., None]).sum(dim=(1, 2))
                t = torch.cholesky_solve(rhs[..., None], S_L)[..., 0]
                return (Fr - (Z @ t[:, None, :, None])[..., 0]).reshape(B, Tb * mB)

            return solve

        # the border-only rows R: with z = W B^T y the R equations read
        # B_R z + reg_d y_R = r_R, and z = S^-1 (B_T^T Kb^-1 r_T + B_R^T y_R)
        # (S the capacitance above), so y_R solves the r x r system
        # (B_R S^-1 B_R^T + reg_d) y_R = r_R - B_R S^-1 B_T^T Kb^-1 r_T: a sum
        # of positive terms, never a difference of near-equal ones
        X_R = torch.cholesky_solve(B_R.transpose(-1, -2), S_L)  # (B, p, r)
        M_R = B_R @ X_R
        M_R = M_R + reg_d * torch.eye(M_R.shape[-1], dtype=dtype, device=device)
        M_L = _chol(M_R)

        def solve(r):
            r0 = r.clone()
            r0[:, rows_R] = 0.0
            Fr = base(r0.reshape(B, Tb, mB))
            u = torch.cholesky_solve((Bb_T * Fr[..., None]).sum(dim=(1, 2))[..., None], S_L)
            rhs = r[:, rows_R, None] - B_R @ u
            y_R = torch.cholesky_solve(rhs, M_L)
            z = u + X_R @ y_R
            y = (Fr - (Z @ z[:, None])[..., 0]).reshape(B, Tb * mB)
            y[:, rows_R] = y_R[..., 0]
            return y

        return solve

    return matvec, rmatvec, make_kkt_solver


# ----------------------------------------------------------------------
def _ruiz_banded(Ad, As, Bb, iters: int = 8):
    """Ruiz equilibration over the batched banded representation: row
    scaling r (B, Tb, mB), time-col ct (B, Tb, nB), border-col cb (B, p)."""
    B, Tb, mB, nB = Ad.shape
    p = Bb.shape[-1]
    kw = dict(dtype=Ad.dtype, device=Ad.device)
    r = torch.ones((B, Tb, mB), **kw)
    ct = torch.ones((B, Tb, nB), **kw)
    cbv = torch.ones((B, p), **kw)

    def sc(x):
        return 1.0 / torch.sqrt(torch.where(x > 0, x, torch.ones_like(x)))

    def scaled():
        ad = Ad * r[..., :, None] * ct[..., None, :]
        as_ = As * r[..., :, None] * _shift_down(ct, 1)[..., None, :]
        bb = Bb * r[..., :, None] * cbv[:, None, None, :]
        return ad, as_, bb

    for _ in range(iters):
        ad, as_, bb = scaled()
        rmax = torch.maximum(
            ad.abs().amax(-1),
            torch.maximum(as_.abs().amax(-1), bb.abs().amax(-1)),
        )
        r = r * sc(rmax)
        ad, as_, bb = scaled()
        # col t gets entries from Ad[t] and As[t+1]
        sub_next = _shift_up(as_.abs().amax(-2), 1)
        cmax = torch.maximum(ad.abs().amax(-2), sub_next)
        ct = ct * sc(cmax)
        cbv = cbv * sc(bb.abs().amax(dim=(1, 2)))
    return r, ct, cbv


def _banded_scaling(blp):
    """The banded solve's scaling prologue on a batched `blp`: Ruiz row,
    time-column and border-column factors, the flat scaled b, c and
    bounds, and the per-lane objective and bound scales ``sig_c``,
    ``sig_b``."""
    Ad, As, Bb, b, c, cb, lt, ut, lb, ub, c0 = blp
    B = Ad.shape[0]
    r, ct, cbv = _ruiz_banded(Ad, As, Bb)
    b_s = (b * r).reshape(B, -1)
    c_flat = torch.cat([(c * ct).reshape(B, -1), cb * cbv], dim=-1)
    cs_all = torch.cat([ct.reshape(B, -1), cbv], dim=-1)
    l_flat = torch.cat([lt.reshape(B, -1), lb], dim=-1) / cs_all
    u_flat = torch.cat([ut.reshape(B, -1), ub], dim=-1) / cs_all

    sig_c = torch.clamp(c_flat.abs().amax(-1), min=1.0)[:, None]
    sig_b = torch.clamp(
        torch.maximum(
            _max0(b_s.abs()),
            torch.where(torch.isfinite(l_flat), l_flat.abs(),
                        torch.zeros_like(l_flat)).amax(-1),
        ),
        min=1.0,
    )[:, None]
    return r, ct, cbv, b_s, c_flat, cs_all, l_flat, u_flat, sig_c, sig_b


def _banded_warm_scaled(meta, warm_start, r, cs_all, sig_c, sig_b):
    """A solution-frame seed (reduced column order, banded row order) in
    the flat scaled frame: scattered through col_pos, the inverse of the
    solution's gather; padding slots get 0, which the safeguard clips
    inside their inert [0, 1] box."""
    B, Tb, mB = r.shape
    col_pos = torch.as_tensor(meta.col_pos, device=r.device)
    xw, yw, zlw, zuw = warm_start

    def scatter(v):
        out = torch.zeros(B, cs_all.shape[-1], dtype=r.dtype, device=r.device)
        out[:, col_pos] = v
        return out

    return (
        scatter(xw) / (cs_all * sig_b),
        (yw.reshape(B, Tb, mB) / (r * sig_c[:, :, None])).reshape(B, -1),
        scatter(zlw) * cs_all / sig_c,
        scatter(zuw) * cs_all / sig_c,
    )


def banded_warm_accept(meta: TimeStructure, blp: BandedLP, warm_start):
    """Would the banded solver's safeguard ACCEPT these solution-frame
    seeds? Replays its scaling prologue and `ipm._warm_safeguard` on the
    scaled bounds, without factorizing or iterating, and returns the flag
    the solver itself computes: one a lane of a batched `blp` (leading
    axis on the seed too), a 0-d flag for one LP."""
    blpb, batch = _broadcast_batch(blp, _BASE_NDIM)
    warm = _warm_tensors(warm_start, blp.b)
    if batch is None:
        blpb = BandedLP(*(a.unsqueeze(0) for a in blp))
        warm = _unsqueeze_lane(warm)
    r, _, _, _, _, cs_all, l_flat, u_flat, sig_c, sig_b = _banded_scaling(blpb)
    l, u = l_flat / sig_b, u_flat / sig_b
    fl, fu = torch.isfinite(l), torch.isfinite(u)
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    ok = _warm_safeguard(_banded_warm_scaled(meta, warm, r, cs_all, sig_c, sig_b),
                         fl, fu, torch.where(fl, l, zero), torch.where(fu, u, zero))[-1]
    return ok if batch is not None else ok[0]


def _solve_banded(
    meta, blp, tol, max_iter, reg_p, reg_d, refine_steps, d_cap, slabs=None,
    chol_dtype=None, kkt_refine=0, fac_d_cap=None, inv_factors=False,
    sweep_backend="scan", correctors=0, trace=False, factor_dtype=None,
    warm_start=None, state=None, it_stop=None, return_state=False,
):
    """The batched banded solve: every field of `blp` carries the batch
    axis, and so do `warm_start` and `state` when given. Returns
    (IPMSolution, SolveTrace), both batched, and the `IPMState` third with
    `return_state`."""
    Ad, As, Bb, b, c, cb, lt, ut, lb, ub, c0 = blp
    B, Tb, mB, nB = Ad.shape
    p = meta.p
    nt = Tb * nB
    r, ct, cbv, b_s, c_flat, cs_all, l_flat, u_flat, sig_c, sig_b = _banded_scaling(blp)
    Ad_s = Ad * r[..., :, None] * ct[..., None, :]
    As_s = As * r[..., :, None] * _shift_down(ct, 1)[..., None, :]
    Bb_s = Bb * r[..., :, None] * cbv[:, None, None, :]

    ops = _banded_ops(
        Ad_s, As_s, Bb_s, Tb, mB, nB, p, reg_d,
        pad_rows=meta.pad_rows, border_rows=meta.border_rows, slabs=slabs,
        chol_dtype=chol_dtype,
        kkt_refine=kkt_refine, fac_d_cap=fac_d_cap, inv_factors=inv_factors,
        sweep_backend=sweep_backend, factor_dtype=factor_dtype,
    )
    col_pos = torch.as_tensor(meta.col_pos, device=Ad.device)
    warm_s = None
    if warm_start is not None:
        warm_s = _banded_warm_scaled(meta, warm_start, r, cs_all, sig_c, sig_b)
    out = _solve_scaled(
        LPData(
            A=None, b=b_s / sig_b, c=c_flat / sig_c, l=l_flat / sig_b,
            u=u_flat / sig_b, c0=torch.zeros_like(c0),
        ),
        tol, max_iter, reg_p, reg_d, refine_steps, None,
        ops=ops, d_cap=d_cap, correctors=correctors, trace=trace,
        warm=warm_s, state0=state, it_stop=it_stop, return_state=return_state,
    )
    sol = out[0]
    # unscale and map back to the CompiledLP's reduced column order
    x_flat = sol.x * cs_all * sig_b
    y = (sol.y.reshape(B, Tb, mB) * r * sig_c[:, :, None]).reshape(B, -1)
    zl = (sol.zl / cs_all * sig_c)[:, col_pos]
    zu = (sol.zu / cs_all * sig_c)[:, col_pos]
    obj = (
        (c * x_flat[:, :nt].reshape(B, Tb, nB)).sum(dim=(1, 2))
        + (cb * x_flat[:, nt:]).sum(-1)
        + c0
    )
    return (sol._replace(x=x_flat[:, col_pos], y=y, zl=zl, zu=zu, obj=obj), *out[1:])


class SmallTF32Warning(UserWarning):
    """Pure-f32 banded solve requested at T <= 200, where it measurably
    under-converges and has no flop advantage (see the JAX package)."""


def _warn_small_T_f32(meta: TimeStructure, dtype) -> None:
    if meta.T <= 200 and dtype == torch.float32:
        warnings.warn(
            f"solve_lp_banded: pure-f32 banded solve at T={meta.T} <= 200 "
            "under-converges on design-bordered problems (rel ~1e-1 at "
            "weekly scale) and has no flop advantage there; use the dense "
            "solve_lp, or float64 data (optionally chol_dtype=float32 "
            "mixed precision) for the banded path.",
            SmallTF32Warning,
            stacklevel=3,
        )


def _options(meta, dtype, tol=1e-8, max_iter=60, reg_p=None, reg_d=None,
             refine_steps=2, d_cap=None, slabs=None, mesh=None,
             mesh_axis="time", chol_dtype=None, kkt_refine=0,
             inv_factors=False, sweep_backend="scan", correctors=0,
             trace=False, state=None, it_stop=None,
             return_state=False, factor_dtype=None):
    """Resolve the solver options of `solve_lp_banded` into `_solve_banded`
    keyword arguments, with the JAX package's defaults and guards."""
    if mesh is not None:
        raise ValueError(
            "mesh= shards time slabs over devices; the port runs one "
            "device and has no such axis"
        )
    if isinstance(chol_dtype, str):
        chol_dtype = getattr(torch, chol_dtype)
    if isinstance(factor_dtype, str):
        factor_dtype = getattr(torch, factor_dtype)
    if chol_dtype is not None and chol_dtype == dtype:
        chol_dtype = None  # same-dtype "mixed" precision is a no-op
    if reg_p is None:
        reg_p = 1e-13 if dtype == torch.float64 else 1e-8
    if reg_d is None:
        reg_d = 1e-12 if dtype == torch.float64 else 1e-7
    # the barrier-weight cap protects the FACTORIZATION dtype: pure f32
    # caps the solve (d_cap); mixed precision caps only the preconditioner
    fac_d_cap = None
    if chol_dtype is not None and chol_dtype != torch.float64:
        if kkt_refine:
            fac_d_cap = 1e12
        elif d_cap is None and dtype == torch.float64:
            d_cap = 1e12
    elif d_cap is None and dtype != torch.float64:
        d_cap = 1e12
    if sweep_backend not in SWEEP_BACKENDS:
        raise ValueError(f"unknown sweep_backend {sweep_backend!r}")
    if sweep_backend == "fused":
        fac_dtype = chol_dtype if chol_dtype is not None else dtype
        if fac_dtype != torch.float32:
            raise ValueError(
                "sweep_backend='fused' needs f32 factor work (f32 data or "
                f"chol_dtype=float32); factor dtype here is {fac_dtype}"
            )
    if slabs:
        if meta.Tb % slabs or meta.Tb // slabs < 2:
            raise ValueError(
                f"slabs={slabs} needs Tb divisible with quotient >= 2 "
                f"(Tb={meta.Tb})"
            )
    return dict(
        tol=tol, max_iter=max_iter, reg_p=reg_p, reg_d=reg_d,
        refine_steps=refine_steps, d_cap=d_cap, slabs=slabs,
        chol_dtype=chol_dtype, kkt_refine=kkt_refine, fac_d_cap=fac_d_cap,
        inv_factors=inv_factors, sweep_backend=sweep_backend,
        correctors=correctors, trace=trace, factor_dtype=factor_dtype,
        state=state, it_stop=it_stop, return_state=return_state,
    )


def _returned(out, opts):
    """`_solve_banded`'s (sol, trace[, state]) as the public solvers return
    it: the trace only with ``trace=True``, the state with
    ``return_state=True``."""
    keep = (True, opts["trace"], opts["return_state"])
    out = tuple(o for o, k in zip(out, keep) if k)
    return out if len(out) > 1 else out[0]


def solve_lp_banded(meta: TimeStructure, blp: BandedLP, warm_start=None, **kw):
    """Solve one time-banded LP by the block-tridiagonal IPM. Returns an
    `IPMSolution` with ``x`` in the CompiledLP's reduced column order and
    ``y`` in the banded row order (``(IPMSolution, SolveTrace)`` with
    ``trace=True``). Options as in the JAX package: ``tol``, ``max_iter``,
    ``reg_p``, ``reg_d``, ``refine_steps``, ``d_cap``, ``slabs`` (SPIKE),
    ``chol_dtype`` + ``kkt_refine`` (mixed precision), ``inv_factors``,
    ``sweep_backend`` ("scan" | "fused": the fused CUDA sweep kernel,
    which implies inverse factors and needs f32 factor work),
    ``correctors`` (Gondzio) and ``trace``. ``mesh`` raises ValueError (one
    device).

    ``warm_start`` = (x, y, zl, zu) in the solution frame (reduced column
    order, banded row order: a neighbour's `IPMSolution` fields) seeds the
    iteration with the safeguarded fallback of `ipm.solve_lp`.
    ``state`` / ``it_stop`` / ``return_state`` are the segmented solve of
    `ipm.solve_lp_partial`: run to iteration ``it_stop``, return the
    resumable `IPMState` after the usual return value, feed it back with
    the same data to continue bitwise. All default to off."""
    pin_matmul_precision()
    _warn_small_T_f32(meta, blp.Ad.dtype)
    opts = _options(meta, blp.Ad.dtype, **kw)
    opts["state"] = _unsqueeze_lane(opts["state"])
    blp1 = BandedLP(*(a.unsqueeze(0) for a in blp))
    warm = _unsqueeze_lane(_warm_tensors(warm_start, blp.b))
    out = _squeeze_lane(_solve_banded(meta, blp1, warm_start=warm, **opts))
    return _returned(out, opts)


def solve_lp_banded_batch(
    meta: TimeStructure, blp: BandedLP, sharding=None, warm_start=None, **kw
):
    """Batched solve over a leading scenario axis on any BandedLP field
    (fields without it are shared), all lanes resident on one device —
    the batched analogue of the reference's per-scenario rebuild + CBC
    loop (`wind_battery_LMP.py:195-267`). Lane ``i`` gives what
    `solve_lp_banded` of lane ``i`` gives; ``warm_start`` and ``state``
    carry the batch axis too."""
    if sharding is not None or kw.get("mesh") is not None:
        raise ValueError(
            "solve_lp_banded_batch runs every lane on one device; "
            "sharding=/mesh= have no device axis to shard over"
        )
    blpb, batch = _broadcast_batch(blp, _BASE_NDIM)
    if batch is None:
        return solve_lp_banded(meta, blp, warm_start=warm_start, **kw)
    pin_matmul_precision()
    _warn_small_T_f32(meta, blp.Ad.dtype)
    opts = _options(meta, blp.Ad.dtype, **kw)
    warm = _warm_tensors(warm_start, blp.b)
    return _returned(_solve_banded(meta, blpb, warm_start=warm, **opts), opts)


# the iteration from which `solve_lp_banded_escalated` keeps float64 factors
ESCALATE_AT_ITER = 16


def solve_lp_banded_escalated(meta: TimeStructure, blp: BandedLP, **kw):
    """`solve_lp_banded_batch` with a precision schedule: the options `kw`
    (e.g. `workflow.runners.year_sweep_solver_kw`: f32 factors swept by the
    fused kernel) for the first `ESCALATE_AT_ITER` iterations, then the same
    iterate resumed with float64 factors and sweeps (the scan), in the same
    SPIKE slabs.

    For LPs whose normal equations grow too ill-conditioned near the
    optimum for f32-stored factors to precondition (the solar-hydrogen
    year LP: its degenerate design columns stall the mixed tier at a
    scaled gap of ~1e-3), while the early iterations keep the kernel.
    Every lane resumes from its best iterate of the first segment, so a
    lane that stopped there (a stall, or a step away from its best) goes
    on from where the mixed tier was last sound."""
    if kw.get("state") is not None or kw.get("return_state"):
        raise ValueError("solve_lp_banded_escalated manages the state itself")
    _, st = solve_lp_banded_batch(meta, blp, it_stop=ESCALATE_AT_ITER, return_state=True, **kw)
    exact = {k: kw[k] for k in ("tol", "max_iter", "reg_p", "reg_d", "refine_steps",
                                "correctors", "d_cap", "slabs") if k in kw}
    st = st._replace(x=st.best_x, y=st.best_y, zl=st.best_zl, zu=st.best_zu,
                     done=torch.zeros_like(st.done))
    return solve_lp_banded_batch(meta, blp, state=st, **exact)


def optimal_value_banded(
    meta: TimeStructure, params: Dict, dtype=torch.float64, device="cuda",
    return_solution: bool = False, **solver_kw,
):
    """Differentiable optimal value at year scale, in the model's sense: the
    banded analogue of `solvers/diff.optimal_value` (year-horizon sweeps
    WITH design gradients, where the reference re-solves per design point,
    `wind_battery_LMP.py:172-267`).

    Envelope theorem through the LAGRANGIAN: with the optimum (x*, y*, zl*,
    zu*) detached, ``L(theta) = c.x* + c0 + y*.(b - A x*) + zl*.(l - x*) +
    zu*.(x* - u)`` has ``dL/dtheta = dV/dtheta`` at the saddle point, so
    one extra O(nnz) evaluation through the same `instantiate` prices the
    design against any parameter (LMP scenarios, CFs), with no adjoint
    solve. The solve itself runs on detached tensors under ``no_grad``, so
    autograd records none of its iterations.

    Batch-first: parameters with a leading scenario axis (``lmp`` of shape
    (B, T)) give values of shape (B,), solved in one `solve_lp_banded_batch`
    call; the lanes are independent, so ``autograd.grad(v.sum(), lmp)``
    gives per-lane gradients. `solver_kw` passes straight to the solve
    (e.g. `workflow.runners.year_sweep_solver_kw`). With
    ``return_solution=True`` the result is ``(value, sol)``, ``sol`` the
    solve's `IPMSolution`: the envelope gradient is exact only where
    ``sol.converged`` holds."""
    blp0 = meta.instantiate(params, dtype=dtype, device=device)
    with torch.no_grad():
        sol = solve_lp_banded_batch(meta, BandedLP(*(a.detach() for a in blp0)), **solver_kw)
    Tb, mB, nB, p = meta.Tb, meta.mB, meta.nB, meta.p
    nt = Tb * nB
    lead = tuple(sol.x.shape[:-1])
    col_pos = torch.as_tensor(meta.col_pos, device=blp0.Ad.device)

    def scatter(v_red):
        out = torch.zeros(*lead, nt + p, dtype=dtype, device=v_red.device)
        out[..., col_pos] = v_red.to(dtype)
        return out

    x_flat, zl_flat, zu_flat = scatter(sol.x), scatter(sol.zl), scatter(sol.zu)
    yt = sol.y.reshape(*lead, Tb, mB).to(dtype)
    Ad, As, Bb, b, c, cb, lt, ut, lb, ub, c0 = blp0
    xt = x_flat[..., :nt].reshape(*lead, Tb, nB)
    xb = x_flat[..., nt:]
    # unbatched Ad / As (no batched parameter reaches them) broadcast here
    Ax = (
        (Ad @ xt[..., None])[..., 0]
        + (As @ _shift_down(xt, -2)[..., None])[..., 0]
        + (Bb @ xb[..., None, :, None])[..., 0]
    )
    l_all = torch.cat([lt.flatten(-2), lb], dim=-1)
    u_all = torch.cat([ut.flatten(-2), ub], dim=-1)
    # infinite bounds carry zero duals; substitute 0 BEFORE the product
    # (0 * inf = NaN would poison the sum and its gradient)
    fin_l, fin_u = torch.isfinite(l_all), torch.isfinite(u_all)
    l_s = torch.where(fin_l, l_all, 0.0)
    u_s = torch.where(fin_u, u_all, 0.0)
    L = (
        (c * xt).sum(dim=(-2, -1))
        + (cb * xb).sum(-1)
        + c0
        + (yt * (b - Ax)).sum(dim=(-2, -1))
        + torch.where(fin_l, zl_flat * (l_s - x_flat), 0.0).sum(-1)
        + torch.where(fin_u, zu_flat * (x_flat - u_s), 0.0).sum(-1)
    )
    value = meta.prog.obj_sense * L
    return (value, sol) if return_solution else value


def solve_horizon(
    prog: CompiledLP, params: Dict, T: int, block_hours: int = 24,
    dtype=torch.float64, device="cuda", **solver_kw,
):
    """One-call front-end: extract structure, instantiate, solve (batched
    when a parameter carries a leading scenario axis)."""
    meta = extract_time_structure(prog, T, block_hours)
    blp = meta.instantiate(params, dtype=dtype, device=device)
    return solve_lp_banded_batch(meta, blp, **solver_kw)
