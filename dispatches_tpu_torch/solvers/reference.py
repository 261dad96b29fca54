"""CPU reference solver: scipy HiGHS on the same LP data.

The truth for the port's quality gates (objective within 1e-3 of HiGHS):
every device-path LP can be cross-solved on the host. Copy of
`dispatches_tpu/solvers/reference.py`, with the sparse assembly built by
numpy from the lowered program instead of a COO instantiation.
"""
from __future__ import annotations

import numpy as np

from ..core.program import LPData


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def solve_lp_scipy(lp: LPData):
    from scipy.optimize import linprog

    A = _host(lp.A)
    b = _host(lp.b)
    c = _host(lp.c)
    l = _host(lp.l)
    u = _host(lp.u)
    bounds = [
        (
            None if not np.isfinite(lo) else lo,
            None if not np.isfinite(hi) else hi,
        )
        for lo, hi in zip(l, u)
    ]
    res = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.status} {res.message}")
    res.obj_with_offset = res.fun + float(_host(lp.c0))
    return res


def coo_standard_form(prog, params):
    """(A_csc, b, c, bounds, c0) in float64 assembled on the host from the
    lowered program's static triplets and the parameter values."""
    import scipy.sparse as sp

    pv = {k: np.ravel(_host(v)) for k, v in params.items()}
    rows, cols, vals = [prog.A_rows], [prog.A_cols], [np.asarray(prog.A_vals)]
    for k, (r, cc, scale, pidx) in prog.A_pgroups.items():
        rows.append(r)
        cols.append(cc)
        vals.append(scale * pv[k][pidx])
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(prog.M, prog.N),
    ).tocsc()
    b = np.zeros(prog.M)
    np.add.at(b, prog.b_rows, prog.b_vals)
    for k, (r, scale, pidx) in prog.b_pgroups.items():
        np.add.at(b, r, scale * pv[k][pidx])
    c = np.zeros(prog.N)
    np.add.at(c, prog.c_cols, prog.c_vals)
    for k, (cc, scale, pidx) in prog.c_pgroups.items():
        np.add.at(c, cc, scale * pv[k][pidx])
    c0 = float(prog.c0_val)
    for k, (scale, pidx) in prog.c0_pgroups.items():
        c0 += float(np.sum(scale * pv[k][pidx]))
    bounds = np.stack([prog.lb, prog.ub], axis=1)
    return A, b, c, bounds, c0


def solve_lp_scipy_sparse(prog, params):
    """HiGHS on the COO instantiation — the reference cross-check for
    year-scale LPs whose dense A would not fit in memory (8,760-h horizons,
    `price_taker_analysis.py:181-224` scale)."""
    from scipy.optimize import linprog

    A, b, c, bounds, c0 = coo_standard_form(prog, params)
    res = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.status} {res.message}")
    res.obj_with_offset = res.fun + c0
    return res
