"""CompiledLP: lowered parametric LP + device instantiation (PyTorch).

Port of `dispatches_tpu/core/program.py`: a model is lowered once to static
numpy index arrays; ``instantiate(params)`` scatters parameter values into
standard-form LP tensors ``min c.x s.t. A x = b, l <= x <= u`` on a torch
device. The scatter-adds of the JAX version (``.at[].add``) are
`_scatter_add` here: ``index_put_(..., accumulate=True)``, with repeated
indices summed in entry order on every device.

Parameters may carry leading batch axes (for example ``lmp`` of shape
``(B, T)``): every parametric field then gains the same leading axes, the
batched counterpart of ``jax.vmap(prog.instantiate)``.
``instantiate_coo`` gives the same LP with A as COO triplets (`SparseLP`)
for the matrix-free PDHG solver.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .expr import Expr


class LPData(NamedTuple):
    """Standard-form LP on device: min c.x + c0  s.t.  A x = b, l <= x <= u."""

    A: torch.Tensor  # (M, N)
    b: torch.Tensor  # (M,)
    c: torch.Tensor  # (N,)
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    c0: torch.Tensor  # ()


class SparseLP(NamedTuple):
    """The same LP with A in COO form for matrix-free first-order solvers.

    `rows`/`cols` are the static int32 sparsity pattern (it never changes
    across scenarios); only `vals` may be parametric. With leading batch
    axes on b/c/l/u/c0 (and on `vals` when a parameter enters A) the
    pattern stays unbatched. M and N are the lengths of b and c."""

    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    b: torch.Tensor  # (M,)
    c: torch.Tensor  # (N,)
    l: torch.Tensor  # (N,)
    u: torch.Tensor  # (N,)
    c0: torch.Tensor  # ()


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _hash_array(h, name: str, a) -> None:
    """Feed one array into a running hash with its full identity: name,
    dtype, shape, and raw bytes (an f32 and an f64 LP with equal values
    solve differently, so they never share a fingerprint)."""
    a = np.ascontiguousarray(_as_numpy(a))
    h.update(name.encode())
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())


def _hash_options(h, options: Optional[Dict]) -> None:
    if not options:
        return
    for k in sorted(options):
        h.update(str(k).encode())
        h.update(repr(options[k]).encode())


def lp_fingerprint(lp, options: Optional[Dict] = None) -> str:
    """Stable content fingerprint of a problem NamedTuple (``LPData``,
    ``SparseLP``, ``BandedLP``) plus the solver options that shape the
    answer. Equal to the JAX package's fingerprint of the same values: the
    hash sees the type name, field names, dtypes, shapes and bytes, never
    the framework."""
    h = hashlib.sha256()
    h.update(type(lp).__name__.encode())
    for name, arr in zip(lp._fields, lp):
        _hash_array(h, name, arr)
    _hash_options(h, options)
    return h.hexdigest()


def _collect(exprs: List[Expr], row_offsets: List[int]):
    """Concatenate term/const blocks of a list of expressions with row offsets."""
    t_rows, t_cols, t_scale = [], [], []
    t_param: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]] = {}
    c_rows, c_scale = [], []
    c_param: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    for e, off in zip(exprs, row_offsets):
        for b in e.terms:
            rows = b.rows.astype(np.int64) + off
            if b.pname is None:
                t_rows.append(rows)
                t_cols.append(b.cols)
                t_scale.append(b.scale)
            else:
                t_param.setdefault(b.pname, []).append((rows, b.cols, b.scale, b.pidx))
        for b in e.consts:
            rows = b.rows.astype(np.int64) + off
            if b.pname is None:
                c_rows.append(rows)
                c_scale.append(b.scale)
            else:
                c_param.setdefault(b.pname, []).append((rows, b.scale, b.pidx))

    def cat(lst, dtype=None):
        if not lst:
            return np.zeros(0, dtype=dtype or np.float64)
        return np.concatenate(lst)

    t = (cat(t_rows, np.int64), cat(t_cols, np.int64), cat(t_scale))
    c = (cat(c_rows, np.int64), cat(c_scale))
    tp = {
        k: tuple(np.concatenate([x[i] for x in v]) for i in range(4))
        for k, v in t_param.items()
    }
    cp = {
        k: tuple(np.concatenate([x[i] for x in v]) for i in range(3))
        for k, v in c_param.items()
    }
    return t, tp, c, cp


def _scatter_add(a: torch.Tensor, idx, vals: torch.Tensor) -> torch.Tensor:
    """``a[..., idx] += vals`` with duplicate indices accumulated, for `a` of
    shape (*lead, n) and `vals` broadcastable to (*lead, len(idx)), summed
    in entry order on every device: the result is the CPU's sequential
    ``index_put_(accumulate=True)``, bit for bit.

    An index that occurs once takes one add on `a`'s device, the same in
    any order. The entries of repeated indices are folded on the CPU, in
    entry order, onto `a`'s values there and written back: on a CUDA
    device ``index_put_(accumulate=True)`` sums repeats in another order
    than the CPU (the design LP's cost columns, and ``eval_expr``'s NPV
    row, which sums every hour of the horizon). Differentiable in `vals`
    and `a`, as the plain scatter is."""
    idx = np.asarray(idx, np.int64)
    if idx.size == 0:
        return a
    dev = a.device
    lead, n = a.shape[:-1], a.shape[-1]
    nb = int(np.prod(lead)) if lead else 1
    vals = torch.broadcast_to(vals, (*lead, idx.size)).reshape(nb, idx.size)
    flat = a.reshape(-1)  # a view: `a` is contiguous
    offs = torch.arange(nb, device=dev)[:, None] * n
    _, inv, counts = np.unique(idx, return_inverse=True, return_counts=True)
    rep = counts[inv] > 1
    if not rep.all():
        once = np.nonzero(~rep)[0]
        tgt = offs + torch.as_tensor(idx[once], device=dev)[None, :]
        flat.index_put_((tgt.reshape(-1),),
                        vals[:, torch.as_tensor(once, device=dev)].reshape(-1),
                        accumulate=True)
    if rep.any():
        sel = np.nonzero(rep)[0]
        targets, local = np.unique(idx[sel], return_inverse=True)
        tgt = (offs + torch.as_tensor(targets, device=dev)[None, :]).reshape(-1)
        loc = (torch.arange(nb)[:, None] * targets.size
               + torch.as_tensor(local.reshape(-1))[None, :]).reshape(-1)
        contrib = vals[:, torch.as_tensor(sel, device=dev)].reshape(-1).cpu()
        folded = flat[tgt].cpu().index_put((loc,), contrib, accumulate=True)
        flat.index_put_((tgt,), folded.to(dev))
    return a


class _ParamSource:
    """Batch-aware gather of parameter values: ``take(name, pidx)`` returns
    ``scale``-ready values of shape (*lead, len(pidx))."""

    def __init__(self, params, shapes, dtype, device):
        self.vals = {}
        lead = None
        for k, shp in shapes.items():
            if k not in params:
                raise KeyError(f"missing param '{k}'")
            v = torch.as_tensor(params[k], dtype=dtype, device=device)
            size = int(np.prod(shp)) if shp else 1
            nlead = v.dim() - len(shp)
            if nlead < 0 or tuple(v.shape[nlead:]) != tuple(shp):
                raise ValueError(
                    f"param '{k}' has shape {tuple(v.shape)}, expected "
                    f"(..., {', '.join(map(str, shp))})"
                )
            this = tuple(v.shape[:nlead])
            if lead is not None and this and lead and this != lead:
                raise ValueError(f"inconsistent batch axes {this} vs {lead}")
            if this:
                lead = this
            elif lead is None:
                lead = ()
            self.vals[k] = v.reshape(*v.shape[:nlead], size)
        self.lead = lead or ()

    def take(self, name, pidx):
        pidx = torch.as_tensor(np.asarray(pidx, np.int64), device=self.vals[name].device)
        return self.vals[name][..., pidx]


class CompiledLP:
    """A parametric LP lowered from a `Model`. Immutable after construction."""

    def __init__(self):
        raise TypeError("use Model.build()")

    @classmethod
    def _from_model(cls, m) -> "CompiledLP":
        self = object.__new__(cls)
        self.name = m.name
        self.param_shapes = {k: p.shape for k, p in m._params.items()}
        self._vars = dict(m._vars)

        n = m._nvars
        Me = sum(e.R for e in m._eq)
        Mi = sum(e.R for e in m._le)
        self.n_orig = n
        self.n_slack = Mi
        self.M = Me + Mi
        self.N = n + Mi

        # row offsets: eq rows first, then le rows (each le row gets one slack)
        eq_offs, off = [], 0
        for e in m._eq:
            eq_offs.append(off)
            off += e.R
        le_offs = []
        for e in m._le:
            le_offs.append(off)
            off += e.R

        # named row regions (Model.mark_rows), excluded from fingerprint()
        self.row_ranges = {}
        for kind, offs, hi in (("eq", eq_offs, Me), ("le", le_offs, Me + Mi)):
            marks = [(ci, name) for name, k, ci in m._row_marks if k == kind]
            for pos, (ci, name) in enumerate(marks):
                start = offs[ci] if ci < len(offs) else hi
                nxt = marks[pos + 1][0] if pos + 1 < len(marks) else len(offs)
                stop = offs[nxt] if nxt < len(offs) else hi
                self.row_ranges[name] = (int(start), int(stop))

        (t, tp, c, cp) = _collect(m._eq + m._le, eq_offs + le_offs)

        # fixed-variable presolve: columns with lb == ub are substituted out
        lb_o = np.zeros(n)
        ub_o = np.full(n, np.inf)
        for vm in self._vars.values():
            lb_o[vm.start : vm.start + vm.size] = vm.lb
            ub_o[vm.start : vm.start + vm.size] = vm.ub
        fixed = np.isfinite(lb_o) & (ub_o - lb_o <= 0.0)
        fixed_vals = np.where(fixed, lb_o, 0.0)
        keep = ~fixed
        n_keep = int(keep.sum())
        col_map = -np.ones(n, dtype=np.int64)
        col_map[keep] = np.arange(n_keep)
        self._n_full = n
        self._keep_cols = np.where(keep)[0]
        self._fixed_vals = fixed_vals
        self.N = n_keep + Mi

        def split_A(rows, cols, scale, pidx=None):
            """Partition triplets into kept-A entries and rhs contributions."""
            isfix = fixed[cols]
            a = (rows[~isfix], col_map[cols[~isfix]], scale[~isfix])
            bpart = (rows[isfix], -scale[isfix] * fixed_vals[cols[isfix]])
            if pidx is not None:
                a = a + (pidx[~isfix],)
                bpart = bpart + (pidx[isfix],)
            return a, bpart

        (ar, ac, av), (br_f, bv_f) = split_A(t[0], t[1], t[2])
        slack_rows = np.arange(Me, Me + Mi, dtype=np.int64)
        slack_cols = np.arange(n_keep, n_keep + Mi, dtype=np.int64)
        self.A_rows = np.concatenate([ar, slack_rows])
        self.A_cols = np.concatenate([ac, slack_cols])
        self.A_vals = np.concatenate([av, np.ones(Mi)])
        self.A_pgroups = {}
        b_extra_pgroups: Dict[str, list] = {}
        for k, (rows, cols, scale, pidx) in tp.items():
            (ar, ac, av, ap), (br, bv, bp) = split_A(rows, cols, scale, pidx)
            if len(ar):
                self.A_pgroups[k] = (ar, ac, av, ap)
            if len(br):
                b_extra_pgroups.setdefault(k, []).append((br, bv, bp))
        self.b_rows = np.concatenate([c[0], br_f])
        self.b_vals = np.concatenate([-c[1], bv_f])
        self.b_pgroups = {}
        for k, v in cp.items():
            b_extra_pgroups.setdefault(k, []).append((v[0], -v[1], v[2]))
        for k, parts in b_extra_pgroups.items():
            self.b_pgroups[k] = tuple(
                np.concatenate([p[i] for p in parts]) for i in range(3)
            )

        # objective
        sense = m._obj_sense
        if m._obj is None:
            ot = ((np.zeros(0, np.int64),) * 2 + (np.zeros(0),), {}, (np.zeros(0, np.int64), np.zeros(0)), {})
        else:
            ot = _collect([m._obj], [0])
        (tt, ttp, tc, tcp) = ot
        cfix = fixed[tt[1]]
        self.c_cols = col_map[tt[1][~cfix]]
        self.c_vals = sense * tt[2][~cfix]
        self.c0_val = float(sense * tc[1].sum()) if tc[1].size else 0.0
        self.c0_val += float(sense * (tt[2][cfix] * fixed_vals[tt[1][cfix]]).sum())
        self.c_pgroups = {}
        self.c0_pgroups = {k: [(sense * v[1], v[2])] for k, v in tcp.items()}
        for k, (rows, cols, scale, pidx) in ttp.items():
            isfix = fixed[cols]
            if (~isfix).any():
                self.c_pgroups[k] = (
                    col_map[cols[~isfix]],
                    sense * scale[~isfix],
                    pidx[~isfix],
                )
            if isfix.any():
                self.c0_pgroups.setdefault(k, []).append(
                    (sense * scale[isfix] * fixed_vals[cols[isfix]], pidx[isfix])
                )
        self.c0_pgroups = {
            k: (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
            )
            for k, parts in self.c0_pgroups.items()
        }
        self.obj_sense = sense

        # bounds of the reduced problem (kept originals + slacks in [0, inf))
        lb = np.zeros(self.N)
        ub = np.full(self.N, np.inf)
        lb[:n_keep] = lb_o[keep]
        ub[:n_keep] = ub_o[keep]
        self.lb = lb
        self.ub = ub

        # named expressions for post-solve evaluation
        self._exprs = {}
        for name, e in getattr(m, "_exprs", {}).items():
            self._exprs[name] = _collect([e], [0]) + (e.R,)

        self.has_param_A = bool(self.A_pgroups)
        return self

    # ------------------------------------------------------------------
    def fingerprint(self, params: Optional[Dict] = None, options: Optional[Dict] = None) -> str:
        """Stable content hash of the lowered program (the JAX package's
        `CompiledLP.fingerprint`, byte for byte)."""
        h = hashlib.sha256()
        h.update(b"CompiledLP")
        h.update(repr(sorted(self.param_shapes.items())).encode())
        h.update(repr((self.M, self.N, self.n_orig, self.n_slack, self.obj_sense)).encode())
        for name in ("A_rows", "A_cols", "A_vals", "b_rows", "b_vals",
                     "c_cols", "c_vals", "lb", "ub", "_keep_cols",
                     "_fixed_vals"):
            _hash_array(h, name, getattr(self, name))
        h.update(repr(self.c0_val).encode())
        for label, groups in (("A", self.A_pgroups), ("b", self.b_pgroups),
                              ("c", self.c_pgroups), ("c0", self.c0_pgroups)):
            for k in sorted(groups):
                h.update(f"{label}:{k}".encode())
                for i, arr in enumerate(groups[k]):
                    _hash_array(h, str(i), arr)
        if params is not None:
            for k in sorted(params):
                _hash_array(h, f"param:{k}", params[k])
        _hash_options(h, options)
        return h.hexdigest()

    # ------------------------------------------------------------------
    def instantiate(
        self, params: Dict, dtype=torch.float64, device="cuda"
    ) -> LPData:
        """Build LP tensors on `device` from parameter values (numpy arrays
        or tensors, optionally with leading batch axes)."""
        src = _ParamSource(params, self.param_shapes, dtype, device)
        lead = src.lead
        M, N = self.M, self.N

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        A = torch.zeros(M * N, dtype=dtype, device=device)
        _scatter_add(A, self.A_rows * N + self.A_cols, t(self.A_vals))
        A = A.expand(*lead, M * N).clone() if lead else A
        for k, (rows, cols, scale, pidx) in self.A_pgroups.items():
            _scatter_add(A, rows * N + cols, t(scale) * src.take(k, pidx))
        A = A.reshape(*lead, M, N)
        b, c, c0 = self._rhs_cost(src, dtype, device)
        return LPData(A=A, b=b, c=c, l=t(self.lb), u=t(self.ub), c0=c0)

    def _rhs_cost(self, src, dtype, device):
        """The b, c and c0 of `instantiate`, shared with `instantiate_coo`."""
        lead = src.lead

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        b = torch.zeros(*lead, self.M, dtype=dtype, device=device)
        _scatter_add(b, self.b_rows, t(self.b_vals))
        for k, (rows, scale, pidx) in self.b_pgroups.items():
            _scatter_add(b, rows, t(scale) * src.take(k, pidx))
        c = torch.zeros(*lead, self.N, dtype=dtype, device=device)
        _scatter_add(c, self.c_cols, t(self.c_vals))
        for k, (cols, scale, pidx) in self.c_pgroups.items():
            _scatter_add(c, cols, t(scale) * src.take(k, pidx))
        c0 = torch.full(lead, self.c0_val, dtype=dtype, device=device)
        for k, (scale, pidx) in self.c0_pgroups.items():
            c0 = c0 + torch.sum(t(scale) * src.take(k, pidx), dim=-1)
        return b, c, c0

    # ------------------------------------------------------------------
    def instantiate_coo(
        self, params: Dict, dtype=torch.float64, device="cuda"
    ) -> SparseLP:
        """COO variant of `instantiate` for matrix-free solvers (PDHG): the
        static pattern first (``A_rows``), then each ``A_pgroups`` entry in
        dict order; duplicate (row, col) entries are kept (the products
        sum them). `rows`/`cols` are int32 and unbatched; `vals` gains the
        parameters' batch axes only when some ``A_pgroups`` parameter
        carries them."""
        src = _ParamSource(params, self.param_shapes, dtype, device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        rows = [self.A_rows]
        cols = [self.A_cols]
        vals = [t(self.A_vals)]
        for k, (r, cc, scale, pidx) in self.A_pgroups.items():
            rows.append(r)
            cols.append(cc)
            vals.append(t(scale) * src.take(k, pidx))
        lead = torch.broadcast_shapes(*(v.shape[:-1] for v in vals))
        vals = torch.cat([v.expand(*lead, v.shape[-1]) for v in vals], dim=-1)
        b, c, c0 = self._rhs_cost(src, dtype, device)
        return SparseLP(
            rows=torch.as_tensor(np.concatenate(rows).astype(np.int32), device=device),
            cols=torch.as_tensor(np.concatenate(cols).astype(np.int32), device=device),
            vals=vals, b=b, c=c, l=t(self.lb), u=t(self.ub), c0=c0,
        )

    # ------------------------------------------------------------------
    def expand(self, x: torch.Tensor) -> torch.Tensor:
        """Map a reduced solver solution (kept columns + slacks) back to the
        full original-variable vector, filling presolved-fixed values."""
        n_keep = len(self._keep_cols)
        full = torch.as_tensor(self._fixed_vals, dtype=x.dtype, device=x.device)
        full = full.expand(*x.shape[:-1], self._n_full).clone()
        keep = torch.as_tensor(self._keep_cols, device=x.device)
        full[..., keep] = x[..., :n_keep]
        return full

    def _full(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(x) if x.shape[-1] == self.N else x

    def col_index(self, name: str) -> np.ndarray:
        """Reduced-column indices of a named variable in the solution vector
        (for callers that address specific coordinates, e.g. the market
        layer's commitment penalties and branch flows)."""
        vm = self._vars[name]
        full = np.arange(vm.start, vm.start + vm.size)
        red = np.searchsorted(self._keep_cols, full)
        if red.max(initial=-1) >= len(self._keep_cols) or np.any(
            self._keep_cols[red] != full
        ):
            raise ValueError(f"variable {name!r} has fixed (presolved) columns")
        return red

    def extract(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Pull a named variable's values out of a solution vector (batched ok)."""
        x = self._full(x)
        vm = self._vars[name]
        sl = x[..., vm.start : vm.start + vm.size]
        return sl.reshape(x.shape[:-1] + tuple(vm.shape)) if vm.shape else sl[..., 0]

    def eval_expr(self, name: str, x: torch.Tensor, params: Dict):
        """Evaluate a named affine expression at solution x (batched over the
        leading axes of x; parameters may share those axes)."""
        (t, tp, cst, cp, R) = self._exprs[name]
        x = self._full(x)
        dtype, device = x.dtype, x.device
        src = _ParamSource(
            {k: params[k] for k in set(tp) | set(cp)},
            {k: self.param_shapes[k] for k in set(tp) | set(cp)},
            dtype, device,
        )

        def tt(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        lead = torch.broadcast_shapes(x.shape[:-1], src.lead)
        out = torch.zeros(*lead, R, dtype=dtype, device=device)
        _scatter_add(out, t[0], tt(t[2]) * x[..., ix(t[1])])
        for k, (rows, cols, scale, pidx) in tp.items():
            _scatter_add(out, rows, tt(scale) * src.take(k, pidx) * x[..., ix(cols)])
        _scatter_add(out, cst[0], tt(cst[1]))
        for k, (rows, scale, pidx) in cp.items():
            _scatter_add(out, rows, tt(scale) * src.take(k, pidx))
        return out[..., 0] if R == 1 else out
