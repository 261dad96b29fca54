"""Affine-expression modeling layer that lowers to parametric LP tensors.

This is the TPU-native replacement for the reference's Pyomo/IDAES modeling
substrate (SURVEY.md L0): instead of building an object-graph ConcreteModel and
writing `.nl` files per scenario (reference `wind_battery_LMP.py:195-267`), a
`Model` here is built ONCE per topology on the host (numpy index arithmetic
only), and lowers to a `CompiledLP` — a pure function from named parameter
arrays (LMPs, capacity factors, sizes) to standard-form LP tensors that live on
device and can be jit/vmap-ed over scenarios.

Design notes
------------
* Variables are declared with a shape: scalar design variables or `(T,)`
  time-indexed operating variables. Indexing/slicing a variable yields a view,
  so time-linking constraints are written vectorized numpy-style, e.g.
  ``soc[1:] - soc[:-1] - eta * ch[1:]`` (the analogue of the reference's
  linking-variable pairs, `wind_battery_LMP.py:22-37`).
* Coefficients and constants may reference named `Param`s. A coefficient is
  ``scale * param[name][pidx]`` (or just ``scale``). At instantiation time the
  parameter values are gathered with static index arrays — everything is
  jit-traceable, nothing is rebuilt.
* Inequalities get slack columns at lowering time so the solver only sees
  ``min c.x  s.t.  A x = b,  l <= x <= u``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Number = Union[int, float, np.floating]


class Param:
    """A named placeholder for data supplied at solve time (LMPs, CFs, sizes).

    The analogue of a mutable ``pyo.Param`` (reference `wind_battery_LMP.py:234`)
    — but instead of mutating a model, values are passed per-call and can carry
    a leading batch dimension for scenario vmap.
    """

    __slots__ = ("name", "shape")

    def __init__(self, name: str, shape: Tuple[int, ...]):
        self.name = name
        self.shape = tuple(shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __getitem__(self, idx) -> "ParamView":
        flat = np.arange(self.size).reshape(self.shape or (1,))[idx]
        return ParamView(self, np.atleast_1d(flat))

    def view(self) -> "ParamView":
        return ParamView(self, np.arange(self.size))

    def __mul__(self, other):
        return self.view() * other

    __rmul__ = __mul__

    def __add__(self, other):
        return self.view() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.view() - other

    def __rsub__(self, other):
        return (-1.0) * self.view() + other

    def __neg__(self):
        return (-1.0) * self.view()

    def sum(self):
        return self.view().sum()


class ParamView:
    """An indexed slice of a Param, usable in expressions."""

    __array_priority__ = 1000
    __slots__ = ("param", "pidx")

    def __init__(self, param: Param, pidx: np.ndarray):
        self.param = param
        self.pidx = np.asarray(pidx, dtype=np.int32).ravel()

    def __len__(self):
        return len(self.pidx)

    def __getitem__(self, idx):
        return ParamView(self.param, self.pidx[idx])

    def _as_expr(self) -> "Expr":
        R = len(self.pidx)
        cb = _ConstBlock(
            rows=np.arange(R, dtype=np.int32),
            scale=np.ones(R),
            pname=self.param.name,
            pidx=self.pidx,
        )
        return Expr(R, [], [cb])

    def __mul__(self, other):
        if isinstance(other, (Var, VarView)):
            return _varview(other)._scaled_by_param(self)
        if isinstance(other, (int, float, np.floating, np.ndarray)):
            e = self._as_expr()
            return e * other
        if isinstance(other, Expr):
            return other._scaled_by_param(self)
        return NotImplemented

    __rmul__ = __mul__

    def __add__(self, other):
        return self._as_expr() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._as_expr() - other

    def __rsub__(self, other):
        return (-1.0) * self._as_expr() + other

    def __neg__(self):
        return (-1.0) * self._as_expr()

    def sum(self):
        return self._as_expr().sum()


@dataclasses.dataclass
class _TermBlock:
    """A batch of linear-coefficient entries: A[row, col] += scale * p[pidx]."""

    rows: np.ndarray  # (L,) int32 — local row index within the expression
    cols: np.ndarray  # (L,) int32 — global column (variable) index
    scale: np.ndarray  # (L,) float
    pname: Optional[str] = None
    pidx: Optional[np.ndarray] = None  # (L,) int32 into flattened param


@dataclasses.dataclass
class _ConstBlock:
    """A batch of constant entries: const[row] += scale * p[pidx]."""

    rows: np.ndarray
    scale: np.ndarray
    pname: Optional[str] = None
    pidx: Optional[np.ndarray] = None


class Var:
    """A (block of) decision variable(s) with static bounds."""

    __array_priority__ = 1000
    __slots__ = ("name", "cols", "shape")

    def __init__(self, name: str, cols: np.ndarray, shape: Tuple[int, ...]):
        self.name = name
        self.cols = cols
        self.shape = shape

    def __len__(self):
        return self.cols.size

    def __getitem__(self, idx) -> "VarView":
        return VarView(np.atleast_1d(self.cols.reshape(self.shape or (1,))[idx]))

    # arithmetic delegates to a full view
    def _view(self) -> "VarView":
        return VarView(self.cols.ravel())

    def __mul__(self, other):
        return self._view() * other

    __rmul__ = __mul__

    def __add__(self, other):
        return self._view() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._view() - other

    def __rsub__(self, other):
        return self._view().__rsub__(other)

    def __neg__(self):
        return -self._view()

    def sum(self) -> "Expr":
        return self._view().sum()


class VarView:
    """An indexed subset of a Var's columns."""

    __array_priority__ = 1000
    __slots__ = ("cols",)

    def __init__(self, cols: np.ndarray):
        self.cols = np.asarray(cols, dtype=np.int32).ravel()

    def __len__(self):
        return len(self.cols)

    def __getitem__(self, idx):
        return VarView(self.cols[idx])

    def _as_expr(self) -> "Expr":
        R = len(self.cols)
        tb = _TermBlock(
            rows=np.arange(R, dtype=np.int32), cols=self.cols, scale=np.ones(R)
        )
        return Expr(R, [tb], [])

    def __mul__(self, other):
        return self._as_expr() * other

    __rmul__ = __mul__

    def __add__(self, other):
        return self._as_expr() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._as_expr() - other

    def __rsub__(self, other):
        return (-1.0) * self._as_expr() + other

    def __neg__(self):
        return (-1.0) * self._as_expr()

    def sum(self):
        return self._as_expr().sum()


def _varview(v) -> "Expr":
    if isinstance(v, Var):
        return v._view()._as_expr()
    if isinstance(v, VarView):
        return v._as_expr()
    raise TypeError(type(v))


def _broadcast_rows(R_target: int, arr: np.ndarray) -> np.ndarray:
    if arr.size == 1 and R_target != 1:
        return np.broadcast_to(arr, (R_target,)).copy()
    return arr


class Expr:
    """A vectorized affine expression with R rows.

    ``value[row] = sum_terms A_entries + sum_consts`` — rows map 1:1 onto
    constraint rows (or objective row 0 after ``.sum()``).
    """

    __array_priority__ = 1000
    __slots__ = ("R", "terms", "consts")

    def __init__(self, R: int, terms: List[_TermBlock], consts: List[_ConstBlock]):
        self.R = R
        self.terms = terms
        self.consts = consts

    # ---- helpers -------------------------------------------------------
    @staticmethod
    def _coerce(other, R_hint: int = 1) -> "Expr":
        if isinstance(other, Expr):
            return other
        if isinstance(other, (Var, VarView)):
            return _varview(other)
        if isinstance(other, Param):
            return other.view()._as_expr()
        if isinstance(other, ParamView):
            return other._as_expr()
        if isinstance(other, (int, float, np.floating)):
            if other == 0:
                return Expr(R_hint, [], [])
            arr = np.full(R_hint, float(other))
            cb = _ConstBlock(rows=np.arange(R_hint, dtype=np.int32), scale=arr)
            return Expr(R_hint, [], [cb])
        if isinstance(other, np.ndarray):
            arr = other.ravel().astype(float)
            cb = _ConstBlock(rows=np.arange(arr.size, dtype=np.int32), scale=arr)
            return Expr(arr.size, [], [cb])
        raise TypeError(f"cannot use {type(other)} in expression")

    def __add__(self, other):
        o = Expr._coerce(other, self.R)
        R = max(self.R, o.R)
        if self.R not in (R, 1) or o.R not in (R, 1):
            raise ValueError(f"row mismatch {self.R} vs {o.R}")

        def up(blocks, src_R):
            out = []
            for b in blocks:
                if src_R == 1 and R != 1:
                    # broadcast single-row expr across R rows
                    reps = R
                    rows = np.tile(np.arange(reps, dtype=np.int32), len(b.rows))
                    scale = np.repeat(b.scale, reps)
                    if isinstance(b, _TermBlock):
                        cols = np.repeat(b.cols, reps)
                        pidx = np.repeat(b.pidx, reps) if b.pidx is not None else None
                        out.append(_TermBlock(rows, cols, scale, b.pname, pidx))
                    else:
                        pidx = np.repeat(b.pidx, reps) if b.pidx is not None else None
                        out.append(_ConstBlock(rows, scale, b.pname, pidx))
                else:
                    out.append(b)
            return out

        terms = up(self.terms, self.R) + up(o.terms, o.R)
        consts = up(self.consts, self.R) + up(o.consts, o.R)
        t = [b for b in terms if isinstance(b, _TermBlock)]
        c = [b for b in terms if isinstance(b, _ConstBlock)]
        c2 = [b for b in consts if isinstance(b, _ConstBlock)]
        t2 = [b for b in consts if isinstance(b, _TermBlock)]
        return Expr(R, t + t2, c + c2)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (Expr._coerce(other, self.R) * -1.0)

    def __rsub__(self, other):
        return (self * -1.0) + other

    def __neg__(self):
        return self * -1.0

    def __mul__(self, other):
        if isinstance(other, (int, float, np.floating)):
            f = float(other)
            terms = [
                _TermBlock(b.rows, b.cols, b.scale * f, b.pname, b.pidx)
                for b in self.terms
            ]
            consts = [
                _ConstBlock(b.rows, b.scale * f, b.pname, b.pidx) for b in self.consts
            ]
            return Expr(self.R, terms, consts)
        if isinstance(other, np.ndarray):
            arr = other.ravel().astype(float)
            arr = _broadcast_rows(self.R, arr)
            if arr.size != self.R:
                raise ValueError("array factor must match rows")
            terms = [
                _TermBlock(b.rows, b.cols, b.scale * arr[b.rows], b.pname, b.pidx)
                for b in self.terms
            ]
            consts = [
                _ConstBlock(b.rows, b.scale * arr[b.rows], b.pname, b.pidx)
                for b in self.consts
            ]
            return Expr(self.R, terms, consts)
        if isinstance(other, (Param, ParamView)):
            pv = other.view() if isinstance(other, Param) else other
            return self._scaled_by_param(pv)
        if isinstance(other, Expr):
            # affine * const-only (e.g. ``(-1.0 * p) * x``): distribute each
            # const block of the const-only factor over this expression
            if not other.terms:
                a, b = other, self
            elif not self.terms:
                a, b = self, other
            else:
                raise TypeError("product of two non-constant expressions")
            out = None
            for cb in a.consts:
                if len(np.unique(cb.rows)) != len(cb.rows):
                    raise ValueError("const factor rows must be unique")
                if cb.pname is None:
                    vec = np.zeros(max(a.R, b.R))
                    vec[cb.rows] = cb.scale
                    piece = b * vec
                else:
                    # scale rows first, then attach the param reference
                    vec = np.zeros(max(a.R, b.R))
                    vec[cb.rows] = cb.scale
                    pidx_full = np.zeros(max(a.R, b.R), dtype=np.int32)
                    pidx_full[cb.rows] = cb.pidx
                    piece = (b * vec)._scaled_by_param(
                        ParamView(Param(cb.pname, (int(pidx_full.max()) + 1,)), pidx_full)
                    )
                out = piece if out is None else out + piece
            return out if out is not None else Expr(max(a.R, b.R), [], [])
        return NotImplemented

    __rmul__ = __mul__

    def _scaled_by_param(self, pv: ParamView) -> "Expr":
        """Elementwise product with a param vector aligned to rows."""
        pidx_all = pv.pidx
        target = self
        if len(pidx_all) == 1 and self.R != 1:
            pidx_all = np.broadcast_to(pidx_all, (self.R,))
        elif self.R == 1 and len(pidx_all) > 1:
            # broadcast a scalar expression across the param's rows, e.g.
            # ``cf * capacity`` with cf a (T,) param and capacity a scalar var
            target = self + Expr(len(pidx_all), [], [])
        if len(pidx_all) != target.R:
            raise ValueError("param factor must match rows")
        self = target
        terms, consts = [], []
        for b in self.terms:
            if b.pname is not None:
                raise ValueError(
                    "bilinear parameter products not supported; premultiply on host"
                )
            terms.append(
                _TermBlock(b.rows, b.cols, b.scale, pv.param.name, pidx_all[b.rows])
            )
        for b in self.consts:
            if b.pname is not None:
                raise ValueError(
                    "bilinear parameter products not supported; premultiply on host"
                )
            consts.append(
                _ConstBlock(b.rows, b.scale, pv.param.name, pidx_all[b.rows])
            )
        return Expr(self.R, terms, consts)

    def sum(self) -> "Expr":
        """Reduce all rows to one (objective/aggregate expressions)."""
        terms = [
            _TermBlock(np.zeros_like(b.rows), b.cols, b.scale, b.pname, b.pidx)
            for b in self.terms
        ]
        consts = [
            _ConstBlock(np.zeros_like(b.rows), b.scale, b.pname, b.pidx)
            for b in self.consts
        ]
        return Expr(1, terms, consts)

    def __getitem__(self, idx):
        sel = np.zeros(self.R, dtype=bool)
        sel[np.arange(self.R)[idx]] = True
        newrow = np.cumsum(sel) - 1
        terms, consts = [], []
        for b in self.terms:
            keep = sel[b.rows]
            terms.append(
                _TermBlock(
                    newrow[b.rows[keep]].astype(np.int32),
                    b.cols[keep],
                    b.scale[keep],
                    b.pname,
                    b.pidx[keep] if b.pidx is not None else None,
                )
            )
        for b in self.consts:
            keep = sel[b.rows]
            consts.append(
                _ConstBlock(
                    newrow[b.rows[keep]].astype(np.int32),
                    b.scale[keep],
                    b.pname,
                    b.pidx[keep] if b.pidx is not None else None,
                )
            )
        return Expr(int(sel.sum()), terms, consts)
