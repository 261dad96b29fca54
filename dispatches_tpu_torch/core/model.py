"""`Model`: declarative LP construction, lowered once to device tensors.

The analogue of the reference's ConcreteModel + MultiPeriodModel stack
(`wind_battery_LMP.py:195-267`), except that time is a native array axis
instead of cloned per-hour blocks, and lowering happens once — scenarios are a
batch dimension of the *parameters*, not model rebuilds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .expr import Expr, Param, ParamView, Var, VarView, _ConstBlock, _TermBlock

INF = float("inf")


@dataclasses.dataclass
class _VarMeta:
    name: str
    start: int
    size: int
    shape: Tuple[int, ...]
    lb: np.ndarray
    ub: np.ndarray


class Model:
    """Host-side LP model builder. Build once; instantiate per parameter set."""

    def __init__(self, name: str = "model"):
        self.name = name
        self._nvars = 0
        self._vars: Dict[str, _VarMeta] = {}
        self._params: Dict[str, Param] = {}
        self._eq: List[Expr] = []
        self._le: List[Expr] = []
        self._obj: Optional[Expr] = None
        self._obj_sense = 1.0  # 1.0 = minimize
        self._exprs: Dict[str, Expr] = {}
        self._row_marks: List[Tuple[str, str, int]] = []

    # ------------------------------------------------------------------
    def var(
        self,
        name: str,
        shape: Union[int, Tuple[int, ...]] = (),
        lb: Union[float, np.ndarray] = 0.0,
        ub: Union[float, np.ndarray] = INF,
    ) -> Var:
        """Declare a variable block. Default bounds [0, inf) match the
        reference's ``within=NonNegativeReals`` idiom (`battery.py:114-130`)."""
        if name in self._vars:
            raise ValueError(f"duplicate var {name}")
        if isinstance(shape, int):
            shape = (shape,)
        size = int(np.prod(shape)) if shape else 1
        cols = np.arange(self._nvars, self._nvars + size, dtype=np.int32)
        lb_arr = np.broadcast_to(np.asarray(lb, dtype=float), (size,)).copy()
        ub_arr = np.broadcast_to(np.asarray(ub, dtype=float), (size,)).copy()
        self._vars[name] = _VarMeta(name, self._nvars, size, shape, lb_arr, ub_arr)
        self._nvars += size
        return Var(name, cols.reshape(shape or (1,)) if shape else cols, shape)

    def param(self, name: str, shape: Union[int, Tuple[int, ...]] = ()) -> Param:
        if isinstance(shape, int):
            shape = (shape,)
        if name in self._params:
            if self._params[name].shape != tuple(shape):
                raise ValueError(f"param {name} redeclared with new shape")
            return self._params[name]
        p = Param(name, shape)
        self._params[name] = p
        return p

    # ------------------------------------------------------------------
    @staticmethod
    def _as_expr(e) -> Expr:
        return Expr._coerce(e)

    def add_eq(self, lhs, rhs=0.0):
        """Constrain lhs == rhs (vectorized over rows)."""
        e = self._as_expr(lhs) - rhs
        self._eq.append(e)
        return e

    def add_le(self, lhs, rhs=0.0):
        """Constrain lhs <= rhs (vectorized over rows)."""
        e = self._as_expr(lhs) - rhs
        self._le.append(e)
        return e

    def add_ge(self, lhs, rhs=0.0):
        e = self._as_expr(rhs) - lhs
        self._le.append(e)
        return e

    def mark_rows(self, name: str, kind: str = "eq") -> None:
        """Open a named row region: every ``kind`` constraint added from
        here until the next ``mark_rows(..., kind)`` call (or the end of
        the model) lands in the region. Lowering resolves each region to
        a global ``[start, stop)`` row range on the built program
        (``CompiledLP.row_ranges``), so consumers that slice rows — LMP
        extraction, contingency row masking — name the region instead of
        hand-counting ordinals that silently skew when constraints are
        added above them."""
        if kind not in ("eq", "le"):
            raise ValueError(f"mark_rows kind must be 'eq' or 'le', got {kind!r}")
        if any(n == name for n, _, _ in self._row_marks):
            raise ValueError(f"duplicate row mark {name!r}")
        self._row_marks.append(
            (name, kind, len(self._eq if kind == "eq" else self._le))
        )

    def expression(self, name: str, e) -> Expr:
        """Register a named affine expression for post-solve evaluation
        (the Pyomo ``Expression`` analogue, e.g. NPV/revenue reporting)."""
        ex = self._as_expr(e)
        self._exprs[name] = ex
        return ex

    def minimize(self, obj):
        e = self._as_expr(obj)
        if e.R != 1:
            raise ValueError("objective must be scalar — use .sum()")
        self._obj = e
        self._obj_sense = 1.0

    def maximize(self, obj):
        e = self._as_expr(obj)
        if e.R != 1:
            raise ValueError("objective must be scalar — use .sum()")
        self._obj = e
        self._obj_sense = -1.0

    # ------------------------------------------------------------------
    def build(self):
        """Lower to a CompiledLP (see core/program.py)."""
        from .program import CompiledLP

        return CompiledLP._from_model(self)
