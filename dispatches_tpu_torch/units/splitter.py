"""Electrical splitter.

Parity with reference `dispatches/unit_models/elec_splitter.py:40-275`: splits
a kW inlet across named outlets with the sum constraint
``electricity[t] == sum(outlet_elec[t])`` (`elec_splitter.py:115-117`). The
optional split-fraction variables (`elec_splitter.py:119-134`) are bilinear in
the LP and only used for initialization in the reference, so they are not
represented; outlet flows are free nonnegative variables.
"""
from __future__ import annotations

from typing import Dict, List

from ..core.model import Model
from .base import Unit


class ElectricalSplitter(Unit):
    def __init__(
        self,
        m: Model,
        T: int,
        inlet,  # affine expression in kW, e.g. wind.electricity_out
        outlet_list: List[str],
        name: str = "splitter",
    ):
        super().__init__(m, name)
        self.T = T
        self.outlets: Dict[str, object] = {}
        total = None
        for out in outlet_list:
            v = self._v(f"{out}_elec", T)
            self.outlets[out] = v
            total = v if total is None else total + v
        m.add_eq(total - inlet)

    def __getattr__(self, key):
        if key.endswith("_elec"):
            out = key[: -len("_elec")]
            if out in self.__dict__.get("outlets", {}):
                return self.outlets[out]
        raise AttributeError(key)
