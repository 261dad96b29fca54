"""Shared plumbing for unit models.

Units are declarative builders over a `Model`: each unit registers its
variables and physics constraints for all T periods at once (the reference
instead clones a single-period Pyomo block per hour and links clones —
`wind_battery_LMP.py:147-169`; here time is an array axis).

A "port" is simply an affine expression in kW (electrical) or mol/s
(material); arcs are equality constraints between port expressions, matching
the semantics of IDAES `Port`/`Arc` + `network.expand_arcs`
(`RE_flowsheet.py:420`).
"""
from __future__ import annotations

from ..core.model import Model


class Unit:
    """Base class: holds the model handle and a namespaced var factory."""

    def __init__(self, m: Model, name: str):
        self.m = m
        self.name = name

    def _v(self, suffix: str, *a, **kw):
        return self.m.var(f"{self.name}.{suffix}", *a, **kw)

    def _p(self, suffix: str, *a, **kw):
        return self.m.param(f"{self.name}.{suffix}", *a, **kw)


def connect(m: Model, port_a, port_b):
    """Equate two port expressions (IDAES Arc analogue)."""
    m.add_eq(port_a - port_b)
