"""Carry an instantiated problem across from numpy arrays.

The system has no weights: what a model's weights are to a network, the
instantiated LP is to a solve. These helpers turn the fields of the JAX
package's `LPData` / `SparseLP` / `BandedLP` (given as numpy arrays, e.g.
``[np.asarray(a) for a in lp]``) into the port's tensors, so one problem can
be fed to both solvers bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.program import LPData, SparseLP
from .solvers.structured import BandedLP


def _fields(cls, fields, dtype, device):
    if isinstance(fields, dict):
        fields = [fields[name] for name in cls._fields]
    if len(fields) != len(cls._fields):
        raise ValueError(f"{cls.__name__} takes {len(cls._fields)} fields, got {len(fields)}")
    return cls(*(
        torch.tensor(np.asarray(a), dtype=dtype, device=device) for a in fields
    ))


def lp_from_numpy(fields: Sequence, device="cuda", dtype=torch.float64) -> LPData:
    """`LPData` from (A, b, c, l, u, c0) numpy arrays (or a dict by name)."""
    return _fields(LPData, fields, dtype, device)


def banded_lp_from_numpy(fields: Sequence, device="cuda", dtype=torch.float64) -> BandedLP:
    """`BandedLP` from (Ad, As, Bb, b, c, cb, l, u, lb, ub, c0) numpy arrays
    (or a dict by name)."""
    return _fields(BandedLP, fields, dtype, device)


def sparse_lp_from_numpy(fields: Sequence, device="cuda", dtype=torch.float64) -> SparseLP:
    """`SparseLP` from (rows, cols, vals, b, c, l, u, c0) numpy arrays (or a
    dict by name); the pattern keeps its int32 indices."""
    if isinstance(fields, dict):
        fields = [fields[name] for name in SparseLP._fields]
    if len(fields) != len(SparseLP._fields):
        raise ValueError(f"SparseLP takes {len(SparseLP._fields)} fields, got {len(fields)}")
    return SparseLP(
        *(torch.tensor(np.asarray(a, np.int32), device=device) for a in fields[:2]),
        *(torch.tensor(np.asarray(a), dtype=dtype, device=device) for a in fields[2:]),
    )
