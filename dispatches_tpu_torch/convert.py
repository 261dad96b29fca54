"""Carry an instantiated problem, and the surrogate and TEA state, across
from numpy arrays.

What a model's weights are to a network, the instantiated LP is to a
solve. These helpers turn the fields of the JAX package's `LPData` /
`SparseLP` / `BandedLP` (given as numpy arrays, e.g.
``[np.asarray(a) for a in lp]``) into the port's tensors, so one problem can
be fed to both solvers bit for bit. The market surrogates do have weights:
`mlp_from_flax` and `load_trained_surrogate` carry a Flax `SurrogateMLP`
(its parameter tree, or the `.npz` + scaling JSON its `save` writes) into
the port's `nn.Module`, and `arma_from_numpy` / `kmeans_from_numpy` the
fitted ARMA model and k-means result.
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


# ---------------------------------------------------------------------------
# Surrogate weights and the TEA / clustering state

def _flax_layers(params_np) -> list:
    """The Dense layers of a Flax `SurrogateMLP` parameter tree (numpy
    leaves), in order: [(kernel (in, out), bias (out,)), ...]."""
    tree = params_np.get("params", params_np)
    names = sorted((k for k in tree if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if not names:
        raise ValueError("no Dense_<i> layers in the parameter tree")
    return [(np.asarray(tree[k]["kernel"]), np.asarray(tree[k]["bias"])) for k in names]


def mlp_from_flax(params_np, hidden, out_dim, device="cuda", dtype=torch.float32):
    """The port's `SurrogateMLP` from a Flax `SurrogateMLP` parameter tree
    of numpy arrays (``{"params": {"Dense_i": {"kernel", "bias"}}}``).
    Flax's `Dense` kernel is (in, out), so each `nn.Linear.weight` takes its
    transpose."""
    from .surrogates.train import SurrogateMLP

    layers = _flax_layers(params_np)
    if len(layers) != len(tuple(hidden)) + 1:
        raise ValueError(f"{len(layers)} Dense layers for hidden={tuple(hidden)}")
    model = SurrogateMLP(layers[0][0].shape[0], hidden, out_dim)
    with torch.no_grad():
        for lin, (kernel, bias) in zip(model.layers, layers):
            if tuple(kernel.shape) != (lin.in_features, lin.out_features):
                raise ValueError(
                    f"kernel {kernel.shape} does not fit a Linear "
                    f"{lin.in_features} -> {lin.out_features}"
                )
            lin.weight.copy_(torch.as_tensor(kernel.T.copy()))
            lin.bias.copy_(torch.as_tensor(np.array(bias)))
    return model.to(device=device, dtype=dtype)


def load_trained_surrogate(weights_path, scaling_path, device="cuda", dtype=torch.float32):
    """A `TrainedSurrogate` from the JAX package's `TrainedSurrogate.save`
    files (or the port's, which writes the same): the `.npz` of Flax
    parameters under keys like ``['params']/['Dense_0']/['kernel']`` and
    the scaling JSON."""
    import json
    import re

    from .surrogates.train import TrainedSurrogate

    tree: dict = {}
    with np.load(weights_path) as z:
        for key in z.files:
            path = re.findall(r"\['([^']*)'\]", key)
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = z[key]
    layers = _flax_layers(tree)
    hidden = [k.shape[1] for k, _ in layers[:-1]]
    model = mlp_from_flax(tree, hidden, layers[-1][0].shape[1], device=device, dtype=dtype)
    with open(scaling_path) as f:
        scaling = json.load(f)
    return TrainedSurrogate(model, scaling)


def arma_from_numpy(fields):
    """The port's `tea.arma.ARMAModel` from (ar, ma, sigma, fourier_coef,
    fourier_periods, mean) numpy arrays (or a dict by name), e.g. the
    fields of the JAX package's `ARMAModel`; float64 tensors on the CPU."""
    from .tea.arma import ARMAModel

    return _fields(ARMAModel, fields, torch.float64, "cpu")


def kmeans_from_numpy(fields, device="cuda"):
    """The port's `surrogates.clustering.KMeansResult` from (centers,
    labels, inertia) numpy arrays (or a dict by name); the labels stay
    integers."""
    from .surrogates.clustering import KMeansResult

    if isinstance(fields, dict):
        fields = [fields[name] for name in KMeansResult._fields]
    centers, labels, inertia = (np.asarray(a) for a in fields)
    return KMeansResult(
        centers=torch.tensor(centers, device=device),
        labels=torch.as_tensor(labels.astype(np.int64), device=device),
        inertia=torch.as_tensor(inertia, dtype=torch.as_tensor(centers).dtype, device=device),
    )
