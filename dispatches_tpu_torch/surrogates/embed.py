"""Surrogate embedding and the uniform training front-end (the OMLT/ALAMO
analogue; port of `dispatches_tpu/surrogates/embed.py`).

The reference encodes trained networks into Pyomo constraints via OMLT
(`RE_surrogate_optimization_steadystate.py:130-166`,
`surrogate_design_scikit.py:140-176`) and trains symbolic-regression models
with the commercial ALAMO binary (`util/surrogates.py:30-69`). Under
autodiff neither encoding is needed: a surrogate is a differentiable torch
function called inside the design objective. This module provides

- :func:`smooth_nonneg`: the reference's smooth max
  ``0.5*sqrt(y^2 + eps^2) + 0.5*y`` on every surrogate output that must
  stay nonnegative (`surrogate_design_scikit.py:152,167,231`);
- :class:`AlamoSurrogate`: a polynomial/interaction basis fit by linear
  least squares, in place of the ALAMO binary (the same save/load JSON idea
  as `alm_surr.save_to_file`);
- :func:`train_surrogate_model`: the uniform front-end over the
  alamo/keras/scikit trainers (`util/surrogates.py:123-228`); both NN
  backends map to `train.train_surrogate`, "alamo" to the basis regression.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .train import train_surrogate


def smooth_nonneg(y, eps: float = 1e-3):
    """Smooth max(y, 0): 0.5*sqrt(y^2+eps^2) + 0.5*y."""
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=torch.float64)
    return 0.5 * torch.sqrt(y**2 + eps**2) + 0.5 * y


def surrogate_fn(sur) -> Callable:
    """Wrap a TrainedSurrogate (or any object with `.predict`) as a plain
    function of one input vector, the "formulation" step of OMLT reduced to
    a closure. Output shape (out_dim,)."""

    def f(x):
        return torch.reshape(sur.predict(x[None, :]), (-1,))

    return f


class AlamoSurrogate:
    """Least-squares regression on a fixed monomial/interaction basis.

    The feature set mirrors ALAMO's default basis options (constant, linear,
    integer powers, pairwise products); the fit is one ridge-regularized
    normal-equations solve in float64 instead of the MILP-driven external
    binary."""

    def __init__(
        self,
        coef,
        powers: Sequence[int] = (1, 2, 3),
        interactions: bool = True,
        x_labels: Optional[Sequence[str]] = None,
        z_labels: Optional[Sequence[str]] = None,
    ):
        self.coef = torch.as_tensor(np.asarray(coef) if not isinstance(coef, torch.Tensor)
                                    else coef)  # (F, out)
        self.powers = tuple(powers)
        self.interactions = bool(interactions)
        self.x_labels = list(x_labels) if x_labels else None
        self.z_labels = list(z_labels) if z_labels else None

    # -- basis ----------------------------------------------------------
    @staticmethod
    def features(X, powers=(1, 2, 3), interactions=True):
        X = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X, float))
        cols = [torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)]
        for p in powers:
            cols.append(X**p)
        if interactions and X.shape[-1] > 1:
            n = X.shape[-1]
            iu, ju = np.triu_indices(n, k=1)
            iu = torch.as_tensor(iu, device=X.device)
            ju = torch.as_tensor(ju, device=X.device)
            cols.append(X[..., iu] * X[..., ju])
        return torch.cat(cols, dim=-1)

    # -- fit / predict --------------------------------------------------
    @classmethod
    def fit(
        cls,
        X,
        z,
        powers: Sequence[int] = (1, 2, 3),
        interactions: bool = True,
        ridge: float = 1e-10,
        x_labels=None,
        z_labels=None,
        device="cuda",
    ) -> "AlamoSurrogate":
        """Fit on `device` in float64."""
        X = torch.as_tensor(np.asarray(X, float), device=device)
        z = torch.as_tensor(np.asarray(z, float), device=device)
        if z.ndim == 1:
            z = z[:, None]
        F = cls.features(X, powers, interactions)
        A = F.T @ F + ridge * torch.eye(F.shape[1], dtype=F.dtype, device=F.device)
        coef = torch.linalg.solve(A, F.T @ z)
        return cls(coef, powers, interactions, x_labels, z_labels)

    def predict(self, X):
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X, float), device=self.coef.device)
        F = self.features(X.to(torch.promote_types(X.dtype, self.coef.dtype)),
                          self.powers, self.interactions)
        return F @ self.coef.to(F.device)

    def r2(self, X, z):
        z = np.asarray(z)
        if z.ndim == 1:
            z = z[:, None]
        pred = self.predict(X).detach().cpu().numpy()
        ss_res = ((z - pred) ** 2).sum(0)
        ss_tot = ((z - z.mean(0)) ** 2).sum(0)
        return 1.0 - ss_res / np.maximum(ss_tot, 1e-30)

    # -- persistence (the `alm_surr.save_to_file` analogue) -------------
    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "coef": self.coef.detach().cpu().numpy().tolist(),
                    "powers": list(self.powers),
                    "interactions": self.interactions,
                    "x_labels": self.x_labels,
                    "z_labels": self.z_labels,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device="cuda") -> "AlamoSurrogate":
        with open(path) as f:
            d = json.load(f)
        return cls(
            torch.as_tensor(np.asarray(d["coef"], float), device=device),
            tuple(d["powers"]),
            d["interactions"],
            d["x_labels"],
            d["z_labels"],
        )


def train_surrogate_model(
    x_data,
    z_data,
    method: str = "keras",
    x_labels: Optional[Sequence[str]] = None,
    z_labels: Optional[Sequence[str]] = None,
    hidden_layers: Sequence[int] = (100, 50),
    epochs: int = 500,
    config: Optional[Dict] = None,
    device="cuda",
):
    """Uniform training front-end (`util/surrogates.py:123-228` parity).

    method='alamo'  -> :class:`AlamoSurrogate` basis regression
    method='keras' | 'scikit' -> the MLP of :func:`train_surrogate`
    Returns (surrogate, metrics dict with per-output R2)."""
    x = np.asarray(x_data, float)
    z = np.asarray(z_data, float)
    if method == "alamo":
        cfg = config or {}
        sur = AlamoSurrogate.fit(
            x,
            z,
            powers=tuple(cfg.get("powers", (1, 2, 3))),
            interactions=bool(cfg.get("interactions", True)),
            x_labels=x_labels,
            z_labels=z_labels,
            device=device,
        )
        return sur, {"R2": sur.r2(x, z)}
    if method in ("keras", "scikit"):
        cfg = config or {}
        sur, metrics = train_surrogate(
            x,
            z,
            hidden=tuple(hidden_layers),
            epochs=epochs,
            lr=float(cfg.get("learning_rate", 1e-3)),
            seed=int(cfg.get("seed", 0)),
            device=device,
        )
        if x_labels is not None:
            sur.scaling["x_labels"] = list(x_labels)
        if z_labels is not None:
            sur.scaling["z_labels"] = list(z_labels)
        return sur, metrics
    raise ValueError(f"unknown surrogate method {method!r}")
