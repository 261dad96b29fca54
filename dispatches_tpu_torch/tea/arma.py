"""Synthetic LMP history generation: ARMA models (port of
`dispatches_tpu/tea/arma.py`).

Replaces the reference's RAVEN ARMA integration
(`dispatches/util/syn_hist_generation.py:21`, `syn_hist_integration.py:
29-110` and `case_studies/nuclear_case/ARMA_Model/`): fit an ARMA(p, q) to
an hourly LMP series with a Fourier seasonal mean (the RAVEN recipe), then
generate batches of synthetic realizations on a device. The JAX package
runs one `lax.scan` per realization under `vmap`; here the realizations are
one batch, and the recursion is a loop over hours on it: the moving-average
part is computed for every hour at once, the autoregressive part is one
small product an hour. Innovations come from an explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch


class ARMAModel(NamedTuple):
    ar: torch.Tensor  # (p,)
    ma: torch.Tensor  # (q,)
    sigma: torch.Tensor  # innovation std
    fourier_coef: torch.Tensor  # (2K,) seasonal mean coefficients
    fourier_periods: torch.Tensor  # (K,) periods in hours
    mean: torch.Tensor


def _fourier_design(T: int, periods: np.ndarray) -> np.ndarray:
    t = np.arange(T)[:, None]
    w = 2 * np.pi / periods[None, :]
    return np.concatenate([np.sin(w * t), np.cos(w * t)], axis=1)


def fit_arma(
    series: np.ndarray,
    p: int = 2,
    q: int = 1,
    fourier_periods: Tuple[float, ...] = (24.0, 168.0, 8760.0),
) -> ARMAModel:
    """Host-side fit: OLS Fourier mean + Hannan-Rissanen ARMA estimation
    (long-AR residuals, then the ARMA regression). The model's fields are
    float64 tensors on the CPU."""
    x = np.asarray(series, dtype=float)
    T = len(x)
    periods = np.asarray(fourier_periods, dtype=float)
    F = _fourier_design(T, periods)
    mean = x.mean()
    coef, *_ = np.linalg.lstsq(F, x - mean, rcond=None)
    resid = x - mean - F @ coef

    # stage 1: a long AR to estimate the innovations
    m = max(20, 2 * (p + q))
    X = np.stack([np.roll(resid, k) for k in range(1, m + 1)], axis=1)[m:]
    yv = resid[m:]
    phi_long, *_ = np.linalg.lstsq(X, yv, rcond=None)
    eps = np.zeros_like(resid)
    eps[m:] = yv - X @ phi_long

    # stage 2: regression on p lags of x and q lags of eps
    k0 = max(p, q) + m
    cols = [np.roll(resid, i)[k0:] for i in range(1, p + 1)]
    cols += [np.roll(eps, j)[k0:] for j in range(1, q + 1)]
    X2 = np.stack(cols, axis=1)
    y2 = resid[k0:]
    theta, *_ = np.linalg.lstsq(X2, y2, rcond=None)
    ar, ma = theta[:p], theta[p:]
    fitted_eps = y2 - X2 @ theta
    sigma = float(np.std(fitted_eps))
    f64 = torch.float64
    return ARMAModel(
        ar=torch.as_tensor(ar, dtype=f64),
        ma=torch.as_tensor(ma, dtype=f64),
        sigma=torch.as_tensor(sigma, dtype=f64),
        fourier_coef=torch.as_tensor(coef, dtype=f64),
        fourier_periods=torch.as_tensor(periods, dtype=f64),
        mean=torch.as_tensor(mean, dtype=f64),
    )


def _generator(generator, device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(0 if generator is None else int(generator))


def generate(
    model: ARMAModel,
    T: int,
    generator: Union[torch.Generator, int, None] = None,
    n_realizations: int = 1,
    clip_min: float = 0.0,
    device="cuda",
    dtype=torch.float64,
):
    """Synthetic series, shape (n_realizations, T), on `device`.

    `generator` is a `torch.Generator` on `device` (or a seed for a fresh
    one; None seeds 0). Each realization draws T + q standard-normal
    innovations, as the JAX package's does:
    x_t = sum_i ar_i x_{t-1-i} + sum_j ma_j e_{t-1-j} + e_t on the
    de-seasonalized series, then the Fourier mean is added and the series
    clipped below at `clip_min`."""
    dev = torch.device(device)
    gen = _generator(generator, dev)
    ar, ma, sigma, coef, periods, mean = (
        torch.as_tensor(a, dtype=dtype).to(dev) for a in model
    )
    p, q = ar.shape[0], ma.shape[0]
    t = torch.arange(T, dtype=dtype, device=dev)[:, None]
    w = 2 * torch.pi / periods[None, :]
    F = torch.cat([torch.sin(w * t), torch.cos(w * t)], dim=1)
    seasonal = mean + F @ coef

    eps = sigma * torch.randn(n_realizations, T + q, generator=gen, dtype=dtype, device=dev)
    # moving-average part for every hour at once: e_t + sum_j ma_j e_{t-1-j}
    # (the q leading draws are the pre-sample innovations, which the JAX
    # package's recursion never reads: its MA history starts at zero)
    e = eps[:, q:]
    drive = e.clone()
    for j in range(q):
        drive[:, j + 1:] += ma[j] * e[:, : T - j - 1]
    # autoregressive part: out[:, p + t] = ar . (x_{t-1}, ..., x_{t-p}) + drive_t
    out = torch.zeros(n_realizations, p + T, dtype=dtype, device=dev)
    ar_rev = ar.flip(0)
    for i in range(T):
        out[:, p + i] = out[:, i : i + p] @ ar_rev + drive[:, i] if p else drive[:, i]
    return torch.clamp_min(seasonal + out[:, p:], clip_min)
