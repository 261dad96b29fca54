"""Wind turbine powercurve -> capacity factors (port of
`dispatches_tpu/units/powercurve.py`, the PySAM replacement).

Parity with reference `dispatches/unit_models/wind_power.py:129-189`, which
runs PySAM's Windpower module per timestep to turn a wind resource into a
capacity factor with the ATB 2018 Market Average turbine
(`wind_power.py:131-147`: hub 110 m, rotor 116 m, 5 MW rated, powercurve
tabulated at 1 m/s steps).

- `capacity_factor_pysam` reproduces PySAM's Weibull resource mode
  (``resource_speed``, `wind_power.py:170-183`): a binned-CDF integration
  over the 1 m/s powercurve grid with k = 100, i.e. a smoothed
  right-continuous staircase, with two constants calibrated against the
  reference's golden results (`tools/calibrate_pysam_cf.py`). It is the
  one to use where parity with the reference's dollars matters
  (`case_studies/renewables/params.py::load_re_goldens`).
- `capacity_factor_from_speed` interpolates the powercurve linearly, a
  smooth approximation for design-gradient studies;
  `capacity_factor_from_pdf` mixes it over a speed PMF, and
  `capacity_factors` dispatches on the reference's resource layouts.

Every function computes in torch on `device` (default: the tensor
argument's device, else the CUDA card) in `dtype` (default: the tensor
argument's floating dtype, else float64), and is differentiable in the
speeds.
"""
from __future__ import annotations

import numpy as np
import torch

# ATB 2018 Market Average turbine powercurve (kW at integer wind speeds, m/s),
# as configured in the reference's `setup_atb_turbine` (wind_power.py:135-141).
ATB_POWERCURVE_KW = np.array(
    [0, 0, 0, 40.5, 177.7, 403.9, 737.6, 1187.2, 1771.1, 2518.6,
     3448.4, 4562.5, 5000, 5000, 5000, 5000, 5000, 5000, 5000, 5000,
     5000, 5000, 5000, 5000, 5000, 5000, 0, 0],
    dtype=np.float64,
)
ATB_WINDSPEEDS = np.arange(len(ATB_POWERCURVE_KW), dtype=np.float64)
ATB_RATED_KW = float(ATB_POWERCURVE_KW.max())
ATB_HUB_HEIGHT_M = 110.0
ATB_ROTOR_DIAMETER_M = 116.0

# PySAM-parity Weibull-bin model calibration (see capacity_factor_pysam),
# fit by tools/calibrate_pysam_cf.py against the reference's seven golden
# scalars in `test_RE_flowsheet.py:132-176`
PYSAM_WEIBULL_K = 100.0  # `wind_power.py:174` (delta-like distribution)
PYSAM_SPEED_SCALE = 0.988
PYSAM_DERATE = 0.16656  # ~ SAM's default wind loss stack


def _placement(v, device, dtype):
    """(device, dtype) for a computation on `v`: the explicit arguments
    first, then `v`'s own when it is a tensor, else the card and float64."""
    if isinstance(v, torch.Tensor):
        device = v.device if device is None else device
        if dtype is None and v.is_floating_point():
            dtype = v.dtype
    return ("cuda" if device is None else device), (torch.float64 if dtype is None else dtype)


def _curve(speeds, power_kw, device, dtype):
    sp = torch.as_tensor(ATB_WINDSPEEDS if speeds is None else speeds, dtype=dtype, device=device)
    pw = torch.as_tensor(ATB_POWERCURVE_KW if power_kw is None else power_kw,
                         dtype=dtype, device=device)
    return sp, pw


def capacity_factor_pysam(speed, k=PYSAM_WEIBULL_K, speed_scale=PYSAM_SPEED_SCALE,
                          derate=PYSAM_DERATE, speeds=None, power_kw=None,
                          device=None, dtype=None):
    """CF(speed) reproducing PySAM Windpower's Weibull resource mode.

    The reference (`wind_power.py:170-183`) runs one PySAM Windpower
    simulation per hour with ``weibull_k_factor=100`` and
    ``weibull_wind_speed=speed``. SSC's Weibull energy model is a binned
    CDF integration: the Weibull scale is ``lambda = speed / Gamma(1 +
    1/k)`` and the probability mass in ``(ws[i-1], ws[i]]`` is assigned
    the tabulated power at ``ws[i]``. ``speed_scale`` and ``derate`` are
    the two calibrated constants of the JAX package.

    `speed` has any shape (hours, scenarios x hours, ...); differentiable
    in `speed`."""
    device, dtype = _placement(speed, device, dtype)
    sp, pw = _curve(speeds, power_kw, device, dtype)
    rated = pw.max()
    s = torch.as_tensor(speed, dtype=dtype, device=device) * speed_scale
    # lambda = s / Gamma(1 + 1/k), through lgamma for any k
    g = torch.special.gammaln(torch.as_tensor(1.0 + 1.0 / k, dtype=dtype, device=device))
    lam = torch.clamp_min(s / torch.exp(g), 1e-12)
    # CDF at the tabulated speeds; mass in (ws[i-1], ws[i]] -> power[ws[i]].
    # (sp/lam)**k in log space with the clamp BEFORE the exp: the ratio**100
    # form overflows (inf) first and then makes the gradient NaN
    t = k * (torch.log(torch.clamp_min(sp, 1e-30)) - torch.log(lam)[..., None])
    cdf = 1.0 - torch.exp(-torch.exp(torch.clamp_max(t, 8.0)))
    mass = torch.diff(cdf, dim=-1)
    energy = torch.sum(mass * pw[1:], dim=-1)
    return (1.0 - derate) * energy / rated


def read_srw_wind_speeds(path):
    """Hub-series wind speeds [m/s] from an SRW (SAM resource wind) file.

    Replaces `PySAM.ResourceTools.SRW_to_wind_data` as used by the reference
    golden fixture (`test_RE_flowsheet.py:35-37`): 5 header lines (location,
    source, field names, units, heights), then 8,760 hourly rows whose third
    column is wind speed. Returns a float64 numpy array of length 8760.
    """
    rows = np.loadtxt(path, delimiter=",", skiprows=5)
    return rows[:, 2].astype(np.float64)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for increasing `xp`, by searchsorted: the
    end values outside ``[xp[0], xp[-1]]``, ``fp[i-1] + (x - xp[i-1]) /
    (xp[i] - xp[i-1]) * (fp[i] - fp[i-1])`` inside."""
    i = torch.clamp(torch.searchsorted(xp, x.detach(), right=True), 1, xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx, df = xp[i] - x0, fp[i] - f0
    flat = dx.abs() <= np.spacing(np.finfo(np.float64).eps if xp.dtype == torch.float64
                                  else np.finfo(np.float32).eps)
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def capacity_factor_from_speed(speed, speeds=None, power_kw=None, device=None, dtype=None):
    """CF at hub-height wind speed(s) via powercurve interpolation.

    `speed` may be scalar or any array shape (hours, scenarios x hours, ...).
    Replaces the per-timestep PySAM run of `wind_power.py:170-183`.
    """
    device, dtype = _placement(speed, device, dtype)
    sp, pw = _curve(speeds, power_kw, device, dtype)
    x = torch.as_tensor(speed, dtype=dtype, device=device)
    return _interp(x.contiguous(), sp, pw) / pw.max()


def capacity_factor_from_pdf(speed_bins, probs, speeds=None, power_kw=None,
                             device=None, dtype=None):
    """CF for a wind-speed probability mass function.

    ``speed_bins``: (..., K) speeds; ``probs``: (..., K) weights summing to 1
    along the last axis. The reference (`wind_power.py:153-169`) only supports
    K=1; this is the general mixture.
    """
    device, dtype = _placement(speed_bins, device, dtype)
    cf = capacity_factor_from_speed(speed_bins, speeds, power_kw, device, dtype)
    return torch.sum(cf * torch.as_tensor(probs, dtype=dtype, device=device), dim=-1)


def capacity_factors(resource, kind="speed", device=None, dtype=None):
    """Dispatch helper mirroring the reference's `setup_resource` branches.

    ``kind='speed'``: `resource` is an array of hub-height speeds (m/s).
    ``kind='pdf'``: `resource` is a sequence of [(speed, direction, prob), ...]
    per hour, the reference's `resource_probability_density` layout
    (direction is ignored: a single wake-free turbine).
    ``kind='cf'``: passthrough of direct capacity factors
    (`wind_power.py:184-189`).
    """
    if kind == "speed":
        device, dtype = _placement(resource, device, dtype)
        return capacity_factor_from_speed(
            torch.as_tensor(resource, dtype=dtype, device=device), device=device, dtype=dtype)
    if kind == "pdf":
        rows = [np.asarray(r, np.float64).reshape(-1, 3) for r in resource]
        k = max(r.shape[0] for r in rows)
        sp = np.zeros((len(rows), k))
        pr = np.zeros((len(rows), k))
        for i, r in enumerate(rows):
            if abs(r[:, 2].sum() - 1.0) > 1e-3:
                raise ValueError(
                    f"probabilities for hour {i} must sum to 1 (got {r[:, 2].sum()})"
                )
            sp[i, : r.shape[0]] = r[:, 0]
            pr[i, : r.shape[0]] = r[:, 2]
        return capacity_factor_from_pdf(sp, pr, device=device, dtype=dtype)
    if kind == "cf":
        device, dtype = _placement(resource, device, dtype)
        return torch.as_tensor(resource, dtype=dtype, device=device)
    raise ValueError(f"unknown resource kind {kind!r}")
