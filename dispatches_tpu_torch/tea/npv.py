"""Techno-economic analysis: cash flows, amortization, NPV (port of
`dispatches_tpu/tea/npv.py`, in torch and numpy).

Replaces the reference's TEAL/RAVEN integration
(`dispatches/util/teal_integration.py:27-340`): capex cash flows, recurring
yearly and hourly cash flows, MACRS depreciation, and NPV, computed directly
(and differentiably) instead of through RAVEN component objects.

Conventions follow the reference: `calculate_TEAL_metrics` builds one Capex
component, one recurring-yearly O&M component, and one hourly revenue
component, then asks TEAL for NPV (`teal_integration.py:136-214`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# IRS MACRS half-year convention tables (fractions per year), standard public
# data; the reference checks amortization against TEAL's MACRS
# (`teal_integration.py:27-48`)
MACRS = {
    3: [0.3333, 0.4445, 0.1481, 0.0741],
    5: [0.20, 0.32, 0.192, 0.1152, 0.1152, 0.0576],
    7: [0.1429, 0.2449, 0.1749, 0.1249, 0.0893, 0.0892, 0.0893, 0.0446],
    10: [0.10, 0.18, 0.144, 0.1152, 0.0922, 0.0737, 0.0655, 0.0655, 0.0656, 0.0655, 0.0328],
    15: [0.05, 0.095, 0.0855, 0.077, 0.0693, 0.0623, 0.059, 0.059, 0.0591, 0.059,
         0.0591, 0.059, 0.0591, 0.059, 0.0591, 0.0295],
    20: [0.0375, 0.07219, 0.06677, 0.06177, 0.05713, 0.05285, 0.04888, 0.04522,
         0.04462, 0.04461, 0.04462, 0.04461, 0.04462, 0.04461, 0.04462, 0.04461,
         0.04462, 0.04461, 0.04462, 0.04461, 0.02231],
}


def capital_recovery_factor(discount_rate: float, n_years: int) -> float:
    """CRF; the reference uses PA = 1/CRF (`load_parameters.py:121`)."""
    r = discount_rate
    return r * (1 + r) ** n_years / ((1 + r) ** n_years - 1)


def present_value_annuity(discount_rate: float, n_years: int) -> float:
    return 1.0 / capital_recovery_factor(discount_rate, n_years)


def _tensor(v):
    """`v` as a float tensor: a tensor keeps its device and dtype, numbers
    and arrays become float64 on the CPU."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v, float))


def npv_cash_flows(cash_flows, discount_rate: float):
    """NPV of a per-year cash-flow vector (year 0 first)."""
    cf = _tensor(cash_flows)
    years = torch.arange(cf.shape[-1], dtype=cf.dtype, device=cf.device)
    return torch.sum(cf / (1.0 + discount_rate) ** years, dim=-1)


def project_npv(
    capex: float,
    annual_revenue,
    annual_om: float = 0.0,
    discount_rate: float = 0.08,
    n_years: int = 30,
    tax_rate: float = 0.0,
    macrs_years: Optional[int] = None,
):
    """Standard project NPV: -capex + PV(annual net revenue), optionally with
    taxes and MACRS depreciation shields (`teal_integration.py:259-340`)."""
    annual_net = _tensor(annual_revenue) - annual_om
    pa = present_value_annuity(discount_rate, n_years)
    if tax_rate <= 0.0:
        return -capex + pa * annual_net
    # after-tax with depreciation shield
    kw = dict(dtype=annual_net.dtype, device=annual_net.device)
    years = torch.arange(1, n_years + 1, **kw)
    disc = (1.0 + discount_rate) ** years
    dep = torch.zeros(n_years, **kw)
    if macrs_years is not None:
        table = torch.as_tensor(MACRS[macrs_years], **kw)
        dep[: table.shape[0]] = table * capex
    taxable = annual_net[..., None] - dep
    after_tax = annual_net[..., None] - tax_rate * taxable
    return -capex + torch.sum(after_tax / disc, dim=-1)


def hourly_revenue_to_annual(hourly_revenue, hours_per_year: float = 8760.0):
    """Scale an hourly revenue series to an annual figure the way the
    reference scales partial-horizon runs (`wind_battery_LMP.py:252-255`)."""
    hr = _tensor(hourly_revenue)
    T = hr.shape[-1]
    return torch.sum(hr, dim=-1) * (hours_per_year / T)
