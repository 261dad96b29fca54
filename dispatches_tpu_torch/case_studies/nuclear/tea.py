"""Traditional (dispatch-free) TEA for nuclear + PEM hybridization (port of
`dispatches_tpu/case_studies/nuclear/tea.py`).

Parity with the reference's `nuclear_case/report/traditional_tea.py:20-74`
(`ne_traditional_tea`): a closed-form annualized-NPV model for adding an
electrolyzer to an existing baseload nuclear generator (capacity-factor
energy accounting at the average LMP, straight-line depreciation, a
max(0, .) corporate tax, an annuity-factor capital charge). The reference's
`run_exhaustive_enumeration` (:77-110) evaluates a 6 x 10 (H2 price x PEM
ratio) grid in a Python double loop; here the model is elementwise over
tensors, so the whole grid is one broadcast evaluation, differentiable in
every input.
"""
from __future__ import annotations

import torch

# reference constants (`traditional_tea.py:44-58`)
NPP_CAPACITY_MW = 400.0
AVG_LMP = 22.09341  # DA LMP at bus Attlee, $/MWh
H2_PROD_RATE_KG_PER_MWH = 20.0
NUM_HOURS = 8784.0
DISCOUNT_RATE = 0.08
PLANT_LIFE_YRS = 30
TAX_RATE = 0.2
VOM_PEM = 0.0
FOM_NPP_PER_MW_YR = 120.0 * 1000.0


def _t(v, like=None, device="cuda", dtype=torch.float64):
    if isinstance(v, torch.Tensor):
        return v
    if like is not None:
        device, dtype = like.device, like.dtype
    return torch.as_tensor(v, dtype=dtype, device=device)


def ne_traditional_tea(
    npp_pem_ratio=0.5,
    pem_cap_factor=0.75,
    h2_selling_price=0.75,
    pem_capex=1200.0,
    vom_npp=2.3,
    device="cuda",
    dtype=torch.float64,
):
    """Annualized NPV, electricity revenue and H2 revenue, broadcasting over
    tensor-shaped inputs (`traditional_tea.py:20-74`, the same constants).
    Numbers become tensors on `device` (on the first tensor input's device
    when there is one)."""
    like = next((v for v in (npp_pem_ratio, pem_cap_factor, h2_selling_price,
                             pem_capex) if isinstance(v, torch.Tensor)), None)
    kw = dict(like=like, device=device, dtype=dtype)
    ratio = _t(npp_pem_ratio, **kw)
    cap_f = _t(pem_cap_factor, **kw)
    h2_price = _t(h2_selling_price, **kw)
    capex_per_kw = _t(pem_capex, **kw)

    pem_capacity = NPP_CAPACITY_MW * ratio
    capex_per_mw = capex_per_kw * 1000.0
    fom_pem = 0.03 * capex_per_mw
    annuity = (1.0 - (1.0 + DISCOUNT_RATE) ** (-PLANT_LIFE_YRS)) / DISCOUNT_RATE

    h2_produced = pem_capacity * H2_PROD_RATE_KG_PER_MWH * NUM_HOURS * cap_f
    electricity_sold = NPP_CAPACITY_MW * NUM_HOURS - pem_capacity * NUM_HOURS * cap_f
    h2_revenue = h2_produced * h2_price
    elec_revenue = electricity_sold * AVG_LMP
    total_vom = (
        NPP_CAPACITY_MW * NUM_HOURS * vom_npp
        + pem_capacity * NUM_HOURS * VOM_PEM
    )
    capex = capex_per_mw * pem_capacity
    total_fom = fom_pem * pem_capacity + FOM_NPP_PER_MW_YR * NPP_CAPACITY_MW
    depreciation = capex / PLANT_LIFE_YRS
    tax = torch.clamp_min(
        TAX_RATE * (h2_revenue + elec_revenue - total_vom - total_fom - depreciation),
        0.0,
    )
    net_profit = h2_revenue + elec_revenue - total_vom - total_fom - tax
    npv = net_profit - capex / annuity
    return npv, elec_revenue, h2_revenue


def traditional_tea_enumeration(
    h2_prices=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
    pem_ratios=tuple(i / 100 for i in range(5, 51, 5)),
    pem_capex=400.0,
    device="cuda",
    dtype=torch.float64,
):
    """The reference's sensitivity sweep (`traditional_tea.py:77-110`) as
    one broadcast evaluation: a dict of (len(h2_prices), len(pem_ratios))
    tensors in $M, the reference's JSON units (values / 1e6)."""
    hp = torch.as_tensor(h2_prices, dtype=dtype, device=device)
    pr = torch.as_tensor(pem_ratios, dtype=dtype, device=device)
    npv, elec_rev, h2_rev = ne_traditional_tea(
        npp_pem_ratio=pr[None, :], h2_selling_price=hp[:, None], pem_capex=pem_capex,
        device=device, dtype=dtype,
    )
    return {
        "h2_price": hp,
        "pem_cap": pr,
        "net_npv": npv / 1e6,
        "elec_rev": elec_rev / 1e6,
        "h2_rev": h2_rev / 1e6,
    }
