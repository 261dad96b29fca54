"""Supercritical (SCPC) steam-cycle NLP, the reference's second plant tier
(port of `dispatches_tpu/case_studies/fossil/scpc_nlp.py`).

A reduced re-build of `fossil_case/supercritical_plant/
supercritical_powerplant.py`: the 9-stage turbine train with one reheat,
seven closed feedwater heaters with UA-LMTD condensing heat transfer and
cascading drains, the deaerator, condensate and boiler-feed pumps, and the
boiler-feed-pump turbine (BFPT) power balance. All fixed data are the
reference's `fix_dof_and_initialize` values (`:580-724`).

Differences from the USC tier (`usc_nlp.py`) mirror the reference pair:
one reheat, 9 stages, 7 FWHs, no booster pump, a fixed 1 MPa
condensate-pump dP, and the BFPT balancing only the BFP while the
condensate pump's work is netted off the plant output (`:387-399`).

The square system: 7 FWH extraction fractions + 7 feedwater outlet
enthalpies + the BFPT fraction = 15 unknowns, solved by
`solvers/nlp.solve_square`. Golden (reference `test_scpc_flowsheet.py:52`):
net power 692 MW +- 1 at design throttle (24.235 MPa, 29,111 mol/s).

As in `usc_nlp.py`, the unknowns-free part of the cycle (the train's
states, the drain and shell saturation states, the condenser pressure,
the pumps' constant parts, the BFPT's specific work) is evaluated once per
solve (`_train`), and the FWHs' inversions run as tensor axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...properties import steam as st
from ...properties.steam import MW_H2O
from ...solvers.nlp import solve_square

# ---- reference data (`fix_dof_and_initialize`, `:622-698`) ---------------
MAIN_FLOW_MOL = 29111.0
MAIN_STEAM_P = 24235081.4
MAIN_STEAM_T = 866.15
RATIO_P = np.array(
    [0.8**5, 0.8**2, 0.79**4, 0.79**6, 0.64**2, 0.64**2, 0.64**2, 0.64**2, 0.5]
)
TURB_EFF = np.array([0.94, 0.94, 0.88, 0.88, 0.78, 0.78, 0.78, 0.78, 0.78])
RH_DELTAP = {3: 96526.64}  # single reheat before stage 3 (`:625`, NETL dP)
DEA_SPLIT = 0.050331  # t_splitter[4] -> deaerator (fixed, `:662`)
COND_PUMP_DP = 1e6  # Pa (`:688`)
BFP_P_RATIO = 1.15  # bfp outlet = main steam pressure * 1.15 (`:696`)
PUMP_EFF = 0.8
BFPT_EFF = 0.8
FWH_AREA = {1: 400.0, 2: 300.0, 3: 200.0, 4: 200.0, 6: 600.0, 7: 400.0, 8: 400.0}
FWH_U = {1: 2000.0, 2: 2900.0, 3: 2900.0, 4: 2900.0, 6: 2900.0, 7: 2900.0, 8: 2900.0}
# shell-side drain throttle: P_drain = 1.1 * ratio * P_extraction
# (`pressure_ratio_list`, `:243-270`)
FWH_DRAIN_RATIO = {1: 0.5, 2: 0.64**2, 3: 0.64**2, 4: 0.64**2,
                   6: 0.79**6, 7: 0.79**4, 8: 0.8**2}
FWH_TUBE_DP_RATIO = 0.96  # 4% feedwater-side drop (`:255-262` analogue)

# extraction topology (`split_fwh_map`, `:461-468`): splitter k -> consumer
#   1->fwh8  2->fwh7  3->fwh6  4->deaerator(+bfpt via outlet_3)
#   5->fwh4  6->fwh3  7->fwh2  8->fwh1
FWH_OF_SPLIT = {1: 8, 2: 7, 3: 6, 5: 4, 6: 3, 7: 2, 8: 1}
SPLIT_OF_FWH = {v: k for k, v in FWH_OF_SPLIT.items()}

# reference initialization split fractions (`:717-724`): Newton start
INIT_FRACS = np.array(
    [0.12812, 0.061824, 0.03815, 0.0381443, 0.017535, 0.0154, 0.00121]
)  # splitter order: s1(fwh8) s2 s3 s5(fwh4) s6 s7 s8
INIT_BFPT = 1.0 - 0.9019 - DEA_SPLIT  # splitter 4 remainder (`:715`)

# concrete-TES initial wall profile (`CONC_TES_DATA`, `:87-91`): linear
# 750 K -> 420 K across the 20 segments
TES_INIT_TEMPERATURE = np.linspace(750.0, 420.0, 20)


class SCPCResult(NamedTuple):
    power_mw: torch.Tensor  # net: sum turbine work - condensate-pump work
    heat_duty_mw: torch.Tensor  # boiler + reheater
    boiler_flow_mol: torch.Tensor
    fracs: torch.Tensor  # (7,) FWH extraction fractions, splitter order
    bfpt_frac: torch.Tensor
    h_fw: torch.Tensor  # (7,) feedwater outlet enthalpies [J/kg], fwh order
    residual: torch.Tensor


_lmtd_underwood = st.lmtd_underwood

# index of each FWH in the h_fw / tube-pressure vectors (fwh1..4, 6..8)
FWH_LIST = (1, 2, 3, 4, 6, 7, 8)
POS_OF_FWH = {f: i for i, f in enumerate(FWH_LIST)}
_UA = np.array([FWH_U[i] * FWH_AREA[i] for i in FWH_LIST])


def _train(P_main):
    """The unknowns-free part of the cycle at throttle pressure `P_main`
    (see the module docstring)."""
    P_main = st._f(P_main, st._dev(P_main))
    dev = P_main.device
    P_in = P_main
    h_in = st.props_vapor(P_in, MAIN_STEAM_T).h
    rh, dh, ext = {}, [], {}
    h_boiler_out = h_in
    for k in range(1, 10):
        if k in RH_DELTAP:
            P2 = P_in - RH_DELTAP[k]
            h2 = st.props_vapor(P2, MAIN_STEAM_T).h
            rh[k] = h2 - h_in
            P_in, h_in = P2, h2
        P_out = RATIO_P[k - 1] * P_in
        # (P, h) expansion: SC stages 8-9 ingest WET steam after the single
        # reheat; the (P, T) form would reset their inlets to dry
        # saturated vapor and overstate the train work
        ex = st.turbine_expansion_ph(P_in, h_in, P_out, TURB_EFF[k - 1])
        dh.append(h_in - ex.h_out)
        h_in, P_in = ex.h_out, P_out
        ext[k] = (h_in, P_out)
    P_cond = P_in  # stage-9 exhaust: the condenser pressure
    P_sh = torch.stack([ext[SPLIT_OF_FWH[i]][1] for i in FWH_LIST])
    P_drain = torch.stack([1.1 * FWH_DRAIN_RATIO[i] * ext[SPLIT_OF_FWH[i]][1]
                           for i in FWH_LIST])
    T_drain = st.sat_temperature(P_drain)
    r = FWH_TUBE_DP_RATIO
    P_lp0 = P_cond + COND_PUMP_DP
    P_hp0 = MAIN_STEAM_P * BFP_P_RATIO  # bfp outlet held at DESIGN pressure
    P_fw_in = torch.stack(
        [P_lp0, P_lp0 * r, P_lp0 * r**2, P_lp0 * r**3]  # fwh1..4
        + [torch.tensor(v, dtype=torch.float64, device=dev)
           for v in (P_hp0, P_hp0 * r, P_hp0 * r**2)]  # fwh6..8
    )
    T_cond = st.sat_temperature(P_cond)
    return {
        "h_main": h_boiler_out,
        "rh": rh,
        "dh": dh,
        "ext_h": {k: v[0] for k, v in ext.items()},
        "P_sh": P_sh,
        "sat_sh": st._sat_hf_hg(P_sh),
        "T_drain": T_drain,
        "hf": st.props_liquid(P_drain, T_drain).h,
        "P_dea": ext[4][1],
        "P_hp0": P_hp0,
        "P_fw_in": P_fw_in,
        "P_fw_out": P_fw_in * r,  # fwh8 outlet = boiler inlet
        "h_cond": st.sat_liquid(P_cond).h,
        "w_cond_spec": st.pump_work(P_cond, P_lp0, T_cond, PUMP_EFF),
        "w_bfpt_spec": st.turbine_expansion_ph(ext[4][1], ext[4][0], P_cond, BFPT_EFF).work,
    }


def _cycle_residuals(x, params):
    """15-equation square system. x = [fracs(7), bfpt_frac, h_fw(7)] with
    h_fw scaled 1e-6 (J/kg -> MJ/kg) for Newton conditioning. Returns
    (residuals, (net_W, Q_rh, h_fw, mflow, h_boiler_out))."""
    tr = params.get("train")
    if tr is None:
        tr = _train(params["P_main"])
    mflow = params["flow_mol"] * MW_H2O
    # optional concrete-TES charge loop (`include_concrete_tes`): hp
    # splitter diverts `tes_split` of the main steam before turbine 1
    # (`:418`), and the TES condensate returns to fwh_mix[7] (`:420`)
    tes_split = params.get("tes_split", 0.0)
    h_tes = params.get("h_tes", 0.0)  # TES charge-outlet enthalpy [J/kg]
    m_tes = mflow * tes_split

    fracs = x[:7]
    f_bfpt = x[7]
    h_fw = x[8:15] * 1e6  # fwh1..4, 6..8 tube-outlet enthalpies [J/kg]

    # ---- turbine train forward pass (mass flows; states from the train)
    split_of_stage = {1: fracs[0], 2: fracs[1], 3: fracs[2],
                      4: DEA_SPLIT + f_bfpt, 5: fracs[3], 6: fracs[4],
                      7: fracs[5], 8: fracs[6]}
    flow = mflow * (1.0 - tes_split)
    W = 0.0
    Q_rh = 0.0
    ext_flow = {}
    for k in range(1, 10):
        if k in tr["rh"]:
            Q_rh = Q_rh + flow * tr["rh"][k]
        W = W + flow * tr["dh"][k - 1]
        if k in split_of_stage:
            ext_flow[k] = flow
            flow = flow * (1.0 - split_of_stage[k])

    # ---- mass bookkeeping ---------------------------------------------
    e = {k: ext_flow[k] * split_of_stage[k] for k in ext_flow}
    e_fwh = {FWH_OF_SPLIT[k]: e[k] for k in FWH_OF_SPLIT}
    e_dea = ext_flow[4] * DEA_SPLIT
    e_bfpt = ext_flow[4] * f_bfpt
    # condensate flow through fwh1..4 = everything reaching the condenser;
    # the HP extractions, deaerator steam and TES condensate bypass it
    cond_flow = mflow - (e_fwh[8] + e_fwh[7] + e_fwh[6] + e_dea + m_tes)
    tube_flow = torch.stack([cond_flow] * 4 + [mflow] * 3)

    # drain cascades (`:536`): HP 8->7->6->deaerator, LP 4->3->2->1->cond;
    # the TES condensate enters at fwh_mix[7] (`:420`)
    drain_hp = {8: e_fwh[8]}
    drain_hp[7] = drain_hp[8] + e_fwh[7] + m_tes
    drain_hp[6] = drain_hp[7] + e_fwh[6]
    drain_lp = {4: e_fwh[4]}
    for i in (3, 2, 1):
        drain_lp[i] = drain_lp[i + 1] + e_fwh[i]
    hf = tr["hf"]  # FWH_LIST order

    # ---- pumps and the feedwater chain ---------------------------------
    w_cond_pump = cond_flow * tr["w_cond_spec"]
    h0 = tr["h_cond"] + tr["w_cond_spec"]
    # deaerator: feed (fwh4 out) + steam + fwh6 drain -> saturated-ish mix
    h_dea_out = (
        cond_flow * h_fw[POS_OF_FWH[4]] + e_dea * tr["ext_h"][4]
        + drain_hp[6] * hf[POS_OF_FWH[6]]
    ) / mflow
    T_liq = st.temperature_ph_liquid(
        torch.cat([tr["P_dea"][None], tr["P_fw_out"]]),
        torch.cat([h_dea_out[None], h_fw]),
    )
    T_dea, T_fw_out = T_liq[0], T_liq[1:]
    w_bfp_spec = st.pump_work(tr["P_dea"], tr["P_hp0"], T_dea, PUMP_EFF)
    w_bfp = mflow * w_bfp_spec
    h_bfp_out = h_dea_out + w_bfp_spec

    h_in_fw = torch.stack([h0, h_fw[0], h_fw[1], h_fw[2], h_bfp_out, h_fw[4], h_fw[5]])

    # ---- FWH residuals: energy balance + UA-LMTD (FWH_LIST order) ------
    zero = torch.zeros_like(mflow)
    p = POS_OF_FWH
    e_i = torch.stack([e_fwh[i] for i in FWH_LIST])
    # fwh1..3 take the LP cascade, fwh6 fwh7's drain, fwh7 fwh8's drain
    # plus the TES condensate (`fwh_mix[7]`); fwh4 and fwh8 take none
    dr_in = torch.stack([drain_lp[2], drain_lp[3], drain_lp[4], zero,
                         drain_hp[7], drain_hp[8] + m_tes, zero])
    h_dr_flow = torch.stack([
        drain_lp[2] * hf[p[2]], drain_lp[3] * hf[p[3]], drain_lp[4] * hf[p[4]], zero,
        drain_hp[7] * hf[p[7]], drain_hp[8] * hf[p[8]] + m_tes * h_tes, zero,
    ])
    h_steam = torch.stack([tr["ext_h"][SPLIT_OF_FWH[i]] for i in FWH_LIST])
    shell_flow = e_i + dr_in
    h_shell_in = (e_i * h_steam + h_dr_flow) / torch.clamp(shell_flow, min=1e-9)
    Tsat, hf_sh, hg_sh = tr["sat_sh"]
    T_in_liq = st.temperature_ph_liquid(
        torch.cat([tr["P_fw_in"], tr["P_sh"]]),
        torch.cat([h_in_fw, torch.minimum(h_shell_in, hf_sh)]),
    )
    T_fw_in, T_sh_liq = T_in_liq[:7], T_in_liq[7:]
    T_sh_vap = st.temperature_ph_vapor(tr["P_sh"], torch.maximum(h_shell_in, hg_sh))
    T_shell_in = torch.where(h_shell_in <= hf_sh, T_sh_liq,
                             torch.where(h_shell_in >= hg_sh, T_sh_vap, Tsat))
    q_shell = shell_flow * (h_shell_in - hf)
    q_tube = tube_flow * (h_fw - h_in_fw)
    scale_q = 1e-7
    res_bal = scale_q * (q_shell - q_tube)
    lmtd = _lmtd_underwood(T_shell_in - T_fw_out, tr["T_drain"] - T_fw_in)
    ua = torch.as_tensor(_UA, dtype=lmtd.dtype, device=lmtd.device)
    res_ua = scale_q * (ua * lmtd - q_tube)

    # ---- BFPT drives the BFP only (`:372-377`) ------------------------
    w_bfpt = e_bfpt * tr["w_bfpt_spec"]
    res_bfpt = scale_q * (w_bfpt - w_bfp)

    net_W = W - w_cond_pump  # `:387-399`: condensate pump is motor-driven
    res = torch.cat([torch.stack([res_bal, res_ua], -1).reshape(-1), res_bfpt[None]])
    return res, (net_W, Q_rh, h_fw, mflow, tr["h_main"])


def _residual_fn(x, params):
    return _cycle_residuals(x, params)[0]


def solve_scpc_cycle(
    P_main: float = MAIN_STEAM_P,
    flow_mol: float = MAIN_FLOW_MOL,
    tol: float = 1e-9,
    max_iter: int = 60,
    tes_split: float = 0.0,
    h_tes: float = 0.0,
    device="cuda",
) -> SCPCResult:
    """Solve the SCPC cycle square system at given throttle (P, flow) on
    `device`. `tes_split`/`h_tes` couple a charge-mode thermal store
    (fraction of main steam diverted before turbine 1; its condensate
    enthalpy)."""
    f64 = dict(dtype=torch.float64, device=device)
    params = {
        "P_main": torch.as_tensor(P_main, **f64),
        "flow_mol": torch.as_tensor(flow_mol, **f64),
        "tes_split": torch.as_tensor(tes_split, **f64),
        "h_tes": torch.as_tensor(h_tes, **f64),
    }
    params["train"] = _train(params["P_main"])
    x0 = torch.cat([
        torch.as_tensor(INIT_FRACS),
        torch.tensor([INIT_BFPT]),
        torch.linspace(0.2, 1.2, 7, dtype=torch.float64),
    ]).to(**f64)
    sol = solve_square(_residual_fn, x0, params=params, tol=tol, max_iter=max_iter)
    _, (W, Q_rh, h_fw, mflow, h_boiler_out) = _cycle_residuals(sol.x, params)
    q_boiler = mflow * (h_boiler_out - h_fw[POS_OF_FWH[8]])
    return SCPCResult(
        power_mw=W / 1e6,
        heat_duty_mw=(q_boiler + Q_rh) / 1e6,
        boiler_flow_mol=params["flow_mol"],
        fracs=sol.x[:7],
        bfpt_frac=sol.x[7],
        h_fw=h_fw,
        residual=sol.kkt_error,
    )


def solve_scpc_with_tes(
    hp_split_fraction: float = 0.1,
    discharge_flow_mol: float = 1.0,
    P_main: float = MAIN_STEAM_P,
    flow_mol: float = MAIN_FLOW_MOL,
    device="cuda",
    **kw,
):
    """SCPC cycle with the concrete-TES charge loop (the reference's
    `include_concrete_tes=True` configuration, golden 625 MW +- 1,
    `test_scpc_flowsheet.py:71`): `hp_split_fraction` of the main steam
    charges the store (`CONC_TES_DATA`, `:78-99`); its condensate returns
    to fwh_mix[7]. The TES hour runs on `device` through the tube-side
    chain kernel there. Returns (SCPCResult, TESHourResult)."""
    from ...units.concrete_tes import ConcreteTES, TESDesign, stream_from_pt

    f64 = dict(dtype=torch.float64, device=device)
    charge = stream_from_pt(torch.as_tensor(flow_mol * hp_split_fraction, **f64),
                            torch.as_tensor(P_main, **f64), MAIN_STEAM_T)
    discharge = stream_from_pt(torch.as_tensor(discharge_flow_mol, **f64),
                               torch.as_tensor(8.5e5, **f64), 355.0)
    tes = ConcreteTES(TESDesign(), mode="combined").hour(
        torch.as_tensor(TES_INIT_TEMPERATURE, **f64), charge=charge, discharge=discharge,
    )
    h_tes = tes.outlet_charge.enth_mol / MW_H2O  # J/mol -> J/kg
    res = solve_scpc_cycle(P_main=P_main, flow_mol=flow_mol, tes_split=hp_split_fraction,
                           h_tes=float(h_tes), device=device, **kw)
    return res, tes
