"""Ultra-supercritical steam-cycle NLP, the physics tier behind the map
(port of `dispatches_tpu/case_studies/fossil/usc_nlp.py`).

A reduced re-build of the reference's 1,352-line USC flowsheet
(`ultra_supercritical_powerplant.py:71-1352`) on IF97 steam properties and
the port's Newton solver: the 11-stage turbine train with two reheats, the
nine closed feedwater heaters with UA-LMTD condensing heat transfer and
cascading drains, the deaerator, condensate/booster/boiler-feed pumps, and
the boiler-feed-pump turbine (BFPT) power balance. All fixed data are the
reference's `set_model_input` values (`:714-805`).

The unknowns the reference's IPOPT solve determines (nine FWH extraction
fractions, nine feedwater outlet enthalpies, the BFPT extraction) are a
19-equation square system solved by `solvers/nlp.solve_square`:

  design   : P=31.126 MPa, flow=17,854 mol/s -> power 436.466 MW
  power    : power fixed 300 MW, flow free  -> flow 12,474.473 mol/s
  pressure : flow fixed, P=27 MPa           -> power 446.15 MW, duty 940.4

Evaluation order. The turbine train's states, the extraction pressures,
the drain saturation states, the BFPT expansion and the pumps' constant
parts depend on the throttle pressure alone, not on the unknowns: `_train`
evaluates them once per solve and `_cycle_residuals` takes them from
``params["train"]`` (evaluating them itself when absent). The nine FWHs'
inversions are tensor axes (one liquid Newton over the 9 feedwater
outlets and the deaerator, one over the 9 feedwater inlets and the shell
inlets' liquid branch, one vapor Newton over the shell inlets). The
residuals are those of the JAX package's per-FWH loop, in its order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...properties import steam as st
from ...properties.steam import MW_H2O
from ...solvers.nlp import solve_square

# ---- reference data (`set_model_input`, `:714-805`) ----------------------
MAIN_FLOW_MOL = 17854.0
MAIN_STEAM_P = 31125980.0
MAIN_STEAM_T = 866.15
RATIO_P = np.array(
    [0.388, 0.774, 0.498, 0.609, 0.523, 0.495, 0.514, 0.389, 0.572, 0.476, 0.204]
)
TURB_EFF = np.array(
    [0.94, 0.94, 0.94, 0.94, 0.88, 0.88, 0.78, 0.78, 0.78, 0.78, 0.78]
)
RH_DELTAP = {3: 742845.0, 5: 210952.0}  # reheater before stages 3 and 5
DEA_SPLIT = 0.017885  # deaerator extraction (splitter 5, fixed, `:771`)
COND_PUMP_DP = 2313881.0
BOOSTER_DP = 5715067.0
BFP_P_RATIO = 1.1231  # bfp outlet = main steam pressure * ratio (`:774`)
PUMP_EFF = 0.8
CONDENSER_P = 6896.0  # Pa (`:945`)
FWH_AREA = {1: 250.0, 2: 195.0, 3: 164.0, 4: 208.0, 5: 152.0,
            6: 207.0, 7: 202.0, 8: 715.0, 9: 175.0}
FWH_U = 3000.0  # W/m^2/K
# shell-side (drain) outlet pressure: 1.1 * ratio * (P_ext - rh_diff)
# (`fwh_s1pdrop_constraint`, `:292-357`); drains leave SATURATED there
FWH_DRAIN_RATIO = {1: 0.204, 2: 0.476, 3: 0.572, 4: 0.389, 5: 0.514,
                   6: 0.523, 7: 0.609, 8: 0.498, 9: 0.774}
FWH_DRAIN_DIFF = {6: 210952.0, 8: 742845.0}
FWH_TUBE_DP_RATIO = 0.96  # 4% feedwater-side drop (`fwh_s2pdrop_constraint`)

# extraction topology (arcs `:424-711`): splitter k -> consumer
#   1->fwh9  2->fwh8  3->fwh7  4->fwh6  5->deaerator
#   6(out2)->fwh5  6(out3)->bfpt  7->fwh4  8->fwh3  9->fwh2  10->fwh1
FWH_OF_SPLIT = {1: 9, 2: 8, 3: 7, 4: 6, 6: 5, 7: 4, 8: 3, 9: 2, 10: 1}
SPLIT_OF_FWH = {v: k for k, v in FWH_OF_SPLIT.items()}

# reference initialization estimates (`:857-866`): Newton starting point
INIT_FRACS = np.array(
    [0.073444, 0.140752, 0.032816, 0.012425, 0.081155,
     0.036058, 0.026517, 0.029888, 0.003007]
)  # fwh9, fwh8, fwh7, fwh6, fwh5, fwh4, fwh3, fwh2, fwh1 (splitter order)
INIT_BFPT = 0.091274

_FWHS = range(1, 10)
_AREA = np.array([FWH_AREA[i] for i in _FWHS])


class CycleResult(NamedTuple):
    power_mw: torch.Tensor  # -sum(turbine work) / 1e6, bfpt excluded
    heat_duty_mw: torch.Tensor  # boiler + both reheaters
    boiler_flow_mol: torch.Tensor
    fracs: torch.Tensor  # (9,) FWH extraction fractions, splitter order
    bfpt_frac: torch.Tensor
    h_fw: torch.Tensor  # (9,) feedwater outlet enthalpies [J/kg], fwh1..fwh9
    residual: torch.Tensor


_lmtd_underwood = st.lmtd_underwood


def _train(P_main):
    """The unknowns-free part of the cycle at throttle pressure `P_main`:
    the turbine train's per-stage states and specific works, the reheat
    pickups, the extraction states, the drain saturation states, the
    shell-side saturation state, the BFPT's specific work and the pumps'
    constant parts."""
    P_main = st._f(P_main, st._dev(P_main))
    dev = P_main.device
    P_in = P_main
    h_in = st.props_vapor(P_in, MAIN_STEAM_T).h
    T_in = MAIN_STEAM_T
    rh, dh, ext = {}, [], {}
    h_boiler_out = h_in
    for k in range(1, 12):
        if k in RH_DELTAP:
            P2 = P_in - RH_DELTAP[k]
            h2 = st.props_vapor(P2, MAIN_STEAM_T).h
            rh[k] = h2 - h_in
            P_in, h_in, T_in = P2, h2, MAIN_STEAM_T
        P_out = RATIO_P[k - 1] * P_in
        ex = st.turbine_expansion(P_in, T_in, P_out, TURB_EFF[k - 1])
        dh.append(h_in - ex.h_out)
        h_in, T_in, P_in = ex.h_out, ex.T_out, P_out
        ext[k] = (h_in, P_out, T_in)
    P_sh = torch.stack([ext[SPLIT_OF_FWH[i]][1] for i in _FWHS])
    P_drain = torch.stack([
        1.1 * FWH_DRAIN_RATIO[i] * (ext[SPLIT_OF_FWH[i]][1] - FWH_DRAIN_DIFF.get(i, 0.0))
        for i in _FWHS
    ])
    T_drain = st.sat_temperature(P_drain)
    P_dea = ext[5][1]
    r = FWH_TUBE_DP_RATIO
    P_lp0 = CONDENSER_P + COND_PUMP_DP
    P_ip0 = P_dea + BOOSTER_DP
    P_hp0 = MAIN_STEAM_P * BFP_P_RATIO  # bfp outlet held at DESIGN pressure
    P_fw_in = torch.stack([
        torch.tensor(v, dtype=torch.float64, device=dev)
        for v in (P_lp0, P_lp0 * r, P_lp0 * r**2, P_lp0 * r**3, P_lp0 * r**4)
    ] + [P_ip0, P_ip0 * r] + [
        torch.tensor(v, dtype=torch.float64, device=dev) for v in (P_hp0, P_hp0 * r)
    ])
    T_cond = st.sat_temperature(CONDENSER_P)
    w_cond_spec = st.pump_work(CONDENSER_P, P_lp0, T_cond, PUMP_EFF)
    return {
        "h_main": h_boiler_out,
        "rh": rh,
        "dh": dh,
        "ext_h": {k: v[0] for k, v in ext.items()},
        "P_sh": P_sh,
        "sat_sh": st._sat_hf_hg(P_sh),
        "T_drain": T_drain,
        "hf": st.props_liquid(P_drain, T_drain).h,
        "P_dea": P_dea,
        "P_ip0": P_ip0,
        "P_hp0": P_hp0,
        "P_fw_in": P_fw_in,
        "P_fw_out": P_fw_in * r,  # fwh9 outlet = boiler inlet (32.2 MPa, `:844`)
        "h_cond": st.sat_liquid(CONDENSER_P).h.to(dev),
        "w_cond_spec": w_cond_spec.to(dev),
        "w_bfpt_spec": st.turbine_expansion(ext[6][1], ext[6][2], CONDENSER_P, PUMP_EFF).work,
    }


def _cycle_residuals(x, params):
    """The 19-equation square system. x = [fracs(9), bfpt_frac, h_fw(9)]
    with h_fw scaled by 1e-6 (J/kg -> MJ/kg) for Newton conditioning.
    Returns (residuals, (W, Q_rh, h_fw, mflow, h_boiler_out))."""
    tr = params.get("train")
    if tr is None:
        tr = _train(params["P_main"])
    mflow = params["flow_mol"] * MW_H2O

    fracs = x[:9]  # splitter order: s1(fwh9) s2 s3 s4 s6_2(fwh5) s7 s8 s9 s10
    f_bfpt = x[9]
    h_fw = x[10:19] * 1e6  # fwh1..fwh9 tube-outlet enthalpies [J/kg]

    # ---- turbine train forward pass (mass flows; states from the train)
    split_of_stage = {1: fracs[0], 2: fracs[1], 3: fracs[2], 4: fracs[3],
                      5: DEA_SPLIT, 6: fracs[4] + f_bfpt, 7: fracs[5],
                      8: fracs[6], 9: fracs[7], 10: fracs[8]}
    flow = mflow
    W = 0.0
    Q_rh = 0.0
    ext_flow = {}
    for k in range(1, 12):
        if k in tr["rh"]:
            Q_rh = Q_rh + flow * tr["rh"][k]
        W = W + flow * tr["dh"][k - 1]
        if k in split_of_stage:
            ext_flow[k] = flow
            flow = flow * (1.0 - split_of_stage[k])

    # ---- mass bookkeeping ---------------------------------------------
    e = {k: ext_flow[k] * split_of_stage[k] for k in ext_flow}
    e_fwh = {FWH_OF_SPLIT[k]: e[k] for k in FWH_OF_SPLIT}
    # splitter 6 feeds BOTH fwh5 (outlet_2) and the bfpt (outlet_3)
    e_fwh[5] = ext_flow[6] * fracs[4]
    e_bfpt = ext_flow[6] * f_bfpt
    e_dea = e[5]
    # condensate (fwh1-5 tube flow) = everything that reaches the condenser
    cond_flow = mflow - (e_fwh[9] + e_fwh[8] + e_fwh[7] + e_fwh[6] + e_dea)
    tube_flow = torch.stack([cond_flow] * 5 + [mflow] * 4)  # fwh1..fwh9

    # drain cascades: HP group 9->8->7->6->deaerator, LP group 5->4->3->2->1
    drain_hp = {9: e_fwh[9]}
    for i in (8, 7, 6):
        drain_hp[i] = drain_hp[i + 1] + e_fwh[i]
    drain_lp = {5: e_fwh[5]}
    for i in (4, 3, 2, 1):
        drain_lp[i] = drain_lp[i + 1] + e_fwh[i]
    hf = tr["hf"]

    # ---- pumps and the feedwater chain ---------------------------------
    w_cond_pump = cond_flow * tr["w_cond_spec"]
    h0 = tr["h_cond"] + tr["w_cond_spec"]
    h_dea_out = (
        cond_flow * h_fw[4] + e_dea * tr["ext_h"][5] + drain_hp[6] * hf[5]
    ) / mflow
    # deaerator outlet and the nine feedwater outlets in one inversion;
    # the BFP inlet is fwh7's outlet
    T_liq = st.temperature_ph_liquid(
        torch.cat([tr["P_dea"][None], tr["P_fw_out"]]),
        torch.cat([h_dea_out[None], h_fw]),
    )
    T_dea, T_fw_out = T_liq[0], T_liq[1:]
    w_boost_spec = st.pump_work(tr["P_dea"], tr["P_ip0"], T_dea, PUMP_EFF)
    w_booster = mflow * w_boost_spec
    h_booster_out = h_dea_out + w_boost_spec
    w_bfp_spec = st.pump_work(tr["P_fw_out"][6], tr["P_hp0"], T_fw_out[6], PUMP_EFF)
    w_bfp = mflow * w_bfp_spec
    h_bfp_out = h_fw[6] + w_bfp_spec

    h_in_fw = torch.stack([h0, h_fw[0], h_fw[1], h_fw[2], h_fw[3],  # fwh1..5
                           h_booster_out, h_fw[5],  # fwh6, fwh7
                           h_bfp_out, h_fw[7]])  # fwh8, fwh9

    # ---- FWH residuals: energy balance + UA-LMTD (FWH i on axis i-1) ---
    zero = torch.zeros_like(mflow)
    e_i = torch.stack([e_fwh[i] for i in _FWHS])
    dr_in = torch.stack([drain_lp[i + 1] if i in (4, 3, 2, 1) else
                         drain_hp[i + 1] if i in (8, 7, 6) else zero for i in _FWHS])
    h_dr = torch.cat([hf[1:5], zero[None], hf[6:9], zero[None]])
    h_steam = torch.stack([tr["ext_h"][SPLIT_OF_FWH[i]] for i in _FWHS])
    shell_flow = e_i + dr_in
    h_shell_in = (e_i * h_steam + dr_in * h_dr) / torch.clamp(shell_flow, min=1e-9)
    # the shell inlets' T(P, h): liquid branch beside the feedwater inlets
    Tsat, hf_sh, hg_sh = tr["sat_sh"]
    T_in_liq = st.temperature_ph_liquid(
        torch.cat([tr["P_fw_in"], tr["P_sh"]]),
        torch.cat([h_in_fw, torch.minimum(h_shell_in, hf_sh)]),
    )
    T_fw_in, T_sh_liq = T_in_liq[:9], T_in_liq[9:]
    T_sh_vap = st.temperature_ph_vapor(tr["P_sh"], torch.maximum(h_shell_in, hg_sh))
    T_shell_in = torch.where(h_shell_in <= hf_sh, T_sh_liq,
                             torch.where(h_shell_in >= hg_sh, T_sh_vap, Tsat))
    q_shell = shell_flow * (h_shell_in - hf)
    q_tube = tube_flow * (h_fw - h_in_fw)
    scale_q = 1e-7
    res_bal = scale_q * (q_shell - q_tube)
    lmtd = _lmtd_underwood(T_shell_in - T_fw_out, tr["T_drain"] - T_fw_in)
    area = torch.as_tensor(_AREA, dtype=lmtd.dtype, device=lmtd.device)
    res_ua = scale_q * (FWH_U * area * lmtd - q_tube)

    # ---- BFPT drives ALL pumps (`constraint_bfp_power`, `:372-377`) ---
    w_bfpt = e_bfpt * tr["w_bfpt_spec"]
    res_bfpt = scale_q * (w_bfpt - (w_bfp + w_booster + w_cond_pump))

    res = torch.cat([torch.stack([res_bal, res_ua], -1).reshape(-1), res_bfpt[None]])
    return res, (W, Q_rh, h_fw, mflow, tr["h_main"])


def _residual_fn(x, params):
    return _cycle_residuals(x, params)[0]


def _x0(dev):
    return torch.cat([
        torch.as_tensor(INIT_FRACS),
        torch.tensor([INIT_BFPT]),
        # feedwater enthalpy ramp guess: condenser to near-boiler
        torch.linspace(0.2, 1.2, 9, dtype=torch.float64),
    ]).to(device=dev, dtype=torch.float64)


def solve_usc_cycle(
    P_main: float = MAIN_STEAM_P,
    flow_mol: float = MAIN_FLOW_MOL,
    tol: float = 1e-9,
    max_iter: int = 60,
    device="cuda",
) -> CycleResult:
    """Solve the USC cycle square system at given throttle (P, flow) on
    `device`."""
    f64 = dict(dtype=torch.float64, device=device)
    params = {"P_main": torch.as_tensor(P_main, **f64),
              "flow_mol": torch.as_tensor(flow_mol, **f64)}
    params["train"] = _train(params["P_main"])
    sol = solve_square(_residual_fn, _x0(device), params=params, tol=tol, max_iter=max_iter)
    _, (W, Q_rh, h_fw, mflow, h_boiler_out) = _cycle_residuals(sol.x, params)
    # boiler duty: feedwater (fwh9 out) to main steam, plus the reheats
    q_boiler = mflow * (h_boiler_out - h_fw[8])
    return CycleResult(
        power_mw=W / 1e6,
        heat_duty_mw=(q_boiler + Q_rh) / 1e6,
        boiler_flow_mol=params["flow_mol"],
        fracs=sol.x[:9],
        bfpt_frac=sol.x[9],
        h_fw=h_fw,
        residual=sol.kkt_error,
    )


def solve_usc_for_power(
    power_mw: float,
    P_main: float = MAIN_STEAM_P,
    tol: float = 1e-9,
    max_iter: int = 60,
    device="cuda",
):
    """Fix plant power, free boiler flow (test_change_power mode): one
    outer Newton on the monotone power(flow) map around the cycle solve."""
    flow = MAIN_FLOW_MOL * power_mw / 436.5  # proportional start

    def power_of(fl):
        return float(solve_usc_cycle(P_main, fl, tol, max_iter, device=device).power_mw)

    for _ in range(8):
        p = power_of(flow)
        dp = (power_of(flow * 1.001) - p) / (flow * 0.001)
        step = (power_mw - p) / dp
        flow = flow + step
        if abs(step) < 1e-4 * flow:
            break
    return flow, solve_usc_cycle(P_main, flow, tol, max_iter, device=device)


def derive_performance_map(points=(0.65, 0.8, 0.9, 1.0), device="cuda"):
    """Re-derive the dispatch-layer map constants (usc_plant.py) from the
    NLP: max power / max duty at design flow, and the linear duty(power)
    relation across the operating range."""
    sols = [solve_usc_cycle(flow_mol=MAIN_FLOW_MOL * f, device=device) for f in points]
    powers = np.array([float(s.power_mw) for s in sols])
    duties = np.array([float(s.heat_duty_mw) for s in sols])
    slope, intercept = np.polyfit(powers, duties, 1)
    return {
        "max_power_mw": powers[-1],
        "max_duty_mw": duties[-1],
        "duty_slope": slope,
        "duty_intercept": intercept,
        "powers": powers,
        "duties": duties,
    }
