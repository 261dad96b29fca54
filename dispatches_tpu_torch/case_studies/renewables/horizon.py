"""Wind + battery long-horizon dispatch by time-axis decomposition (port of
`dispatches_tpu/case_studies/renewables/horizon.py`).

The case-study entry of `parallel/time_axis.py`: the per-chunk wind +
battery operating LP with free boundary states (battery SoC and energy
throughput), a warm start of the chunk-boundary consensus from a cheap
time-aggregated monolithic solve, and the ring ADMM, its chunks the lanes
of one batch on one card. It is the fast approximate horizon path: the
objective stalls at the warm start's quality (consensus averaging cannot
discover cross-chunk arbitrage the coarse solve missed; the JAX package
records ~0.3-1% from the monolithic optimum at T = 48 and 1.6-3.2% at
T = 336-672 with 8 chunks). Exact year-scale solves use the banded IPM
(`solvers/structured.py`).

Reference framing: the full-year price-taker chain of
`wind_battery_LMP.py:22-50` / `price_taker_analysis.py:181-224`, which the
reference solves monolithically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...core.model import Model
from ...parallel.time_axis import HorizonSolution, solve_horizon_admm
from ...solvers.ipm import solve_lp
from ...units.battery import BatteryStorage
from ...units.splitter import ElectricalSplitter
from ...units.wind import WindPower
from . import params as P


@dataclasses.dataclass
class WindBatteryChunk:
    """Operational wind + battery dispatch over one horizon chunk with free
    boundary states (fixed design: the tracking / price-taker operating
    mode)."""

    Tc: int
    wind_mw: float = P.FIXED_WIND_MW
    batt_mw: float = 25.0


def _wind_battery_model(m: Model, T: int, spec: WindBatteryChunk, dt: float,
                        free_boundaries: bool):
    """Shared structure of the chunk LP and the coarse warm-start LP."""
    wind = WindPower(m, T, capacity=spec.wind_mw * 1e3, cf_param="wind_cf")
    split = ElectricalSplitter(
        m, T, inlet=wind.electricity_out, outlet_list=["grid", "battery"]
    )
    batt = BatteryStorage(
        m,
        T,
        dt=dt,
        duration=P.BATTERY_DURATION_HRS,
        charging_eta=P.BATTERY_EFF,
        discharging_eta=P.BATTERY_EFF,
        degradation_rate=P.BATTERY_DEGRADATION,
        power_capacity=spec.batt_mw * 1e3,
        initial_soc=None if free_boundaries else 0.0,
        initial_throughput=None if free_boundaries else 0.0,
        periodic_soc=not free_boundaries,
    )
    m.add_eq(batt.elec_in - split.outlets["battery"])
    lmp = m.param("lmp", T)
    revenue = dt * 1e-3 * (lmp * (split.outlets["grid"] + batt.elec_out))
    # degradation cost on the LOCAL throughput delta, the reference's
    # per-block accounting (`wind_battery_LMP.py:136-142`: each hour pays
    # deg*(tp[t] - tp[t-1]); the total telescopes to tp[end] - tp[start])
    tp_start = batt.initial_throughput if free_boundaries else 0.0
    deg_cost = (P.BATT_REP_COST_KWH * P.BATTERY_DEGRADATION) * (
        batt.throughput[T - 1 : T].sum() - tp_start
    )
    profit = revenue.sum() - deg_cost
    m.expression("profit", profit)
    m.minimize(-profit * 1e-5)
    return batt


def build_chunk(spec: WindBatteryChunk):
    """Returns (prog, idx_in, idx_out): the chunk LP and the reduced-column
    indices of its boundary-state copies [soc, throughput]."""
    m = Model("wb_chunk")
    _wind_battery_model(m, spec.Tc, spec, dt=1.0, free_boundaries=True)
    prog = m.build()
    idx_in = np.concatenate(
        [
            prog.col_index("battery.initial_soc"),
            prog.col_index("battery.initial_throughput"),
        ]
    )
    Tc = spec.Tc
    idx_out = np.array(
        [
            prog.col_index("battery.soc")[Tc - 1],
            prog.col_index("battery.throughput")[Tc - 1],
        ]
    )
    return prog, idx_in, idx_out


def coarse_boundary_states(
    spec: WindBatteryChunk,
    lmp: np.ndarray,
    wind_cf: np.ndarray,
    D: int,
    agg: int = 4,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
):
    """Chunk-boundary [SoC, throughput] warm start (D, 2) from a
    time-aggregated monolithic LP (every `agg` hours averaged into one step
    with dt = agg), solved by the dense IPM on `device` in one call."""
    T = len(lmp)
    if T % agg:
        raise ValueError(f"horizon T={T} must be a multiple of agg={agg}")
    Tg = T // agg
    m = Model("wb_coarse")
    _wind_battery_model(m, Tg, spec, dt=float(agg), free_boundaries=False)
    prog = m.build()
    lp = prog.instantiate(
        {
            "lmp": np.asarray(lmp).reshape(Tg, agg).mean(1),
            "wind_cf": np.asarray(wind_cf).reshape(Tg, agg).mean(1),
        },
        dtype=dtype, device=device,
    )
    sol = solve_lp(lp, **solver_kw)
    soc = prog.extract("battery.soc", sol.x).cpu().numpy()
    tp = prog.extract("battery.throughput", sol.x).cpu().numpy()
    Tc = T // D
    # the coarse step holding the last hour of chunk d (its end state)
    bidx = [((d + 1) * Tc - 1) // agg for d in range(D)]
    z0 = np.stack([soc[bidx], tp[bidx]], axis=1)
    z0[-1] = 0.0  # the wrap boundary is pinned anyway
    return torch.as_tensor(z0, dtype=dtype, device=device)


def wind_battery_horizon_solve(
    lmp: np.ndarray,
    wind_cf: np.ndarray,
    n_chunks: int,
    spec: Optional[WindBatteryChunk] = None,
    admm_iters: int = 80,
    rho: float = 1e-5,
    agg: int = 4,
    dtype=torch.float64,
    device="cuda",
    **admm_kw,
) -> HorizonSolution:
    """A long wind + battery horizon by chunked consensus ADMM from a
    coarse-LP warm start: aggregate, warm-start the boundary states, then
    each ADMM sweep one batch of the `n_chunks` chunk solves on `device`
    (the card unless asked otherwise). The solution carries ``program``,
    ``chunk_params`` and ``coarse_seconds`` (the warm start's wall)."""
    import time

    T = len(lmp)
    if T % n_chunks:
        raise ValueError(f"T={T} must divide into {n_chunks} chunks")
    spec = spec or WindBatteryChunk(Tc=T // n_chunks)
    if spec.Tc != T // n_chunks:
        raise ValueError("spec.Tc inconsistent with T/n_chunks")
    prog, idx_in, idx_out = build_chunk(spec)
    t0 = time.perf_counter()
    z0 = coarse_boundary_states(spec, lmp, wind_cf, n_chunks, agg=agg, dtype=dtype,
                                device=device)
    coarse_s = time.perf_counter() - t0
    cp = {
        "lmp": torch.as_tensor(np.asarray(lmp).reshape(n_chunks, spec.Tc), dtype=dtype,
                               device=device),
        "wind_cf": torch.as_tensor(np.asarray(wind_cf).reshape(n_chunks, spec.Tc),
                                   dtype=dtype, device=device),
    }
    sol = solve_horizon_admm(
        prog,
        cp,
        idx_in,
        idx_out,
        rho=rho,
        admm_iters=admm_iters,
        z_fixed=np.zeros(2),
        wrap_free=np.array([False, True]),  # soc periodic, throughput cumulative
        z0=z0,
        adapt_rho=False,  # ramping rho perturbs a good warm start
        dtype=dtype,
        device=device,
        **admm_kw,
    )
    sol.program = prog
    sol.chunk_params = cp
    sol.coarse_seconds = coarse_s
    return sol
