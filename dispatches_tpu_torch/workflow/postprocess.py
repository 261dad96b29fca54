"""Simulation-output readers + revenue/NPV post-processing.

The analogue of `renewables_case/double_loop_utils.py:21-341` and
`utils.py:32-351`: the reference reads Prescient's CSV dumps back into
DataFrames and computes settlement revenue/NPV summaries. Here the simulator
is in-framework (`market/network.py` / `market/simulator.py`), so the
readers consume its result rows (or CSVs written from them) and the same
summaries come out as plain dicts/arrays.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..case_studies.renewables import params as P


def results_to_csv(results: List[dict], path: str):
    """Persist simulator result rows (the Prescient output-CSV analogue)."""
    if not results:
        raise ValueError("no results to write")
    keys = list(results[0])
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(results)


def read_results_csv(path: str) -> List[dict]:
    """Read rows back, parsing numerics (the `read_prescient_file` analogue,
    `double_loop_utils.py:21-33`)."""
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            parsed = {}
            for k, v in row.items():
                try:
                    parsed[k] = float(v)
                except (TypeError, ValueError):
                    parsed[k] = v
            out.append(parsed)
    return out


def gen_outputs(results: List[dict], lmp_key: str = "LMP") -> Dict[str, np.ndarray]:
    """Column-extract a participant's hourly series from simulator rows
    (`prescient_outputs_for_gen`, `double_loop_utils.py:176-205`)."""
    def col(key, default=0.0):
        return np.array([float(r.get(key, default)) for r in results])

    out = {
        "lmp": col(lmp_key) if results and lmp_key in results[0] else None,
        "dispatch_mw": col("Dispatch [MW]")
        if results and "Dispatch [MW]" in results[0]
        else col("Participant [MW]"),
        "delivered_mw": col("Delivered [MW]")
        if results and "Delivered [MW]" in results[0]
        else None,
    }
    return out


def summarize_revenue(
    results: List[dict],
    lmp_key: str = "LMP",
    dispatch_key: Optional[str] = None,
    cap_lmp: Optional[float] = None,
) -> dict:
    """Energy-market settlement summary (`utils.py:121-204`): sum of
    hourly LMP x delivered MW, with the optional LMP cap of the reference's
    `cap_rt_lmp` path."""
    if dispatch_key is None:
        dispatch_key = (
            "Delivered [MW]" if results and "Delivered [MW]" in results[0]
            else "Participant [MW]"
        )
    lmps = np.array([float(r[lmp_key]) for r in results])
    if cap_lmp is not None:
        lmps = np.minimum(lmps, cap_lmp)
    mw = np.array([float(r[dispatch_key]) for r in results])
    rev = float(np.sum(lmps * mw))
    return {
        "total_revenue": rev,
        "mean_lmp": float(lmps.mean()),
        "total_mwh": float(mw.sum()),
        "capacity_factor_hours": int(len(results)),
    }


def summarize_h2_revenue(
    pem_dispatch_kw: Sequence[float],
    pem_size_kw: float,
    h2_price_per_kg: float,
) -> dict:
    """H2 side revenue (`summarize_H2_revenue`, `utils.py:238-273`): PEM
    electricity -> kg H2 at the fixed conversion -> $."""
    from ..units.pem import DEFAULT_ELECTRICITY_TO_MOL

    e = np.asarray(pem_dispatch_kw, float)
    kg = e * DEFAULT_ELECTRICITY_TO_MOL * 3600.0 / P.H2_MOLS_PER_KG
    return {
        "h2_kg": float(kg.sum()),
        "h2_revenue": float(kg.sum() * h2_price_per_kg),
        "pem_capacity_factor": float(e.mean() / pem_size_kw) if pem_size_kw else 0.0,
    }


def calculate_npv(
    annual_revenue: float,
    wind_size_mw: float,
    battery_size_mw: float,
    duration: float = 4.0,
    extant_wind: bool = True,
    om_cost: bool = True,
) -> dict:
    """NPV roll-up from an annual revenue figure (`calculate_NPV`,
    `utils.py:274-325`), using the shared cost tables (params.py)."""
    wind_kw = wind_size_mw * 1e3
    batt_kw = battery_size_mw * 1e3
    capex = (P.BATT_CAP_COST_KW + P.BATT_CAP_COST_KWH * duration) * batt_kw
    if not extant_wind:
        capex += P.WIND_CAP_COST * wind_kw
    fixed_om = 0.0
    if om_cost:
        fixed_om = P.WIND_OP_COST * wind_kw + P.BATT_OP_COST * batt_kw
    npv = -capex + P.PA * (annual_revenue - fixed_om)
    return {
        "NPV": float(npv),
        "capex": float(capex),
        "annual_fixed_om": float(fixed_om),
        "annualized_revenue": float(annual_revenue),
    }


# ------------------------------------------------------ real-Prescient CSVs
def read_prescient_datetime_csv(path: str) -> Dict[str, np.ndarray]:
    """One Prescient output CSV (`bus_detail.csv`, `thermal_detail.csv`,
    `renewables_detail.csv`, `hourly_summary.csv`, ...) -> column arrays
    keyed by header, plus a "Datetime" key of ISO strings assembled from
    the Date/Hour[/Minute] columns (`double_loop_utils.py:21-33`
    behavior). Numeric columns parse to float arrays; labels stay str."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    out: Dict[str, np.ndarray] = {}
    have_minute = "Minute" in rows[0]
    dts = []
    for r in rows:
        minute = int(float(r.get("Minute", 0) or 0)) if have_minute else 0
        dts.append(f"{r['Date']} {int(float(r['Hour'])):02d}:{minute:02d}")
    out["Datetime"] = np.asarray(dts)
    for key in rows[0]:
        if key in ("Date", "Hour", "Minute"):
            continue
        vals = [r[key] for r in rows]
        # label columns stay strings even when their values look numeric
        # (datasets with numeric bus/generator ids must still match by
        # string equality downstream)
        if key in ("Generator", "Bus"):
            out[key] = np.asarray(vals)
            continue
        try:
            # empty/missing cells become NaN, not 0.0: a silent zero in an
            # LMP or dispatch column fabricates a price/quantity; NaN
            # propagates into any aggregate so the gap is visible to the
            # consumer. `v is None` covers DictReader's restval for ragged
            # rows.
            out[key] = np.asarray(
                [
                    float(v) if (v is not None and str(v).strip()) else float("nan")
                    for v in vals
                ]
            )
        except (ValueError, TypeError):
            out[key] = np.asarray(vals)
    return out


def read_prescient_output_dir(
    output_dir: str,
    gen_name: str,
    bus: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Hourly series for ONE generator from a real Prescient output
    directory (the task of `prescient_outputs_for_gen`,
    `double_loop_utils.py:176-206`): generator dispatch/revenue columns
    from thermal_detail.csv + renewables_detail.csv (whichever carries the
    generator — the double loop may register a wind plant as thermal),
    merged with its bus's LMP series from bus_detail.csv on Datetime.

    `bus` may be omitted only when bus_detail.csv has a single bus; with
    several buses an explicit (existing) name is required — guessing the
    bus would silently price the generator at the wrong node. Every
    lookup failure raises: a missing LMP column, a bus_detail timestamp
    grid that doesn't cover the generator's hours, or a `bus` argument
    the file cannot be filtered by."""
    if gen_name is None:
        raise ValueError("gen_name is required (one generator per call)")
    gen_cols: Dict[str, np.ndarray] = {}
    # one source table per generator — a double-loop plant registered as
    # thermal reads from thermal_detail only; mixing two tables filtered
    # by different masks would misalign columns
    for fname in ("thermal_detail.csv", "renewables_detail.csv"):
        p = os.path.join(output_dir, fname)
        if not os.path.exists(p):
            continue
        tab = read_prescient_datetime_csv(p)
        if not tab or "Generator" not in tab:
            continue
        mask = tab["Generator"] == gen_name
        if not mask.any():
            continue
        gen_cols = {k: v[mask] for k, v in tab.items()}
        break
    if not gen_cols:
        raise FileNotFoundError(
            f"generator {gen_name!r} not found in thermal/renewables detail "
            f"under {output_dir}"
        )

    bus_p = os.path.join(output_dir, "bus_detail.csv")
    if bus is not None and not os.path.exists(bus_p):
        raise FileNotFoundError(
            f"bus= was given but {bus_p} does not exist — no LMPs to merge"
        )
    if os.path.exists(bus_p):
        bt = read_prescient_datetime_csv(bus_p)
        if bus is not None and "Bus" not in bt:
            raise ValueError(
                "bus= was given but bus_detail.csv has no 'Bus' column"
            )
        buses = np.unique(bt["Bus"]) if "Bus" in bt else np.zeros(0)
        if bus is None:
            if len(buses) > 1:
                raise ValueError(
                    f"bus_detail.csv has {len(buses)} buses "
                    f"({', '.join(map(str, buses))}); pass bus= explicitly"
                )
        else:
            mask = bt["Bus"] == bus
            if not mask.any():
                raise ValueError(
                    f"bus {bus!r} not in bus_detail.csv "
                    f"(buses: {', '.join(map(str, buses))})"
                )
            bt = {k: v[mask] for k, v in bt.items()}
        for col, key in (("LMP", "LMP"), ("LMP DA", "LMP DA")):
            if col not in bt:
                raise ValueError(f"bus_detail.csv has no {col!r} column")
            of_dt = dict(zip(bt["Datetime"], bt[col]))
            missing = [d for d in gen_cols["Datetime"] if d not in of_dt]
            if missing:
                raise ValueError(
                    f"bus_detail.csv does not cover {len(missing)} of the "
                    f"generator's timestamps (first: {missing[0]!r}) — "
                    "mixed time resolutions?"
                )
            gen_cols[key] = np.asarray(
                [float(of_dt[d]) for d in gen_cols["Datetime"]]
            )
    return gen_cols
