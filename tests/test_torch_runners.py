"""Port parity: the year-sweep runner (`dispatches_tpu_torch/workflow/
runners.py`) against the JAX package's, and the port's independence from
JAX and from the JAX package. The sweeps' checkpoints and the battery
sweep are in `test_torch_checkpoints.py`.
"""
import inspect
import re
from pathlib import Path

import pytest

from dispatches_tpu.workflow.runners import run_year_sweep as j_run_year_sweep
from dispatches_tpu_torch.workflow import runners as T

ROOT = Path(__file__).resolve().parents[1]


def test_year_sweep_matches_jax():
    """Two 96-h scenarios in one batch with the JAX package's precision
    tier (f32 factorization): the same seeded LMP scales, the same NPVs
    (rel 1e-3) and convergence, lane by lane."""
    want = j_run_year_sweep(scenarios=2, batch=2, hours=96, verbose=False)
    got = T.run_year_sweep(scenarios=2, batch=2, hours=96, verbose=False,
                           device="cpu", factor_dtype="float32")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["scenario"] == w["scenario"]
        assert g["lmp_scale"] == w["lmp_scale"]
        assert g["converged"] == w["converged"] is True
        assert g["iterations"] == w["iterations"]
        assert g["NPV"] == pytest.approx(w["NPV"], rel=1e-3)
        assert g["batch_seconds"] > 0
    # `cost=` is taken now and off by default (its records are checked in
    # tests/test_torch_journal.py and tests/test_torch_perf_cost.py): the
    # records above carry none
    assert inspect.signature(T.run_year_sweep).parameters["cost"].default is False
    assert not any("cost" in g for g in got)


def test_year_sweep_default_meets_highs():
    """The port's default tier (f64 factorization in 2 SPIKE slabs here,
    f32 swept factors, tol 1e-8) holds every lane to 1e-3 of HiGHS —
    measured ~1e-7, where the f32-factored tier stops at its f32 Cholesky
    breakdown ~6e-3 away."""
    import numpy as np
    import torch

    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.solvers.reference import solve_lp_scipy_sparse

    hours = 96
    got = T.run_year_sweep(scenarios=2, batch=2, hours=hours, verbose=False, device="cpu")
    prog, _ = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    data = P.load_rts303()
    for rec in got:
        assert rec["converged"]
        params = {"lmp": rec["lmp_scale"] * np.resize(data["da_lmp"], hours),
                  "wind_cf": np.resize(data["da_wind_cf"], hours)}
        res = solve_lp_scipy_sparse(prog, params)
        want = float(prog.eval_expr("NPV", torch.as_tensor(res.x), params))
        assert rec["NPV"] == pytest.approx(want, rel=1e-3)


def test_year_sweep_takes_the_fused_kernel_whenever_factors_are_f32():
    import torch

    kw = T.year_sweep_solver_kw(torch.float64, Tb=365)
    assert kw["sweep_backend"] == "fused"
    assert kw["chol_dtype"] == torch.float32 and kw["factor_dtype"] == torch.float64
    assert kw["slabs"] == 5 and T.spike_slabs(4) == 2 and T.spike_slabs(7) is None
    assert "slabs" not in T.year_sweep_solver_kw(torch.float64, factor_dtype="float32", Tb=365)
    assert T.year_sweep_solver_kw(torch.float64, factor_dtype="float32")["sweep_backend"] == "fused"
    assert T.year_sweep_solver_kw(torch.float32)["sweep_backend"] == "fused"
    assert T.year_sweep_solver_kw(torch.float64, mixed_precision=False)["sweep_backend"] == "scan"


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = sorted(
        p for p in (ROOT / "dispatches_tpu_torch").rglob("*.py")
        if "_build" not in p.parts  # kernel build outputs, git-ignored
    )
    sources += [ROOT / "chip_smoke.py"] + [
        ROOT / "tools" / f"{name}.py"
        for name in ("torch_replay_solve", "torch_serve_dispatch", "torch_loadgen",
                     "torch_banded_precision", "torch_capacity_plan", "torch_bench_history")
    ]
    assert len(sources) > 10
    found = {p.relative_to(ROOT).as_posix() for p in sources}
    for name in ("__init__", "network", "contingency", "tracker", "coordinator", "stochastic",
                 "double_loop", "bidder", "forecaster", "simulator", "model_data"):
        assert f"dispatches_tpu_torch/market/{name}.py" in found, name
    for name in ("options", "postprocess", "rts_gmlc", "workflow", "runners"):
        assert f"dispatches_tpu_torch/workflow/{name}.py" in found, name
    # the steam and NLP half of the case studies; units/concrete_tes.py is
    # also the wrapper of csrc/tes_chain.cu
    for name in ("properties/steam", "properties/salts", "solvers/nlp",
                 "case_studies/rankine/__init__", "case_studies/rankine/flowsheet",
                 "case_studies/rankine/stochastic", "case_studies/fossil/__init__",
                 "case_studies/fossil/usc_plant", "case_studies/fossil/usc_nlp",
                 "units/concrete_tes", "case_studies/fossil/scpc_nlp",
                 "case_studies/fossil/multiperiod", "case_studies/fossil/pricetaker",
                 "case_studies/fossil/superstructure", "_nvcc"):
        assert f"dispatches_tpu_torch/{name}.py" in found, name
    # the nuclear and solar-hydrogen cases, the detailed tank and the
    # market-surrogate pillar
    for name in ("mp/multiperiod", "units/tank_detailed", "case_studies/nuclear/__init__",
                 "case_studies/nuclear/flowsheet", "case_studies/nuclear/pricetaker",
                 "case_studies/nuclear/multiperiod", "case_studies/nuclear/tea",
                 "case_studies/nuclear/conceptual_design",
                 "case_studies/renewables/solar_hydrogen",
                 "case_studies/renewables/conceptual_design",
                 "case_studies/rankine/surrogate_design", "tea/npv", "tea/arma",
                 "tea/syn_hist", "surrogates/__init__", "surrogates/clustering",
                 "surrogates/data", "surrogates/train", "surrogates/embed"):
        assert f"dispatches_tpu_torch/{name}.py" in found, name
    # the capacity plane, the probe and cost records, the bench history and
    # the horizon decomposition
    for name in ("obs/signals", "obs/capacity", "obs/benchstore", "obs/cost", "obs/perf",
                 "parallel/__init__", "parallel/mesh", "parallel/time_axis",
                 "case_studies/renewables/horizon"):
        assert f"dispatches_tpu_torch/{name}.py" in found, name
    assert (ROOT / "dispatches_tpu_torch" / "csrc" / "tes_chain.cu").exists()
    bad = re.compile(
        r"^\s*(?:import|from)\s+jax\b"  # jax itself
        r"|^\s*(?:import|from)\s+dispatches_tpu\b"  # the JAX package ...
        r"|\bdispatches_tpu\.",  # ... or any dotted use of it
        re.M,
    )
    for path in sources:
        text = path.read_text()
        hits = [m.group(0) for m in bad.finditer(text)]
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"

