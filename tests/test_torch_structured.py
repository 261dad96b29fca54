"""Port parity: the block-tridiagonal banded IPM (`dispatches_tpu_torch/
solvers/structured.py`) against the JAX package's, on the flagship design LP
at T=120 (5 day-blocks) and T=240 (10).

The mixed-precision case runs the port's "fused" sweep backend, which on
CPU tensors is the chain-sweep kernel's plain version, against the JAX
package's "pallas" backend under the Pallas interpreter.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.case_studies.renewables.pricetaker import (
    HybridDesign as JHybridDesign,
    build_pricetaker as j_build,
)
from dispatches_tpu.solvers import structured as JS
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu_torch.convert import banded_lp_from_numpy
from dispatches_tpu_torch.runtime.adaptive import solve_lp_banded_adaptive
from dispatches_tpu_torch.solvers import structured as TS

DATA = JP.load_rts303()
DESIGN = dict(
    with_battery=True, with_pem=True, design_opt=True,
    h2_price_per_kg=2.5, initial_soc_fixed=None,
)
MIXED = dict(kkt_refine=1, tol=1e-7, max_iter=40)


def _case(T):
    p = _params(T)
    jprog, _ = j_build(JHybridDesign(T=T, **DESIGN))
    jmeta = JS.extract_time_structure(jprog, T, block_hours=24)
    jblp = jmeta.instantiate({k: jnp.asarray(v) for k, v in p.items()})
    tprog, _ = build_pricetaker(HybridDesign(T=T, **DESIGN))
    tmeta = TS.extract_time_structure(tprog, T, block_hours=24)
    tblp = tmeta.instantiate(p, device="cpu")
    return jmeta, jblp, tmeta, tblp


@pytest.fixture(scope="module")
def case120():
    return _case(120)


def _params(T):
    return {"lmp": DATA["da_lmp"][:T], "wind_cf": DATA["da_wind_cf"][:T]}


@pytest.fixture(scope="module")
def jax_f64_120(case120):
    """The JAX package's f64 solve at T=120 through its one-call front-end
    `solve_horizon` (extract, instantiate, `solve_lp_banded`: the same
    computation as `solve_lp_banded` on the case's BandedLP, compiled once)."""
    jmeta = case120[0]
    p = {k: jnp.asarray(v) for k, v in _params(120).items()}
    return jax.block_until_ready(JS.solve_horizon(jmeta.prog, p, 120))


def test_instantiate_and_f64_solve_match_jax(case120, jax_f64_120):
    jmeta, jblp, tmeta, tblp = case120
    for name, a, b in zip(jblp._fields, jblp, tblp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_array_equal(tmeta.col_pos, jmeta.col_pos)
    want = jax_f64_120
    got = TS.solve_lp_banded(tmeta, tblp)
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(want.iterations)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-6)
    # the same problem carried across by value solves the same way
    same = TS.solve_lp_banded(
        tmeta, banded_lp_from_numpy([np.asarray(a) for a in jblp], device="cpu")
    )
    assert float(same.obj) == float(got.obj)


def test_mixed_precision_fused_matches_pallas(case120):
    jmeta, jblp, tmeta, tblp = case120
    want = jax.block_until_ready(JS.solve_lp_banded(
        jmeta, jblp, sweep_backend="pallas", chol_dtype=jnp.float32, **MIXED
    ))
    got = TS.solve_lp_banded(
        tmeta, tblp, sweep_backend="fused", chol_dtype=torch.float32, **MIXED
    )
    assert int(got.iterations) == int(want.iterations)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-3)


def test_f64_factor_tier_reaches_the_f64_solve(case120, jax_f64_120):
    """Factorization in f64, factors stored and swept in f32 (the port's
    year-sweep tier): the f64 refinement carries the solve to the JAX
    package's all-f64 optimum, where the f32-factored solve above stops
    short at its f32 Cholesky breakdown."""
    _, _, tmeta, tblp = case120
    got = TS.solve_lp_banded(
        tmeta, tblp, sweep_backend="fused", chol_dtype=torch.float32,
        factor_dtype=torch.float64, kkt_refine=1, tol=1e-8, max_iter=60,
    )
    assert bool(got.converged)
    assert float(got.obj) == pytest.approx(float(jax_f64_120.obj), rel=1e-6)


def test_slabs_match_unslabbed():
    """SPIKE decomposition (5 slabs of 2 blocks, fused sweeps on interior
    and interface chains) == the sequential chain."""
    _, _, tmeta, tblp = _case(240)
    kw = dict(sweep_backend="fused", chol_dtype=torch.float32, **MIXED)
    ref = TS.solve_lp_banded(tmeta, tblp, **kw)
    slab = TS.solve_lp_banded(tmeta, tblp, slabs=5, **kw)
    assert bool(ref.converged) and bool(slab.converged)
    assert float(slab.obj) == pytest.approx(float(ref.obj), rel=1e-3)


def test_solve_horizon_matches_jax(case120, jax_f64_120):
    """The one-call front-end at T=120, f64: the port's `solve_horizon`
    against the JAX package's (objective rel 1e-6, the same iteration
    count, x atol 1e-6); with two LMP scenarios on a leading axis it
    solves them as a batch whose lane 0 is the unbatched solve (rel 1e-9)."""
    tprog, p, want = case120[2].prog, _params(120), jax_f64_120
    got = TS.solve_horizon(tprog, p, 120, device="cpu")
    assert bool(got.converged) and bool(want.converged)
    assert int(got.iterations) == int(want.iterations)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6)
    two = TS.solve_horizon(tprog, dict(p, lmp=np.stack([p["lmp"], 1.1 * p["lmp"]])), 120,
                           device="cpu")
    assert two.obj.shape == (2,) and bool(two.converged.all())
    assert float(two.obj[0]) == pytest.approx(float(got.obj), rel=1e-9)


def test_guards_match_jax(case120):
    _, _, tmeta, tblp = case120
    with pytest.raises(ValueError, match="f32 factor work"):
        TS.solve_lp_banded(tmeta, tblp, sweep_backend="fused")
    with pytest.raises(ValueError, match="unknown sweep_backend"):
        TS.solve_lp_banded(tmeta, tblp, sweep_backend="pallas")
    with pytest.raises(ValueError, match="slabs=4"):
        TS.solve_lp_banded(tmeta, tblp, slabs=4)
    with pytest.raises(ValueError, match="mesh"):
        TS.solve_lp_banded(tmeta, tblp, mesh=object())
    with pytest.raises(ValueError, match="sharding"):
        TS.solve_lp_banded_batch(tmeta, tblp, sharding=object())
    # the performance probe is taken; an unbatched problem takes the plain
    # solve, so it has no chunk to measure
    from dispatches_tpu_torch.obs.perf import PerfProbe

    probe = PerfProbe()
    solve_lp_banded_adaptive(tmeta, tblp, perf=probe, max_iter=1)
    assert probe.chunks == 0
    # pure f32 data IS allowed under "fused" (one iteration suffices here)
    b32 = TS.BandedLP(*(a.float() for a in tblp))
    with pytest.warns(TS.SmallTF32Warning):
        sol = TS.solve_lp_banded(tmeta, b32, sweep_backend="fused", max_iter=1)
    assert int(sol.iterations) == 1
