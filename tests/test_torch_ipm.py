"""Port parity: the dense Mehrotra IPM (`dispatches_tpu_torch/solvers/
ipm.py`) against the JAX package's, in float64 on the same LP.

The weekly design LP is instantiated by the JAX package and carried across
with `convert.lp_from_numpy`, so both solvers see the same bytes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.case_studies.renewables.pricetaker import (
    HybridDesign,
    build_pricetaker,
)
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.solvers.ipm import solve_lp as j_solve_lp
from dispatches_tpu.solvers.ipm import solve_lp_batch as j_solve_lp_batch
from dispatches_tpu_torch.convert import lp_from_numpy
from dispatches_tpu_torch.obs.trace import SolveTrace
from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
from dispatches_tpu_torch.solvers.ipm import (
    IPMSolution,
    solve_lp,
    solve_lp_batch,
    status_name,
)

DATA = JP.load_rts303()


def _weekly_lp(T):
    prog, _ = build_pricetaker(HybridDesign(
        T=T, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    p = {"lmp": jnp.asarray(DATA["da_lmp"][:T]),
         "wind_cf": jnp.asarray(DATA["da_wind_cf"][:T])}
    return prog.instantiate(p)


def test_dense_solve_matches_jax_weekly():
    jlp = _weekly_lp(168)
    # finish the JAX solve before the port's starts: the two thread pools
    # would otherwise contend for the cores
    want = jax.block_until_ready(j_solve_lp(jlp))
    got = solve_lp(lp_from_numpy([np.asarray(a) for a in jlp], device="cpu"))
    assert isinstance(got, IPMSolution)
    assert bool(got.converged) == bool(want.converged) is True
    assert int(got.status) == int(want.status)
    assert status_name(got.status) == "optimal"
    assert int(got.iterations) == int(want.iterations)
    assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-8)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-5, atol=1e-6)


def test_batch_lanes_and_trace_match_jax():
    """Three LMP scales share A (only c differs). Each lane of the batched
    solve matches the JAX package's vmapped lane, the lanes run on after
    the fastest finishes (frozen, as under vmap), and `trace=True` returns
    a `SolveTrace` of the JAX package's shapes."""
    T, max_iter = 48, 40
    jlp = _weekly_lp(T)
    scales = np.array([0.6, 1.0, 1.8])
    lmp = DATA["da_lmp"][:T]
    from dispatches_tpu.case_studies.renewables.pricetaker import build_pricetaker as jb

    prog, _ = jb(HybridDesign(
        T=T, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    cs = np.stack([
        np.asarray(prog.instantiate({
            "lmp": jnp.asarray(s * lmp), "wind_cf": jnp.asarray(DATA["da_wind_cf"][:T])
        }).c) for s in scales
    ])
    jbatch = JLPData(jlp.A, jlp.b, jnp.asarray(cs), jlp.l, jlp.u, jlp.c0)
    want, wtr = jax.block_until_ready(
        j_solve_lp_batch(jbatch, max_iter=max_iter, trace=True)
    )
    tlp = lp_from_numpy([np.asarray(a) for a in jlp], device="cpu")
    tbatch = tlp._replace(c=torch.tensor(cs))
    got, tr = solve_lp_batch(tbatch, max_iter=max_iter, trace=True)
    assert isinstance(tr, SolveTrace)
    for a, b in zip(wtr, tr):
        assert tuple(b.shape) == tuple(np.asarray(a).shape) == (3, max_iter)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=1e-8)
    assert len(set(got.iterations.tolist())) > 1  # lanes finish apart
    for i in range(3):
        n = int(got.iterations[i])
        # recorded prefix, NaN tail — per lane
        assert np.isfinite(tr.gap[i, :n].numpy()).all()
        assert np.isnan(tr.gap[i, n:].numpy()).all()
        np.testing.assert_allclose(
            tr.res_primal[i, :n].numpy(), np.asarray(wtr.res_primal)[i, :n],
            rtol=1e-4, atol=1e-12,
        )
        # lane i alone gives what the batch gives for lane i
        one, one_tr = solve_lp(tbatch._replace(c=tbatch.c[i]), max_iter=max_iter, trace=True)
        assert int(one.iterations) == n
        assert float(one.obj) == pytest.approx(float(got.obj[i]), rel=1e-10)
        assert tuple(one_tr.gap.shape) == (max_iter,)
    # the adaptive entry with the performance probe: the same lanes
    from dispatches_tpu_torch.obs.perf import PerfProbe

    probe = PerfProbe()
    ad = solve_lp_adaptive(tbatch, perf=probe, max_iter=max_iter)
    np.testing.assert_array_equal(ad.iterations.numpy(), got.iterations.numpy())
    assert probe.chunks >= 1
