"""Port parity: the simple Rankine cycle (`dispatches_tpu_torch/
case_studies/rankine/`) against the JAX package's, on the CPU in float64.

The flowsheet at rel 1e-12 in each configuration; the 6-scenario
stochastic design of `tests/test_rankine.py` at rel 1e-6 on the design and
objective (the same NLP on the same recipe: iterations may differ by one
where an Armijo near-tie flips); the second 6-scenario case held to that
file's assertions; `surrogate_design_problem` with an analytic revenue
callable.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies import rankine as JR
from dispatches_tpu_torch.case_studies import rankine as TR


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SPECS = [{}, {"heat_recovery": True}, {"closed_loop": False}, {"include_cooling_cost": False}]
FLOWS = np.array([5000.0, 10000.0, 17000.0])


def _flowsheet_kw(eff):
    return dict(net_power_max_w=1.5e8, calc_boiler_eff=True) if eff else {}


LMP6 = np.array([30.0, 60.0, 90.0, 150.0, 220.0, 300.0])


def _jax_flowsheets():
    """The JAX flowsheet and capital cost of every (spec, eff) case, in one
    jitted program (one compile for the eight)."""
    def every(f):
        return {(i, eff): (JR.solve_rankine(f, JR.RankineSpec(**spec), **_flowsheet_kw(eff)),
                           JR.capital_cost_musd(f, JR.RankineSpec(**spec)))
                for i, spec in enumerate(SPECS) for eff in (False, True)}

    return jax.block_until_ready(jax.jit(every)(jnp.asarray(FLOWS)))


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX references, computed once before any port call, in
    two threads: tracing holds the GIL, but XLA's compiles do not."""
    with ThreadPoolExecutor(2) as pool:
        design = pool.submit(JR.stochastic_optimization_problem, LMP6, max_iter=200)
        flowsheets = pool.submit(_jax_flowsheets)
        return {"flowsheets": flowsheets.result(), "design": design.result()}


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("eff", [False, True])
def test_flowsheet_matches_jax(spec, eff, jax_refs):
    want, want_capex = jax_refs["flowsheets"][SPECS.index(spec), eff]
    got = TR.solve_rankine(torch.tensor(FLOWS), TR.RankineSpec(**spec), **_flowsheet_kw(eff))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    np.testing.assert_allclose(
        TR.capital_cost_musd(torch.tensor(FLOWS), TR.RankineSpec(**spec)).numpy(),
        np.asarray(want_capex), rtol=1e-12)


def test_flowsheet_energy_balance_and_gradient():
    st = TR.solve_rankine(10000.0, TR.RankineSpec(heat_recovery=True))
    assert float(st.boiler_duty_w + st.pump_work_w) == pytest.approx(
        float(st.turbine_work_w - st.condenser_duty_w), rel=1e-9)
    # the capital cost's derivative in the flow, autograd against jax.grad
    want = jax.jit(jax.grad(lambda f: JR.capital_cost_musd(f)))(12000.0)
    f = torch.tensor(12000.0, dtype=torch.float64, requires_grad=True)
    TR.capital_cost_musd(f).backward()
    assert float(f.grad) == pytest.approx(float(want), rel=1e-12)


def test_stochastic_design_matches_jax(jax_refs):
    want = jax_refs["design"]
    got = TR.stochastic_optimization_problem(LMP6, max_iter=200, device="cpu")
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 1
    for field in ("cap_flow_mol", "p_max_mw", "obj_usd"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-6)
    np.testing.assert_allclose(got.op_power_mw, want.op_power_mw, rtol=1e-6)
    # `tests/test_rankine.py`'s assertions
    assert got.p_max_mw > 50.0
    assert got.op_power_mw[-1] == pytest.approx(got.p_max_mw, rel=1e-2)
    assert np.all(got.op_power_mw >= 0.3 * got.p_max_mw - 1e-3)


def test_unprofitable_prices_shrink_design():
    lmp = 15 + 20 * np.random.default_rng(0).random(6)
    res = TR.stochastic_optimization_problem(lmp, max_iter=120, device="cpu")
    assert res.converged
    assert res.p_max_mw == pytest.approx(10.0, rel=1e-2)  # lower bound


def test_surrogate_design_optimum():
    """An analytic revenue surrogate (`tests/test_rankine.py:91-101`): the
    design is interior, and there the NPV's derivative in the capacity
    flow vanishes (autograd through the flowsheet and the capital cost)."""
    def revenue(p):
        return 3e6 * p[0] - 6e3 * p[0] ** 2

    got = TR.surrogate_design_problem(revenue, plant_lifetime=20.0, max_iter=80, device="cpu")
    assert got["converged"]
    assert 10.0 < got["p_max_mw"] < 300.0
    flow = torch.tensor(got["cap_flow_mol"], dtype=torch.float64, requires_grad=True)
    p_max = TR.solve_rankine(flow).net_power_w * 1e-6
    npv = 20.0 * revenue(p_max.reshape(1)) - TR.capital_cost_musd(flow) * 1e6
    (g,) = torch.autograd.grad(npv, flow)
    # scaled as the solver sees it (x 1e-8 per mol/s), within its tolerance
    assert abs(float(g)) * 1e-8 < 1e-6
    assert float(npv.detach()) == pytest.approx(got["npv_usd"], rel=1e-12)
