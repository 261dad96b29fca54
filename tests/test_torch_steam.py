"""Port parity: IAPWS-IF97 steam and the heat-transfer-fluid correlations
(`dispatches_tpu_torch/properties/{steam,salts}.py`) against the JAX
package's, on the CPU in float64.

Inputs are a seeded grid across regions 1, 2 and 4 and the two-phase
plateau. Tolerances: rel 1e-12 on every property (the port sums the same
Gibbs terms, hoists the pressure-only factors and takes its powers with
torch's pow: differences of a few ulps, amplified by cancellation in the
region-1 sums to ~3e-13); rel 1e-9 on gradients.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.properties import salts as JS
from dispatches_tpu.properties import steam as J
from dispatches_tpu_torch.properties import salts as S
from dispatches_tpu_torch.properties import steam as T

RTOL = 1e-12
RNG = np.random.default_rng(0)
P = RNG.uniform(5e3, 30e6, 64)
T_LIQ = RNG.uniform(280.0, 620.0, 64)
T_VAP = RNG.uniform(700.0, 1000.0, 64)
P_SAT = RNG.uniform(1e4, 2e7, 32)
# enthalpies across subcooled liquid, the plateau and superheated vapor
H = RNG.uniform(1e5, 3.8e6, 64)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def jx(fn, *args):
    """The JAX function jitted: one compile instead of an op-by-op dispatch
    (several seconds each for the Newton loops)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


P_OUT = np.array([2e6, 1e5, 7e3])  # turbine outlet pressures
H_TURB = np.array([2.6e6, 2.9e6, 3.3e6])  # wet and dry turbine inlets
SAT_T = np.linspace(280.0, 640.0, 32)
D1, D2 = RNG.uniform(-1.0, 80.0, 16), RNG.uniform(0.0, 80.0, 16)


def _salt_refs(fluid):
    jf = JS.FLUIDS[fluid]
    temps = np.linspace(jf.T_min + 1.0, jf.T_max - 1.0, 16)
    h = np.asarray(jf.enth_mass(temps[::3]))
    return {
        "temps": temps, "h": h,
        **{prop: np.asarray(getattr(jf, prop)(temps))
           for prop in ("cp_mass", "dens_mass", "enth_mass", "visc_d", "therm_cond")},
        "slope": np.asarray(jax.vmap(jax.grad(lambda x: jf.enth_mass(x)))(jnp.asarray(temps))),
        "t_of_h": jx(lambda x: jf.temperature_from_enthalpy(x, jnp.full(h.shape, 600.0)), h),
    }


def _jax_jobs():
    liq, vap = (lambda: J.props_liquid(P, T_LIQ)), (lambda: J.props_vapor(P, T_VAP))
    grad_work = jax.jit(jax.grad(lambda x: J.turbine_expansion(24e6, x, 2e6, 0.85).work))
    jobs = {
        "props_liquid": liq, "props_vapor": vap,
        "sat_temperature": lambda: J.sat_temperature(P_SAT),
        "sat_pressure": lambda: J.sat_pressure(SAT_T),
        "temperature_ph": lambda: jx(J.temperature_ph, P[:32] * 0.6, H[:32]),
        "vapor_fraction_ph": lambda: jx(J.vapor_fraction_ph, P[:32] * 0.6, H[:32]),
        "enthalpy_pt": lambda: jx(J.enthalpy_pt, P, T_LIQ + 200.0),
        "t_ph_liquid": lambda: jx(J.temperature_ph_liquid, P, np.asarray(liq().h)),
        "t_ph_vapor": lambda: jx(J.temperature_ph_vapor, P, np.asarray(vap().h)),
        "t_ps_vapor": lambda: jx(J.temperature_ps_vapor, P, np.asarray(vap().s)),
        "t_ph_fn": lambda: jx(lambda h: J.temperature_ph_fn(19.6e6, iters=12)(h), H),
        "turbine_pt": lambda: jx(lambda p: J.turbine_expansion(24e6, 866.0, p, 0.85), P_OUT),
        "turbine_ph": lambda: jx(lambda h: J.turbine_expansion_ph(2e6, h, 1e5, 0.8), H_TURB),
        "pump_work": lambda: J.pump_work(P[:8], P[:8] * 1.5, T_LIQ[:8], 0.8),
        "lmtd": lambda: J.lmtd_underwood(D1, D2),
        "grad_work": lambda: [jax.block_until_ready(grad_work(T_in)) for T_in in (800.0, 866.0)],
    }
    jobs.update({f"salt_{fluid}": (lambda f=fluid: _salt_refs(f)) for fluid in JS.FLUIDS})
    return jobs


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX references, computed once before any port call, in
    threads: tracing holds the GIL, but XLA's compiles do not."""
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(job) for name, job in _jax_jobs().items()}
        return {name: jax.block_until_ready(f.result()) for name, f in futures.items()}


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("name,temps", [("props_liquid", T_LIQ), ("props_vapor", T_VAP)])
@pytest.mark.parametrize("field", ["v", "h", "s", "u", "cp"])
def test_region_properties(name, temps, field, jax_refs):
    close(getattr(getattr(T, name)(t(P), t(temps)), field), getattr(jax_refs[name], field))


@pytest.mark.parametrize("fn,arg", [("sat_temperature", P_SAT), ("sat_pressure", SAT_T)])
def test_saturation_curve(fn, arg, jax_refs):
    close(getattr(T, fn)(t(arg)), jax_refs[fn])


@pytest.mark.parametrize("fn", ["temperature_ph", "vapor_fraction_ph"])
def test_ph_inversions_across_regions(fn, jax_refs):
    want = np.asarray(jax_refs[fn])
    close(getattr(T, fn)(t(P[:32] * 0.6), t(H[:32])), want)
    # the plateau is hit: quality strictly inside (0, 1) somewhere
    if fn == "vapor_fraction_ph":
        assert np.any((want > 0) & (want < 1))


def test_enthalpy_pt_and_inversions_by_branch(jax_refs):
    close(T.enthalpy_pt(t(P), t(T_LIQ + 200.0)), jax_refs["enthalpy_pt"])
    liq, vap = jax_refs["props_liquid"], jax_refs["props_vapor"]
    close(T.temperature_ph_liquid(t(P), t(liq.h)), jax_refs["t_ph_liquid"])
    close(T.temperature_ph_vapor(t(P), t(vap.h)), jax_refs["t_ph_vapor"])
    close(T.temperature_ps_vapor(t(P), t(vap.s)), jax_refs["t_ps_vapor"])
    ft = T.temperature_ph_fn(19.6e6, iters=12)
    close(ft(t(H)), jax_refs["t_ph_fn"])


@pytest.mark.parametrize("form", ["pt", "ph"])
def test_turbine_expansions(form, jax_refs):
    want = jax_refs[f"turbine_{form}"]
    if form == "pt":
        got = T.turbine_expansion(24e6, 866.0, t(P_OUT), 0.85)
    else:
        got = T.turbine_expansion_ph(2e6, t(H_TURB), 1e5, 0.8)
    for g, w in zip(got, want):
        close(g, w)


def test_pump_work_and_lmtd(jax_refs):
    close(T.pump_work(t(P[:8]), t(P[:8] * 1.5), t(T_LIQ[:8]), 0.8), jax_refs["pump_work"])
    close(T.lmtd_underwood(t(D1), t(D2)), jax_refs["lmtd"])


def test_expansion_work_gradient_in_inlet_temperature(jax_refs):
    """autograd through both Newton inversions against `jax.grad`
    (`tests/test_steam.py:101`), rel 1e-9."""
    for T_in, want in zip((800.0, 866.0), jax_refs["grad_work"]):
        x = torch.tensor(T_in, dtype=torch.float64, requires_grad=True)
        T.turbine_expansion(24e6, x, 2e6, 0.85).work.backward()
        close(x.grad, want, rtol=1e-9)


@pytest.mark.parametrize("fluid", sorted(JS.FLUIDS))
def test_salt_correlations(fluid, jax_refs):
    tf, ref = S.FLUIDS[fluid], jax_refs[f"salt_{fluid}"]
    temps = ref["temps"]
    for prop in ("cp_mass", "dens_mass", "enth_mass", "visc_d", "therm_cond"):
        close(getattr(tf, prop)(t(temps)), ref[prop])
    # the Newton slope: autodiff of the enthalpy (not cp: Hitec's enthalpy
    # is not the integral of its cp)
    got = torch.func.vmap(torch.func.grad(lambda x: tf.enth_mass(x)))(t(temps))
    close(got, ref["slope"])
    close(tf.temperature_from_enthalpy(t(ref["h"]), t(np.full(ref["h"].shape, 600.0))),
          ref["t_of_h"], rtol=1e-11)
