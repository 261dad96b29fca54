"""Port parity: the concrete thermal store (`dispatches_tpu_torch/units/
concrete_tes.py`) against the JAX package's, on the CPU in float64, where
the tube-side chain runs its plain version.

Small sizes (the plain chain is ~10^4 eager ops a segment): the fluid pass
at 4 segments, a combined-mode period at 4 segments with 3 Gauss-Seidel
iterations, and one charge-mode hour at 2 segments and 1 period with its
gradient through the chain's autograd Function. Tolerances: rel 1e-12 of
each profile's scale (the same bisection path, sums in another order),
1e-9 K / W on the period, rel 1e-8 on the gradient.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.units import concrete_tes as J
from dispatches_tpu_torch.units import concrete_tes as T

D4 = J.TESDesign(num_segments=4)
D2 = J.TESDesign(num_segments=2, num_time_periods=1)
WALLS4 = np.linspace(750.0, 420.0, 4)
WALLS2 = np.array([750.0, 420.0])
CHARGE = (0.00958 * 1000 / 18.01528 * 1e4, 19.6e6, 865.0)  # `test_concrete_tes.py:49-54`
DISCHARGE = (3 / 18.01528 * 1e4, 8.5e5, 355.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def design(d):
    return T.TESDesign(**dataclasses.asdict(d))


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close_scaled(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_design_and_inlet_streams():
    d = design(J.TESDesign())
    for prop in ("htc", "ua_segment", "seg_heat_capacity", "delta_time", "segment_length"):
        assert getattr(d, prop) == getattr(J.TESDesign(), prop)
    for spec in (CHARGE, DISCHARGE):
        for g, w in zip(T.stream_from_pt(*spec), J.stream_from_pt(*spec)):
            close_scaled(g, w, 1e-14)


def _jax_profile(mode):
    spec = CHARGE if mode == "charge" else DISCHARGE
    return jax.block_until_ready(jax.jit(
        lambda w: J.tube_side_profile(D4, w, J.stream_from_pt(*spec), mode))(jnp.asarray(WALLS4)))


def _jax_period():
    return jax.block_until_ready(jax.jit(lambda w: J.tes_period(
        D4, w, J.stream_from_pt(*CHARGE), J.stream_from_pt(*DISCHARGE), gs_iters=3))(
        jnp.asarray(WALLS4)))


def _jax_hour():
    """The stored energy of a charge-mode hour, its gradient in the flow,
    and the hour's results."""
    def stored_j(flow):
        res = J.ConcreteTES(D2, mode="charge").hour(
            jnp.asarray(WALLS2), charge=J.stream_from_pt(flow, 19.6e6, 865.0))
        return jnp.sum(res.wall_temp[-1] - jnp.asarray(WALLS2)), res

    return jax.block_until_ready(
        jax.jit(jax.value_and_grad(stored_j, has_aux=True))(jnp.asarray(5317.0)))


@pytest.fixture(scope="module")
def jax_refs():
    """The module's JAX references, computed once before any port call, in
    threads: tracing holds the GIL, but XLA's compiles do not."""
    jobs = {"charge": lambda: _jax_profile("charge"),
            "discharge": lambda: _jax_profile("discharge"),
            "period": _jax_period, "hour": _jax_hour}
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("mode", ["charge", "discharge"])
def test_tube_side_profile(mode, jax_refs):
    spec = CHARGE if mode == "charge" else DISCHARGE
    want = jax_refs[mode]
    launches = T.tes_chain.launches
    got = T.tube_side_profile(design(D4), t(WALLS4), T.stream_from_pt(*spec), mode)
    assert T.tes_chain.launches == launches  # the CPU runs the plain version
    for g, w in zip(got, want):
        close_scaled(g, w, 1e-12)


def test_combined_period(jax_refs):
    want = jax_refs["period"]
    got = T.tes_period(design(D4), t(WALLS4), T.stream_from_pt(*CHARGE),
                       T.stream_from_pt(*DISCHARGE), gs_iters=3)
    np.testing.assert_allclose(got.wall_temp.numpy(), np.asarray(want.wall_temp), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.heat_rate.numpy(), np.asarray(want.heat_rate), rtol=0, atol=1e-9)
    for side in ("charge", "discharge"):
        for g, w in zip(getattr(got, side), getattr(want, side)):
            close_scaled(g, w, 1e-12)


def test_hour_and_its_flow_gradient(jax_refs):
    """`tests/test_concrete_tes.py:170-180` at 2 segments and 1 period:
    the stored energy and its derivative in the charge flow, through the
    chain's autograd Function, against `jax.grad` through the bisection."""
    (vj, rj), gj = jax_refs["hour"]
    gj = float(gj)

    flow = torch.tensor(5317.0, dtype=torch.float64, requires_grad=True)
    res = T.ConcreteTES(design(D2), mode="charge").hour(
        t(WALLS2), charge=T.stream_from_pt(flow, 19.6e6, 865.0))
    v = torch.sum(res.wall_temp[-1] - t(WALLS2))
    (g,) = torch.autograd.grad(v, flow)
    assert float(v.detach()) == pytest.approx(float(vj), rel=1e-12)
    assert float(g) > 0 and float(g) == pytest.approx(gj, rel=1e-8)
    for field in ("wall_temp", "heat_rate", "charge_temp", "charge_enth_mol"):
        close_scaled(getattr(res, field), getattr(rj, field), 1e-12)
    close_scaled(res.outlet_charge.enth_mol, rj.outlet_charge.enth_mol, 1e-12)
    assert res.discharge_temp is None and res.outlet_discharge is None


def test_chain_weights_are_the_bisection_gradient():
    """The plain chain's weights lie in [0, 1], and through the autograd
    Function the first outlet's derivative in the inlet enthalpy is the
    first weight (discharge lane, walls in walk order)."""
    d = design(D4)
    side = T._side(d, T.stream_from_pt(*DISCHARGE), "discharge")
    tw = t(WALLS4[::-1].copy())[None]
    h_eq = T.steam.enthalpy_pt(side.P, tw)
    par = torch.stack([side.h_in0, side.c, side.P, *side.sat])[None]
    h_out, a = T._tes_chain_plain(tw, h_eq, par)
    assert torch.all((a >= 0) & (a <= 1))
    h_in0 = side.h_in0.clone().requires_grad_(True)[None]
    out = T._TESChain.apply(h_in0, h_eq, tw, par[:, 1:], 48)
    (g,) = torch.autograd.grad(out[0, 0], h_in0)
    assert float(g[0]) == float(a[0, 0])
    assert torch.equal(out, h_out)
