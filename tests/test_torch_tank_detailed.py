"""Port parity: the detailed hydrogen tank (`dispatches_tpu_torch/units/
tank_detailed.py`) against the JAX package's, on the CPU in float64.

The reference's fill/empty goldens (`tests/test_tank_detailed.py:25-46`)
through the port, a seeded 2-lane trajectory against the JAX package's
`simulate` lane by lane (rel 1e-12), mass conservation, and the gradient
of the final pressure in the inflow through `torch.autograd`. The tank
reads hydrogen alone from `properties.h2`'s Shomate forms: each species'
one-species form is its column of the all-species form to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.units.tank_detailed import HydrogenTankDetailed as JTank
from dispatches_tpu_torch.properties import h2
from dispatches_tpu_torch.units.tank_detailed import HydrogenTankDetailed, tank_volume

TRAJ_RTOL = 1e-12


@pytest.fixture(scope="module")
def tank():
    return HydrogenTankDetailed(tank_diameter=0.1, tank_length=0.3, dt=3600.0, device="cpu")


@pytest.mark.parametrize("species", h2.SPECIES)
def test_one_species_forms_are_their_columns(species):
    T = torch.linspace(250.0, 1900.0, 301, dtype=torch.float64)
    k = h2.SPECIES.index(species)
    for form in (h2.enth_mol, h2.cp_mol):
        assert torch.equal(form(T, species), form(T)[..., k]), form.__name__


def test_volume():
    assert tank_volume(0.1, 0.3) == pytest.approx(np.pi * 0.3 * 0.05**2)


@pytest.mark.parametrize("fout,holdup,temp,pressure", [
    (0.0, 3600.0945, 300.749, 3820683416.0),
    (0.9, 360.0945, 300.055, 381276652.0),
])
def test_fill_and_empty_goldens(tank, fout, holdup, temp, pressure):
    st0 = tank.initial_state(pressure=1e5, temperature=300.0)
    assert float(st0.holdup_mol) == pytest.approx(0.0945, rel=1e-3)
    st = tank.step(st0, flow_in_mol=1.0, T_in=300.0, flow_out_mol=fout)
    assert float(st.holdup_mol) == pytest.approx(holdup, rel=1e-6)
    assert float(st.temperature) == pytest.approx(temp, abs=0.2)
    assert float(st.pressure) == pytest.approx(pressure, rel=1e-2)


def _flows(lanes=2, hours=12, seed=3):
    rng = np.random.default_rng(seed)
    fin = rng.uniform(0.0, 1.0, (lanes, hours))
    fout = rng.uniform(0.0, 0.8, (lanes, hours)) * (rng.random((lanes, hours)) < 0.5)
    return fin, fout


def test_trajectory_matches_jax(tank):
    fin, fout = _flows()
    jt = JTank(tank_diameter=0.1, tank_length=0.3, dt=3600.0)
    js0 = jt.initial_state()
    # the lanes as one vmapped scan: one compile
    want = jax.block_until_ready(jax.vmap(lambda f, o: jt.simulate(js0, f, 300.0, o))(
        jnp.asarray(fin), jnp.asarray(fout)))
    got = tank.simulate(tank.initial_state(), fin, 300.0, fout)
    for i in range(len(fin)):
        for name in ("holdup_mol", "temperature", "pressure"):
            ref = np.asarray(getattr(want, name))[i]
            # rel 1e-12 of the trajectory's scale: an hour that drains the
            # tank leaves the 1e-9 mol floor, a difference of ~1e3 mol terms
            np.testing.assert_allclose(getattr(got, name)[i].numpy(), ref, rtol=TRAJ_RTOL,
                                       atol=TRAJ_RTOL * np.abs(ref).max(),
                                       err_msg=f"lane {i} {name}")


def test_mass_conservation_and_gradient(tank):
    rng = np.random.default_rng(5)
    fin = rng.uniform(0.5, 1.0, (3, 8))
    fout = rng.uniform(0.0, 0.4, (3, 8))  # never drains the tank
    fin_t = torch.tensor(fin, requires_grad=True)
    st0 = tank.initial_state()
    traj = tank.simulate(st0, fin_t, 300.0, fout)
    expect = float(st0.holdup_mol) + 3600.0 * np.cumsum(fin - fout, axis=1)
    np.testing.assert_allclose(traj.holdup_mol.detach().numpy(), expect, rtol=1e-12)
    (g,) = torch.autograd.grad(traj.pressure[:, -1].sum(), fin_t)
    assert torch.isfinite(g).all()
    assert (g > 0).all()  # more inflow in any hour -> higher final pressure
