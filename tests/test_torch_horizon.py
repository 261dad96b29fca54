"""Port parity: the time-axis horizon decomposition and the one-card
scenario batch (`dispatches_tpu_torch/parallel/`,
`case_studies/renewables/horizon.py`) against the JAX package, at
`tests/test_time_axis.py`'s sizes (T = 48, 4 and 8 chunks).

The JAX package runs the chunk solves as a `vmap` (or one a device); the
port as the lanes of one `solve_lp_batch(..., q=)`. ADMM amplifies last
bits between the two packages' lanes, so the comparisons are tolerances
(objective rel 1e-9, boundary states and x abs 1e-5 kWh on states of
1e3-1e5 kWh; at T = 48 the two differ by 0 and 9.3e-10 on the CPU), never
bitwise; within the port, `solve_lp_sharded` is bitwise `solve_lp_batch`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies.renewables import horizon as JH
from dispatches_tpu.parallel import time_axis as JT
from dispatches_tpu_torch.case_studies.renewables import horizon as TH
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.parallel import mesh as TM
from dispatches_tpu_torch.parallel import time_axis as TT
from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

T = 48
RNG = np.random.default_rng(0)
LMP = RNG.uniform(-5, 60, T)
CF = RNG.uniform(0, 1, T)
OBJ_RTOL = 1e-9
STATE_ATOL = 1e-5  # kWh


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cold_case(pkg):
    """8 chunks of 6 h from a cold consensus with residual-balancing rho."""
    H, tensor = (JH, jnp.asarray) if pkg == "jax" else (TH, torch.as_tensor)
    prog, idx_in, idx_out = H.build_chunk(H.WindBatteryChunk(Tc=6))
    cp = {"lmp": tensor(LMP.reshape(8, 6)), "wind_cf": tensor(CF.reshape(8, 6))}
    kw = dict(admm_iters=12, z_fixed=np.zeros(2), wrap_free=np.array([False, True]))
    if pkg == "jax":
        return JT.solve_horizon_admm(prog, cp, idx_in, idx_out, **kw)
    return TT.solve_horizon_admm(prog, cp, idx_in, idx_out, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's solves, each finished before any port solve."""
    out = {
        "warm": JH.wind_battery_horizon_solve(LMP, CF, n_chunks=4, admm_iters=20),
        "cold": _cold_case("jax"),
        "z0": JH.coarse_boundary_states(JH.WindBatteryChunk(Tc=12), LMP, CF, 4),
    }
    return jax.block_until_ready({k: (v if k == "z0" else (v.x, v.z, v.obj,
                                                           v.primal_residual))
                                  for k, v in out.items()})


def _close(port, jax_sol):
    x, z, obj, res = (np.asarray(a) for a in jax_sol)
    assert float(port.obj) == pytest.approx(float(obj), rel=OBJ_RTOL)
    np.testing.assert_allclose(port.z.numpy(), z, rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(port.x.numpy(), x, rtol=0, atol=STATE_ATOL)
    assert float(port.primal_residual) == pytest.approx(float(res), abs=STATE_ATOL)


def test_wind_battery_horizon_matches_jax(jax_ref):
    sol = TH.wind_battery_horizon_solve(LMP, CF, n_chunks=4, admm_iters=20, device="cpu")
    _close(sol, jax_ref["warm"])
    assert float(sol.primal_residual) < 1.0  # tests/test_time_axis.py's bound
    assert sol.stats["sweeps"] == 20 and all(sol.stats["converged_finite"])
    assert len(sol.stats["ipm_iterations"]) == 21  # the sweeps and the final solve


def test_cold_ring_with_adaptive_rho_matches_jax(jax_ref):
    _close(_cold_case("port"), jax_ref["cold"])


def test_coarse_boundary_states_match_jax(jax_ref):
    z0 = TH.coarse_boundary_states(TH.WindBatteryChunk(Tc=12), LMP, CF, 4, device="cpu")
    assert tuple(z0.shape) == (4, 2) and bool((z0 >= 0).all())
    np.testing.assert_allclose(z0.numpy(), np.asarray(jax_ref["z0"]), rtol=0,
                               atol=STATE_ATOL)
    assert z0[-1].abs().max() == 0.0  # the pinned wrap boundary


def test_chunk_boundary_indices_and_wrap_free_needs_a_pin():
    prog, idx_in, idx_out = TH.build_chunk(TH.WindBatteryChunk(Tc=12))
    jprog, jin, jout = JH.build_chunk(JH.WindBatteryChunk(Tc=12))
    np.testing.assert_array_equal(idx_in, jin)
    np.testing.assert_array_equal(idx_out, jout)
    assert (prog.M, prog.N) == (jprog.M, jprog.N)
    with pytest.raises(ValueError, match="z_fixed"):
        TT.solve_horizon_admm(prog, {"lmp": torch.as_tensor(LMP.reshape(4, 12)),
                                     "wind_cf": torch.as_tensor(CF.reshape(4, 12))},
                              idx_in, idx_out, wrap_free=np.array([False, True]),
                              device="cpu")


@pytest.mark.parametrize("batch", [3, 4])
def test_sharded_lanes_are_the_batch_lanes(batch):
    r = np.random.default_rng(batch)
    A = r.normal(size=(3, 6))
    x0 = r.uniform(0.5, 1.5, size=(batch, 6))
    lp = LPData(*(torch.as_tensor(a) for a in (
        A, x0 @ A.T, r.normal(size=(batch, 6)), np.zeros(6), np.full(6, 4.0), 0.0)))
    mesh = TM.scenario_mesh(device="cpu")
    assert mesh.size == 1 and mesh.axis_names == ("scenario",)
    got = TM.solve_lp_sharded(lp, mesh, tol=1e-9)
    ref = solve_lp_batch(lp, tol=1e-9)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    padded, n = TM.pad_batch(lp.b, 4)
    assert n == batch and padded.shape[0] == 4 and torch.equal(padded[-1], lp.b[-1])
    with pytest.raises(ValueError, match="machine has 1"):
        TM.scenario_mesh(2, device="cpu")
