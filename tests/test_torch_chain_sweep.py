"""Port parity: the fused sweep chain (`dispatches_tpu_torch/solvers/
chain_sweep.py`) and the block-tridiagonal factor/solve it serves, against
the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the JAX Pallas kernel
runs under the Pallas interpreter, as `tests/test_pallas_sweep.py` runs it.
The CUDA kernel itself is held against the plain version on the card
(`test_kernel_matches_plain_on_card`, and `chip_smoke.py`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dispatches_tpu.solvers.pallas_sweep import _prep_factors
from dispatches_tpu.solvers.structured import (
    _block_chol as j_block_chol,
    _bt_solve as j_bt_solve,
)
from dispatches_tpu_torch.solvers import chain_sweep as cs
from dispatches_tpu_torch.solvers.structured import _block_chol, _bt_solve


def _spd_chains(D, S, m, seed):
    """Random SPD block-tridiagonal chains as numpy (D, S, m, m) arrays."""
    rng = np.random.default_rng(seed)
    M1 = rng.normal(0, 1, (D, S, m, m))
    Ds = M1 @ np.swapaxes(M1, -1, -2) + m * np.eye(m)
    Es = rng.normal(0, 0.3, (D, S, m, m))
    Es[:, 0] = 0.0
    return Ds, Es, rng


def _j_factors(Ds, Es, dtype):
    out = [j_block_chol(jnp.asarray(d, dtype), jnp.asarray(e, dtype), inv=True)
           for d, e in zip(Ds, Es)]
    return jnp.stack([o[0] for o in out]), jnp.stack([o[1] for o in out])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D,S,m", [(1, 12, 17), (4, 6, 33)])
def test_chain_solve_matches_pallas_interpret(D, S, m, k):
    """Forward + backward sweep == the Pallas kernel's solve (interpret
    mode), incl. several chains (carry reset per chain) and unaligned m."""
    Ds, Es, rng = _spd_chains(D, S, m, seed=5)
    Js, Cs = _j_factors(Ds, Es, jnp.float32)
    r = rng.normal(0, 1, (D, S, m, k)).astype(np.float32)
    want = np.asarray(_prep_factors(Js, Cs, interpret=True)(jnp.asarray(r)))
    J, C = _block_chol(torch.tensor(Ds, dtype=torch.float32),
                       torch.tensor(Es, dtype=torch.float32), inv=True)
    got = cs.chain_solve(J, C, torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if k == 1:  # vector right-hand sides take the same path
        np.testing.assert_allclose(
            cs.chain_solve(J, C, torch.tensor(r[..., 0])).numpy(), want[..., 0], atol=1e-4
        )


def test_wide_rhs_matches_scan():
    """k = 18 > 8: the JAX package falls back to its scan; the port's
    wrapper (and the CUDA kernel, by tiling over k) takes any k."""
    D, S, m = 2, 5, 9
    Ds, Es, rng = _spd_chains(D, S, m, seed=7)
    Js, Cs = _j_factors(Ds, Es, jnp.float32)
    R = rng.normal(0, 1, (D, S, m, 2 * m)).astype(np.float32)
    want = np.stack([
        np.asarray(j_bt_solve(Js[d], Cs[d], jnp.asarray(R[d]), inv=True))
        for d in range(D)
    ])
    J, C = _block_chol(torch.tensor(Ds, dtype=torch.float32),
                       torch.tensor(Es, dtype=torch.float32), inv=True)
    np.testing.assert_allclose(cs.chain_solve(J, C, torch.tensor(R)).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("inv", [False, True])
def test_block_chol_and_bt_solve_match_jax_f64(inv):
    Ds, Es, rng = _spd_chains(2, 5, 9, seed=11)
    r = rng.normal(0, 1, (2, 5, 9, 3))
    L, C = _block_chol(torch.tensor(Ds), torch.tensor(Es), inv=inv)
    x = _bt_solve(L, C, torch.tensor(r), inv=inv)
    xv = _bt_solve(L, C, torch.tensor(r[..., 0]), inv=inv)
    for d in range(2):
        jL, jC = j_block_chol(jnp.asarray(Ds[d]), jnp.asarray(Es[d]), inv=inv)
        np.testing.assert_allclose(L[d].numpy(), np.asarray(jL), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(C[d].numpy(), np.asarray(jC), rtol=1e-10, atol=1e-12)
        jx = np.asarray(j_bt_solve(jL, jC, jnp.asarray(r[d]), inv=inv))
        np.testing.assert_allclose(x[d].numpy(), jx, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(xv[d].numpy(), jx[..., 0], rtol=1e-10, atol=1e-12)


def test_reference_is_the_pallas_recurrence():
    """`chain_sweep_reference` computes the TPU kernel's own row-form
    recurrence on tile-aligned inputs (kp = 8, mp = 128)."""
    from dispatches_tpu.solvers.pallas_sweep import chain_sweep as j_chain_sweep

    rng = np.random.default_rng(3)
    RT, BT, AT = (rng.normal(0, 0.1, s).astype(np.float32)
                  for s in [(2, 3, 8, 128), (2, 3, 128, 128), (2, 3, 128, 128)])
    want = np.asarray(j_chain_sweep(*map(jnp.asarray, (RT, BT, AT)), interpret=True))
    got = cs.chain_sweep_reference(*map(torch.tensor, (RT, BT, AT)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """The wrapper runs the plain version because the tensors lie on the
    CPU: no library is loaded, no nvcc is needed, no launch is counted."""
    Ds, Es, rng = _spd_chains(3, 4, 6, seed=2)
    J, C = _block_chol(torch.tensor(Ds, dtype=torch.float32),
                       torch.tensor(Es, dtype=torch.float32), inv=True)
    R = torch.tensor(rng.normal(0, 1, (3, 4, 6, 2)), dtype=torch.float32)
    before = cs.chain_sweep.launches
    for reverse in (False, True):
        got = cs.chain_sweep(J, C, R, reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), cs._sweep_plain(J, C, R, reverse).numpy())
    assert cs.chain_sweep.launches == before
    if not torch.cuda.is_available():
        assert cs._lib is None
    # forward sweep by hand: v_t = J_t (r_t - C_t v_{t-1})
    v = torch.zeros(3, 6, 2)
    for t in range(4):
        v = J[:, t] @ (R[:, t] - C[:, t] @ v)
        np.testing.assert_allclose(cs.chain_sweep(J, C, R)[:, t].numpy(), v.numpy(), atol=1e-6)
    src = cs._SRC.read_text()
    assert 'extern "C" int chain_sweep_f32' in src
    assert "pallas_sweep.py" in src


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for D, S, m, k in [(1, 12, 17, 1), (4, 6, 33, 3), (2, 5, 9, 18)]:
        M1 = torch.randn(D, S, m, m, device="cuda", generator=gen)
        Ds = M1 @ M1.transpose(-1, -2) + m * torch.eye(m, device="cuda")
        Es = 0.3 * torch.randn(D, S, m, m, device="cuda", generator=gen)
        J, C = _block_chol(Ds, Es, inv=True)
        R = torch.randn(D, S, m, k, device="cuda", generator=gen)
        for reverse in (False, True):
            before = cs.chain_sweep.launches
            got = cs.chain_sweep(J, C, R, reverse=reverse)
            torch.cuda.synchronize()
            assert cs.chain_sweep.launches == before + 1
            ref = cs._sweep_plain(J, C, R, reverse)
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    with pytest.raises(TypeError, match="float32"):
        cs.chain_sweep(J.double(), C.double(), R.double())
