"""Port parity: the fused sweep chain (`dispatches_tpu_torch/solvers/
chain_sweep.py`) and the block-tridiagonal factor/solve it serves, against
the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the JAX Pallas kernel
runs under the Pallas interpreter, as `tests/test_pallas_sweep.py` runs it.
The CUDA kernel itself is held against the plain version on the card
(`test_kernel_matches_plain_on_card`, and `chip_smoke.py`), and so is the
year-tier gradient that runs through it
(`test_year_tier_gradient_on_the_card_launches_the_kernel`).
"""
import functools

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


@functools.lru_cache(maxsize=None)
def _pallas_solve(D, S, m, k):
    """Random chains, a right-hand side, and the Pallas kernel's solve of
    them (interpret mode); shared by the natural- and padded-layout tests."""
    Ds, Es, rng = _spd_chains(D, S, m, seed=5)
    Js, Cs = _j_factors(Ds, Es, jnp.float32)
    r = rng.normal(0, 1, (D, S, m, k)).astype(np.float32)
    want = np.asarray(_prep_factors(Js, Cs, interpret=True)(jnp.asarray(r)))
    return Ds, Es, r, want


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D,S,m", [(1, 12, 17), (4, 6, 33)])
def test_chain_solve_matches_pallas_interpret(D, S, m, k):
    """Forward + backward sweep == the Pallas kernel's solve (interpret
    mode), incl. several chains (carry reset per chain) and unaligned m."""
    Ds, Es, r, want = _pallas_solve(D, S, m, k)
    J, C = _block_chol(torch.tensor(Ds, dtype=torch.float32),
                       torch.tensor(Es, dtype=torch.float32), inv=True)
    got = cs.chain_solve(J, C, torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if k == 1:  # vector right-hand sides take the same path
        np.testing.assert_allclose(
            cs.chain_solve(J, C, torch.tensor(r[..., 0])).numpy(), want[..., 0], atol=1e-4
        )


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D,S,m", [(1, 12, 17), (4, 6, 33)])
def test_chain_solve_padded_layout_matches_pallas_interpret(D, S, m, k):
    """The factors in the kernel's padded layout (rows m_pad apart, as
    `_banded_ops` hands them to the fused sweeps on the card) give the
    Pallas kernel's solve through the plain version."""
    Ds, Es, r, want = _pallas_solve(D, S, m, k)
    J, C = (cs.sweep_factors(a, pad=True) for a in _block_chol(
        torch.tensor(Ds), torch.tensor(Es), inv=True))
    assert J.stride(-2) == C.stride(-2) == -(-m // 4) * 4 != m
    np.testing.assert_allclose(cs.chain_solve(J, C, torch.tensor(r)).numpy(), want, atol=1e-4)


# cudaOccupancyMaxActiveClusters on an H100 80GB HBM3 for the main-path plan
# (clusters of each size resident at once), as tools/torch_chain_sweep_tune.py
# printed it
_H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9,
                  11: 7, 13: 7, 16: 7}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("chains,S,m,k", [
    (40, 72, 241, 1), (40, 72, 241, 3), (8, 365, 241, 1), (8, 5, 241, 3),
    (1, 12, 17, 1), (4, 6, 33, 3), (2, 5, 9, 18), (132, 4, 241, 1), (3, 4, 300, 2),
    (16, 2, 1000, 8),
])
def test_launch_plan_invariants(chains, S, m, k, reverse):
    """The slices cover m in multiples of 4 floats, the shared memory fits a
    block, the blocks fit one wave, and the cluster is the largest that does."""
    for fits in (None, lambda c, smem: _H100_CLUSTERS.get(c, 0)):
        plan = cs.launch_plan(chains, S, m, k, reverse, max_clusters=fits)
        assert plan.width % 4 == 0 and plan.width >= 4
        assert plan.cluster * plan.width >= m > (plan.cluster - 1) * plan.width
        assert plan.m_pad == -(-m // 4) * 4
        assert plan.smem_bytes <= cs.MAX_SMEM and plan.stages >= 2
        assert 1 <= plan.stage_rows <= cs.MAX_BOX
        assert plan.kt == cs.k_tile(k) and plan.kt >= min(k, 8)
        if reverse:
            assert plan.width <= cs.MAX_BOX  # one TMA box spans a block's columns
        assert chains * plan.cluster <= cs.SMS
        n = fits or (lambda c, smem: cs.SMS // c)
        assert n(plan.cluster, plan.smem_bytes) >= chains
        for c in range(plan.cluster + 1, cs.MAX_CLUSTER + 1):  # no larger one fits
            big = cs._geometry(m, plan.kt, reverse, c)
            if big is not None:
                assert n(big.cluster, big.smem_bytes) < chains
    if (chains, m) == (40, 241):  # the main path's choice on the H100
        assert cs.launch_plan(chains, S, m, k, reverse,
                              max_clusters=lambda c, smem: _H100_CLUSTERS.get(c, 0)).cluster == 2


def test_sweep_factors_layout():
    """The padded layout: a view of the input's shape and values whose rows
    are m_pad floats apart over zero padding columns; CPU tensors keep the
    natural layout unless asked."""
    a = torch.tensor(np.random.default_rng(1).normal(0, 1, (2, 3, 9, 9)))
    v = cs.sweep_factors(a, pad=True)
    assert v.shape == a.shape and v.dtype == torch.float32
    assert v.stride() == (3 * 9 * 12, 9 * 12, 12, 1)
    np.testing.assert_array_equal(v.numpy(), a.float().numpy())
    full = torch.as_strided(v, (2, 3, 9, 12), v.stride())
    assert (full[..., 9:] == 0).all()
    assert cs.kernel_stride(v, v) == 12
    assert cs.sweep_factors(a).is_contiguous()  # CPU default: natural layout
    w = cs.sweep_factors(a[..., :8, :8], pad=True)  # m already a multiple of 4
    assert w.stride(-2) == 8 and w.is_contiguous()


def test_kernel_stride_rejects_layouts_the_kernel_cannot_take():
    a = torch.zeros(2, 3, 17, 17)
    v = cs.sweep_factors(a, pad=True)
    with pytest.raises(ValueError, match="multiple of 4"):
        cs.kernel_stride(a, a)  # natural layout, rows 17 floats apart
    with pytest.raises(ValueError, match="unit-stride"):
        t = cs.sweep_factors(torch.zeros(2, 3, 20, 20), pad=True).transpose(-1, -2)
        cs.kernel_stride(t, t)
    with pytest.raises(ValueError, match="share one row stride"):
        cs.kernel_stride(v, torch.zeros(2, 3, 24, 24)[..., :17, :17])
    with pytest.raises(ValueError, match="apart"):
        cs.kernel_stride(v[:, ::2], v[:, ::2])  # every other block
    assert cs.kernel_stride(v, v) == 20


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
    """The kernel on the padded layout against the plain version at
    m in {9, 17, 33, 241, 300} and k up to 18, and at m = 241 with the chain count
    that makes the plan pick each cluster size the card allows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(D, S, m, k, want_cluster=None):
        M1 = torch.randn(D, S, m, m, device="cuda", generator=gen)
        Ds = M1 @ M1.transpose(-1, -2) + m * torch.eye(m, device="cuda")
        Es = 0.3 * torch.randn(D, S, m, m, device="cuda", generator=gen)
        J, C = (cs.sweep_factors(a) for a in _block_chol(Ds, Es, inv=True))
        assert J.stride(-2) == -(-m // 4) * 4
        R = torch.randn(D, S, m, k, device="cuda", generator=gen)
        for reverse in (False, True):
            before = cs.chain_sweep.launches
            got = cs.chain_sweep(J, C, R, reverse=reverse)
            torch.cuda.synchronize()
            assert cs.chain_sweep.launches == before + 1
            if want_cluster is not None:
                plan = cs._device_plan(D, S, m, k, reverse, cs._library())
                assert plan.cluster == want_cluster
            ref = cs._sweep_plain(J, C, R, reverse)
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        return J, C, R

    for D, S, m, k in [(1, 12, 17, 1), (4, 6, 33, 3), (2, 5, 9, 18), (2, 4, 300, 3),
                       (3, 7, 241, 2)]:
        J, C, R = check(D, S, m, k)  # the last, m = 241, is used below
    lib = cs._library()
    consumers = 32 * lib.chain_sweep_consumer_warps()
    for m in (9, 17, 33, 241, 300, 1000):  # _geometry's layout is the kernel's
        for k in (1, 2, 3, 8, 18):
            for reverse in (0, 1):
                for c in range(1, cs.MAX_CLUSTER + 1):
                    for sb in (16384, cs.STAGE_BYTES):
                        p = cs._geometry(m, cs.k_tile(k), reverse, c, consumers, sb)
                        if p is not None:
                            assert lib.chain_sweep_smem_bytes(
                                m, k, reverse, c, p.width, p.stage_rows, p.stages
                            ) == p.smem_bytes, (m, k, reverse, p)
    chosen = set()
    for D in range(1, cs.SMS + 1):  # every cluster size the plan picks at m = 241
        plan = cs.launch_plan(
            D, 3, 241, 1, consumer_warps=lib.chain_sweep_consumer_warps(),
            max_clusters=lambda c, smem: lib.chain_sweep_max_clusters(c, smem, 1, 0))
        if plan.cluster not in chosen:
            chosen.add(plan.cluster)
            check(D, 3, 241, 1, want_cluster=plan.cluster)
    assert len(chosen) > 1
    with pytest.raises(TypeError, match="float32"):
        cs.chain_sweep(J.double(), C.double(), R.double())
    with pytest.raises(ValueError, match="multiple of 4"):
        cs.chain_sweep(J.contiguous(), C.contiguous(), R)  # natural layout, m = 241


@pytest.mark.cuda
def test_year_tier_gradient_on_the_card_launches_the_kernel():
    """`optimal_value_banded` at the year tier on the card (the flagship
    design LP at T=240, 2 lanes): the kernel launches during the gradient's
    solve, and value and LMP gradient agree with the same call on the CPU,
    whose sweeps are the plain version: value rel 1e-6, gradient atol 1e-3
    (entries up to 1.4; f32 sweeps in another order move the iterate)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.solvers.structured import (
        extract_time_structure, optimal_value_banded,
    )
    from dispatches_tpu_torch.workflow.runners import year_sweep_solver_kw

    T = 240
    prog, _ = build_pricetaker(HybridDesign(
        T=T, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None,
    ))
    meta = extract_time_structure(prog, T, block_hours=24)
    data = P.load_rts303()
    lmps = np.array([[1.0], [1.3]]) * data["da_lmp"][:T][None]
    cf = data["da_wind_cf"][:T]
    kw = year_sweep_solver_kw(torch.float64, Tb=meta.Tb)
    out = {}
    for device in ("cpu", "cuda"):
        cs.chain_sweep.launches = 0
        lm = torch.tensor(lmps, device=device, requires_grad=True)
        v = optimal_value_banded(meta, {"lmp": lm, "wind_cf": cf}, device=device, **kw)
        g, = torch.autograd.grad(v.sum(), lm)
        out[device] = (v.detach().cpu().numpy(), g.cpu().numpy(), cs.chain_sweep.launches)
    assert out["cpu"][2] == 0 and out["cuda"][2] > 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-6)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-3)
