"""Port parity: the powercurve capacity factors (`dispatches_tpu_torch/
units/powercurve.py`) and the golden-dollar inputs
(`case_studies/renewables/params.py::load_re_goldens`) against the JAX
package's, in float64 on the CPU.

`capacity_factor_pysam` evaluates the same log-space Weibull CDF; the two
packages' `lgamma`, `log` and `exp` differ in their last bits, so its
values are held to rel 1e-12 and its gradient to rel 1e-10. The
interpolation forms are the same arithmetic (rel 1e-15 of the curve).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dispatches_tpu.case_studies.renewables import params as JP
from dispatches_tpu.units import powercurve as J
from dispatches_tpu_torch.case_studies.renewables import params as TPP
from dispatches_tpu_torch.units import powercurve as T


@pytest.fixture(scope="module")
def goldens():
    """(JAX package's, port's) `load_re_goldens`, the port's on the CPU."""
    want = JP.load_re_goldens()
    return want, TPP.load_re_goldens(device="cpu")


def test_load_re_goldens_matches_jax(goldens):
    want, got = goldens
    assert sorted(got) == sorted(want)
    for k in ("da_lmp", "wind_speed_m_s"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["da_lmp"].shape == (8736,) and float(got["da_lmp"].max()) == 200.0
    speeds = T.read_srw_wind_speeds(TPP.DATA_DIR / "windtoolkit_2012_60min_80m.srw")
    assert np.array_equal(speeds, want["wind_speed_m_s"]) and speeds.shape == (8760,)
    assert got["wind_cf"].shape == (8760,) and got["wind_cf"].dtype == np.float64
    np.testing.assert_allclose(got["wind_cf"], want["wind_cf"], rtol=1e-12, atol=0)


def test_capacity_factor_pysam_gradient_matches_jax(goldens):
    """d CF / d speed over the 8,760 vendored hours: finite everywhere
    (the clamp before the exp) and within rel 1e-10 of `jax.grad`'s."""
    speeds = goldens[0]["wind_speed_m_s"]
    want = np.asarray(jax.block_until_ready(
        jax.jit(jax.grad(lambda s: jnp.sum(J.capacity_factor_pysam(s))))(jnp.asarray(speeds))))
    s = torch.as_tensor(speeds).requires_grad_(True)
    got = torch.autograd.grad(T.capacity_factor_pysam(s).sum(), s)[0].numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_interpolated_capacity_factors_match_jax():
    """`capacity_factor_from_speed` / `_from_pdf` / `capacity_factors` on
    seeded speeds that cover the curve's ends (below cut-in, rated,
    cut-out, beyond the table), a PMF mixture, and the reference's
    per-hour (speed, direction, probability) layout."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 30.0, (7, 11))
    x[0, :5] = [0.0, 3.0, 12.0, 26.0, 27.0]
    probs = rng.random((7, 11))
    probs /= probs.sum(-1, keepdims=True)
    pairs = [
        (J.capacity_factor_from_speed(jnp.asarray(x)),
         T.capacity_factor_from_speed(x, device="cpu")),
        (J.capacity_factor_from_pdf(x, probs), T.capacity_factor_from_pdf(x, probs, device="cpu")),
        (J.capacity_factors(x[1]), T.capacity_factors(x[1], device="cpu")),
        (J.capacity_factors(x[2], kind="cf"), T.capacity_factors(x[2], kind="cf", device="cpu")),
    ]
    pdf = [[(6.0, 90.0, 0.5), (10.0, 90.0, 0.5)], [(9.0, 0.0, 1.0)]]
    pairs.append((J.capacity_factors(pdf, kind="pdf"),
                   T.capacity_factors(pdf, kind="pdf", device="cpu")))
    for want, got in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="sum to 1"):
        T.capacity_factors([[(6.0, 0.0, 0.5)]], kind="pdf", device="cpu")
    with pytest.raises(ValueError, match="unknown resource kind"):
        T.capacity_factors(x[0], kind="nope", device="cpu")
