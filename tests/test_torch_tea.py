"""Port parity: TEA (`dispatches_tpu_torch/tea/`) against the JAX package's,
on the CPU in float64.

The annuity, MACRS and NPV arithmetic (rel 1e-12); the ARMA fit on the
same series (rel 1e-10, the same host least squares); the ARMA realizations
and the synthetic-history pipeline, whose innovations come from another
generator than the JAX package's, held by `tests/test_tea_pdhg.py`'s own
statistical checks; the saved model read by both packages; the ARMA model
and a k-means result carried across by `convert`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.surrogates.clustering import KMeansResult as JKMeansResult
from dispatches_tpu.tea import arma as JA
from dispatches_tpu.tea import npv as JN
from dispatches_tpu.tea import syn_hist as JH
from dispatches_tpu_torch import convert
from dispatches_tpu_torch.tea import arma as TA
from dispatches_tpu_torch.tea import npv as TN
from dispatches_tpu_torch.tea import syn_hist as TH


def _series(T=24 * 120, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    return 30 + 10 * np.sin(2 * np.pi * t / 24) + rng.normal(0, 2, T)


def test_npv_arithmetic_matches_jax():
    assert TN.present_value_annuity(0.08, 30) == pytest.approx(11.257783, rel=1e-6)
    assert TN.present_value_annuity(0.08, 30) == JN.present_value_annuity(0.08, 30)
    assert TN.MACRS == JN.MACRS
    cf = np.array([-1000.0, 500.0, 500.0, 500.0])
    assert float(TN.npv_cash_flows(cf, 0.1)) == pytest.approx(
        float(JN.npv_cash_flows(cf, 0.1)), rel=1e-12)
    for kw in (dict(), dict(tax_rate=0.2), dict(tax_rate=0.21, macrs_years=7)):
        got = TN.project_npv(capex=1000.0, annual_revenue=200.0, annual_om=20.0, **kw)
        want = JN.project_npv(capex=1000.0, annual_revenue=200.0, annual_om=20.0, **kw)
        assert float(got) == pytest.approx(float(want), rel=1e-12), kw
    hr = np.linspace(0.0, 3.0, 168)
    assert float(TN.hourly_revenue_to_annual(hr)) == pytest.approx(
        float(JN.hourly_revenue_to_annual(hr)), rel=1e-12)


def test_arma_fit_matches_jax():
    s = _series()
    for kw in (dict(p=2, q=1, fourier_periods=(24.0,)), dict(p=3, q=2)):
        got, want = TA.fit_arma(s, **kw), JA.fit_arma(s, **kw)
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12,
                                       err_msg=name)


def test_generate_statistics():
    """`tests/test_tea_pdhg.py:46-57`'s checks on the port's realizations."""
    model = TA.fit_arma(_series(), p=2, q=1, fourier_periods=(24.0,))
    sims = TA.generate(model, T=24 * 10, generator=0, n_realizations=4, device="cpu")
    assert tuple(sims.shape) == (4, 240)
    assert float(sims.mean()) == pytest.approx(30.0, abs=3.0)
    prof = sims.numpy().reshape(4, 10, 24).mean(axis=(0, 1))
    assert prof.max() - prof.min() > 10
    again = TA.generate(model, T=240, generator=0, n_realizations=4, device="cpu")
    np.testing.assert_array_equal(again.numpy(), sims.numpy())


def test_generate_recursion_matches_jax_without_noise():
    """With sigma = 0 the realizations are the seasonal mean in both
    packages, whatever the generators draw."""
    m = TA.fit_arma(_series(), p=2, q=1, fourier_periods=(24.0, 168.0))
    m0 = m._replace(sigma=torch.zeros(()))
    got = TA.generate(m0, 96, device="cpu").numpy()
    jm = JA.fit_arma(_series(), p=2, q=1, fourier_periods=(24.0, 168.0))
    want = np.asarray(JA.generate(jm._replace(sigma=jm.sigma * 0.0), 96, jax.random.PRNGKey(0)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_saved_arma_reads_in_both_packages(tmp_path):
    model = TA.fit_arma(_series(T=24 * 60), p=2, q=1, fourier_periods=(24.0,))
    TH.save_arma(model, str(tmp_path / "t.json"))
    back = JH.load_arma(str(tmp_path / "t.json"))
    for a, b in zip(model, back):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jmodel = JA.fit_arma(_series(T=24 * 60), p=2, q=1, fourier_periods=(24.0,))
    carried = convert.arma_from_numpy([np.asarray(a) for a in jmodel])
    for a, b in zip(carried, model):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)


def test_kmeans_result_carried_across():
    rng = np.random.default_rng(0)
    res = JKMeansResult(centers=jnp.asarray(rng.normal(size=(3, 4))),
                        labels=jnp.asarray(rng.integers(0, 3, 50)),
                        inertia=jnp.asarray(12.5))
    got = convert.kmeans_from_numpy([np.asarray(a) for a in res], device="cpu")
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(res.centers))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(res.labels))
    assert got.labels.dtype == torch.int64
    assert float(got.inertia) == float(res.inertia)


def test_synthetic_history_shape(tmp_path):
    t = np.arange(24 * 90)
    series = 30.0 + 10.0 * np.sin(2 * np.pi * t / 24.0) + np.random.default_rng(1).normal(
        0, 3, t.size)
    path = tmp_path / "m.json"
    TH.save_arma(TA.fit_arma(series, fourier_periods=(24.0,)), str(path))
    sh = TH.SynHistIntegration(str(path), device="cpu")
    years = [2025, 2026]
    out = sh.generate_synthetic_history("LMP", years, n_clusters=5, days_per_year=60)
    assert set(out) == {"weights_days", "LMP", "cluster_map"}
    for year in years:
        assert set(out["weights_days"][year]) == set(range(1, 6))
        assert sum(out["weights_days"][year].values()) == 60
        all_days = sorted(d for ds in out["cluster_map"][year].values() for d in ds)
        assert all_days == list(range(60))
        assert set(out["LMP"][year][1]) == set(range(1, 25))
    assert out["LMP"][2025][1] != out["LMP"][2026][1]
    with pytest.raises(KeyError, match="not in this model"):
        sh.generate_synthetic_history("WIND", [2025])
