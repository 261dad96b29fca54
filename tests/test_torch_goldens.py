"""The reference's golden-dollar tests through the port's drivers, on the
CPU in float64: `tests/test_re_goldens.py`'s four cases, at its
tolerances (rel 1e-3 on the wind + battery dollars, rel 1e-2 and abs 3-5
MW on the design cases), from the port's own `load_re_goldens`.
"""
import pytest
import torch

from dispatches_tpu_torch.case_studies.renewables import params as P
from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
    wind_battery_optimize,
    wind_battery_pem_optimize,
    wind_battery_pem_tank_turb_optimize,
)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gold():
    return P.load_re_goldens(device="cpu")


def test_wind_battery_golden(gold):
    """`test_RE_flowsheet.py:127-137`: NPV 666,049,365, revenue 59,163,455
    (rel 1e-3), battery sized to zero."""
    res = wind_battery_optimize(7 * 24, gold["da_lmp"], gold["wind_cf"], device="cpu")
    assert res["converged"]
    assert res["NPV"] == pytest.approx(666_049_365, rel=1e-3)
    assert res["annual_revenue"] == pytest.approx(59_163_455, rel=1e-3)
    assert res["batt_kw"] == pytest.approx(0.0, abs=1.0)


def test_wind_pem_golden(gold):
    """`test_RE_flowsheet.py:140-151`: PEM 487 MW, H2 revenue 155,129,116,
    elec revenue 68,599,396, NPV 1,339,462,317 (rel 1e-2)."""
    res = wind_battery_pem_optimize(6 * 24, gold["da_lmp"], gold["wind_cf"],
                                    h2_price_per_kg=2.5, design_opt="PEM", device="cpu")
    assert res["converged"]
    assert res["batt_kw"] == pytest.approx(0.0, abs=1.0)
    assert res["pem_kw"] * 1e-3 == pytest.approx(487, rel=1e-2)
    assert res["annual_rev_h2"] == pytest.approx(155_129_116, rel=1e-2)
    assert res["annual_rev_E"] == pytest.approx(68_599_396, rel=1e-2)
    assert res["NPV"] == pytest.approx(1_339_462_317, rel=1e-2)


def test_wind_battery_pem_golden(gold):
    """`test_RE_flowsheet.py:154-163`: with the battery free to size the
    optimum still puts it at zero and lands on the same PEM design."""
    res = wind_battery_pem_optimize(6 * 24, gold["da_lmp"], gold["wind_cf"],
                                    h2_price_per_kg=2.5, design_opt=True, device="cpu")
    assert res["converged"]
    assert res["batt_kw"] * 1e-3 == pytest.approx(0.0, abs=1e-3)
    assert res["pem_kw"] * 1e-3 == pytest.approx(487, abs=5)
    assert res["annual_rev_h2"] == pytest.approx(155_129_116, rel=1e-2)
    assert res["annual_rev_E"] == pytest.approx(68_599_396, rel=1e-2)
    assert res["NPV"] == pytest.approx(1_339_462_317, rel=1e-2)


def test_wind_battery_pem_tank_turb_golden(gold):
    """`test_RE_flowsheet.py:166-176`: at $2/kg H2 the tank and turbine
    size to zero, PEM to ~355 MW, NPV 1,018,975,372 (rel 1e-2)."""
    res = wind_battery_pem_tank_turb_optimize(6 * 24, gold["da_lmp"], gold["wind_cf"],
                                              h2_price_per_kg=2.0, design_opt=True,
                                              device="cpu")
    assert res["converged"]
    assert res["NPV"] == pytest.approx(1_018_975_372, rel=1e-2)
    assert res["batt_kw"] * 1e-3 == pytest.approx(0.0, abs=3)
    assert res["pem_kw"] * 1e-3 == pytest.approx(355, abs=3)
    assert res["tank_mol"] / P.H2_MOLS_PER_KG == pytest.approx(0.0, abs=3)
    assert res["turb_kw"] * 1e-3 == pytest.approx(0.0, abs=3)
    assert res["annual_rev_h2"] == pytest.approx(99_396_474, rel=1e-2)
    assert res["annual_rev_E"] == pytest.approx(28_711_076, rel=1e-2)


def test_turbine_chain_matches_jax():
    """The hydrogen turbine's chain (`properties/hturbine.py`, whose net
    specific work is the tank/turbine case's LP coefficient) against the
    JAX package's, rel 1e-12; and `test_RE_flowsheet.py:174`'s average
    turbine/compressor work ratio, ~1.51 (rel 1e-1)."""
    import numpy as np

    from dispatches_tpu.properties import hturbine as J
    from dispatches_tpu_torch.properties import hturbine as T

    flows = np.array([0.5, 1.0, 3.0])  # the LP coefficient is the chain at 1 mol/s
    want, got = J.turbine_chain(flows), T.turbine_chain(flows)
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=0, err_msg=name)
    assert T.net_specific_work_kwh_per_mol() == pytest.approx(
        float(want.net_power[1]) / 1000.0 / 3600.0, rel=1e-12)
    assert float(-got.work_turbine[1] / got.work_compressor[1]) == pytest.approx(1.51, rel=1e-1)
