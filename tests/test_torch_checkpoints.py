"""Port parity: the sweep runners' ResultStore checkpoints
(`dispatches_tpu_torch/runtime/native.py`, `workflow/runners.py`) and the
battery sweep, against the JAX package's `_point_key`, `ResultStore` and
`run_battery_ratio_sweep`.

These cases sit apart from `test_torch_runners.py` on purpose: the suite
hands files to its workers largest first, and a larger
`test_torch_runners.py` would pull its ~20 s of year-sweep parity runs
ahead of many faster files in the time-limited tier-1 run.
"""
from pathlib import Path

import numpy as np
import pytest

from dispatches_tpu.runtime import native as JN
from dispatches_tpu.workflow import runners as JR
from dispatches_tpu_torch.runtime import native as TN
from dispatches_tpu_torch.workflow import runners as T


class _Solved(Exception):
    """Raised by a patched solver: the runner tried to solve a point."""


def _no_solve(monkeypatch, module, name):
    def refuse(*a, **k):
        raise _Solved(name)

    monkeypatch.setattr(module, name, refuse)


@pytest.mark.parametrize("point", [
    ("wind_pem", 168, 2.5), ("wind_battery", 24, 2),  # pricetaker
    (0.1, 2, 168, 847.0), (0.25, 8.0, 24, 847),  # battsweep
    ("yearsweep", 1.4554, 8760, 2.5, "float64", 1.0),  # yearsweep, JAX tier
    ("yearsweep", 0.75, 96, 2.5, "float64", 1.0, 0.0, 0.0),  # JAX's pre-knob key
    ("yearsweep", 0.75, 96, 2.5, "float64", 1.0, "factor_dtype=float64"),  # f64 tier
])
def test_point_keys_match_jax(point):
    """The store keys of all three sweeps equal the JAX package's, ints
    and floats alike (the key hashes ``float()`` of every number)."""
    assert T._point_key(*point) == JR._point_key(*point)
    as_floats = tuple(v if isinstance(v, str) else float(v) for v in point)
    assert T._point_key(*point) == T._point_key(*as_floats)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_result_store_round_trips_between_packages(tmp_path, native):
    """A store written by either package reads back in the other's
    ResultStore, byte for byte the same file, with the JAX package's
    native library and with its pure-Python writer and reader; the last
    record of a key wins and a torn tail is ignored."""

    def jax_store(path):
        store = JN.ResultStore(path)
        if not native:
            store._lib = None
        assert (store._lib is not None) == native
        return store

    recs = [(7, [1.0, 2.5]), (2**62 + 3, [-1e300, 0.0, 3.25]), (7, [4.0])]
    stores = {"port": TN.ResultStore(tmp_path / "port.bin"),
              "jax": jax_store(tmp_path / "jax.bin")}
    for store in stores.values():
        for k, v in recs:
            store.append(k, v)
    data = {name: Path(store.path).read_bytes() for name, store in stores.items()}
    assert data["port"] == data["jax"]
    for writer, reader in (("port", jax_store), ("jax", TN.ResultStore)):
        path = stores[writer].path
        Path(path).write_bytes(data[writer] + data[writer][:23])  # torn tail
        store = reader(path)
        assert store.keys() == [7, 2**62 + 3, 7]
        got = store.load()
        assert set(got) == {7, 2**62 + 3}
        np.testing.assert_array_equal(got[7], [4.0])
        np.testing.assert_array_equal(got[2**62 + 3], [-1e300, 0.0, 3.25])


def test_battery_sweep_matches_jax():
    """The battery ratio x duration sweep (24 h, 2 x 2 grid): NPV and
    revenue rel 1e-6 of the JAX package's, point by point."""
    kw = dict(ratios=(0.1, 0.5), durations=(2, 4), hours=24, verbose=False)
    want = JR.run_battery_ratio_sweep(**kw)
    got = T.run_battery_ratio_sweep(**kw, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g["battery_ratio"], g["duration_hrs"]) == (w["battery_ratio"], w["duration_hrs"])
        assert g["converged"] and w["converged"]
        assert g["NPV"] == pytest.approx(w["NPV"], rel=1e-6)
        assert g["annual_revenue"] == pytest.approx(w["annual_revenue"], rel=1e-6)


def test_resumed_pricetaker_and_battsweep_solve_nothing(tmp_path, monkeypatch):
    """Both weekly sweeps, first through the CLI's ``--out``: every point
    is stored, and a second run against the store solves none."""
    from dispatches_tpu_torch.case_studies.renewables import pricetaker as TP

    pt, bs = str(tmp_path / "pt.bin"), str(tmp_path / "bs.bin")
    assert T.main(["--device", "cpu", "pricetaker", "--hours", "24",
                   "--h2-price", "2.0", "2.5", "--out", pt]) == 0
    assert T.main(["--device", "cpu", "battsweep", "--ratio", "0.1", "0.5",
                   "--duration", "2", "--hours", "24", "--out", bs]) == 0
    assert len(TN.ResultStore(pt).keys()) == 2 and len(TN.ResultStore(bs).keys()) == 2
    _no_solve(monkeypatch, TP, "solve_lp")
    assert T.run_pricetaker(hours=24, h2_prices=[2.0, 2.5], store_path=pt,
                            verbose=False, device="cpu") == []
    assert T.run_battery_ratio_sweep(ratios=(0.1, 0.5), durations=(2,), hours=24,
                                     store_path=bs, verbose=False, device="cpu") == []
    with pytest.raises(_Solved):  # a new point is solved
        T.run_pricetaker(hours=24, h2_prices=[3.0], store_path=pt, verbose=False,
                         device="cpu")


def test_resumed_year_sweep_solves_nothing_and_tiers_keep_apart(tmp_path, monkeypatch):
    """Year sweep at 96 h, 3 scenarios in batches of 2: every converged
    scenario is stored and a resumed run solves none. The f64-factor tier
    (the default) and the JAX-parity tier (``factor_dtype="float32"``)
    keep separate keys: a store the JAX package's keys wrote (written here
    with its `_point_key` and `ResultStore`, not its sweep) is skipped by
    the float32 tier and re-solved by the default."""
    from dispatches_tpu_torch.solvers import structured as TS

    kw = dict(scenarios=3, batch=2, hours=96, verbose=False, device="cpu")
    path = str(tmp_path / "year.bin")
    first = T.run_year_sweep(store_path=path, **kw)
    assert [r["scenario"] for r in first] == [0, 1, 2] and all(r["converged"] for r in first)
    assert len(TN.ResultStore(path).keys()) == 3
    _no_solve(monkeypatch, TS, "solve_lp_banded_batch")
    assert T.run_year_sweep(store_path=path, **kw) == []
    with pytest.raises(_Solved):
        T.run_year_sweep(store_path=path, factor_dtype="float32", **kw)

    jpath = str(tmp_path / "jax_year.bin")
    jstore = JN.ResultStore(jpath)
    for scale in np.random.default_rng(0).uniform(0.5, 2.0, 3):
        # runners.py's key of a default JAX year sweep (f64 data, mixed precision)
        jstore.append(JR._point_key("yearsweep", float(scale), 96, 2.5, "float64", 1.0),
                      [scale, 0.0, 1.0])
    assert T.run_year_sweep(store_path=jpath, factor_dtype="float32", **kw) == []
    with pytest.raises(_Solved):
        T.run_year_sweep(store_path=jpath, **kw)
