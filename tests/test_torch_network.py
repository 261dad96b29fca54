"""Port parity: the network market (`dispatches_tpu_torch/market/network.py`)
and the `doubleloop` runner against the JAX package's, on the CPU in float64.

Data and programs: the loaders and seeded synthesizers give bitwise-equal
grids; the lowered programs instantiate to the same A, b, c (rel 1e-12),
with equal `col_index` and `row_ranges`. Solves: `solve_hours` x, LMPs and
cost within 1e-7 of their max|.|; the heuristic and the host optimizing RUC
give the same schedules; the port's device RUC backend (here on the CPU)
costs what its host backend costs (rel 1e-6). The loop: one five-bus day of
the double loop with the wind + PEM participant, and the CLI's summary.
The JAX package runs once per module fixture, at one day.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from dispatches_tpu.market import network as J
from dispatches_tpu.workflow.options import SimulationOptions as JOptions
from dispatches_tpu.workflow.runners import run_double_loop as j_run_double_loop
from dispatches_tpu_torch.market import network as P
from dispatches_tpu_torch.workflow import runners as R


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads for the port's CPU solves (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    return J.load_rts_format(), P.load_rts_format()


@pytest.fixture(scope="module")
def jax_day():
    """The JAX package's `doubleloop` for one day: rows, summary, and the
    RUC's (inputs, schedule) calls, recorded on the way."""
    calls = []
    commit = J.OptimizingUnitCommitment.commit

    def recording(self, loads, ren, *a, **kw):
        out = commit(self, loads, ren, *a, **kw)
        calls.append((np.array(loads), np.array(ren), self.backend, out.copy()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J.OptimizingUnitCommitment, "commit", recording)
        rows, summary = j_run_double_loop(JOptions(num_days=1), verbose=False)
    return rows, summary, calls


def _assert_grids_equal(gj, gp):
    for f in dataclasses.fields(gj):
        a, b = getattr(gj, f.name), getattr(gp, f.name)
        if f.name in ("thermal", "renewable"):
            assert len(a) == len(b)
            for ua, ub in zip(a, b):
                for uf in dataclasses.fields(ua):
                    va, vb = getattr(ua, uf.name), getattr(ub, uf.name)
                    if isinstance(va, np.ndarray):
                        assert va.dtype == vb.dtype
                        assert va.tobytes() == vb.tobytes(), (f.name, uf.name)
                    else:
                        assert va == vb, (f.name, uf.name)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def test_loaders_and_synthesizers_bitwise(grids):
    gj, gp = grids
    assert P.FIVE_BUS_DIR == J.FIVE_BUS_DIR
    _assert_grids_equal(gj, gp)
    _assert_grids_equal(J.extend_grid_to_year(gj, days=9, seed=3),
                        P.extend_grid_to_year(gp, days=9, seed=3))
    _assert_grids_equal(J.synthesize_fleet(n_units=14, days=2, seed=4),
                        P.synthesize_fleet(n_units=14, days=2, seed=4))
    _assert_grids_equal(J.synthesize_network(n_buses=12, n_units=10, seed=5),
                        P.synthesize_network(n_buses=12, n_units=10, seed=5))
    with pytest.raises(ValueError, match="rating_mode"):
        P.synthesize_network(n_buses=10, n_units=10, rating_mode="typo")


def _lp_close(pj, pp, params):
    """The two lowerings are the same program (equal fingerprints, row
    regions and column indices), and the port's `instantiate` gives the A,
    b, c that the JAX package's lowering assembles to on the host, within
    1e-12 of max|.|."""
    from dispatches_tpu_torch.solvers.reference import coo_standard_form

    assert pp.fingerprint() == pj.fingerprint()
    assert pj.row_ranges == pp.row_ranges
    for name in pj._vars:
        try:
            want = pj.col_index(name)
        except ValueError:
            with pytest.raises(ValueError, match="fixed"):
                pp.col_index(name)
            continue
        np.testing.assert_array_equal(pp.col_index(name), want)
    A, b, c, bounds, c0 = coo_standard_form(pj, params)
    lq = pp.instantiate(params, device="cpu")
    for name, want, got in (("A", A.toarray(), lq.A), ("b", b, lq.b), ("c", c, lq.c),
                            ("l", bounds[:, 0], lq.l), ("u", bounds[:, 1], lq.u)):
        got = got.numpy()
        scale = max(float(np.abs(want[np.isfinite(want)]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale, err_msg=name)
    assert float(lq.c0) == pytest.approx(c0, rel=1e-12, abs=1e-12)


def test_programs_instantiate_equal(grids):
    """`dcopf_program` (participant, reserve, a flow cut), `uc_program` and
    `contingency_dcopf_program` (the `branch_on` A-matrix group); the
    contingency stack against the JAX package's own `instantiate` is in
    `test_torch_contingency.py`."""
    from dispatches_tpu.market.contingency import contingency_dcopf_program as j_ctg
    from dispatches_tpu_torch.market.contingency import contingency_dcopf_program as p_ctg

    gj, gp = grids
    sim = J.ProductionCostSimulator(gj, uc="heuristic")
    load = sim._bus_loads(gj.da_load[5])
    cuts = [({0: 1.0, 2: -0.4}, 90.0)]
    base = {"load": load, "ren_cap": gj.da_renewables[5], "commit": np.ones(4)}
    pj = J.dcopf_program(gj, 2, 10, reserve=True, flow_cuts=cuts)
    pp = P.dcopf_program(gp, 2, 10, reserve=True, flow_cuts=cuts)
    assert pp.balance_row0 == pj.balance_row0 and pp.n_bus == pj.n_bus
    _lp_close(pj, pp, {**base, "bid_mw": np.array([3.0, 4.0]),
                       "bid_cost": np.array([0.0, 25.0]), "reserve_req": np.array([10.0])})
    T = 8
    uj, up = J.uc_program(gj, T), P.uc_program(gp, T)
    assert (up.uc_T, up.uc_G, up.uc_reserve_row0) == (uj.uc_T, uj.uc_G, uj.uc_reserve_row0)
    _lp_close(uj, up, {"load_total": gj.da_load[:T].sum(1),
                       "ren_total": gj.da_renewables[:T].sum(1)})
    cj, cp = j_ctg(gj), p_ctg(gp)
    np.testing.assert_array_equal(cp.flow_cols, cj.flow_cols)
    on = np.ones(len(gj.branch_b))
    on[1] = 0.0
    _lp_close(cj, cp, {**base, "branch_on": on, "branch_cap": gj.branch_limit * 1.1})


def test_solve_hours_matches_jax(grids, jax_day):
    """A day of the participant's reserve SCED program, the shape of the
    double loop's day-ahead batch (so the JAX package reuses the loop's
    compiled solve): x, bus LMPs (the balance rows' duals, unscaled and in
    the JAX package's sign) and cost within 1e-7 of their max|.|."""
    gj, gp = grids
    sim = J.ProductionCostSimulator(gj, participant_segments=2, uc="heuristic")
    loads = np.stack([sim._bus_loads(gj.da_load[h]) for h in range(24)])
    commit = J.UnitCommitment(gj).commit(gj.da_load.sum(1)[:24],
                                         gj.da_renewables.sum(1)[:24])
    kw = dict(bid_mw=np.tile([3.0, 4.0], (24, 1)), bid_cost=np.tile([0.0, 25.0], (24, 1)),
              reserve_req=np.full(24, gj.reserve_mw))
    want = J.solve_hours(sim.prog, gj, loads, gj.da_renewables[:24], commit, **kw)
    got = P.solve_hours(P.dcopf_program(gp, 2, reserve=True), gp, loads,
                        gp.da_renewables[:24], commit, device="cpu", **kw)
    assert got["converged"].all() and want["converged"].all()
    for key, a, b in (("x", np.asarray(want["x"]), got["x"].numpy()),
                      ("lmp", want["lmp"], got["lmp"]), ("cost", want["cost"], got["cost"])):
        assert b.shape == a.shape, key
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7 * np.abs(a).max(), err_msg=key)
    assert got["lmp"].min() > 0


def test_unit_commitment_schedules(grids, jax_day):
    """The heuristic RUC gives equal schedules; the optimizing RUC's host
    backend gives the schedule JAX's took in the double loop's day."""
    gj, gp = grids
    loads, ren, backend, want = jax_day[2][0]
    assert backend == "host"
    np.testing.assert_array_equal(P.UnitCommitment(gp).commit(loads, ren),
                                  J.UnitCommitment(gj).commit(loads, ren))
    ouc = P.OptimizingUnitCommitment(gp, backend="auto", device="cpu")
    assert ouc.backend == "host"
    np.testing.assert_array_equal(ouc.commit(loads, ren), want)


def test_device_backend_costs_what_host_does(grids):
    """The port's batched device evaluation (on the CPU here, T = 8) chooses
    a schedule whose cost, evaluated exactly by the host backend, is the
    host backend's chosen cost within 1e-6. The device evaluation itself
    reads the cost at the penalty solve's tolerance (tol 1e-7 on an
    objective the 1e3 penalties dominate): 8.5e-5 above the exact cost
    here, as the JAX package's device backend reads it; it lies within
    [1 - 1e-6, 1.01] of the exact MILP's cost, the JAX package's gate."""
    _, gp = grids
    T = 8
    loads, ren = gp.da_load[:T].sum(1), gp.da_renewables[:T].sum(1)
    dev = P.OptimizingUnitCommitment(gp, T=T, backend="device", device="cpu")
    host = P.OptimizingUnitCommitment(gp, T=T, backend="host", device="cpu")
    s_dev, s_host = dev.commit(loads, ren), host.commit(loads, ren)
    exact, ok = host._evaluate(np.stack([s_dev, s_host]), loads, ren)
    assert ok.all()
    assert exact[0] == pytest.approx(exact[1], rel=1e-6)
    c_dev, ok_dev = dev._evaluate(s_dev[None], loads, ren)
    assert ok_dev[0]
    milp = P.solve_uc_milp(dev.prog, {"load_total": loads, "ren_total": ren})
    want = milp.obj_with_offset * 1e3
    assert want * (1 - 1e-6) <= c_dev[0] <= want * 1.01
    assert want * (1 - 1e-6) <= exact[1] <= want * 1.01


def _port_day(device="cpu"):
    """One five-bus day through the port's `ProductionCostSimulator` with
    the participant `run_double_loop` builds."""
    from dispatches_tpu_torch.market import (
        DoubleLoopCoordinator, PEMParametrizedBidder, PerfectForecaster,
        RenewableGeneratorModelData, Tracker,
    )
    from dispatches_tpu_torch.market.double_loop import MultiPeriodWindPEM

    grid = P.load_rts_format()
    cfs = np.clip(grid.da_renewables[:, 0] / max(u.p_max for u in grid.renewable), 0, 1)
    gen = grid.renewable[0].name
    md = RenewableGeneratorModelData(gen_name=gen, bus=str(grid.buses[0]), p_min=0.0, p_max=50.0)
    mp = MultiPeriodWindPEM(model_data=md, wind_capacity_factors=cfs,
                            wind_pmax_mw=50, pem_pmax_mw=10)
    bidder = PEMParametrizedBidder(
        mp, day_ahead_horizon=24, real_time_horizon=4,
        forecaster=PerfectForecaster({f"{gen}-DACF": cfs, f"{gen}-RTCF": cfs}),
        pem_marginal_cost=25.0, pem_mw=10,
    )
    tracker = Tracker(mp, tracking_horizon=4, n_tracking_hour=1, device=device)
    sim = P.ProductionCostSimulator(grid, participant_segments=2, device=device)
    assert sim.uc.backend == "host"  # "auto" on the CPU
    rows = sim.simulate(n_days=1, coordinator=DoubleLoopCoordinator(bidder, tracker))
    return rows, mp


def test_production_cost_simulator_with_participant(jax_day):
    """Same convergence flags; LMPs, participant MW, cost and shortfalls
    within 1e-6 of their max|.| (measured ~1e-13)."""
    want = jax_day[0]
    got, mp = _port_day()
    assert len(got) == len(want) == 24
    assert list(got[0]) == list(want[0])
    assert [r["SCED Converged"] for r in got] == [r["SCED Converged"] for r in want]
    assert all(r["SCED Converged"] for r in got)
    for key in want[0]:
        a = np.array([r[key] for r in want], float)
        b = np.array([r[key] for r in got], float)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * max(np.abs(a).max(), 1.0),
                                   err_msg=key)
    assert max(r["Participant [MW]"] for r in got) > 1.0
    assert len(mp.result_list) == 24 * 4


def test_doubleloop_cli_matches_jax_summary(jax_day, capsys, tmp_path):
    """`main(["doubleloop", "--days", "1", "--device", "cpu"])`: the summary
    it prints equals the JAX package's within 1e-9 relative; the CSV it
    writes reads back; the default device is the card."""
    from dispatches_tpu_torch.workflow.postprocess import read_results_csv

    want = jax_day[1]
    out = tmp_path / "dl.csv"
    assert R.main(["doubleloop", "--days", "1", "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    rows = read_results_csv(str(out))
    assert len(rows) == 24
    assert R.run_double_loop.__defaults__[-1] == "cuda"
