"""The port's crash-domain fleet on the CPU: the shard frame codec against
the JAX package's, and one fleet of two torch shard children held
bitwise to the port's in-process service, then through an exit fault
(zero lost, a respawn, a requeue). The children run with a `jax` on
their path that refuses to import, so a child that imported it would
die and the test would fail. At most three children are spawned.
"""
import time

import numpy as np
import pytest
import torch

from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.serve import shard as jshard
from dispatches_tpu.solvers.ipm import IPMSolution as JIPMSolution
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.serve import make_dense_fleet, make_dense_service, shard
from dispatches_tpu_torch.solvers.ipm import IPMSolution
from tools.torch_loadgen import make_problem, shard_counter_deltas


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Two intra-op threads here, and so in the children (they take the
    parent's count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _biteq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _solution_row(seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=8), r.normal(size=4), r.random(8), r.random(8), r.normal(),
            np.bool_(True), np.int64(17), r.random() * 1e-9, r.random() * 1e-9,
            r.random() * 1e-10, np.int64(0))


@pytest.mark.parametrize("kind", ["problem", "solution"])
def test_frames_decode_bitwise_across_packages(kind):
    """A row encoded by either package's `shard.py` decodes bitwise in the
    other's, into that package's own row class."""
    if kind == "problem":
        leaves, jcls, cls = make_problem(3), JLPData, LPData
    else:
        leaves, jcls, cls = _solution_row(3), JIPMSolution, IPMSolution
    jrow = jcls(*(np.asarray(a) for a in leaves))
    row = cls(*(np.asarray(a) for a in leaves))
    for enc, dec, want in ((jshard.encode_row, shard.decode_row, cls),
                           (shard.encode_row, jshard.decode_row, jcls)):
        spec = enc(jrow if enc is jshard.encode_row else row)
        assert spec == (shard.encode_row(row) if enc is jshard.encode_row
                        else jshard.encode_row(jrow))  # the same bytes on the wire
        got = dec(spec)
        assert type(got) is want
        assert all(_biteq(a, b) for a, b in zip(got, leaves))


@pytest.fixture()
def no_jax_for_children(tmp_path, monkeypatch):
    """A `jax` package that refuses to import, on the children's path."""
    pkg = tmp_path / "jax"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        'raise ImportError("a shard child of the port must not import jax")\n')
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    return tmp_path


def _pump_until(fleet, cond, limit=60.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < limit:
        fleet.pump()
        time.sleep(0.005)
    return cond()


def test_fleet_bitwise_then_survives_an_exit_fault(no_jax_for_children):
    from dispatches_tpu_torch.obs import metrics as obs_metrics

    problems = {s: make_problem(s) for s in range(400, 424)}
    svc = make_dense_service(4, chunk_iters=4, max_iter=60, cache_size=None, device="cpu")
    ref = {s: svc.submit(p) for s, p in problems.items()}
    svc.drain()
    ref = {s: t.result(0).solution for s, t in ref.items()}

    before = obs_metrics.snapshot()["counters"]
    # a long heartbeat timeout: on a loaded test host a child's torch
    # import must not be taken for a wedge (an extra respawn)
    fleet = make_dense_fleet(2, 4, chunk_iters=4, cache_size=None, telemetry=True,
                             heartbeat_every=0.1, heartbeat_timeout=60.0,
                             solver_kw={"max_iter": 60},
                             stderr_dir=str(no_jax_for_children), device="cpu")
    try:
        first = {s: fleet.submit(problems[s]) for s in list(problems)[:12]}
        fleet.drain(timeout=120.0)
        # the second half: shard 0 hangs (its reader still takes frames),
        # so the lanes routed to it stay in flight until the exit fault
        fleet.inject_fault(0, "hang")
        second = {s: fleet.submit(problems[s]) for s in list(problems)[12:]}
        assert _pump_until(fleet, lambda: fleet.shard_states()[0]["inflight"] > 0)
        fleet.inject_fault(0, "exit")
        fleet.drain(timeout=120.0)  # the requeued lanes may finish on shard 1
        assert _pump_until(fleet, lambda: fleet.stats()["respawns"] >= 1)
        st = fleet.stats()
        assert st["requeued_lanes"] >= 1
        assert sum(v["spawn_count"] for v in st["shards"].values()) == 3
        tickets = {**first, **second}
        assert all(t.done() for t in tickets.values())  # zero lost
        for s, t in tickets.items():
            res = t.result(0)
            assert res.verdict == "healthy", s
            assert all(_biteq(a, b) for a, b in zip(res.solution, ref[s])), s
        # the children's counters merged under a shard label, and the
        # label-free aggregate is their sum
        assert _pump_until(fleet, lambda: fleet.health()["ok"] and all(
            abs(sum(m.values()) - u.get(k, 0.0)) < 1e-9
            for lab, u in [shard_counter_deltas(before, obs_metrics.snapshot()["counters"])]
            for k, m in lab.items()) and shard_counter_deltas(
                before, obs_metrics.snapshot()["counters"])[0])
    finally:
        fleet.close()
    assert "must not import jax" not in "".join(
        p.read_text(errors="replace") for p in no_jax_for_children.glob("shard*.log"))
