"""Port parity: the lane observatory (`dispatches_tpu_torch/obs/lanes.py`)
and the learned lane router (`learn/laneroute.py`) against the JAX
package's, on the CPU.

Under a fake clock and the same probe sequence (lane timers pinned, so
both packages see the same walls), the decision records, probe records,
win ratios, scoreboards and ``route_advice`` flips equal the JAX
observatory's. Exported probe shards load in both packages'
`load_dataset` with equal arrays. ``lane_policy="model"`` routes as the
JAX router does on a JAX-trained artifact. With the observatory (probing
every solve) and the time-series store on, the adaptive entries and the
service return results bitwise those with both off.
"""
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu import learn as JL
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.obs import journal as JJ
from dispatches_tpu.obs import lanes as JLa
from dispatches_tpu.runtime import remedy as JR
from dispatches_tpu_torch import learn as TL
from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.obs import journal as TJ
from dispatches_tpu_torch.obs import lanes as TLa
from dispatches_tpu_torch.runtime import remedy as TR
from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive, solve_lp_pdhg_adaptive
from dispatches_tpu_torch.serve import make_dense_service

N, M = 8, 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_problem(seed, A_seed=7):
    A = np.random.default_rng(A_seed).standard_normal((M, N))
    r = np.random.default_rng(seed)
    x0 = r.uniform(0.5, 3.5, N)
    return (A, A @ x0, r.standard_normal(N), np.zeros(N), np.full(N, 4.0), np.float64(0.0))


class Clk:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _stub(clk, wall, iters):
    """A pinned lane timer: the probe machinery, scoring, retention and
    export stay real, only the walls are fixed."""
    def f(problem):
        clk.t += wall
        return SimpleNamespace(x=np.zeros(N), iterations=iters, obj=-1.0,
                               converged=True), wall
    return f


def _session(la, jr, journal, cls, conv, tmp):
    """One scripted observatory session: decisions on two families and both
    lanes, probes under pinned walls that flip the advice, a forced pin and
    its release; returns the transcript and the exported shard paths."""
    clk = Clk()
    tracer = journal.Tracer(None)
    with journal.use_tracer(tracer):
        obs = la.LaneObservatory(la.LaneConfig(probe_fraction=1.0, min_probes=3, hold=2,
                                               warm_probes=False, seed=3), clock=clk)
        obs.checker = None  # stub solutions carry no certifiable x
        out = []
        for phase, (wd, wp) in enumerate(((0.01, 0.5), (0.9, 0.02), (0.9, 0.02))):
            obs._solve_dense = _stub(clk, wd, 9 + phase)
            obs._solve_pdhg = _stub(clk, wp, 400 - phase)
            for s in range(4):
                p = cls(*(conv(a) for a in _np_problem(100 * phase + s)))
                out.append(obs.note_solve(p, "dense", entry="t", wall=0.1, iterations=7))
                sp = jr.dense_to_sparse(cls(*(conv(a) for a in _np_problem(50 + s, 8))))
                out.append(obs.note_solve(sp, "pdhg", entry="t", wall=0.2, iterations=70))
            out.append(obs.run_probes())
            if phase == 1:
                fam = sorted(obs.scoreboard())[0]
                obs.force_advice(fam, "pdhg")
                out.append(obs.advice(fam))
                obs.force_advice(fam, None)
        out.append(obs.scoreboard())
        rep = obs.report()
        out.append(rep)
        paths = obs.export_dataset(str(tmp))
    events = [{k: v for k, v in e.items() if k not in ("t", "mono", "ts", "wall_time")}
              for e in tracer.events if e.get("kind") == "event"]
    return json.loads(json.dumps({"out": out, "events": events}, default=str)), paths


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    jt = tmp_path_factory.mktemp("jlanes")
    tt = tmp_path_factory.mktemp("tlanes")
    jrec, jpaths = _session(JLa, JR, JJ, JLPData, jnp.asarray, jt)
    trec, tpaths = _session(TLa, TR, TJ, LPData, torch.as_tensor, tt)
    return {"j": jrec, "t": trec, "jpaths": jpaths, "tpaths": tpaths, "jdir": jt, "tdir": tt}


def test_decisions_probes_and_advice_equal_jax(sessions):
    j, t = sessions["j"], sessions["t"]
    assert t["out"] == j["out"]
    assert t["events"] == j["events"]
    flips = [e for e in t["events"] if e.get("name") == "lane_advice_flip"]
    assert flips, "the scripted walls should flip the advice"


def test_exported_shards_load_in_both_packages(sessions):
    assert len(sessions["tpaths"]) == len(sessions["jpaths"]) == 2
    for jp, tp in zip(sorted(sessions["jpaths"]), sorted(sessions["tpaths"])):
        with np.load(jp) as a, np.load(tp) as b:
            assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))
        for loader in (JL.load_dataset, TL.load_dataset):
            ja, ta = loader([jp]), loader([tp])
            np.testing.assert_array_equal(ja.X, ta.X)
            np.testing.assert_array_equal(ja.Y, ta.Y)
            assert ja.family == ta.family and ja.targets == ta.targets


def test_model_policy_routes_as_jax(sessions, tmp_path):
    """A JAX-trained lane-route artifact, served by both routers: the same
    lanes and iteration predictions, and the port's adaptive entries re-lane
    where the model says."""
    paths = []
    for shard in sessions["jpaths"]:
        ds = JL.load_dataset([shard])
        model, _ = JL.train_laneroute_model(ds, hidden=(8, 8), epochs=60, seed=0)
        paths.append(model.save(str(tmp_path / f"{ds.problem_type}.npz")))
    jr = JL.as_laneroute(paths)
    tr = TL.as_laneroute(paths, device="cpu")
    for s in range(6):
        f = _np_problem(900 + s)
        jp = jr.route(JLPData(*(jnp.asarray(a) for a in f)))
        tp = tr.route(LPData(*(torch.as_tensor(a) for a in f)))
        assert tp.lane == jp.lane
        np.testing.assert_allclose(tp.iterations, jp.iterations, rtol=1e-12)
    for fam in list(jr.families) + [None, "0" * 64]:
        assert tr.advice(fam) == jr.advice(fam)
    # the dense family's probes said PDHG wins (the last walls): re-laned
    stats = {}
    lp = LPData(*(torch.as_tensor(a) for a in _np_problem(990)))
    want = jr.route(JLPData(*(jnp.asarray(a) for a in _np_problem(990)))).lane
    sol = solve_lp_adaptive(lp, lane_policy="model", lane_model=tr, stats=stats)
    assert stats.get("relaned") == ("pdhg" if want == "pdhg" else None)
    assert bool(sol.converged)
    assert stats["lane_prediction"]["lane"] == want


def _batch(seeds):
    return LPData(*(torch.stack([torch.as_tensor(a) for a in col])
                    for col in zip(*(_np_problem(s) for s in seeds))))


def _biteq(ref, out):
    for a, b in zip(ref, out):
        a, b = torch.as_tensor(a).numpy(), torch.as_tensor(b).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_planes_on_are_bitwise_off():
    """Probe every solve and keep the store: the answers do not move."""
    lp = _batch(range(3))
    obs = TLa.as_lanes({"probe_fraction": 1.0})
    _biteq(solve_lp_adaptive(lp), solve_lp_adaptive(lp, lanes=obs, lane_policy="static"))
    one = LPData(*(a[0] for a in lp))
    _biteq(solve_lp_adaptive(one), solve_lp_adaptive(one, lanes=obs, lane_policy="advice"))
    slp = TR.dense_to_sparse(one)
    kw = dict(tol=1e-6, max_iter=4000)
    _biteq(solve_lp_pdhg_adaptive(slp, **kw), solve_lp_pdhg_adaptive(slp, lanes=obs, **kw))
    recs = obs.run_probes()
    assert recs and all(r["outcome"] in ("chosen_best", "regret") for r in recs)
    assert obs.report()["decisions"] == 5
    # the service with the observatory probing every solve and the store on
    rows = [_np_problem(40 + s) for s in range(5)]
    got = {}
    for on in (False, True):
        svc = make_dense_service(4, cache_size=None, device="cpu", timeseries=on,
                                 lanes={"probe_fraction": 1.0} if on else None)
        tickets = [svc.submit(LPData(*r)) for r in rows]
        svc.drain()
        got[on] = [t.result(0).solution for t in tickets]
        if on:
            assert svc.lanes.report()["probes_run"] > 0
            assert svc.store.stats()["series"] > 0
    for a, b in zip(got[False], got[True]):
        _biteq(a, b)
