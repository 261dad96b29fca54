"""Port parity: the learned N-1 screener (`dispatches_tpu_torch/learn/
screener.py`) and `secure_dispatch(screener=)` against the JAX package's,
on the CPU.

Operating points of `tests/test_contingency.py`'s tight 8-bus grid are
labelled by the port's full (unscreened) constraint generation and written
as `learn.dataset` shards; the JAX package trains one screener artifact on
them. Its criticality masks are equal in both packages. On the port's
`secure_dispatch`, a blind screener cannot let a violation escape (the
full-set verify falls back), an oracle screener is accepted first time,
and the trained artifact's screened dispatches are N-1 feasible at the
unscreened objective.
"""
import dataclasses

import numpy as np
import pytest
import torch

from dispatches_tpu import learn as JL
from dispatches_tpu.learn import screener as JS
from dispatches_tpu.market import contingency as JC
from dispatches_tpu.market import network as JN
from dispatches_tpu_torch.learn import screener as TS
from dispatches_tpu_torch.learn.dataset import DatasetWriter
from dispatches_tpu_torch.market import contingency as C
from dispatches_tpu_torch.market import network as TN
from dispatches_tpu_torch.obs import metrics as obs_metrics

KW = dict(max_iter=60, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _soften(u, k=0.15):
    pmin = k * u.p_min
    scale = (u.p_max - pmin) / max(u.p_max - u.p_min, 1e-9)
    return dataclasses.replace(u, p_min=pmin, seg_mw=np.asarray(u.seg_mw, float) * scale)


def _grid(net):
    g = net.synthesize_network(n_buses=8, n_units=6, days=1, seed=0)
    return dataclasses.replace(g, thermal=[_soften(u) for u in g.thermal],
                               branch_limit=np.asarray(g.branch_limit, float) * 0.75)


def _draw(base, rng, lo=0.9, hi=1.15):
    p = dict(base)
    p["load"] = np.asarray(base["load"]) * rng.uniform(lo, hi, size=np.shape(base["load"]))
    return p


class _Recording:
    def __init__(self, mask):
        self.mask, self.accepts, self.caught = mask, 0, 0

    def screen(self, problem, cset):
        return self.mask

    def note_accept(self):
        self.accepts += 1

    def note_violation_fallback(self, n=1):
        self.caught += n


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("screener")
    grid = _grid(TN)
    cset = C.ContingencySet.n_minus_1(grid, gens=False)
    base = C.base_operating_point(grid, hour=0)
    prog0 = TN.dcopf_program(grid)
    rng = np.random.default_rng(7)
    writer = DatasetWriter(str(tmp / "shards"), varying=TS.SCREEN_VARYING, shard_rows=8)
    points = []
    for _ in range(14):
        p = _draw(base, rng)
        sd = C.secure_dispatch(grid, p, cset, **KW)
        assert sd.feasible and sd.escaped_violations == 0
        lp = prog0.instantiate({k: np.asarray(v) for k, v in p.items()}, device="cpu")
        assert writer.add(lp, {"x": TS.screen_targets(cset, sd.violated_outages)})
        points.append((p, float(sd.sol.obj)))
    writer.flush()
    ds = JL.load_dataset([str(tmp / "shards")], varying=JS.SCREEN_VARYING,
                         healthy_only=False)
    model, _ = JL.train_screener_model(ds, hidden=(16, 16), epochs=200, seed=0)
    path = model.save(str(tmp / "screener.npz"))
    return {"path": path, "grid": grid, "cset": cset, "points": points, "base": base}


def test_masks_from_a_jax_artifact_equal(trained):
    jgrid = _grid(JN)
    jcset = JC.ContingencySet.n_minus_1(jgrid, gens=False)
    jprog, tprog = JN.dcopf_program(jgrid), TN.dcopf_program(trained["grid"])
    jscr = JS.as_screener(trained["path"])
    tscr = TS.as_screener(trained["path"], device="cpu")
    assert tscr.families == jscr.families
    kept = []
    for p, _ in trained["points"][:6]:
        params = {k: np.asarray(v) for k, v in p.items()}
        jm = jscr.screen(jprog.instantiate(params), jcset)
        tm = tscr.screen(tprog.instantiate(params, device="cpu"), trained["cset"])
        assert jm is not None and tm is not None
        np.testing.assert_array_equal(tm, np.asarray(jm))
        kept.append(tm.mean())
    assert min(kept) < 1.0, "the screen never shrank the set"
    # an unseen family (another grid) falls back to the full set in both
    for net, scr in ((TN, tscr), (JN, jscr)):
        g = net.synthesize_network(n_buses=8, n_units=6, days=1, seed=1)
        cs = (C if net is TN else JC).ContingencySet.n_minus_1(g, gens=False)
        params = {k: np.asarray(v) for k, v in
                  (C if net is TN else JC).base_operating_point(g, hour=0).items()}
        kw = {"device": "cpu"} if net is TN else {}
        assert scr.screen(net.dcopf_program(g).instantiate(params, **kw), cs) is None


def test_blind_screener_cannot_escape_violations(trained):
    grid, cset = trained["grid"], trained["cset"]
    p, _ = trained["points"][0]
    blind = _Recording(np.zeros(len(cset.branch_indices()), bool))
    before = obs_metrics.flat_values()
    sd = C.secure_dispatch(grid, p, cset, screener=blind, **KW)
    after = obs_metrics.flat_values()
    assert blind.caught > 0, "vacuous probe: the point had no violations"
    assert sd.screened and sd.screen_fallback
    assert sd.feasible and sd.escaped_violations == 0 and blind.accepts == 0
    key = "screener_violation_fallback_total"
    assert after.get(key, 0.0) > before.get(key, 0.0)


def test_oracle_screener_accepted(trained):
    grid, cset = trained["grid"], trained["cset"]
    p, obj = trained["points"][1]
    truth = C.secure_dispatch(grid, p, cset, **KW).violated_outages
    assert truth
    oracle = _Recording(TS.screen_targets(cset, truth) >= 0.5)
    sd = C.secure_dispatch(grid, p, cset, screener=oracle, **KW)
    assert sd.screened and not sd.screen_fallback and sd.shrink_ratio < 1.0
    assert sd.feasible and sd.escaped_violations == 0
    assert oracle.accepts == 1 and oracle.caught == 0
    assert abs(float(sd.sol.obj) - obj) <= 1e-6 * max(1.0, abs(obj))


def test_trained_artifact_secures_every_point(trained):
    """`secure_dispatch(screener=PATH)`: no escaped violation, the unscreened
    objective, a smaller evaluated set."""
    grid, cset = trained["grid"], trained["cset"]
    shrunk = 0
    for p, obj in trained["points"][6:10]:
        sd = C.secure_dispatch(grid, p, cset, screener=trained["path"], **KW)
        assert sd.feasible and sd.escaped_violations == 0
        assert abs(float(sd.sol.obj) - obj) <= 1e-6 * max(1.0, abs(obj))
        shrunk += sd.shrink_ratio < 1.0
    assert shrunk
