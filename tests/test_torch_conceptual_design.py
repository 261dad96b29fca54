"""Port parity: the designs that embed market surrogates
(`dispatches_tpu_torch/case_studies/renewables/conceptual_design.py`,
`case_studies/rankine/surrogate_design.py`) against the JAX package's, on
the CPU in float64.

With `tests/test_conceptual_design.py`'s analytic stand-in surrogates: the
wind + PEM design NLP and its (bid, size) sweep with the wind size free
(one `solve_nlp_batch`): optima rel 1e-6 of the JAX package's, and the
design no worse than a brute-force grid over its box. The Rankine market
design (`conceptual_design_problem_nn`, free and with its marginal cost
fixed): optima rel 1e-6 of the JAX package's, and the JAX test's checks. A
network trained by the JAX package and carried across
(`convert.load_trained_surrogate`) as the revenue model of the nuclear
PEM sizing: rel 1e-6 of the JAX package's design with the same network.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.case_studies.nuclear import conceptual_design as JN
from dispatches_tpu.case_studies.rankine import surrogate_design as JR
from dispatches_tpu.case_studies.renewables import conceptual_design as JD
from dispatches_tpu.surrogates import train as JTR
from dispatches_tpu.surrogates.embed import surrogate_fn as j_surrogate_fn
from dispatches_tpu_torch import convert
from dispatches_tpu_torch.case_studies.nuclear import conceptual_design as TN
from dispatches_tpu_torch.case_studies.rankine import conceptual_design_problem_nn
from dispatches_tpu_torch.case_studies.renewables import conceptual_design as TD
from dispatches_tpu_torch.surrogates import surrogate_fn

OPT_RTOL = 1e-6
# the free-wind sweep's NLPs: at the default 1e-6 two lanes take the full
# 150 iterations in both packages (~12 s of eager iterations on the CPU);
# at 1e-5 the 122 of the slowest lane
SWEEP_TOL = 1e-5
K = 4
CFS = dict(dispatch_cf=np.array([0.1, 0.3, 0.5, 0.2]), pem_cf=np.array([0.3, 0.4, 0.2, 0.5]),
           wind_cf=np.array([0.5, 0.8, 0.75, 0.9]))
BIDS, SIZES = np.array([20.0, 30.0]), np.array([150.0, 300.0])
RANKINE_FIX = {"marg_cst": 12.0}
RANKINE_KEYS = ("pmax_mw", "marg_cst", "obj_npv_usd", "pmin_mw", "revenue_mm_per_yr",
                "nstartups", "op_cost_mm_per_yr")


def _analytic(xp):
    """Revenue grows with PEM size and peaks at a $30 bid; frequencies
    favour the later clusters (`tests/test_conceptual_design.py:71-82`),
    written for `xp` = jnp or torch."""
    def rev_fn(inp):
        return xp.reshape(4e7 + 1e5 * inp[1] - 2e4 * (inp[0] - 30.0) ** 2, (1,))

    def freq_fn(inp):
        base = xp.arange(1, K + 1) * 1.0
        if xp is torch:
            base = base.to(inp)
        return base / (1.0 + 0.01 * inp[0]) - 0.1

    return rev_fn, freq_fn


def _rankine(xp):
    def rev_fn(inp):
        return xp.reshape(0.5 * inp[0] - 0.05 * (inp[5] - 18.0) ** 2, (1,))

    def ns_fn(inp):
        return xp.reshape(50.0 - 2.0 * inp[3], (1,))

    def zone_fn(inp):
        z = xp.linspace(2.0, 1.0, 11)
        if xp is torch:
            z = z.to(inp)
        return z * (1.0 + 0.001 * inp[0])

    return rev_fn, ns_fn, zone_fn


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_trained():
    """A tiny JAX-trained revenue network on the nuclear design's inputs
    ([threshold price, PEM/NPP ratio, reserve, max LMP]), and the JAX
    package's PEM sizing against it."""
    rng = np.random.default_rng(3)
    X = np.column_stack([rng.uniform(10, 50, 300), rng.uniform(0.05, 0.5, 300),
                         np.full(300, 10.0), np.full(300, 500.0)])
    y = 2.0e8 * (1.0 - 0.8 * X[:, 1]) + 1.0e7 * np.sin(6.0 * X[:, 1])
    sur, _ = JTR.train_surrogate(X, y, hidden=(16,), epochs=200, lr=3e-3)
    res = JN.conceptual_design_ss_NE(j_surrogate_fn(sur), _ne_cf, h2_price=2.0)
    return sur, (float(res.pem_np_cap_ratio), float(res.objective))


def _ne_cf(x):
    return 0.98 - 0.5 * x[1]


@pytest.fixture(scope="module")
def jax_refs():
    d = JD.ConceptualDesignInputs(**CFS)
    free = dataclasses.replace(d, extant_wind=False)
    rev, freq = _analytic(jnp)
    jobs = {
        "design": lambda: JD.conceptual_design_dynamic_RE(d, rev, freq),
        "sweep": lambda: JD.design_sweep(free, rev, freq, BIDS, SIZES, tol=SWEEP_TOL),
        "trained": _jax_trained,
        "rankine": lambda: JR.conceptual_design_problem_nn(*_rankine(jnp)),
        "rankine_fixed": lambda: JR.conceptual_design_problem_nn(*_rankine(jnp),
                                                                 fix=RANKINE_FIX),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _close(got, want, keys):
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=OPT_RTOL, abs=1e-6), k


def test_re_design_matches_jax(jax_refs):
    d = TD.ConceptualDesignInputs(**CFS)
    rev, freq = _analytic(torch)
    res = TD.conceptual_design_dynamic_RE(d, rev, freq, device="cpu")
    assert res["converged"]
    _close(res, jax_refs["design"], ("wind_mw", "pem_mw", "pem_bid", "e_revenue", "NPV")
           + tuple(f"freq_day_{k}" for k in range(K)))
    assert res["pem_mw"] == pytest.approx(423.5, rel=1e-3)
    fixed = TD.conceptual_design_dynamic_RE(d, rev, freq, PEM_bid=25.0, PEM_MW=200.0,
                                            device="cpu")
    assert fixed["pem_bid"] == pytest.approx(25.0, abs=1e-4)
    assert fixed["pem_mw"] == pytest.approx(200.0, rel=1e-4)
    # no worse than a brute-force grid over the (size, bid) box
    sizes, bids = np.linspace(127.5e3, 423.5e3, 41), np.linspace(15.0, 45.0, 41)
    wind = torch.tensor(847e3, dtype=torch.float64)
    grid = max(float(TD._npv_terms(wind, torch.tensor(s, dtype=torch.float64),
                                   torch.tensor(b, dtype=torch.float64), d, rev, freq))
               for s in sizes[::4] for b in bids)
    assert res["NPV"] >= grid * (1 - 1e-9)


def test_sweep_matches_jax(jax_refs):
    d = TD.ConceptualDesignInputs(**CFS)
    free = dataclasses.replace(d, extant_wind=False)
    rev, freq = _analytic(torch)
    sweep = TD.design_sweep(free, rev, freq, BIDS, SIZES, tol=SWEEP_TOL, device="cpu")
    assert sweep["converged"].all()
    np.testing.assert_allclose(sweep["NPV"], jax_refs["sweep"]["NPV"], rtol=OPT_RTOL)
    extant = TD.design_sweep(d, rev, freq, BIDS, SIZES, device="cpu")
    assert np.all(extant["NPV"][extant["pem_bid"] == 30.0]
                  > extant["NPV"][extant["pem_bid"] == 20.0])


def test_rankine_design_solves(jax_refs):
    """The Rankine market design with `tests/test_conceptual_design.py`'s
    analytic stand-ins: its optimum (size, marginal cost, NPV and the
    terms read at it) rel 1e-6 of the JAX package's, free and with the
    marginal cost fixed, and that file's checks (`:151-167`)."""
    res = conceptual_design_problem_nn(*_rankine(torch), device="cpu")
    assert res["converged"]
    _close(res, jax_refs["rankine"], RANKINE_KEYS)
    np.testing.assert_allclose(res["zone_hours"], jax_refs["rankine"]["zone_hours"],
                               rtol=OPT_RTOL)
    assert 10.0 <= res["pmax_mw"] <= 300.0
    assert res["zone_hours"].sum() == pytest.approx(8736.0, rel=1e-6)
    assert res["pmin_mw"] == pytest.approx(res["pmin_multi"] * res["pmax_mw"], rel=1e-6)
    fixed = conceptual_design_problem_nn(*_rankine(torch), fix=RANKINE_FIX, device="cpu")
    assert fixed["converged"]
    assert fixed["marg_cst"] == pytest.approx(12.0, abs=1e-5)
    _close(fixed, jax_refs["rankine_fixed"], RANKINE_KEYS)


def test_jax_trained_network_drives_the_port_design(jax_refs, tmp_path):
    """A network trained by the JAX package, carried across by
    `convert.load_trained_surrogate`, as the revenue model of the nuclear
    PEM sizing in both packages."""
    jsur, (ratio_j, obj_j) = jax_refs["trained"]
    jsur.save(str(tmp_path / "w.npz"), str(tmp_path / "s.json"))
    sur = convert.load_trained_surrogate(tmp_path / "w.npz", tmp_path / "s.json", device="cpu")
    res = TN.conceptual_design_ss_NE(surrogate_fn(sur), _ne_cf, h2_price=2.0, device="cpu")
    assert float(res.pem_np_cap_ratio) == pytest.approx(ratio_j, rel=OPT_RTOL)
    assert float(res.objective) == pytest.approx(obj_j, rel=OPT_RTOL)
