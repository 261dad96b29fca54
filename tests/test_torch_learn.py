"""Port parity: the learned warm-start subsystem (`dispatches_tpu_torch/
learn/`) against the JAX package's `learn/`, on the CPU.

Family fingerprints and features: equal hex digests and arrays for the same
numpy problems in both packages (dense, sparse, banded; batched with a
shared expanded field). Artifacts cross both ways (warm start, screener,
lane route): predictions within rel 1e-12 in float64. Every refuse-to-load
case raises `ArtifactMismatch` in both packages. The adversarial predictors
of `tests/test_learn.py` (NaN, huge, wrong shape, raising) and a disabled
predictor land bitwise on the cold path; seeds and accept verdicts from one
JAX-trained artifact equal the JAX predictor's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu import learn as JL
from dispatches_tpu.core.program import LPData as JLPData
from dispatches_tpu.core.program import SparseLP as JSparseLP
from dispatches_tpu.solvers.ipm import solve_lp as j_solve_lp
from dispatches_tpu.solvers.structured import BandedLP as JBandedLP
from dispatches_tpu_torch import learn as TL
from dispatches_tpu_torch.core.program import LPData, SparseLP
from dispatches_tpu_torch.obs import metrics as obs_metrics
from dispatches_tpu_torch.runtime.adaptive import solve_lp_adaptive
from dispatches_tpu_torch.solvers.ipm import solve_lp
from dispatches_tpu_torch.solvers.structured import BandedLP

N, M = 8, 4
_A = np.random.default_rng(7).standard_normal((M, N))
REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_problem(seed, A=_A):
    """`tests/test_learn.py`'s family: fixed A and bounds, per-seed feasible
    b and objective c, as numpy fields."""
    r = np.random.default_rng(seed)
    x0 = r.uniform(0.5, 3.5, N)
    c = r.standard_normal(N)
    return (A, A @ x0, c, np.zeros(N), np.full(N, 4.0), np.float64(0.0))


def _t(p):
    return LPData(*(torch.as_tensor(np.asarray(a)) for a in p))


def _j(p):
    return JLPData(*(jnp.asarray(a) for a in p))


def _assert_bitwise(ref, out):
    for name, a, b in zip(ref._fields, ref, out):
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's dataset (48 solves), artifact, and seeds for four
    fresh rows, made before any port computation runs."""
    tmp = tmp_path_factory.mktemp("learn")
    writer = JL.DatasetWriter(str(tmp / "jds"), varying=("b", "c"))
    for s in range(48):
        p = _j(_np_problem(s))
        sol = j_solve_lp(p)
        writer.add(p, sol, iterations=int(np.asarray(sol.iterations)))
    writer.close()
    ds = JL.load_dataset([str(tmp / "jds")], varying=("b", "c"))
    model, _ = JL.train_warmstart_model(ds, hidden=(16, 16), epochs=200, seed=0)
    path = model.save(str(tmp / "jwarm.npz"))
    rows = [_np_problem(6000 + s) for s in range(4)]
    seeds, accepted = JL.WarmStartPredictor(path).seed_rows([_j(p) for p in rows])
    X = ds.X[:6]
    out = {"tmp": tmp, "path": path, "model": model, "ds": ds, "rows": rows,
           "seeds": [tuple(np.asarray(a) for a in s) for s in seeds],
           "accepted": accepted, "X": X, "pred": model.predict(X)}
    jax.block_until_ready(out["pred"])
    return out


def _banded_fields(seed, Tb=3, mB=2, nB=3, p=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((Tb, mB, nB)), r.standard_normal((Tb, mB, nB)),
            r.standard_normal((Tb, mB, p)), r.standard_normal((Tb, mB)),
            r.standard_normal((Tb, nB)), r.standard_normal(p), np.zeros((Tb, nB)),
            np.full((Tb, nB), 5.0), np.zeros(p), np.full(p, 9.0), np.float64(1.5))


def _sparse_fields(p):
    A = p[0]
    rows, cols = np.nonzero(A)
    return (rows.astype(np.int32), cols.astype(np.int32), A[rows, cols]) + tuple(p[1:])


@pytest.mark.parametrize("kind", ["dense", "sparse", "banded"])
def test_fingerprints_and_features_equal(kind):
    make = {
        "dense": (_np_problem, JLPData, LPData),
        "sparse": (lambda s: _sparse_fields(_np_problem(s)), JSparseLP, SparseLP),
        "banded": (_banded_fields, JBandedLP, BandedLP),
    }[kind]
    gen, jcls, tcls = make
    for varying in (("b", "c"), ("b",)):
        fams = set()
        for seed in (0, 1):
            f = gen(seed)
            jp = jcls(*(jnp.asarray(a) for a in f))
            tp = tcls(*(torch.as_tensor(np.asarray(a)) for a in f))
            fam = TL.family_fingerprint(tp, varying)
            assert fam == JL.family_fingerprint(jp, varying)
            np.testing.assert_array_equal(TL.features_of(tp, varying),
                                          np.asarray(JL.features_of(jp, varying)))
            fams.add(fam)
        # the dense family varies only in b and c; the banded fields all differ
        assert len(fams) == (1 if kind != "banded" and "c" in varying else 2)


def test_batched_fingerprints_hash_shared_fields_once():
    """`family_fingerprints` over a batch whose shared field is an expanded
    tensor equals the per-row JAX fingerprints."""
    rows = [_banded_fields(0) for _ in range(3)]
    c = np.stack([np.random.default_rng(k).standard_normal(rows[0][4].shape) for k in range(3)])
    batched = BandedLP(*(
        torch.as_tensor(c) if i == 4 else
        torch.as_tensor(np.asarray(a)).unsqueeze(0).expand(3, *np.shape(a))
        for i, a in enumerate(rows[0])
    ))
    axes = [0] * len(BandedLP._fields)
    got = TL.family_fingerprints(batched, axes, 3)
    want = [JL.family_fingerprint(JBandedLP(*(
        jnp.asarray(c[k]) if i == 4 else jnp.asarray(a) for i, a in enumerate(rows[0])
    ))) for k in range(3)]
    assert got == want and len(set(got)) == 1
    # a lane whose non-varying field differs forks its own hash
    Ad = torch.as_tensor(np.stack([rows[0][0], rows[0][0] + 1.0, rows[0][0]]))
    forked = TL.family_fingerprints(batched._replace(Ad=Ad), axes, 3)
    assert forked[0] == forked[2] == want[0] != forked[1]


def test_dataset_shards_cross_between_packages(jax_ref, tmp_path):
    ds = TL.load_dataset([str(jax_ref["tmp"] / "jds")], varying=("b", "c"))
    np.testing.assert_array_equal(ds.X, jax_ref["ds"].X)
    np.testing.assert_array_equal(ds.Y, jax_ref["ds"].Y)
    assert ds.family == jax_ref["ds"].family and ds.targets == jax_ref["ds"].targets
    writer = TL.DatasetWriter(str(tmp_path), varying=("b", "c"), shard_rows=4)
    for s in range(5):
        p = _t(_np_problem(s))
        sol = solve_lp(p)
        assert writer.add(p, sol, iterations=int(sol.iterations))
    alien = _t(_np_problem(0, np.random.default_rng(9).standard_normal((M, N))))
    assert not writer.add(alien, solve_lp(alien))
    writer.close()
    jds = JL.load_dataset([str(tmp_path)], varying=("b", "c"))
    assert len(jds) == 5 and jds.family == jax_ref["ds"].family
    np.testing.assert_allclose(jds.Y, jax_ref["ds"].Y[:5], rtol=0, atol=1e-6)


def _toy(kind):
    """A small dataset of the artifact's kind: warm start, screener (one
    0/1 ``x`` block), lane route (the probe-pair columns)."""
    r = np.random.default_rng(3)
    X = r.uniform(-1, 1, (24, 6))
    if kind == "screener":
        Y, targets = (X[:, :4] > 0).astype(float), [("x", 4)]
    elif kind == "laneroute":
        Y = np.c_[np.abs(X[:, :2]) + 0.1, 10 + X[:, 2:4], (X[:, 0] > 0).astype(float)]
        targets = [("wall_dense", 1), ("wall_pdhg", 1), ("iters_dense", 1),
                   ("iters_pdhg", 1), ("chosen", 1)]
    else:
        Y, targets = X @ r.standard_normal((6, 5)), [("x", 3), ("y", 2)]
    return X, Y, targets


_KINDS = {
    "warmstart": ("WarmStartModel", "train_warmstart_model"),
    "screener": ("ScreenerModel", "train_screener_model"),
    "laneroute": ("LaneRouteModel", "train_laneroute_model"),
}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_artifacts_cross_both_ways(kind, tmp_path):
    cls, train = _KINDS[kind]
    X, Y, targets = _toy(kind)

    def ds(pkg):
        return pkg.WarmStartDataset(X, Y, family="f" * 64, varying=("b", "c"),
                                    targets=targets, problem_type="LPData")

    jmodel, _ = getattr(JL, train)(ds(JL), hidden=(8, 8), epochs=30, seed=0)
    jpath = jmodel.save(str(tmp_path / "j.npz"))
    jpred = np.asarray(jmodel.predict(X))
    tmodel, _ = getattr(TL, train)(ds(TL), hidden=(8, 8), epochs=30, seed=0,
                                   device="cpu")
    tpath = tmodel.save(str(tmp_path / "t.npz"))
    tpred = tmodel.predict(X)
    # the JAX artifact in the port, the port's in the JAX package
    got = getattr(TL, cls).load(jpath, device="cpu")
    np.testing.assert_allclose(got.predict(X), jpred, rtol=REL, atol=0)
    assert got.manifest == jmodel.manifest
    back = getattr(JL, cls).load(tpath)
    np.testing.assert_allclose(np.asarray(back.predict(X)), tpred, rtol=REL, atol=0)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)


_REFUSALS = ["family", "version", "not_artifact", "missing_scale", "missing_weights",
             "wrong_kind"]


@pytest.mark.parametrize("case", _REFUSALS)
def test_refuse_to_load_as_jax(case, jax_ref, tmp_path):
    path = jax_ref["path"]
    with np.load(path, allow_pickle=False) as dat:
        payload = {k: dat[k] for k in dat.files}
    man = json.loads(str(payload["__manifest__"]))
    kw, load = {}, "WarmStartModel"
    if case == "family":
        kw = {"expect_family": "0" * 64}
    elif case == "version":
        man["version"] = 99
    elif case == "not_artifact":
        payload = {"foo": np.zeros(3)}
    elif case == "missing_scale":
        payload.pop("scale/y_std")
    elif case == "missing_weights":
        payload = {k: v for k, v in payload.items() if not k.startswith("w/")}
    elif case == "wrong_kind":
        load = "ScreenerModel"
    if "__manifest__" in payload:
        payload["__manifest__"] = np.asarray(json.dumps(man))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **payload)
    with pytest.raises(JL.ArtifactMismatch):
        getattr(JL, load).load(bad, **kw)
    with pytest.raises(TL.ArtifactMismatch):
        getattr(TL, load).load(bad, device="cpu", **kw)
    if case == "family":
        with pytest.raises(TL.ArtifactMismatch):
            TL.WarmStartPredictor(path, expect_family="0" * 64, device="cpu")


def _rigged(base, predict_parts):
    clone = TL.WarmStartModel(base.surrogate, base.manifest)
    clone.predict_parts = predict_parts
    return clone


@pytest.mark.parametrize("adversary", ["nan", "huge", "wrong-shape", "raises"])
def test_adversarial_predictions_land_bitwise_cold(adversary, jax_ref):
    """`tests/test_learn.py`'s adversaries on the port: every lane rejected,
    every solve bitwise the cold one, alone and through the adaptive batch."""
    base = TL.WarmStartModel.load(jax_ref["path"], device="cpu")
    layout = base.targets

    def rig(X):
        if adversary == "raises":
            raise RuntimeError("synthetically poisoned artifact")
        extra = 3 if adversary == "wrong-shape" else 0
        val = {"nan": np.nan, "huge": 1e12}.get(adversary, 0.0)
        return {n: np.full((X.shape[0], d + extra), val) for n, d in layout}

    pred = TL.WarmStartPredictor(_rigged(base, rig), device="cpu")
    rows = [_t(_np_problem(5000 + s)) for s in range(3)]
    before = obs_metrics.flat_values()
    seeds, accepted = pred.seed_rows(rows, entry="test")
    after = obs_metrics.flat_values()
    assert accepted == [False] * 3
    assert sum(after.get(k, 0.0) - before.get(k, 0.0) for k in after
               if k.startswith("learned_warm_reject_total")) == 3
    for p, s in zip(rows, seeds):
        assert tuple(a.shape for a in s) == ((N,), (M,), (N,), (N,))
        _assert_bitwise(solve_lp(p), solve_lp(p, warm_start=s))
    batch = LPData(*(torch.stack(col) for col in zip(*rows)))
    _assert_bitwise(solve_lp_adaptive(batch), solve_lp_adaptive(batch, warm_predictor=pred))


def test_predictor_disabled_and_off_family_are_cold(jax_ref):
    batch = LPData(*(torch.stack(col) for col in zip(*(_t(_np_problem(7000 + s))
                                                       for s in range(3)))))
    _assert_bitwise(solve_lp_adaptive(batch), solve_lp_adaptive(batch, warm_predictor=None))
    pred = TL.WarmStartPredictor(jax_ref["path"], device="cpu")
    alien = _t(_np_problem(0, np.random.default_rng(11).standard_normal((M, N))))
    seeds, acc = pred.seed_rows([alien])
    assert acc == [False] and all(np.all(np.isnan(a)) for a in seeds[0])
    assert pred.seed_rows([BandedLP(*(torch.as_tensor(np.asarray(a))
                                      for a in _banded_fields(0)))]) == (None, None)


def test_seeds_and_verdicts_equal_across_packages(jax_ref):
    pred = TL.WarmStartPredictor(jax_ref["path"], device="cpu")
    seeds, accepted = pred.seed_rows([_t(p) for p in jax_ref["rows"]])
    assert accepted == jax_ref["accepted"] and any(accepted)
    for got, want in zip(seeds, jax_ref["seeds"]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=REL, atol=1e-14)
    # the batched entry gives the same seeds as the per-row one
    batch = LPData(*(torch.stack(col) for col in zip(*(_t(p) for p in jax_ref["rows"]))))
    bseeds, bacc = pred.seed_batch(batch, [0] * 6, 4)
    assert bacc == accepted
    for a, b in zip(bseeds, seeds):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    np.testing.assert_allclose(pred.model.predict(jax_ref["X"]), jax_ref["pred"],
                               rtol=REL, atol=0)
