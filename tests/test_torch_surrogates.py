"""Port parity: the market-surrogate stack (`dispatches_tpu_torch/
surrogates/` and the surrogate half of `convert.py`) against the JAX
package's, on the CPU.

k-means on `tests/test_surrogates.py`'s archetype sweep: the same partition
as the JAX package's up to a permutation of the labels, inertia rel 1e-6
(the k-means++ picks come from different generators). The frequency labels
of a fixed clustering: equal to the JAX package's. The MLP forward with
weights carried across by `convert.mlp_from_flax`: rel 1e-12 in float64;
50 full-batch Adam steps from the same initial weights: each step's loss
rel 1e-4 in float32; a saved surrogate read back by the other package
predicts within rel 1e-12. The CSV reader against the JAX package's on
numeric and "run_37"-style labels. ALAMO-style basis regression: rel 1e-9.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dispatches_tpu.runtime import native as jnative
from dispatches_tpu.surrogates import clustering as JC
from dispatches_tpu.surrogates import embed as JE
from dispatches_tpu.surrogates import train as JTR
from dispatches_tpu.surrogates.data import SimulationData as JSimulationData
from dispatches_tpu_torch import convert
from dispatches_tpu_torch.surrogates import (
    AlamoSurrogate,
    SimulationData,
    TimeSeriesClustering,
    TrainNNSurrogates,
    read_csv_matrix,
    smooth_nonneg,
    surrogate_fn,
    train_surrogate,
    train_surrogate_model,
)

ARCHETYPES = np.stack([
    0.5 + 0.4 * np.sin(np.linspace(0, 2 * np.pi, 24)),
    np.clip(np.linspace(0, 1, 24), 0, 0.9),
    np.full(24, 0.3),
])


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweep():
    """`tests/test_surrogates.py`'s synthetic sweep: 10 runs x 8736 h of
    three day archetypes, all-zero and all-full days."""
    rng = np.random.default_rng(0)
    n_runs, n_days = 10, 364
    pmax = rng.uniform(100, 400, n_runs)
    inputs = np.column_stack([pmax, rng.uniform(0, 1, n_runs)])
    dispatch = np.zeros((n_runs, n_days * 24))
    for r in range(n_runs):
        for d in range(n_days):
            k = rng.integers(0, 5)
            if k < 3:
                day = ARCHETYPES[k] + 0.01 * rng.standard_normal(24)
            elif k == 3:
                day = np.zeros(24)
            else:
                day = np.ones(24)
            dispatch[r, d * 24 : (d + 1) * 24] = np.clip(day, 0, 1) * pmax[r]
    return dispatch, inputs


def _flax_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def test_kmeans_partition_and_inertia_match_jax(sweep):
    dispatch, inputs = sweep
    cf = SimulationData(dispatch, inputs).dispatch_capacity_factors()
    jres = JC.TimeSeriesClustering(3).clustering_data(cf)
    res = TimeSeriesClustering(3).clustering_data(cf, device="cpu")
    assert res["centers"].shape == (3, 24)
    # the same partition up to a permutation of the labels
    pairs = set(zip(res["labels"].tolist(), np.asarray(jres["labels"]).tolist()))
    assert len(pairs) == 3
    assert res["inertia"] == pytest.approx(jres["inertia"], rel=1e-6)
    for a in ARCHETYPES:
        assert np.linalg.norm(res["centers"] - a, axis=1).min() < 0.2
    np.testing.assert_array_equal(res["zero_days"], jres["zero_days"])


def test_frequency_labels_match_jax(sweep):
    dispatch, inputs = sweep
    centers = ARCHETYPES + 0.01
    model = {"cluster_centers": centers, "n_clusters": 3}
    want = JTR.TrainNNSurrogates(JSimulationData(dispatch, inputs), model)
    got = TrainNNSurrogates(SimulationData(dispatch, inputs), model, device="cpu")
    freqs = got.generate_label_data_frequency()
    np.testing.assert_array_equal(freqs, want.generate_label_data_frequency())
    np.testing.assert_allclose(freqs.sum(1), 1.0, atol=1e-9)


def test_mlp_forward_with_converted_weights():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (32, 3))
    jm = JTR.SurrogateMLP(hidden=(8, 6), out_dim=2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), _flax_tree(jm.init(jax.random.PRNGKey(0), X[:1])))
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(X)))
    model = convert.mlp_from_flax(params, (8, 6), 2, device="cpu", dtype=torch.float64)
    got = model(torch.as_tensor(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_adam_steps_match_optax():
    """50 full-batch steps of the JAX package's `train_surrogate` loop
    (optax.adam on the standardized MSE) against the port's from the same
    initial weights."""
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    y = (X @ np.array([2.0, -1.0, 0.5]) + np.sin(3 * X[:, 0]))[:, None].astype(np.float32)
    Xs, Ys = (X - X.mean(0)) / (X.std(0) + 1e-12), (y - y.mean(0)) / (y.std(0) + 1e-12)
    jm = JTR.SurrogateMLP(hidden=(16, 16), out_dim=1)
    params = jm.init(jax.random.PRNGKey(0), Xs[:1])
    opt = optax.adam(3e-3)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda q: jnp.mean((jm.apply(q, Xs) - Ys) ** 2))(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, loss

    losses = []
    p = params
    for _ in range(50):
        p, state, loss = step(p, state)
        losses.append(float(loss))
    init = convert.mlp_from_flax(_flax_tree(params), (16, 16), 1, device="cpu")
    _, metrics = train_surrogate(X, y, hidden=(16, 16), epochs=50, lr=3e-3, device="cpu",
                                 init_model=init)
    np.testing.assert_allclose(metrics["loss"], losses, rtol=1e-4)


def test_saved_surrogates_read_in_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (64, 2))
    y = X @ np.array([2.0, -1.0]) + 3
    jsur, _ = JTR.train_surrogate(X, y, hidden=(8,), epochs=20)
    jsur.save(str(tmp_path / "j.npz"), str(tmp_path / "j.json"))
    sur = convert.load_trained_surrogate(tmp_path / "j.npz", tmp_path / "j.json", device="cpu")
    np.testing.assert_allclose(sur.predict(X).numpy(), np.asarray(jsur.predict(X)), rtol=1e-12)
    # the port writes the JAX package's keys and layout
    sur.save(str(tmp_path / "t.npz"), str(tmp_path / "t.json"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))


def test_training_fits_and_refuses_a_mesh():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (256, 3))
    y = 5e6 + 1e6 * (X[:, 0] * 2 + np.sin(3 * X[:, 1]) - X[:, 2] ** 2)
    sur, metrics = train_surrogate(X, y, hidden=(32, 32), epochs=800, lr=3e-3, device="cpu")
    assert metrics["R2"][0] > 0.97
    assert tuple(sur.predict(X[:5]).shape) == (5, 1)
    # a one-device mesh trains on its device, bitwise as mesh=None; another
    # device than the mesh's, and a mesh of more devices, are refused (the
    # port trains on one)
    from dispatches_tpu_torch.parallel import DeviceMesh, scenario_mesh

    plain, _ = train_surrogate(X, y, hidden=(8,), epochs=5, device="cpu")
    cpu_mesh = scenario_mesh(1, device="cpu")
    for kw in ({}, {"device": "cpu"}):
        meshed, _ = train_surrogate(X, y, hidden=(8,), epochs=5, mesh=cpu_mesh, **kw)
        for a, b in zip(plain.model.state_dict().values(), meshed.model.state_dict().values()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not the mesh's device"):
        train_surrogate(X, y, epochs=1, mesh=cpu_mesh, device="cuda")
    two = DeviceMesh([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="trains on one"):
        train_surrogate(X, y, epochs=1, mesh=two, device="cpu")


def _write_csv(path, labels, mat, header=True):
    with open(path, "w") as f:
        if header:
            f.write("run," + ",".join(f"h{i}" for i in range(mat.shape[1])) + "\n")
        for lab, row in zip(labels, mat):
            f.write(lab + "," + ",".join(repr(float(v)) for v in row) + "\n")


@pytest.mark.parametrize("style", ["numeric", "run_label"])
def test_csv_reader_matches_jax(tmp_path, style):
    rng = np.random.default_rng(4)
    mat = np.round(rng.uniform(0, 400, (7, 30)), 3)
    labels = [str(i) if style == "numeric" else f"run_{37 + i}" for i in range(7)]
    path = str(tmp_path / "dispatch.csv")
    _write_csv(path, labels, mat)
    want = JSimulationData(path, np.ones((7, 2)))
    got = SimulationData(path, np.ones((7, 2)))
    np.testing.assert_array_equal(got.dispatch, want.dispatch)
    np.testing.assert_array_equal(got.index, want.index)
    cut = SimulationData(path, np.ones((7, 2)), num_sims=3)
    np.testing.assert_array_equal(cut.index, want.index[:3])


def test_read_csv_matrix_matches_the_native_reader(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("# a comment\nname,x,y\n1,2.5,\n3,,4e2\n-5,nan,7junk\n")
    want = jnative.read_csv_matrix(str(path))
    got = read_csv_matrix(str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_csv_matrix(str(path), rows=(1, 3)), want[1:3])


def test_embed_matches_jax(tmp_path):
    for v in (5.0, -5.0, 0.0):
        assert float(smooth_nonneg(v)) == pytest.approx(float(JE.smooth_nonneg(v)), rel=1e-15)
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (200, 2))
    z = 3.0 + 2.0 * X[:, 0] - X[:, 1] ** 2 + 0.5 * X[:, 0] * X[:, 1]
    jsur = JE.AlamoSurrogate.fit(X, z, powers=(1, 2), interactions=True)
    sur = AlamoSurrogate.fit(X, z, powers=(1, 2), interactions=True, device="cpu")
    np.testing.assert_allclose(sur.coef.numpy(), np.asarray(jsur.coef), rtol=1e-9, atol=1e-12)
    assert sur.r2(X, z)[0] > 1 - 1e-8
    p = tmp_path / "alamo.json"
    sur.save(str(p))
    back = JE.AlamoSurrogate.load(str(p))
    np.testing.assert_allclose(np.asarray(back.predict(X)), sur.predict(X).numpy(), rtol=1e-12)
    f = surrogate_fn(sur)
    assert tuple(f(torch.as_tensor(X[0])).shape) == (1,)
    _, m = train_surrogate_model(X, z, method="alamo", device="cpu")
    assert m["R2"][0] > 0.999
    with pytest.raises(ValueError):
        train_surrogate_model(X, z, method="gp", device="cpu")
