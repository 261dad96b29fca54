"""Port parity: the NLP lane (`dispatches_tpu_torch/solvers/nlp.py`)
against the JAX package's `solvers/nlp.py`, on the CPU in float64.

Every problem of `tests/test_nlp.py`: the same converged flag, iterations
within 1 of JAX's, x within rel 1e-7 (the port's merit sums and matrix
products take another order, which can flip an Armijo near-tie), plus a
seeded 8-lane HS071-style batch whose lanes each keep their own iteration
count, and the trace.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dispatches_tpu.solvers import nlp as JN
from dispatches_tpu_torch.obs.trace import recorded_iterations
from dispatches_tpu_torch.solvers import nlp as TN

INF = np.inf
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _problems(stack, none):
    """(f, c, x0, l, u, max_iter) of each `tests/test_nlp.py` problem, in
    the array library of `stack` (JAX's or torch's)."""
    return {
        "rosenbrock": (lambda x, p: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, none,
                       [-1.2, 1.0], -INF, INF, 200),
        "hs006": (lambda x, p: (1 - x[0]) ** 2,
                  lambda x, p: stack([10.0 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], -INF, INF, 200),
        "bounds_active": (lambda x, p: (x[0] - 2.0) ** 2, none, [0.0], [-INF], [1.0], 100),
        "hs071_param": (
            lambda x, p: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
            lambda x, p: stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - 40.0,
                                x[0] * x[1] * x[2] * x[3] - x[4]]),
            [1.0, 5.0, 5.0, 1.0, 25.0], [1.0, 1, 1, 1, 25], [5.0, 5, 5, 5, INF], 300),
        "fixed_equal_bounds": (lambda x, p: (x[1] - 3.0) ** 2 + x[0] * x[1], none,
                               [1.0, 0.0], [1.0, -INF], [1.0, INF], 100),
    }


J_PROBLEMS = _problems(jnp.stack, lambda x, p: jnp.zeros((0,), x.dtype))
T_PROBLEMS = _problems(torch.stack, lambda x, p: x[:0])


MIXING = np.array([2.0, 300.0, 1.0, 450.0])
RADII = np.random.default_rng(0).uniform(30.0, 45.0, 8)  # the lane batch's sphere radii
X0_HS071 = np.tile([1.0, 5.0, 5.0, 1.0, 25.0], (8, 1))
L_HS071, U_HS071 = np.array([1.0, 1, 1, 1, 25]), np.array([5.0, 5, 5, 5, INF])


def _hs071_obj(x, p):
    return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]


def _jax_problem(f, c, x0, l, u, mi):
    return jax.block_until_ready(JN.solve_nlp(f, c, jnp.asarray(x0), jnp.asarray(l, float),
                                              jnp.asarray(u, float), tol=1e-8, max_iter=mi))


def _jax_jobs():
    jobs = {name: (lambda p=p: _jax_problem(*p)) for name, p in J_PROBLEMS.items()}
    jobs["mixing"] = lambda: jax.block_until_ready(JN.solve_square(
        lambda x, q: jnp.array([x[0] - (q[0] + q[2]), x[0] * x[1] - (q[0] * q[1] + q[2] * q[3])]),
        jnp.array([1.0, 350.0]), jnp.asarray(MIXING)))
    jobs["damped_exp"] = lambda: jax.block_until_ready(JN.solve_square(
        lambda x, q: jnp.array([jnp.exp(x[0]) - 2.0]), jnp.array([10.0]), None, max_iter=100))
    jobs["hs071_batch"] = lambda: jax.block_until_ready(JN.solve_nlp_batch(
        _hs071_obj, lambda x, p: jnp.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - p,
                                            x[0] * x[1] * x[2] * x[3] - x[4]]),
        jnp.asarray(X0_HS071), jnp.asarray(L_HS071), jnp.asarray(U_HS071),
        params_batch=jnp.asarray(RADII), tol=1e-8, max_iter=300))
    return jobs


@pytest.fixture(scope="module")
def jax_solutions():
    """The module's JAX solutions, computed once before any port call, in
    threads: tracing holds the GIL, but XLA's compiles do not."""
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(job) for name, job in _jax_jobs().items()}
        return {name: f.result() for name, f in futures.items()}


def _same(got, want):
    assert bool(got.converged) == bool(want.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-7, atol=1e-12)


# The port-only tests come first: they need no JAX reference, so a run
# cut at its time limit counts them before the references are built.
def test_bound_dual_and_trace():
    f, c, x0, l, u, mi = T_PROBLEMS["bounds_active"]
    sol, tr = TN.solve_nlp(f, c, torch.tensor(x0, dtype=F64), torch.tensor(l, dtype=F64),
                           torch.tensor(u, dtype=F64), tol=1e-8, max_iter=mi, trace=True)
    assert float(sol.zu[0]) == pytest.approx(2.0, abs=1e-4)
    assert int(recorded_iterations(tr)) == int(sol.iterations)
    plain = TN.solve_nlp(f, c, torch.tensor(x0, dtype=F64), torch.tensor(l, dtype=F64),
                         torch.tensor(u, dtype=F64), tol=1e-8, max_iter=mi)
    assert torch.equal(plain.x, sol.x)  # tracing does not change the iterates


def test_batched_quadratics():
    ts = np.array([[-1.0], [0.5], [3.0]])
    sols = TN.solve_nlp_batch(lambda x, p: torch.sum((x - p) ** 2), lambda x, p: x[:0],
                              torch.zeros((3, 1), dtype=F64), torch.tensor([0.0], dtype=F64),
                              torch.tensor([2.0], dtype=F64), params_batch=torch.tensor(ts),
                              tol=1e-8, max_iter=60)
    assert bool(sols.converged.all())
    np.testing.assert_allclose(sols.x[:, 0].numpy(), [0.0, 0.5, 2.0], atol=1e-5)


@pytest.mark.parametrize("name", sorted(T_PROBLEMS))
def test_problem_matches_jax(name, jax_solutions):
    f, c, x0, l, u, mi = T_PROBLEMS[name]
    sol = TN.solve_nlp(f, c, torch.tensor(x0, dtype=F64), torch.tensor(l, dtype=F64),
                       torch.tensor(u, dtype=F64), tol=1e-8, max_iter=mi)
    _same(sol, jax_solutions[name])
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.obj), float(jax_solutions[name].obj), rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("case", ["mixing", "damped_exp"])
def test_square_solves_match_jax(case, jax_solutions):
    want = jax_solutions[case]
    if case == "mixing":
        got = TN.solve_square(
            lambda x, q: torch.stack([x[0] - (q[0] + q[2]), x[0] * x[1] - (q[0] * q[1] + q[2] * q[3])]),
            torch.tensor([1.0, 350.0], dtype=F64), torch.tensor(MIXING, dtype=F64))
        assert float(got.x[1]) == pytest.approx((2 * 300 + 450) / 3, abs=1e-6)
    else:
        got = TN.solve_square(lambda x, q: torch.exp(x) - 2.0, torch.tensor([10.0], dtype=F64),
                              None, max_iter=100)
        assert float(got.x[0]) == pytest.approx(np.log(2.0), abs=1e-8)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-12)


def test_hs071_lane_batch_matches_jax_lanes(jax_solutions):
    """8 seeded lanes (the sphere constraint's radius varies): each lane's
    converged flag, iteration count and x are JAX's vmapped lane's."""
    want = jax_solutions["hs071_batch"]
    got = TN.solve_nlp_batch(
        _hs071_obj, lambda x, p: torch.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - p,
                                              x[0] * x[1] * x[2] * x[3] - x[4]]),
        torch.tensor(X0_HS071), torch.tensor(L_HS071), torch.tensor(U_HS071),
        params_batch=torch.tensor(RADII), tol=1e-8, max_iter=300)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    assert np.abs(got.iterations.numpy() - np.asarray(want.iterations)).max() <= 1
    assert len(set(got.iterations.tolist())) > 1  # lanes stop on their own
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-7, atol=1e-12)
