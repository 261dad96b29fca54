"""A dense IPM lane's bits do not depend on where in the batch it sits:
the serving engine puts a lane in whatever slot is free, and holds it to
the same lane of a one-shot `solve_lp_batch` at the bucket.

On the card, PyTorch's reductions over a row (`sum`, `vector_norm`) add in
an order that depends on the row's address alignment, so with rows of an
odd length the same lane gave other bits at another position
(`tools/torch_serve_lanes.py`, ROADMAP C). The IPM's per-lane sums are
fixed-order halving sums there (`ipm._lane_sum`); on the CPU they stay
torch's. Imports no JAX: the card machine runs this file.
"""
import numpy as np
import pytest
import torch

from dispatches_tpu_torch.core.program import LPData
from dispatches_tpu_torch.runtime.adaptive import make_dense_engine
from dispatches_tpu_torch.solvers import ipm
from tools.torch_loadgen import make_problem

# odd row lengths: consecutive f64 lanes start at other 16-byte alignments
N, M = 257, 129


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stack(problems, device):
    return LPData(*(torch.as_tensor(np.stack([p[i] for p in problems]), device=device)
                    for i in range(len(LPData._fields))))


def _lanes(sol):
    return [[f[i].cpu().numpy().tobytes() for f in sol] for i in range(sol.x.shape[0])]


def _position_checks(device):
    problems = [make_problem(s, n=N, m=M) for s in range(8)]
    kw = dict(tol=1e-8, max_iter=60)
    ref = _lanes(ipm.solve_lp_batch(_stack(problems, device), **kw))
    rev = _lanes(ipm.solve_lp_batch(_stack(problems[::-1], device), **kw))[::-1]
    eng = make_dense_engine(8, chunk_iters=4, device=device, **kw)
    todo = [100, 101, 102] + list(range(8))  # the 8 refill freed slots
    got = {}
    while todo or eng.active():
        while todo and eng.free_slots():
            s = todo.pop(0)
            eng.admit(s, problems[s] if s < 8 else make_problem(s, n=N, m=M))
        for s, row, _ in eng.step():
            got[s] = [np.asarray(f).tobytes() for f in row]
    return ref, rev, [got[s] for s in range(8)]


def test_lane_sums_keep_the_cpu_bits():
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(5, N)))
    assert torch.equal(ipm._lane_sum(v), v.sum(-1))
    assert torch.equal(ipm._lane_norm(v), torch.linalg.vector_norm(v, dim=-1))
    rolled = ipm._vsum(torch.roll(v, 1, dims=0))
    assert torch.equal(rolled[1], ipm._vsum(v)[0])  # the halving sum at any position
    ref, rev, eng = _position_checks("cpu")
    assert rev == ref and eng == ref


@pytest.mark.cuda
def test_lane_is_position_independent_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault and its repair are the card's")
    ref, rev, eng = _position_checks("cuda")
    assert rev == ref  # each lane at the mirrored position
    assert eng == ref  # through the engine's refilled slots
