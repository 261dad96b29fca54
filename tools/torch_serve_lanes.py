#!/usr/bin/env python
"""Is a lane of the port's dense IPM independent of its batch companions
on this device? The serving tier's contract (`runtime/adaptive.py::
SlotEngine`) is that a lane harvested by the engine is bitwise the same
lane of a one-shot `solve_lp_batch` at the bucket; this tool finds where
that holds and, when it does not, which operation mixes lanes.

    python tools/torch_serve_lanes.py              # on the card
    python tools/torch_serve_lanes.py --device cpu --hours 24

Over the weekly design LPs of rts303 (T = 168 by default; lanes of 8):

1. solves: a group of 8 weeks twice (repeatable?), reversed (position?),
   one week among other companions, and the 8 through a `SlotEngine`
   admitted at once (chunked resume without refills) and with refills;
   each lane compared bitwise with the first one-shot batch;
2. operations: each batched operation of an IPM iteration at the real
   shapes (the normal-equations product, the Cholesky factor, the
   Cholesky solve, the triangular solves that can replace it, the
   matrix-vector products, the norms), run on a batch and again with
   every other lane's input changed: does lane 0's output move? And with
   lane 0 moved to positions 1..4 of the batch, in the natural layout
   and with every lane's start padded to 64 elements: does its output
   depend on where in memory the lane starts?

Prints one line a check and a JSON summary last; exits 1 when a solve
check is not bitwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

KW = dict(tol=1e-8, max_iter=60)


def weekly_rows(hours=168, device="cuda"):
    """The 52 weekly design LPs of rts303 as host rows (numpy leaves)."""
    import numpy as np
    import torch

    from dispatches_tpu_torch.case_studies.renewables import params as P
    from dispatches_tpu_torch.case_studies.renewables.pricetaker import (
        HybridDesign, build_pricetaker,
    )
    from dispatches_tpu_torch.core.program import LPData
    from dispatches_tpu_torch.solvers.ipm import _LP_NDIM

    prog = build_pricetaker(HybridDesign(
        T=hours, with_battery=True, with_pem=True, design_opt=True,
        h2_price_per_kg=2.5, initial_soc_fixed=None))[0]
    data = P.load_rts303()
    params = {"lmp": data["da_lmp"][:52 * hours].reshape(52, hours),
              "wind_cf": data["da_wind_cf"][:52 * hours].reshape(52, hours)}
    lp = prog.instantiate({k: torch.as_tensor(v, device=device) for k, v in params.items()},
                          device=device)
    host = {n: f.cpu().numpy() for n, f in zip(LPData._fields, lp)}
    return [LPData(*(np.asarray(f[w] if f.ndim > _LP_NDIM[n] else f)
                     for n, f in host.items())) for w in range(52)]


def stack(rows, device):
    import numpy as np
    import torch

    from dispatches_tpu_torch.core.program import LPData

    return LPData(*(torch.as_tensor(np.stack([r[i] for r in rows]), device=device)
                    for i in range(len(LPData._fields))))


def _lanes(sol):
    return [type(sol)(*(f[i].cpu().numpy() for f in sol)) for i in range(sol.x.shape[0])]


def _same(a, b):
    import numpy as np

    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes() for x, y in zip(a, b))


def solve_checks(rows, device, log):
    """Section 1: whole solves, each lane against the first batch's."""
    from dispatches_tpu_torch.runtime.adaptive import make_dense_engine
    from dispatches_tpu_torch.solvers.ipm import solve_lp_batch

    group = list(range(8))
    ref = dict(zip(group, _lanes(solve_lp_batch(stack([rows[w] for w in group], device), **KW))))
    its = {w: int(ref[w].iterations) for w in group}
    out = {}

    def report(name, got):
        bad = [w for w, lane in got.items() if not _same(lane, ref[w])]
        out[name] = bad
        log(f"[solve] {name}: {len(got) - len(bad)} of {len(got)} lanes bitwise the first "
            f"batch's; differing weeks {bad}"
            + (f" (iterations {[int(got[w].iterations) for w in bad]} against "
               f"{[its[w] for w in bad]})" if bad else ""))

    report("repeat", dict(zip(group, _lanes(
        solve_lp_batch(stack([rows[w] for w in group], device), **KW)))))
    rev = group[::-1]
    report("reversed", dict(zip(rev, _lanes(
        solve_lp_batch(stack([rows[w] for w in rev], device), **KW)))))
    mixed = [0] + list(range(20, 27))
    report("week 0 among weeks 20-26", {0: _lanes(
        solve_lp_batch(stack([rows[w] for w in mixed], device), **KW))[0]})

    def engine_run(todo):
        eng = make_dense_engine(8, chunk_iters=8, device=device, **KW)
        todo, got = list(todo), {}
        while todo or eng.active():
            while todo and eng.free_slots():
                w = todo.pop(0)
                eng.admit(w, rows[w])
            for w, row, _ in eng.step():
                got[w] = row
        return got

    report("engine, 8 admitted at once", engine_run(group))
    got = engine_run([30, 31, 32, 33] + group)  # the group's weeks refill freed slots
    report("engine with refills", {w: got[w] for w in group})
    log(f"[solve] iterations of weeks 0-7 {its}")
    return out


def op_checks(rows, device, log):
    """Section 2: each batched operation of an IPM iteration, lane 0's
    output with the other lanes' inputs changed."""
    import torch

    from dispatches_tpu_torch.solvers.ipm import _chol, solve_lp_partial

    lp = stack([rows[w] for w in range(8)], device)
    other = stack([rows[w] for w in [0] + list(range(40, 47))], device)
    # a mid-solve iterate of each batch, to give the operations real values
    _, st = solve_lp_partial(lp, it_stop=6, **KW)
    _, st2 = solve_lp_partial(other, it_stop=3, **KW)
    A, A2 = lp.A, other.A
    d = (st.zl / (st.x - lp.l).clamp(min=1e-3) + 1e-3)
    d2 = d.clone()
    d2[1:] = (st2.zl / (st2.x - other.l).clamp(min=1e-3) + 1e-3)[1:]
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)

    def normal_eq(A_, d_):
        return (A_ * (1.0 / d_)[:, None, :]) @ A_.transpose(-1, -2) + 1e-12 * eye

    K, K2 = normal_eq(A, d), normal_eq(A2, d2)
    L, L2 = _chol(K, symmetrize=False), _chol(K2, symmetrize=False)
    r = st.y.clone()
    r2 = r.clone()
    r2[1:] = st2.y[1:]
    x, x2 = st.x, st.x.clone()
    x2[1:] = st2.x[1:]
    ops = {
        "normal equations (A W Aᵀ, batched gemm)": lambda i: normal_eq(*((A, d), (A2, d2))[i]),
        "cholesky_ex": lambda i: _chol((K, K2)[i], symmetrize=False),
        "cholesky_solve": lambda i: torch.cholesky_solve((r, r2)[i][..., None], (L, L2)[i]),
        "solve_triangular x2": lambda i: torch.linalg.solve_triangular(
            (L, L2)[i].transpose(-1, -2), torch.linalg.solve_triangular(
                (L, L2)[i], (r, r2)[i][..., None], upper=False), upper=True),
        "A x (batched gemv)": lambda i: ((A, A2)[i] @ (x, x2)[i][..., None]),
        "Aᵀ y (batched gemv)": lambda i: ((A, A2)[i].transpose(-1, -2) @ (r, r2)[i][..., None]),
        "vector_norm": lambda i: torch.linalg.vector_norm((x, x2)[i], dim=-1),
        "amin": lambda i: (x, x2)[i].amin(-1),
    }
    out = {}
    for name, f in ops.items():
        a, again, b = f(0), f(0), f(1)
        rep = bool(torch.equal(a, again))
        lane0 = bool(torch.equal(a[0], b[0]))
        out[name] = dict(repeatable=rep, lane0_independent=lane0)
        log(f"[op] {name}: repeatable {rep}, lane 0 unchanged by the other lanes {lane0}")
    out.update(position_checks(A, d, K, L, r, x, log))
    return out


def _roll(t, k):
    """`t` with every lane moved k positions up (lane j at j + k mod B)."""
    import torch

    return torch.roll(t, k, dims=0)


def padded(t, elems=64):
    """A copy of the batch `t` whose lanes start `elems`-element-aligned
    (the lane stride rounded up), as the other strides were."""
    import torch

    per = t[0].numel()
    stride = -(-per // elems) * elems
    buf = torch.empty(t.shape[0] * stride, dtype=t.dtype, device=t.device)
    v = buf.as_strided(t.shape, (stride,) + tuple(t[0].stride()))
    v.copy_(t)
    return v


def position_checks(A, d, K, L, r, x, log):
    """Each operation on lane 0 at position 0 and at positions 1..4 of the
    batch (the batch rolled): lane offsets in bytes differ by the lane's
    size, so a kernel that picks its path from a lane's address alignment
    gives other bits at another position. Again with every lane's start
    padded to 64 elements."""
    import torch

    from dispatches_tpu_torch.solvers.ipm import _chol
    from dispatches_tpu_torch.solvers.pdhg import _vsum

    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)

    def ops(A_, d_, K_, L_, r_, x_, pad):
        P = padded if pad else (lambda t: t)
        AW = P(A_ * (1.0 / d_)[:, None, :])
        return {
            "A x": lambda: A_ @ x_[..., None],
            "Aᵀ y": lambda: A_.transpose(-1, -2) @ r_[..., None],
            "A W": lambda: A_ * (1.0 / d_)[:, None, :],
            "(A W) Aᵀ": lambda: AW @ A_.transpose(-1, -2) + 1e-12 * eye,
            "cholesky_ex": lambda: _chol(K_, symmetrize=False),
            "cholesky_solve": lambda: torch.cholesky_solve(r_[..., None], L_),
            "solve_triangular x2": lambda: torch.linalg.solve_triangular(
                L_.transpose(-1, -2), torch.linalg.solve_triangular(
                    L_, r_[..., None], upper=False), upper=True),
            "vector_norm": lambda: torch.linalg.vector_norm(x_, dim=-1),
            "vector_norm over rows": lambda: torch.linalg.vector_norm(r_, dim=-1),
            "sum": lambda: (x_ * x_).sum(-1),
            "sum over rows": lambda: (r_ * r_).sum(-1),
            "fixed-order halving sum": lambda: _vsum(x_ * x_),
        }

    out = {}
    for pad in (False, True):
        tag = "padded lanes" if pad else "natural layout"
        base = ops(*((padded(t) if pad else t) for t in (A, d, K, L, r, x)), pad)
        ref = {k: f()[0] for k, f in base.items()}
        same = {k: [] for k in base}
        for k in range(1, 5):
            rolled = ops(*((padded(_roll(t, k)) if pad else _roll(t, k))
                           for t in (A, d, K, L, r, x)), pad)
            for name, f in rolled.items():
                same[name].append(bool(torch.equal(f()[k], ref[name])))
        for name, s in same.items():
            log(f"[position] {name} ({tag}): lane 0 at positions 1..4 bitwise its "
                f"position-0 output {s}")
        out[tag] = same
    return {"position": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_serve_lanes", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hours", type=int, default=168)
    args = ap.parse_args(argv)
    import torch

    if str(args.device).startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch_serve_lanes: no CUDA device")
    if str(args.device).startswith("cuda"):
        print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}", flush=True)

    def log(msg):
        print(msg, flush=True)

    rows = weekly_rows(args.hours, args.device)
    ops = op_checks(rows, args.device, log)
    solves = solve_checks(rows, args.device, log)
    print(json.dumps({"device": str(args.device), "ops": ops, "solves": solves}))
    return 1 if any(solves.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
