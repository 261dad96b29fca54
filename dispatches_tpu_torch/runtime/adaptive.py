"""Adaptive batched solving: lane retirement and compaction (port of
`dispatches_tpu/runtime/adaptive.py`).

A plain batched solve runs every lane until the slowest one converges:
the IPM loop (`ipm._solve_scaled`) computes finished lanes along with the
rest and discards their updates. This module recovers that waste on the
host without touching any lane's iterate sequence:

- **Lane retirement.** The segmented entry points (`ipm.solve_lp_partial`,
  `structured.solve_lp_banded_batch(..., return_state=True)`,
  `pdhg.solve_lp_pdhg(..., return_state=True)`) run the solve in chunks of `chunk_iters` iterations and return each lane's
  resumable `IPMState`. Between chunks the loop reads every lane's
  `done` and `it` to the host (one transfer a chunk) and harvests the
  finished lanes' rows.
- **Compaction.** The surviving lanes' data and states are gathered on
  the device into a smaller batch, which resumes. The state lives in the
  solver's scaled frame, recomputed from each lane's own data, so a lane
  harvested while its bucket is unchanged is bitwise the one-shot solve.
  After the bucket shrinks, a lane runs the same iteration sequence, but
  batched linear algebra whose rounding depends on the batch count may
  move its last bits (the IPMs). PDHG's products and reductions are
  fixed-order, so its lanes stay bitwise through compaction too.
- **Buckets.** Active-lane counts are padded up to a geometric ladder
  (`bucket_ladder`) with duplicates of the first survivor, exactly as in
  the JAX package, where each rung is one compiled executable. Eager
  PyTorch compiles nothing; the padding is kept so that `stats` and each
  lane's iterate sequence compare with the JAX package's (PERF.md, Open
  questions, asks whether the port should drop it).

`stats` (when a dict) receives the JAX package's keys but its compile
accounting: ``adaptive_entry``, ``batch``, ``chunk_iters``, ``chunks``,
``buckets``, ``lanes_retired``, ``total_iterations``, ``remediated``
when the remedy ladder ran, and two of the port's own:
``lane_iterations``, the lane-iterations the chunks ran (bucket x loop
iterations, summed over chunks), and ``padded_lane_iterations``, the
share of them spent on padding rows. ``adaptive_lanes_retired_total``
counts the lanes retired while their batch ran on.

``conformance=`` (True, a `ConformancePolicy`, a mapping or a
`ConformanceChecker`) certifies every returned lane against its KKT
conditions (`obs.conformance`) into ``stats["conformance"]`` and the
``solve_residual_*`` histograms; it only reads the results, which stay
bitwise those of the same call without it.

The JAX package's `perf`, `lanes`, `lane_policy`, `lane_model` and
`warm_predictor` options and its serving-tier `SlotEngine` are not
ported yet; the options raise NotImplementedError.
Its persistent compile cache and compile-hit accounting manage XLA's
executables and have no counterpart in eager PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..obs import metrics as obs_metrics
from ..solvers.ipm import _reject_deferred, _tree_map

obs_metrics.describe(
    "adaptive_lanes_retired_total",
    "Lanes retired from an adaptive batch while the batch ran on.",
)


def bucket_ladder(batch: int, base: int = 8) -> list:
    """Geometric ladder of lane-count buckets for `batch` lanes:
    ``[base, 2*base, 4*base, ...]`` capped at, and always including,
    `batch`."""
    if batch <= 0:
        raise ValueError(f"batch must be positive (got {batch})")
    rungs = []
    b = base
    while b < batch:
        rungs.append(b)
        b *= 2
    rungs.append(batch)
    return rungs


def next_bucket(n: int, ladder: list) -> int:
    """Smallest ladder rung holding `n` active lanes."""
    for b in ladder:
        if b >= n:
            return b
    return ladder[-1]


def _batch_axes(fields_cls, base_ndim, data):
    """Per-field batch axis (0 or None) and the batch size (None when no
    field carries one)."""
    axes, batch = [], None
    for name, arr in zip(fields_cls._fields, data):
        nd = base_ndim[name]
        if arr.dim() == nd + 1:
            axes.append(0)
            batch = arr.shape[0]
        elif arr.dim() == nd:
            axes.append(None)
        else:
            raise ValueError(f"bad ndim for {fields_cls.__name__}.{name}")
    return axes, batch


def _stack_rows(cls, rows):
    """Per-lane result rows -> one batched `cls`, in the original lane
    order."""
    return cls(*(torch.stack([r[i] for r in rows]) for i in range(len(cls._fields))))


def _adaptive_drive(entry, fields_cls, data, axes, batch, seg_cold, seg_resume,
                    sol_cls, max_iter, chunk_iters, ladder, warm_start, trace,
                    stats):
    """Host-side retirement / compaction loop shared by the dense, banded
    and PDHG entry points.

    ``seg_cold(d, w, stop)`` starts a bucketed sub-batch (optionally from
    per-lane warm seeds) and ``seg_resume(d, s, stop)`` resumes one from
    its gathered states; both return ``(solution, state)``, the trace
    riding in ``state.trace``. A lane retires when its state is `done` or
    out of iterations. Returns the solution rows stacked in the original
    lane order, and the stitched traces (or None)."""
    device = data[0].device
    dtype = next(a.dtype for a in data if torch.is_floating_point(a))

    def take(lane_rows):
        idx = torch.as_tensor(lane_rows, device=device)
        return fields_cls(*(
            a.index_select(0, idx) if ax == 0 else a for a, ax in zip(data, axes)
        ))

    out_rows = [None] * batch
    tr_rows = [None] * batch if trace else None
    active = list(range(batch))
    chunks = 0
    buckets_used = []
    lanes_retired = 0
    lane_iterations = padded_lane_iterations = 0

    bucket = next_bucket(batch, ladder)
    cur_map = active + [active[0]] * (bucket - batch)  # row -> original lane
    d_cur = take(cur_map)
    w_cur = None
    if warm_start is not None:
        idx0 = torch.as_tensor(cur_map, device=device)
        w_cur = tuple(
            torch.as_tensor(w, dtype=dtype, device=device).index_select(0, idx0)
            for w in warm_start
        )
    st_cur = None
    it_stop = 0
    stop = 0

    while True:
        prev_stop = stop
        it_stop += chunk_iters
        stop = min(it_stop, max_iter)
        if st_cur is not None:
            sol, st = seg_resume(d_cur, st_cur, stop)
        else:
            sol, st = seg_cold(d_cur, w_cur, stop)
        chunks += 1
        buckets_used.append(bucket)
        # the chunk's one host read: every row's stop flag and iteration
        done_h, it_h = torch.stack([st.done.long(), st.it]).cpu().tolist()
        finished = [d or i >= max_iter for d, i in zip(done_h, it_h)]
        # every row still running entered the chunk at prev_stop
        loop_iters = max(it_h) - prev_stop
        lane_iterations += bucket * loop_iters
        padded_lane_iterations += (bucket - len(set(cur_map))) * loop_iters

        still = []  # (row in current batch, original lane)
        seen = set()  # padding rows duplicate a real lane; count it once
        for row, lane in enumerate(cur_map):
            if lane in seen or out_rows[lane] is not None:
                continue
            seen.add(lane)
            if finished[row]:
                out_rows[lane] = [leaf[row] for leaf in sol]
                if trace:
                    tr_rows[lane] = [leaf[row] for leaf in st.trace]
            else:
                still.append((row, lane))
        newly = len(active) - len(still)
        active = [lane for _, lane in still]
        if not active:
            break
        # lanes that stopped consuming device time while the batch runs on
        lanes_retired += newly

        new_bucket = next_bucket(len(active), ladder)
        if new_bucket < bucket:
            # compaction: gather the survivors; duplicates of the first one
            # pad the bucket (their results are dropped by the guard above)
            rows = [r for r, _ in still]
            rows += [rows[0]] * (new_bucket - len(rows))
            cur_map = active + [active[0]] * (new_bucket - len(active))
            d_cur = take(cur_map)
            idx = torch.as_tensor(rows, device=device)
            st = _tree_map(lambda a: a.index_select(0, idx), st)
            bucket = new_bucket
        st_cur = st

    if lanes_retired:
        obs_metrics.inc("adaptive_lanes_retired_total", lanes_retired, entry=entry)
    out = _stack_rows(sol_cls, out_rows)
    tr_out = None
    if trace:
        from ..obs.trace import SolveTrace

        tr_out = _stack_rows(SolveTrace, tr_rows)
    if stats is not None:
        stats.update(
            adaptive_entry=entry,
            batch=batch,
            chunk_iters=chunk_iters,
            chunks=chunks,
            buckets=buckets_used,
            lanes_retired=lanes_retired,
            total_iterations=int(out.iterations.sum()),
            lane_iterations=lane_iterations,
            padded_lane_iterations=padded_lane_iterations,
        )
    return out, tr_out


def _remedy_info(verdict, outcome) -> dict:
    """JSON-safe per-lane remediation record for `stats`."""
    return {
        "original": verdict.verdict,
        "verdict": outcome.verdict.verdict,
        "rung": outcome.rung,
        "attempts": outcome.attempts,
        "recovered": outcome.recovered,
    }


def _apply_remedy(remedy, fields_cls, data, axes, batch, out, tr, budget,
                  *, meta=None, stats=None):
    """Classify every lane of the result (from its trace when there is one)
    and run the remedy ladder on the remediable ones, substituting
    recovered rows in place. Lanes that stay unhealthy keep their rows;
    traces are not rewritten (a remediated lane's trace is the record of
    why the ladder ran). The same tensors come back when every lane is
    healthy."""
    from ..obs import health as obs_health
    from .remedy import REMEDIABLE

    verdicts = obs_health.classify_trace(tr, sol=out) if tr is not None else None
    if verdicts is None:
        verdicts = obs_health.classify_solution(out, budget=budget) or []
    bad = [i for i, v in enumerate(verdicts) if v.verdict in REMEDIABLE]
    if not bad:
        return out, tr
    infos = {}
    if batch is None:
        outc = remedy.remediate(fields_cls(*data), verdicts[0], meta=meta)
        infos[0] = _remedy_info(verdicts[0], outc)
        if outc.recovered:
            out = outc.solution
    else:
        fields = [leaf.clone() for leaf in out]
        for i in bad:
            problem = fields_cls(*(a[i] if ax == 0 else a for a, ax in zip(data, axes)))
            outc = remedy.remediate(problem, verdicts[i], meta=meta)
            infos[i] = _remedy_info(verdicts[i], outc)
            if outc.recovered:
                for leaf, new in zip(fields, outc.solution):
                    leaf[i] = new
        out = type(out)(*fields)
    if stats is not None:
        stats["remediated"] = {int(k): v for k, v in infos.items()}
    return out, tr


def _check_conformance(conformance, fields_cls, data, axes, batch, out, entry,
                       *, meta=None, stats=None):
    """Certify every lane of the (possibly remediated) result; the summary
    goes into ``stats["conformance"]``. Only reads `out`."""
    from ..obs.conformance import FIELDS, as_conformance

    checker = as_conformance(conformance, meta=meta)
    if checker is None:
        return None
    problem = fields_cls(*data)
    if batch is None:
        fields = checker.check_row(problem, out, entry=entry, meta=meta)
        summary = {
            "entry": entry,
            "lanes": [fields],
            "ok": fields["ok"],
            "worst": {name: fields[name] for name in FIELDS},
        }
    else:
        summary = checker.check_batch(problem, axes, out, entry=entry, meta=meta)
    if stats is not None:
        stats["conformance"] = summary
    return summary


def solve_lp_adaptive(
    lp,
    *,
    chunk_iters: int = 8,
    ladder_base: int = 8,
    warm_start=None,
    warm_predictor=None,
    trace: bool = False,
    stats: Optional[dict] = None,
    remedy=None,
    perf=None,
    conformance=None,
    lanes=None,
    lane_policy=None,
    lane_model=None,
    **solver_kw,
):
    """Adaptive-batch version of `ipm.solve_lp_batch`: each lane's result is
    what the plain batched solve gives it (bitwise while its bucket is
    unchanged, see the module docstring), but lanes that converge early
    retire and the batch is compacted down the bucket ladder.

    Returns the batched `IPMSolution`; with ``trace=True``
    ``(IPMSolution, SolveTrace)``, the stitched traces equal to the
    one-shot ones. `stats`, when a dict, receives the loop's accounting.
    Unbatched input takes the plain solve. `remedy` (a
    `runtime.remedy.RemedyEngine`, `RemedyPolicy`, dict or True) runs the
    escalation ladder on lanes that retire unhealthy, and records each in
    ``stats["remediated"]``; its last rung re-solves a stuck lane through
    PDHG. `conformance` certifies the returned lanes (module docstring).

    `warm_predictor`, `perf`, `lanes`, `lane_policy` and `lane_model` are
    not ported yet and raise NotImplementedError."""
    from ..core.program import LPData
    from ..solvers.ipm import _LP_NDIM, IPMSolution, solve_lp, solve_lp_partial

    _reject_deferred(warm_predictor=warm_predictor, perf=perf, lanes=lanes,
                     lane_policy=lane_policy, lane_model=lane_model)
    axes, batch = _batch_axes(LPData, _LP_NDIM, lp)
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp")
    max_iter = solver_kw.get("max_iter", 60)
    if batch is None:
        out0 = solve_lp(lp, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, LPData, lp, axes, None, sol0, tr0,
                                      max_iter, stats=stats)
        _check_conformance(conformance, LPData, lp, axes, None, sol0, "solve_lp",
                           stats=stats)
        return (sol0, tr0) if trace else sol0

    def seg_cold(d, w, stop):
        return solve_lp_partial(d, warm_start=w, it_stop=stop, trace=trace, **solver_kw)

    def seg_resume(d, s, stop):
        return solve_lp_partial(d, state=s, it_stop=stop, trace=trace, **solver_kw)

    out, tr = _adaptive_drive(
        "solve_lp", LPData, lp, axes, batch, seg_cold, seg_resume, IPMSolution,
        max_iter, chunk_iters, bucket_ladder(batch, ladder_base), warm_start,
        trace, stats,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, LPData, lp, axes, batch, out, tr,
                                max_iter, stats=stats)
    _check_conformance(conformance, LPData, lp, axes, batch, out, "solve_lp",
                       stats=stats)
    return (out, tr) if trace else out


def solve_lp_banded_adaptive(
    meta,
    blp,
    *,
    chunk_iters: int = 8,
    ladder_base: int = 8,
    warm_start=None,
    warm_predictor=None,
    trace: bool = False,
    stats: Optional[dict] = None,
    remedy=None,
    perf=None,
    conformance=None,
    lanes=None,
    lane_policy=None,
    **solver_kw,
):
    """Adaptive-batch version of `structured.solve_lp_banded_batch`, with
    the contract of `solve_lp_adaptive` (the year-scenario path). Each
    segment is one batched banded solve, so on CUDA tensors every chunk
    runs its sweeps through the chain-sweep kernel at the bucket's batch
    size. The remedy ladder has no lane switch here (no paired lane), so
    ``remedy=True`` works as it stands. `conformance` certifies the
    returned lanes through the banded certificate, the reduced solution
    scattered back to the flat frame through ``meta.col_pos``.
    `warm_predictor`, `perf`, `lanes` and `lane_policy` are not ported yet
    and raise NotImplementedError."""
    from ..solvers.ipm import IPMSolution
    from ..solvers.structured import _BASE_NDIM, BandedLP, solve_lp_banded, solve_lp_banded_batch

    _reject_deferred(warm_predictor=warm_predictor, perf=perf, lanes=lanes,
                     lane_policy=lane_policy)
    axes, batch = _batch_axes(BandedLP, _BASE_NDIM, blp)
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp_banded")
    max_iter = solver_kw.get("max_iter", 60)
    if batch is None:
        out0 = solve_lp_banded(meta, blp, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, BandedLP, blp, axes, None, sol0, tr0,
                                      max_iter, meta=meta, stats=stats)
        _check_conformance(conformance, BandedLP, blp, axes, None, sol0,
                           "solve_lp_banded", meta=meta, stats=stats)
        return (sol0, tr0) if trace else sol0

    def segment(d, w, s, stop):
        out = solve_lp_banded_batch(
            meta, d, warm_start=w, state=s, it_stop=stop, trace=trace,
            return_state=True, **solver_kw,
        )
        return (out[0], out[2]) if trace else out

    out, tr = _adaptive_drive(
        "solve_lp_banded", BandedLP, blp, axes, batch,
        lambda d, w, stop: segment(d, w, None, stop),
        lambda d, s, stop: segment(d, None, s, stop),
        IPMSolution, max_iter, chunk_iters, bucket_ladder(batch, ladder_base),
        warm_start, trace, stats,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, BandedLP, blp, axes, batch, out, tr,
                                max_iter, meta=meta, stats=stats)
    _check_conformance(conformance, BandedLP, blp, axes, batch, out,
                       "solve_lp_banded", meta=meta, stats=stats)
    return (out, tr) if trace else out


def solve_lp_pdhg_adaptive(
    lps,
    *,
    chunk_iters: int = 2000,
    ladder_base: int = 8,
    warm_start=None,
    warm_predictor=None,
    trace: bool = False,
    stats: Optional[dict] = None,
    remedy=None,
    perf=None,
    conformance=None,
    lanes=None,
    lane_policy=None,
    lane_model=None,
    **solver_kw,
):
    """Adaptive-batch PDHG over a batch of `SparseLP`s sharing one sparsity
    pattern (batched b/c/l/u/c0, and `vals` when A is parametric; `rows`
    and `cols` unbatched), with the contract of `solve_lp_adaptive`.
    `chunk_iters` is rounded up to a whole number of check periods
    (`check_every`), as the PDHG loop only stops between checks. Lanes
    stay bitwise the one-shot `solve_lp_pdhg` batch's through compaction
    (fixed-order products). `warm_start` is a per-lane ``(x, y)``. The
    `remedy` ladder's last rung re-solves a stuck lane through the dense
    IPM; `conformance` certifies the returned lanes. The PDLP controls
    (``adaptive_restarts``, ``primal_weight``, ``linesearch``, ``polish``)
    ride through ``solver_kw`` into `solve_lp_pdhg`. `warm_predictor`,
    `perf`, `lanes`, `lane_policy` and `lane_model` are not ported yet and
    raise NotImplementedError."""
    from ..core.program import SparseLP
    from ..solvers.pdhg import _SPARSE_NDIM, PDHGSolution, solve_lp_pdhg

    _reject_deferred(warm_predictor=warm_predictor, perf=perf, lanes=lanes,
                     lane_policy=lane_policy, lane_model=lane_model)
    axes, batch = _batch_axes(SparseLP, _SPARSE_NDIM, lps)
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp_pdhg")
    max_iter = solver_kw.get("max_iter", 100_000)
    if batch is None:
        out0 = solve_lp_pdhg(lps, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, SparseLP, lps, axes, None, sol0, tr0,
                                      max_iter, stats=stats)
        _check_conformance(conformance, SparseLP, lps, axes, None, sol0,
                           "solve_lp_pdhg", stats=stats)
        return (sol0, tr0) if trace else sol0
    if axes[0] == 0 or axes[1] == 0:
        raise ValueError(
            "solve_lp_pdhg_adaptive needs one shared sparsity pattern "
            "(unbatched rows/cols); batch vals/b/c/l/u instead"
        )
    check_every = solver_kw.get("check_every", 200)
    chunk_iters = -(-chunk_iters // check_every) * check_every

    def segment(d, w, s, stop):
        out = solve_lp_pdhg(d, warm_start=w, state=s, it_stop=stop, trace=trace,
                            return_state=True, **solver_kw)
        return (out[0], out[2]) if trace else out

    def seg_cold(d, w, stop):
        return segment(d, w, None, stop)

    def seg_resume(d, s, stop):
        return segment(d, None, s, stop)

    out, tr = _adaptive_drive(
        "solve_lp_pdhg", SparseLP, lps, axes, batch, seg_cold, seg_resume,
        PDHGSolution, max_iter, chunk_iters, bucket_ladder(batch, ladder_base),
        warm_start, trace, stats,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, SparseLP, lps, axes, batch, out, tr,
                                max_iter, stats=stats)
    _check_conformance(conformance, SparseLP, lps, axes, batch, out,
                       "solve_lp_pdhg", stats=stats)
    return (out, tr) if trace else out
