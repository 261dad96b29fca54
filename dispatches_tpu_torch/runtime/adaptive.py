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

**Continuous batching** (`SlotEngine`, `make_dense_engine`): the serving
tier's engine keeps the bucket fixed and back-fills the slots of retired
lanes with new problems between chunks, instead of compacting. A lane it
harvests is bitwise the same lane in a one-shot `solve_lp_batch` of
`bucket` lanes on the same device (`SlotEngine`).

``warm_predictor=`` (a `learn.WarmStartPredictor`, a `WarmStartModel`
or an artifact path) seeds the lanes of a call without an explicit
``warm_start`` through the solvers' per-lane safeguard (`_predict_warm`);
a seed the safeguard rejects lands the lane bitwise on its cold start,
and a predictor that degrades leaves the call plainly cold.

``lanes=`` (True, a `LaneConfig`, a mapping or a `LaneObservatory`)
journals a ``lane_decision`` per solved row and samples shadow-lane
probes (`obs.lanes`); it only reads the results. ``lane_policy="advice"``
re-lanes an unbatched, trace-free dense or PDHG solve onto the lane the
observatory's settled ``route_advice`` names, ``"model"`` onto the lane
the learned router (``lane_model=``, `learn.laneroute`) predicts, with
the advice as its fallback; ``"static"`` and None never re-lane
(`_relane_advice`).

``perf=`` (an `obs.perf.PerfProbe`, on the three entries and as
``SlotEngine.perf``) measures each chunk's phases and times every segment
call, "cold" being a key's first call in the process; it reads the host
clock only. The JAX package's persistent compile cache manages XLA's
executables and has no counterpart in eager PyTorch.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.perf import first_call
from ..solvers.ipm import _tree_map

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


def _opt_key(solver_kw: dict):
    """Hashable summary of the solver options (part of the serving tier's
    result-cache key, as in the JAX package)."""
    return tuple(sorted((k, str(v)) for k, v in solver_kw.items()))


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
                    stats, perf=None):
    """Host-side retirement / compaction loop shared by the dense, banded
    and PDHG entry points.

    ``seg_cold(d, w, stop)`` starts a bucketed sub-batch (optionally from
    per-lane warm seeds) and ``seg_resume(d, s, stop)`` resumes one from
    its gathered states; both return ``(solution, state)``, the trace
    riding in ``state.trace``. A lane retires when its state is `done` or
    out of iterations. Returns the solution rows stacked in the original
    lane order, and the stitched traces (or None).

    `perf` (an `obs.perf.PerfProbe`) measures each chunk's dispatch /
    compute / harvest / host phases and times every segment call; it
    reads the host clock only, so the results are bitwise those without
    it."""
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
        resume = st_cur is not None
        pc = None
        if perf is not None:
            key = (entry, bucket, "resume" if resume else "cold")
            hit = first_call(key)
            pc = perf.chunk(entry)
        with perf.capture(key, hit, device) if pc is not None else contextlib.nullcontext():
            if resume:
                sol, st = seg_resume(d_cur, st_cur, stop)
            else:
                sol, st = seg_cold(d_cur, w_cur, stop)
        if pc is not None:
            perf.note_compile(entry, key, hit, perf.clock() - pc.t0, kind=key[2])
            pc.mark("dispatch")
        chunks += 1
        buckets_used.append(bucket)
        # the chunk's one host read: every row's stop flag and iteration
        done_h, it_h = torch.stack([st.done.long(), st.it]).cpu().tolist()
        if pc is not None:
            pc.mark("compute")
        finished = [d or i >= max_iter for d, i in zip(done_h, it_h)]
        # every row still running entered the chunk at prev_stop
        loop_iters = max(it_h) - prev_stop
        if pc is not None:
            perf.credit(pc, key, loop_iters, entry)
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
        if pc is not None:
            pc.mark("harvest")
        if not active:
            if pc is not None:
                pc.done(bucket=bucket, chunk=chunks)
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
        if pc is not None:
            # retirement and compaction are the "host" phase; the chunk ran
            # at buckets_used[-1] (compaction may just have shrunk `bucket`)
            pc.done(bucket=buckets_used[-1], chunk=chunks)

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


def _sync_of(data) -> None:
    """Wait for the card when `data` lives there (a no-op on the CPU), so
    a wall read after it is the device's."""
    dev = data[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _note_lanes(lanes, fields_cls, data, axes, batch, out, entry, lane, t_wall,
                *, stats=None, predicted=None):
    """Post-drive lane-decision hook shared by the adaptive entry points:
    journal one ``lane_decision`` per solved row (`obs.lanes`), the
    batched wall (since `t_wall`, the device's) amortized across rows, and
    let the observatory sample shadow probes from the unbatched rows. It
    only reads the results, so ``lanes=`` anything leaves them bitwise
    as they are."""
    from ..obs import health as obs_health
    from ..obs.lanes import as_lanes

    obs = as_lanes(lanes)
    if obs is None:
        return None
    _sync_of(data)
    wall = time.monotonic() - t_wall
    if stats is not None:
        stats["lane"] = lane
    verdicts = obs_health.classify_solution(out) or []
    its = np.atleast_1d(_host(getattr(out, "iterations", 0)))
    if batch is None:
        v = verdicts[0].verdict if verdicts else "healthy"
        obs.note_solve(
            fields_cls(*data), lane, entry=entry, wall=wall,
            iterations=int(its[0]), verdict=v,
            predicted_iterations=(
                None if predicted is None
                else float(predicted.get("iterations", 0.0))
            ),
        )
        return obs
    share = wall / batch
    for i in range(batch):
        row = fields_cls(*(a[i] if ax is not None else a for a, ax in zip(data, axes)))
        v = verdicts[i].verdict if i < len(verdicts) else "healthy"
        obs.note_solve(
            row, lane, entry=entry, wall=share,
            iterations=int(its[i]) if i < its.shape[0] else None, verdict=v,
        )
    return obs


def _relane_advice(lanes, lane_policy, problem, native_lane, batch, trace,
                   lane_model=None, stats=None, pred_out=None):
    """Resolve the opt-in lane-policy consultation: returns the advised
    lane when (and only when) the policy names a lane for this problem's
    family that differs from the native lane AND the solve is a shape the
    paired lane can take over (unbatched, no trace stitching). Anything
    else returns None — the native path runs untouched, which keeps the
    default bitwise as it was.

    Policies: None and ``"static"`` never re-lane. ``"advice"`` consults
    the observatory's hysteresis-settled ``route_advice``. ``"model"``
    consults the learned lane-portfolio router (`learn.laneroute`,
    ``lane_model=``) per instance, falling back to the ``"advice"``
    scoreboards when the model has nothing for this family. A model
    prediction fills ``pred_out`` / ``stats["lane_prediction"]`` with the
    predicted lane and expected iteration count even when it names the
    native lane."""
    if lane_policy not in (None, "static", "advice", "model"):
        raise ValueError(
            f"unknown lane_policy {lane_policy!r} "
            "(expected None, 'static', 'advice', or 'model')"
        )
    if lane_policy in (None, "static"):
        return None
    if batch is not None or trace:
        return None
    from ..obs.lanes import ALTERNATE, as_lanes

    obs = as_lanes(lanes) if lanes is not None else None
    advised = None
    if lane_policy == "model" and lane_model is not None:
        from ..learn.laneroute import as_laneroute

        router = as_laneroute(
            lane_model, fallback=obs.advice if obs is not None else None,
            device=problem.b.device,
        )
        pred = router.route(problem) if router is not None else None
        if pred is not None:
            advised = pred.lane
            record = {"lane": pred.lane, "iterations": pred.iterations}
            if pred_out is not None:
                pred_out.update(record)
            if stats is not None:
                stats["lane_prediction"] = record
    if advised is None:
        # "advice", or a model miss falling back to the scoreboards
        if obs is None:
            return None
        advised = obs.advice_for(problem)
    if advised is None or advised == native_lane:
        return None
    if ALTERNATE.get(native_lane) != advised:
        return None
    return advised


def _predict_warm(predictor, fields_cls, data, axes, batch, entry, meta=None):
    """Seeds for an adaptive entry from a `learn.WarmStartPredictor` (or a
    `WarmStartModel` / artifact path, loaded on the data's device): the
    predictor seeds the batch without unstacking it (a shared field is
    fingerprinted once), and the seeds come back as the ``warm_start=``
    tuple (stacked when batched). A banded seed needs the entry's
    `TimeStructure` `meta`. Returns None on any degradation — the entry
    then runs plainly cold, the path without a predictor."""
    try:
        from ..learn.predictor import WarmStartPredictor

        if not isinstance(predictor, WarmStartPredictor):
            predictor = WarmStartPredictor(predictor, device=data[0].device)
        if batch is None:
            problem = fields_cls(*(a.unsqueeze(0) for a in data))
            seeds, _ = predictor.seed_batch(problem, [0] * len(data), 1,
                                            entry=entry, meta=meta)
            return seeds[0] if seeds else None
        seeds, _ = predictor.seed_batch(fields_cls(*data), axes, batch,
                                        entry=entry, meta=meta)
        if not seeds:
            return None
        return tuple(np.stack([s[j] for s in seeds]) for j in range(len(seeds[0])))
    except Exception:
        return None


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
    PDHG. `conformance` certifies the returned lanes; `warm_predictor`,
    `lanes`, `lane_policy` and `lane_model` as in the module docstring
    (the paired lane here is PDHG, reached through `runtime.remedy`'s
    program and row maps; an advised lane that does not converge falls
    back to the native path). `perf` (an `obs.perf.PerfProbe`) measures
    each chunk's phases; the results are bitwise those without it."""
    from ..core.program import LPData
    from ..solvers.ipm import _LP_NDIM, IPMSolution, solve_lp

    t_wall = time.monotonic()
    axes, batch = _batch_axes(LPData, _LP_NDIM, lp)
    _pred: dict = {}
    if _relane_advice(
        lanes, lane_policy, lp, "dense", batch, trace,
        lane_model=lane_model, stats=stats, pred_out=_pred,
    ) == "pdhg":
        from ..solvers.pdhg import solve_lp_pdhg
        from .remedy import _ipm_row_from_pdhg, dense_to_sparse

        psol = solve_lp_pdhg(
            dense_to_sparse(lp), tol=max(float(solver_kw.get("tol") or 1e-6), 1e-6)
        )
        if bool(psol.converged):
            sol0 = _ipm_row_from_pdhg(psol, lp)
            if stats is not None:
                stats["relaned"] = "pdhg"
            _check_conformance(conformance, LPData, lp, axes, None, sol0,
                               "solve_lp", stats=stats)
            _note_lanes(lanes, LPData, lp, axes, None, sol0, "solve_lp", "pdhg",
                        t_wall, stats=stats, predicted=_pred or None)
            return sol0
        # the advised lane could not certify a takeover: native path
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp")
    if warm_start is None and warm_predictor is not None:
        warm_start = _predict_warm(warm_predictor, LPData, lp, axes, batch, "solve_lp")
    max_iter = solver_kw.get("max_iter", 60)
    if batch is None:
        out0 = solve_lp(lp, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None and lanes is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, LPData, lp, axes, None, sol0, tr0,
                                      max_iter, stats=stats)
        _check_conformance(conformance, LPData, lp, axes, None, sol0, "solve_lp",
                           stats=stats)
        _note_lanes(lanes, LPData, lp, axes, None, sol0, "solve_lp", "dense",
                    t_wall, stats=stats, predicted=_pred or None)
        return (sol0, tr0) if trace else sol0

    seg_cold, seg_resume = dense_segments(trace, solver_kw)
    out, tr = _adaptive_drive(
        "solve_lp", LPData, lp, axes, batch, seg_cold, seg_resume, IPMSolution,
        max_iter, chunk_iters, bucket_ladder(batch, ladder_base), warm_start,
        trace, stats, perf,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, LPData, lp, axes, batch, out, tr,
                                max_iter, stats=stats)
    _check_conformance(conformance, LPData, lp, axes, batch, out, "solve_lp",
                       stats=stats)
    _note_lanes(lanes, LPData, lp, axes, batch, out, "solve_lp", "dense", t_wall,
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
    `warm_predictor` seeds the lanes in the banded solver's frame (the
    reduced columns of ``meta.col_pos``, the banded rows); `lanes`
    journals lane decisions, and as the banded lane has no paired lane,
    every `lane_policy` is accepted and none re-lanes. `perf` as in
    `solve_lp_adaptive`."""
    from ..solvers.ipm import IPMSolution
    from ..solvers.structured import _BASE_NDIM, BandedLP, solve_lp_banded, solve_lp_banded_batch

    t_wall = time.monotonic()
    axes, batch = _batch_axes(BandedLP, _BASE_NDIM, blp)
    _relane_advice(lanes, lane_policy, blp, "banded", batch, trace)
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp_banded")
    if warm_start is None and warm_predictor is not None:
        warm_start = _predict_warm(
            warm_predictor, BandedLP, blp, axes, batch, "solve_lp_banded", meta=meta,
        )
    max_iter = solver_kw.get("max_iter", 60)
    if batch is None:
        out0 = solve_lp_banded(meta, blp, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None and lanes is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, BandedLP, blp, axes, None, sol0, tr0,
                                      max_iter, meta=meta, stats=stats)
        _check_conformance(conformance, BandedLP, blp, axes, None, sol0,
                           "solve_lp_banded", meta=meta, stats=stats)
        _note_lanes(lanes, BandedLP, blp, axes, None, sol0, "solve_lp_banded",
                    "banded", t_wall, stats=stats)
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
        warm_start, trace, stats, perf,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, BandedLP, blp, axes, batch, out, tr,
                                max_iter, meta=meta, stats=stats)
    _check_conformance(conformance, BandedLP, blp, axes, batch, out,
                       "solve_lp_banded", meta=meta, stats=stats)
    _note_lanes(lanes, BandedLP, blp, axes, batch, out, "solve_lp_banded",
                "banded", t_wall, stats=stats)
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
    ride through ``solver_kw`` into `solve_lp_pdhg`. `warm_predictor`
    seeds ``(x, y)``; `lanes`, `lane_policy` and `lane_model` mirror
    `solve_lp_adaptive`, the paired lane here the dense IPM. `perf` as in
    `solve_lp_adaptive`."""
    from ..core.program import SparseLP
    from ..solvers.pdhg import _SPARSE_NDIM, PDHGSolution, solve_lp_pdhg

    t_wall = time.monotonic()
    axes, batch = _batch_axes(SparseLP, _SPARSE_NDIM, lps)
    _pred: dict = {}
    if _relane_advice(
        lanes, lane_policy, lps, "pdhg", batch, trace,
        lane_model=lane_model, stats=stats, pred_out=_pred,
    ) == "dense":
        from ..solvers.ipm import solve_lp
        from .remedy import _pdhg_row_from_ipm, sparse_to_dense

        isol = solve_lp(sparse_to_dense(lps), tol=float(solver_kw.get("tol") or 1e-8))
        if bool(isol.converged):
            sol0 = _pdhg_row_from_ipm(isol, lps)
            if stats is not None:
                stats["relaned"] = "dense"
            _check_conformance(conformance, SparseLP, lps, axes, None, sol0,
                               "solve_lp_pdhg", stats=stats)
            _note_lanes(lanes, SparseLP, lps, axes, None, sol0, "solve_lp_pdhg",
                        "dense", t_wall, stats=stats, predicted=_pred or None)
            return sol0
        # the advised lane could not certify a takeover: native path
    if remedy is not None:
        from .remedy import as_remedy

        remedy = as_remedy(remedy, solver_kw=solver_kw, entry="solve_lp_pdhg")
    if warm_start is None and warm_predictor is not None:
        warm_start = _predict_warm(warm_predictor, SparseLP, lps, axes, batch,
                                   "solve_lp_pdhg")
    max_iter = solver_kw.get("max_iter", 100_000)
    if batch is None:
        out0 = solve_lp_pdhg(lps, warm_start=warm_start, trace=trace, **solver_kw)
        if remedy is None and conformance is None and lanes is None:
            return out0
        sol0, tr0 = out0 if trace else (out0, None)
        if remedy is not None:
            sol0, tr0 = _apply_remedy(remedy, SparseLP, lps, axes, None, sol0, tr0,
                                      max_iter, stats=stats)
        _check_conformance(conformance, SparseLP, lps, axes, None, sol0,
                           "solve_lp_pdhg", stats=stats)
        _note_lanes(lanes, SparseLP, lps, axes, None, sol0, "solve_lp_pdhg",
                    "pdhg", t_wall, stats=stats, predicted=_pred or None)
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
        warm_start, trace, stats, perf,
    )
    if remedy is not None:
        out, tr = _apply_remedy(remedy, SparseLP, lps, axes, batch, out, tr,
                                max_iter, stats=stats)
    _check_conformance(conformance, SparseLP, lps, axes, batch, out,
                       "solve_lp_pdhg", stats=stats)
    _note_lanes(lanes, SparseLP, lps, axes, batch, out, "solve_lp_pdhg", "pdhg",
                t_wall, stats=stats)
    return (out, tr) if trace else out


# ---------------------------------------------------------------------------
# continuous batching: slot refill instead of compaction


def dense_segments(trace: bool, solver_kw: dict):
    """The dense IPM's ``(seg_cold, seg_resume)`` pair: ``seg_cold(d, w,
    stop)`` starts a batch (from warm seeds `w`, or cold with None) and
    ``seg_resume(d, s, stop)`` resumes one from its `IPMState`; both run
    `solve_lp_partial` to `stop`, an int or a per-lane tensor, and return
    ``(IPMSolution, IPMState)``. The stop only decides where the host
    looks: a lane's iterate sequence never depends on it."""
    from ..solvers.ipm import solve_lp_partial

    def seg_cold(d, w, stop):
        return solve_lp_partial(d, warm_start=w, it_stop=stop, trace=trace, **solver_kw)

    def seg_resume(d, s, stop):
        return solve_lp_partial(d, state=s, it_stop=stop, trace=trace, **solver_kw)

    return seg_cold, seg_resume


def _host(a) -> np.ndarray:
    """A tensor on any device, an array or a number, as numpy."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_row(row):
    return type(row)(*(_host(a) for a in row))


def _where_rows(sel, new, old):
    """Rows of `new` where the per-lane `sel` holds, else rows of `old`,
    over a (nested) NamedTuple of batch-first tensors."""
    if isinstance(new, tuple):
        items = [_where_rows(sel, n, o) for n, o in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    return torch.where(sel.reshape(sel.shape + (1,) * (new.dim() - 1)), new, old)


def _require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (the serving tier never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the serving tier was asked for a CUDA device and none is "
            "available; pass device='cpu' to serve on the CPU"
        )
    return device


class SlotEngine:
    """Fixed-bucket continuous-batching engine (port of the JAX package's
    `SlotEngine`). Where `_adaptive_drive` compacts to a smaller bucket
    when lanes retire, this engine keeps the bucket size fixed and
    back-fills freed slots with new problems between chunks: under
    sustained load there is always fresh work.

    Per `step()`:

    1. rows admitted since the last chunk are copied from the persistent
       host mirror into the device batch (only those rows);
    2. newly admitted slots get their cold loop state from ``seg_cold`` at
       a stop of 0 (no iteration), scattered into the carried state with
       `torch.where` on a per-lane mask. The first chunk goes through the
       same scatter (every row selected), so the carried state has one
       code path;
    3. every occupied slot resumes to its own stop,
       ``min(it + chunk_iters, max_iter)``, taken from the host's marks:
       a surviving lane always ran exactly to its previous stop. Idle
       slots get stop 0 and stay frozen;
    4. one host read of every lane's ``done`` and ``it``; finished lanes
       are harvested (one device-to-host copy of the chunk's solution)
       and their slots freed.

    Identity contract (`tests/test_torch_serve.py`, `chip_smoke.py`
    serve (a)): nothing in the IPM mixes lanes, and every batched kernel
    depends on the batch size alone, so a lane harvested here is bitwise
    the same lane in a one-shot ``solve_lp_batch`` of `bucket` lanes on
    the same device, whenever it was admitted and whatever shared its
    batch.

    `fields` is the problem NamedTuple class (`LPData`); every field is
    stacked per slot from the admitted rows, on `device`. Harvested rows
    have numpy leaves.

    `warm_fn` (learned warm starts, `make_dense_engine(warm_predictor=)`)
    seeds the freshly admitted slots' cold states: ``warm_fn(rows)``
    returns ``(seeds, accepted)`` for their problems, the seeds go through
    the solver's per-lane safeguard (a rejected seed is bitwise the cold
    start), and a harvested lane's stats carry ``warm_source`` /
    ``warm_accepted``, its accepted iterations credited against
    ``warm_fn.iters_baseline`` in
    ``warm_start_iters_saved_total{source=...}``. With `warm_fn` None the
    cold dispatch passes no seeds, as before. (The JAX engine's `shared` fields and custom
    `done_flag` serve its PDHG and banded engines, which the serving tier
    does not build.)
    """

    def __init__(
        self,
        entry: str,
        fields,
        seg_cold,
        seg_resume,
        bucket: int,
        *,
        chunk_iters: int = 8,
        max_iter: int = 60,
        opt_key=(),
        device="cuda",
        warm_fn=None,
    ):
        if bucket <= 0:
            raise ValueError(f"bucket must be positive (got {bucket})")
        self.entry = entry
        self.fields = fields
        self.seg_cold = seg_cold
        self.seg_resume = seg_resume
        self.bucket = bucket
        self.chunk_iters = int(chunk_iters)
        self.max_iter = int(max_iter)
        self.device = _require_device(device)
        self.opt_key = opt_key
        self._tokens = [None] * bucket  # slot -> caller token (None = idle)
        self._fresh = [False] * bucket  # needs its cold state before resuming
        self._buf = None  # persistent (bucket, ...) host mirror of the lane data
        self._stale = set()  # slots whose device rows lag the mirror
        self._d_cur = None  # the stacked device data
        self._st = None  # the carried device state
        self._zero_stops = None
        self._sol_dev = None  # the last chunk's solution, on the device
        self._sol_np_cache = None  # its host copy, made on first use per chunk
        self.fields_sol = tuple  # set by step() from the first solution
        # host mirror of each lane's iteration count
        self._it_mark = np.zeros(bucket, np.int64)
        self.chunks = 0
        self.refills = 0
        # optional chunk-loop observer (obs.reqtrace.EngineJourneyObserver
        # duck type: chunk_begin / cold_end / compute_end / harvest_end)
        self.observer = None
        # optional runtime.remedy.RemedyEngine: a lane that harvests
        # unhealthy re-solves up the ladder before the caller sees it
        self.remedy = None
        # optional obs.conformance.ConformanceChecker: every harvested row
        # is certified into lane_stats["conformance"]; rows are not touched
        self.conformance = None
        # optional obs.perf.PerfProbe: phase-attributed chunk timings and
        # first-call telemetry, host clocks only
        self.perf = None
        self._warm_fn = warm_fn
        self._warm_buf = None  # (bucket, ...) host seed mirror per part
        self._warm_src = [None] * bucket  # slot -> seed source label
        self._warm_ok = [False] * bucket  # slot -> safeguard accept verdict

    # -- slot management ----------------------------------------------
    def free_slots(self) -> int:
        return sum(t is None for t in self._tokens)

    def active(self) -> list:
        return [t for t in self._tokens if t is not None]

    def admit(self, token, row) -> int:
        """Place one problem (`row`: the problem NamedTuple of ONE lane,
        tensors on any device or arrays) into a free slot. Returns the slot
        index; raises when full."""
        for i, t in enumerate(self._tokens):
            if t is not None:
                continue
            row_np = [_host(a) for a in row]
            if self._buf is None:
                # every slot starts as a copy of the first row: idle slots
                # hold finite data and stay frozen at stop 0
                self._buf = [np.broadcast_to(r, (self.bucket,) + r.shape).copy()
                             for r in row_np]
            for name, buf, r in zip(self.fields._fields, self._buf, row_np):
                if r.shape != buf.shape[1:] or r.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.fields.__name__}.{name}: {r.dtype}{list(r.shape)} does "
                        f"not fit the engine's {buf.dtype}{list(buf.shape[1:])}"
                    )
            for buf, r in zip(self._buf, row_np):
                buf[i] = r
            self._tokens[i] = token
            self._fresh[i] = True
            self._warm_src[i] = None
            self._warm_ok[i] = False
            self._it_mark[i] = 0
            self._stale.add(i)
            if self._st is not None:
                self.refills += 1
            return i
        raise RuntimeError("SlotEngine.admit on a full bucket")

    def evict(self, token):
        """Pull an in-flight lane out mid-solve and return its best iterate
        so far as a solution row (deadline enforcement); None when the lane
        has not run a chunk yet."""
        i = self._tokens.index(token)
        out = None
        if self._sol_dev is not None and not self._fresh[i]:
            out = self.fields_sol(*(leaf[i] for leaf in self._sol_rows()))
        self._release(i)
        return out

    def _release(self, i: int) -> None:
        # the slot's device rows stay in place as finite padding, frozen
        # at stop 0
        self._tokens[i] = None
        self._fresh[i] = False
        self._warm_src[i] = None
        self._warm_ok[i] = False

    # -- the chunk step ------------------------------------------------
    def _sol_rows(self):
        """Host copy of the last chunk's solution (at most one
        device-to-host copy a chunk, none when nothing retires)."""
        if self._sol_np_cache is None:
            self._sol_np_cache = [_host(leaf) for leaf in self._sol_dev]
        return self._sol_np_cache

    def _row_problem(self, i: int, device=None):
        """One slot's problem NamedTuple, from the host mirror: numpy
        leaves, or tensors on `device`."""
        return self.fields(*(
            buf[i] if device is None else torch.as_tensor(buf[i], device=device)
            for buf in self._buf
        ))

    def _warm_seeds(self):
        """Per-part ``(bucket, ...)`` warm tensors for the cold dispatch.
        Fresh occupied slots get seeds from `warm_fn` (NaN seeds when the
        predictor degrades — the safeguard rejects those per lane, landing
        bitwise on the cold start); every other row keeps what the seed
        buffer holds, as its cold state is not scattered in."""
        fresh = [i for i, (f, t) in enumerate(zip(self._fresh, self._tokens))
                 if f and t is not None]
        rows = [self._row_problem(i) for i in fresh]
        seeds, accepted = self._warm_fn(rows)
        src = getattr(self._warm_fn, "source", "learned")
        if seeds is None:
            # no layout known: solver-rejected NaN seeds from the lane data
            seeds = [
                tuple(np.full((k,), np.nan, r.b.dtype)
                      for k in (r.c.shape[-1], r.b.shape[-1], r.c.shape[-1],
                                r.c.shape[-1]))
                for r in rows
            ]
            accepted = None
        if self._warm_buf is None:
            self._warm_buf = [np.zeros((self.bucket,) + np.shape(p), np.asarray(p).dtype)
                              for p in seeds[0]]
        for j, i in enumerate(fresh):
            ok = bool(accepted[j]) if accepted else False
            for buf, part in zip(self._warm_buf, seeds[j]):
                part = np.asarray(part)
                if part.shape == buf.shape[1:]:
                    buf[i] = part
                else:  # a malformed seed: rejected, not a crash
                    buf[i] = np.nan
                    ok = False
            self._warm_src[i] = src
            self._warm_ok[i] = ok
        return tuple(torch.from_numpy(b).to(self.device, copy=True) for b in self._warm_buf)

    def _sync_rows(self) -> None:
        """Bring the device batch up to the host mirror: the whole batch on
        the first chunk, after that only the rows admitted since."""
        if self._d_cur is None:
            self._d_cur = self.fields(*(
                torch.from_numpy(buf).to(self.device, copy=True) for buf in self._buf
            ))
        else:
            for i in sorted(self._stale):
                for buf, d in zip(self._buf, self._d_cur):
                    d[i].copy_(torch.from_numpy(np.asarray(buf[i])))
        self._stale.clear()

    def step(self) -> list:
        """Run one chunk over the occupied slots. Returns the harvested
        ``(token, solution_row, lane_stats)`` triples (possibly none);
        `lane_stats` carries the lane's iteration count. A no-op returning
        [] when every slot is idle."""
        if not any(t is not None for t in self._tokens):
            return []
        watch = self.observer
        perf = self.perf
        pc = perf.chunk(self.entry) if perf is not None else None
        if watch is not None:
            watch.chunk_begin(self._tokens)
        if self._stale:
            self._sync_rows()
            if pc is not None:
                # admitted rows copied to the device; a chunk with nothing
                # admitted skips the phase
                pc.mark("transfer")
        occupied = np.asarray([t is not None for t in self._tokens])

        if any(self._fresh):
            if self._zero_stops is None:
                self._zero_stops = torch.zeros(self.bucket, dtype=torch.int64,
                                               device=self.device)
            w_arg = self._warm_seeds() if self._warm_fn is not None else None
            if pc is not None:
                key_c = (self.entry, self.bucket, "cold")
                hit_c = first_call(key_c)
                t0c = perf.clock()
            _, st0 = self.seg_cold(self._d_cur, w_arg, self._zero_stops)
            if pc is not None:
                perf.note_compile(self.entry, key_c, hit_c, perf.clock() - t0c,
                                  kind="cold")
            # the first chunk routes through the same scatter as every later
            # one (every row selected)
            first = self._st is None
            sel = torch.as_tensor(
                np.ones(self.bucket, bool) if first else np.asarray(self._fresh),
                device=self.device,
            )
            self._st = _where_rows(sel, st0, st0 if first else self._st)
            if watch is not None:
                watch.cold_end(self._tokens, self._fresh)
            if pc is not None:
                # the zero-stop cold start and its scatter (no iteration,
                # so no FLOPs are credited here)
                pc.mark("cold")
            self._fresh = [False] * self.bucket

        it_before = self._it_mark
        stops = np.where(
            occupied, np.minimum(self._it_mark + self.chunk_iters, self.max_iter), 0
        ).astype(np.int64)
        stops_dev = torch.as_tensor(stops, device=self.device)
        if pc is None:
            sol, st = self.seg_resume(self._d_cur, self._st, stops_dev)
        else:
            key_r = (self.entry, self.bucket, "resume")
            hit_r = first_call(key_r)
            t0r = perf.clock()
            with perf.capture(key_r, hit_r, self.device):
                sol, st = self.seg_resume(self._d_cur, self._st, stops_dev)
            perf.note_compile(self.entry, key_r, hit_r, perf.clock() - t0r, kind="resume")
        self._st = st
        self._it_mark = stops
        self.chunks += 1
        self._sol_dev = sol
        self._sol_np_cache = None
        self.fields_sol = type(sol)
        # the chunk's one host read: every lane's stop flag and iteration
        done_h, its = torch.stack([st.done.long(), st.it.long()]).cpu().numpy()
        finished = done_h.astype(bool) | (its >= self.max_iter)
        if watch is not None:
            watch.compute_end(self._tokens, it_before, stops)
        if pc is not None:
            # the loop ran as many iterations as its furthest lane advanced
            ran = its[occupied] - np.asarray(it_before)[occupied]
            perf.credit(pc, key_r, int(ran.max()) if ran.size else 0, self.entry)
            pc.mark("compute")

        out = []
        slots = []
        if finished.any():
            sol_np = self._sol_rows()
            for i, token in enumerate(self._tokens):
                if token is None or not finished[i]:
                    continue
                row = type(sol)(*(leaf[i] for leaf in sol_np))
                lane_stats = {"iterations": int(its[i])}
                src = self._warm_src[i]
                if src is not None:
                    lane_stats["warm_source"] = src
                    lane_stats["warm_accepted"] = bool(self._warm_ok[i])
                    base = getattr(self._warm_fn, "iters_baseline", None)
                    if self._warm_ok[i] and base:
                        # credited against the artifact's measured cold
                        # baseline: the serve path never runs the lane cold
                        saved = max(0.0, float(base) - float(its[i]))
                        if saved > 0:
                            obs_metrics.inc("warm_start_iters_saved_total", saved,
                                            source=src, entry=self.entry)
                if self.remedy is not None:
                    # the ladder re-solves on the engine's device
                    row, rinfo = self.remedy.remediate_solution_row(
                        self._row_problem(i, self.device), row, budget=self.max_iter,
                        deadline=getattr(token, "deadline", None),
                        request_id=getattr(token, "request_id", None),
                    )
                    if rinfo is not None:
                        row = _host_row(row)
                        lane_stats["remediation"] = rinfo
                out.append((token, row, lane_stats))
                slots.append(i)
                self._release(i)
        if out:
            obs_metrics.inc("adaptive_lanes_retired_total", len(out), entry=self.entry)
            if watch is not None:
                watch.harvest_end([tok for tok, _, _ in out])
            if pc is not None:
                pc.mark("harvest")
            if self.conformance is not None:
                # a released slot's mirror row stays until the next admit,
                # so the lane's problem is still there; certified on the host
                for (_, row, lane_stats), i in zip(out, slots):
                    lane_stats["conformance"] = self.conformance.check_row(
                        self._row_problem(i), row, entry=self.entry
                    )
                if pc is not None:
                    pc.mark("conformance")
        if pc is not None:
            pc.done(bucket=self.bucket, chunk=self.chunks, retired=len(out))
        return out


def make_dense_engine(
    bucket: int,
    *,
    chunk_iters: int = 8,
    trace: bool = False,
    warm_predictor=None,
    remedy=None,
    conformance=None,
    device="cuda",
    **solver_kw,
) -> SlotEngine:
    """One dense-LP `SlotEngine` at `bucket` lanes on `device`: the
    construction the in-process service (`serve.service.make_dense_service`)
    and the fleet's shard child (`serve.shard`) share, so both run the
    same solves and the bitwise contract holds across the process
    boundary. `solver_kw` flows to `solve_lp_partial` (`max_iter` also
    bounds each lane's budget).

    `remedy` (a `runtime.remedy.RemedyEngine` / `RemedyPolicy` / True)
    re-solves lanes that harvest unhealthy up the escalation ladder;
    `conformance` (True / `ConformancePolicy` / `ConformanceChecker`)
    certifies every harvested row and leaves it as it is.

    `warm_predictor` (a `learn.WarmStartPredictor`, a `WarmStartModel`,
    or an artifact path, loaded on `device`) seeds every admitted lane
    through the safeguarded warm-start path, and extends the option key
    with the artifact's family; with it None (the default) the engine and
    its solution bits are the cold engine's."""
    from ..core.program import LPData

    solver_kw.setdefault("max_iter", 60)
    seg_cold, seg_resume = dense_segments(trace, solver_kw)
    opt_key = _opt_key(solver_kw)
    warm_fn = None
    if warm_predictor is not None:
        from ..learn.predictor import WarmStartPredictor

        if not isinstance(warm_predictor, WarmStartPredictor):
            warm_predictor = WarmStartPredictor(warm_predictor, device=device)

        dev = torch.device(device)

        def warm_fn(rows, _p=warm_predictor):
            # the accept verdict replays the safeguard on the engine's device
            rows = [LPData(*(torch.as_tensor(a, device=dev) for a in r)) for r in rows]
            return _p.seed_rows(rows, entry="serve_dense")

        warm_fn.source = warm_predictor.source
        warm_fn.iters_baseline = warm_predictor.cold_iters_mean
        opt_key = opt_key + (("warm_model", warm_predictor.model.family[:12]),)
    engine = SlotEngine(
        "serve_dense", LPData, seg_cold, seg_resume, bucket,
        chunk_iters=chunk_iters, max_iter=solver_kw["max_iter"],
        opt_key=opt_key, device=device, warm_fn=warm_fn,
    )
    if remedy is not None:
        from .remedy import as_remedy

        engine.remedy = as_remedy(remedy, solver_kw=solver_kw, entry="serve_dense")
    if conformance is not None:
        from ..obs.conformance import as_conformance

        engine.conformance = as_conformance(conformance)
    return engine
