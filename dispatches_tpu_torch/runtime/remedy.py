"""Self-healing solves: the verdict-driven remediation ladder (port of
`dispatches_tpu/runtime/remedy.py`).

`obs/health.py` turns solver end states and traces into verdicts; this
module answers the numerical ones (`diverged` / `stalled` / `cycling` /
`nonfinite`) with an escalation ladder run on the host against the ONE
lane that retired unhealthy, while the rest of the batch's results stand:

1. ``cold`` — re-solve with the original options and no warm start;
2. ``regularize`` — raise the IPM's `reg_p` / `reg_d` by
   `RemedyPolicy.reg_scale` over the dtype defaults;
3. ``float64`` — re-solve an f32 problem in f64 (skipped for f64 data);
4. ``lane_switch`` — change solver family: a dense LP re-solves through
   the first-order PDHG lane (`solvers/pdhg.py`) and its solution is
   mapped back into the IPM's row shape; a `SparseLP` re-solves through
   the dense IPM. Banded problems have no paired lane
   (``"no_paired_lane"``);
5. give up — an ``unrecoverable`` verdict, and the original (unhealthy)
   row passes through.

The engine dispatches on the problem's type (`LPData`, `SparseLP`,
`BandedLP`), as in the JAX package; PDHG lanes skip ``regularize``
(``"no_reg_knob"``). Every rung tried counts in
``remediation_attempts_total{rung,entry}``; a rung that cures the lane
counts in
``remediation_recovered_total{verdict,rung}`` and ends the ladder. Every
call journals a ``remediation`` event (entry, original verdict, outcome,
the rung-by-rung history) to the installed tracer, and a give-up is
captured by the installed flight recorder: the problem, the options, the
``unrecoverable`` verdict and, when the ``cold`` rung ran, its re-solve
(the original options without a warm start, which a replay of the
capture reproduces). The outcome also goes into the adaptive entry
points' ``stats["remediated"]``.

In the serving tier the ladder is bounded by the request's deadline too:
`remediate(deadline=...)` stops climbing the moment the engine's `clock`
reaches it (less `RemedyPolicy.deadline_margin`), and the original verdict
stands, as the deadline machinery owns that failure.
`remediate_solution_row` is the `SlotEngine` harvest hook: it classifies
one harvested row and runs the ladder when the verdict is remediable.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import torch

from ..core.program import LPData, SparseLP
from ..obs import health as obs_health
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs.journal import get_tracer

# verdicts the ladder knows how to attack; the others are policy or
# process failures, which a re-solve would not change
REMEDIABLE = ("diverged", "stalled", "cycling", "nonfinite")

# ladder order, cheapest first
RUNGS = ("cold", "regularize", "float64", "lane_switch")

obs_metrics.describe(
    "remediation_attempts_total",
    "Remediation ladder rungs tried, by rung and entry point.",
)
obs_metrics.describe(
    "remediation_recovered_total",
    "Unhealthy solves recovered by the ladder, by original verdict and "
    "winning rung.",
)


class RemedyPolicy(NamedTuple):
    """Knobs of the escalation ladder. `max_attempts` is the per-request
    retry budget (rungs solved; skipped rungs are free);
    `deadline_margin` stops the ladder that many seconds before a
    request's deadline."""

    max_attempts: int = 4
    reg_scale: float = 1e3  # rung-2 multiplier over the dtype reg defaults
    allow_f64: bool = True
    allow_lane_switch: bool = True
    deadline_margin: float = 0.0  # stop climbing this early (seconds)


class RemedyOutcome(NamedTuple):
    solution: Any  # recovered row (rung set), else None
    verdict: Any  # final obs_health.Verdict
    rung: Optional[str]  # winning rung name; None when not recovered
    attempts: int  # rungs actually solved
    history: tuple  # ((rung, resulting verdict or note), ...)

    @property
    def recovered(self) -> bool:
        return self.rung is not None


def as_remedy(spec, *, solver_kw=None, entry="solve_lp", clock=None):
    """Coerce a ``remedy=`` argument into a `RemedyEngine` (or None):
    None, True (default policy), a `RemedyPolicy`, a dict of policy
    keywords, or an engine (returned as is, its own options and clock
    kept)."""
    if spec is None:
        return None
    if isinstance(spec, RemedyEngine):
        return spec
    if spec is True:
        spec = RemedyPolicy()
    elif isinstance(spec, dict):
        spec = RemedyPolicy(**spec)
    return RemedyEngine(spec, solver_kw=solver_kw, entry=entry, clock=clock)


class RemedyEngine:
    """One remediation policy bound to the solver options of the path it
    heals (`entry` labels its metrics). Host-side and stateless between
    calls; each `remediate` re-solves on the device of the problem's
    tensors. `clock` (default `time.monotonic`) is the domain of the
    deadlines passed to `remediate`."""

    def __init__(
        self,
        policy: Optional[RemedyPolicy] = None,
        *,
        solver_kw: Optional[dict] = None,
        entry: str = "solve_lp",
        clock=None,
    ):
        self.policy = policy or RemedyPolicy()
        self.solver_kw = dict(solver_kw or {})
        # the ladder re-solves plainly
        self.solver_kw.pop("trace", None)
        self.entry = entry
        self.clock = clock or time.monotonic

    def remediate(self, problem, verdict, *, deadline: Optional[float] = None,
                  request_id=None, meta=None) -> RemedyOutcome:
        """Run the ladder for ONE unbatched problem (`LPData`, `SparseLP`,
        or `BandedLP` with its `meta`) whose solve earned `verdict`.
        ``outcome.solution`` is a one-lane solution shaped and typed like
        the original path's row, to substitute in place. Never raises: a
        rung whose re-solve fails is recorded in the history and the
        ladder climbs on. With `deadline` (on the engine's clock) the
        ladder stops before a rung that would start past it, and the
        outcome keeps the original verdict."""
        pol = self.policy
        original = getattr(verdict, "verdict", str(verdict))
        kind = type(problem).__name__
        history = []
        attempts = 0
        won = None
        sol = None
        cold = None  # the cold rung's re-solve, kept for a give-up capture
        for rung in RUNGS:
            if attempts >= pol.max_attempts:
                break
            if deadline is not None and self.clock() >= deadline - pol.deadline_margin:
                history.append((rung, "deadline"))
                break
            try:
                result = getattr(self, f"_rung_{rung}")(kind, problem, meta)
            except Exception as e:  # a broken rung must not kill the solve
                result = f"error:{type(e).__name__}"
            if isinstance(result, str):  # rung skipped / inapplicable
                history.append((rung, result))
                continue
            attempts += 1
            obs_metrics.inc("remediation_attempts_total", rung=rung, entry=self.entry)
            cand, budget = result
            if rung == "cold":
                cold = cand
            v = obs_health.classify_solution(cand, budget=budget)
            name = v[0].verdict if v else "unknown"
            history.append((rung, name))
            if name in ("healthy", "slow"):
                won, sol = rung, cand
                break
        if won is not None:
            obs_metrics.inc("remediation_recovered_total", verdict=original, rung=won)
            final = obs_health.Verdict(
                "healthy", None, None, f"remediated ({won}) from {original}"
            )
        elif any(note == "deadline" for _, note in history):
            final = verdict  # the deadline machinery owns this failure
        else:
            final = obs_health.Verdict(
                "unrecoverable",
                getattr(verdict, "first_bad_iteration", None),
                getattr(verdict, "quantity", None),
                f"remediation ladder exhausted after {attempts} attempts "
                f"(original: {original}; "
                + ", ".join(f"{r}={n}" for r, n in history) + ")",
            )
            obs_recorder.maybe_capture(
                self.entry,
                verdict=final,
                problem=problem,
                solution=cold,
                options=dict(self.solver_kw),
                extra={"remediation": [list(h) for h in history],
                       "request_id": request_id},
            )
        get_tracer().event(
            "remediation",
            entry=self.entry,
            original=original,
            recovered=won is not None,
            rung=won,
            attempts=attempts,
            rungs=[f"{r}:{n}" for r, n in history],
            request_id=request_id,
        )
        return RemedyOutcome(sol, final, won, attempts, tuple(history))

    def remediate_solution_row(self, problem, row, *, budget: Optional[int] = None,
                               deadline: Optional[float] = None, request_id=None,
                               meta=None):
        """Classify one harvested solution row and run the ladder when its
        verdict is remediable: ``(row, info)``, the row replaced when the
        ladder recovered it, and a JSON-safe record of what ran (None when
        the row was healthy). The `SlotEngine` harvest hook."""
        vs = obs_health.classify_solution(row, budget=budget)
        v = vs[0] if vs else None
        if v is None or v.verdict not in REMEDIABLE:
            return row, None
        out = self.remediate(problem, v, deadline=deadline, request_id=request_id,
                             meta=meta)
        info = {
            "original": v.verdict,
            "verdict": out.verdict.verdict,
            "rung": out.rung,
            "attempts": out.attempts,
            "recovered": out.recovered,
        }
        return (out.solution if out.recovered else row), info

    # -- the rungs: each returns (solution, classify budget), or a short
    # string naming why the rung does not apply
    def _rung_cold(self, kind, problem, meta):
        return self._native_solve(kind, problem, meta, self.solver_kw)

    def _rung_regularize(self, kind, problem, meta):
        if kind == "SparseLP":
            return "no_reg_knob"  # PDHG has no KKT regularization
        kw = dict(self.solver_kw)
        f64 = problem.b.dtype == torch.float64
        # a user reg (an explicit 0.0 too) escalates FROM the dtype
        # defaults: 0 * scale would change nothing
        rp = kw.get("reg_p") or (1e-13 if f64 else 1e-8)
        rd = kw.get("reg_d") or (1e-12 if f64 else 1e-7)
        kw["reg_p"] = float(rp) * self.policy.reg_scale
        kw["reg_d"] = float(rd) * self.policy.reg_scale
        return self._native_solve(kind, problem, meta, kw)

    def _rung_float64(self, kind, problem, meta):
        if not self.policy.allow_f64:
            return "disabled"
        dtype = problem.b.dtype
        if dtype == torch.float64:
            return "already_f64"
        sol, budget = self._native_solve(
            kind, _cast_floats(problem, torch.float64), meta, self.solver_kw
        )
        return _cast_floats(sol, dtype), budget

    def _rung_lane_switch(self, kind, problem, meta):
        if not self.policy.allow_lane_switch:
            return "disabled"
        if kind == "BandedLP":
            return "no_paired_lane"
        if kind == "SparseLP":
            return self._switch_to_ipm(problem)
        return self._switch_to_pdhg(problem)

    def _native_solve(self, kind, problem, meta, kw):
        if kind == "BandedLP":
            from ..solvers.structured import solve_lp_banded

            return solve_lp_banded(meta, problem, **kw), kw.get("max_iter", 60)
        if kind == "SparseLP":
            from ..solvers.pdhg import solve_lp_pdhg

            return solve_lp_pdhg(problem, **kw), kw.get("max_iter", 100_000)
        from ..solvers.ipm import solve_lp

        return solve_lp(problem, **kw), kw.get("max_iter", 60)

    def _switch_to_pdhg(self, lp):
        """Dense IPM lane -> PDHG lane. The PDHG solution is classified
        as it is, then mapped into the IPM's row shape (bound duals from
        the reduced costs) so the batch stays homogeneous."""
        from ..solvers.pdhg import solve_lp_pdhg

        tol = max(float(self.solver_kw.get("tol") or 1e-6), 1e-6)
        sol = solve_lp_pdhg(dense_to_sparse(lp), tol=tol)
        v = obs_health.classify_solution(sol, budget=100_000)
        if v and v[0].verdict in ("healthy", "slow"):
            return _ipm_row_from_pdhg(sol, lp), None
        return sol, 100_000  # the ladder's classify rejects it

    def _switch_to_ipm(self, slp):
        """PDHG lane -> dense IPM lane (the pattern densified)."""
        from ..solvers.ipm import solve_lp

        lp = sparse_to_dense(slp)
        sol = solve_lp(lp, tol=float(self.solver_kw.get("tol") or 1e-8))
        v = obs_health.classify_solution(sol, budget=60)
        if v and v[0].verdict in ("healthy", "slow"):
            return _pdhg_row_from_ipm(sol, slp), None
        return sol, 60


def dense_to_sparse(lp: LPData) -> SparseLP:
    """Dense `LPData` row -> the equivalent `SparseLP` (COO over the
    nonzeros of A, in row-major order, int32 indices)."""
    rows, cols = torch.nonzero(lp.A, as_tuple=True)
    return SparseLP(
        rows.to(torch.int32), cols.to(torch.int32), lp.A[rows, cols],
        lp.b, lp.c, lp.l, lp.u, lp.c0,
    )


def sparse_to_dense(slp: SparseLP) -> LPData:
    """`SparseLP` row -> the equivalent dense `LPData` (the inverse of
    `dense_to_sparse`; a repeated (row, col) keeps one value, as numpy
    assignment does)."""
    A = torch.zeros(slp.b.shape[-1], slp.c.shape[-1], dtype=slp.vals.dtype,
                    device=slp.vals.device)
    A[slp.rows.long(), slp.cols.long()] = slp.vals
    return LPData(A, slp.b, slp.c, slp.l, slp.u, slp.c0)


def _cast_floats(tree, dtype):
    """Cast the floating tensors of a problem / solution NamedTuple,
    leaving flag, count and index fields as they are."""
    return type(tree)(*(
        a.to(dtype) if torch.is_floating_point(a) else a for a in tree
    ))


def _ipm_row_from_pdhg(psol, lp: LPData):
    """PDHGSolution -> IPMSolution row for a dense LP: bound duals from
    the reduced costs ``z = c - Aᵀy`` (zl the positive part on finite
    lower bounds, zu the negative part on finite upper ones), and the
    complementarity gap they imply."""
    from ..solvers.ipm import IPMSolution

    dt = lp.b.dtype
    x, y = psol.x.to(dt), psol.y.to(dt)
    fl, fu = torch.isfinite(lp.l), torch.isfinite(lp.u)
    z = lp.c - lp.A.transpose(-1, -2) @ y
    zl = torch.where(fl, torch.clamp(z, min=0.0), 0.0)
    zu = torch.where(fu, torch.clamp(-z, min=0.0), 0.0)
    comp = (torch.where(fl, (x - lp.l) * zl, 0.0).sum()
            + torch.where(fu, (lp.u - x) * zu, 0.0).sum())
    obj = psol.obj.to(dt)
    conv = psol.converged.to(torch.bool)
    return IPMSolution(
        x, y, zl, zu, obj, conv, psol.iterations.to(torch.int64),
        psol.res_primal.to(dt), psol.res_dual.to(dt),
        comp / (1.0 + obj.abs()), torch.where(conv, 0, 1).to(torch.int64),
    )


def _pdhg_row_from_ipm(isol, slp: SparseLP):
    """IPMSolution -> PDHGSolution row for a sparse LP (the bound duals
    dropped; the other fields map one to one)."""
    from ..solvers.pdhg import PDHGSolution

    dt = slp.b.dtype
    return PDHGSolution(
        isol.x.to(dt), isol.y.to(dt), isol.obj.to(dt), isol.converged.to(torch.bool),
        isol.iterations.to(torch.int64), isol.res_primal.to(dt),
        isol.res_dual.to(dt), torch.zeros((), dtype=torch.int32, device=isol.x.device),
    )
