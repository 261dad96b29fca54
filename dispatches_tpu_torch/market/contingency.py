"""N-1 security-constrained SCED: one lowered program, K contingencies.

The reference's double loop clears a security-*unconstrained* SCED; real
market clearing is N-1 secure — the dispatch must survive the loss of
any single branch or generator. The classical way to get there rebuilds
one model per outage; here every outage is a *parameter vector over the
same lowered program*, so a K-contingency screen is one batched
executable through the adaptive machinery (`runtime/adaptive.py`):

- :func:`contingency_dcopf_program` lowers a DC-OPF once whose branch
  susceptances are scaled by a ``branch_on`` 0/1 param (an A-matrix
  parameter group — `core/expr.py` param-scaled terms) and whose flow
  limits are parametric ``branch_cap`` ≤ rows. A branch outage is
  ``branch_on[l] = 0`` (the flow-definition row collapses to ``f_l = 0``);
  a generator outage rides the existing ``commit`` mask. No retrace per
  contingency: the executable is keyed on the program, not the outage.
- :func:`screen_contingencies` stacks K such parameter vectors into one
  batched ``LPData`` and solves it through ``solve_lp_adaptive`` (or a
  serving-tier ``SlotEngine`` — the continuous-batching path), returning
  per-contingency shed, binding branches, and objectives.
- :func:`secure_dispatch` is the constraint-generation loop: solve the
  base SCED, project post-contingency flows with the LODF matrix,
  translate violations into preventive cuts over the base flow
  variables (``dcopf_program(flow_cuts=...)``), and repeat until N-1
  feasible — then certify the final solve's KKT conditions through
  `obs/conformance.py`. An optional learned screener
  (`learn/screener.py`) shrinks the evaluated contingency set; every
  screened run is verified against the FULL set afterwards and falls
  back to the full loop on any violation, so screening never gates
  correctness.

Metrics: ``contingency_rounds_total`` / ``contingency_cuts_total`` /
``contingency_screen_solves_total`` (volume),
``contingency_violations_total`` (post-contingency overloads found by
the CG loop — expected during convergence),
``contingency_escaped_violations_total`` (overloads remaining AFTER the
final full-set verify — must stay zero; zero-seeded and gated
lower-is-better by `tools/journal_diff.py`), and the
``contingency_screened_share`` gauge (evaluated/total contingencies —
higher is better). Journal: ``contingency_event`` records per CG round
plus a final summary (schema v8), and ``ctg=`` attrs on solve records.

Port of the JAX package's `market/contingency.py`. The solving entries
take ``device=`` (default ``"cuda"``) and ``dtype=`` (default float64):
the K-lane stack is ONE batched `instantiate` on the device, screened by
the port's `solve_lp_adaptive` or a `SlotEngine`; the PTDF / LODF algebra
and the violation scan are host numpy, as in the JAX package. The
learned screener (``screener=``, `learn/screener.py`) shrinks the outage
set each round evaluates; the final dispatch is verified against the
full set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs.conformance import as_conformance
from ..obs.journal import get_tracer
from .network import GridData, dcopf_program

# a limit excess below max(rel_tol * limit, ABS_TOL) MW is rounding, not
# an overload — the IPM converges to ~1e-8 relative KKT residuals
ABS_TOL = 1e-6


def seed_metrics() -> None:
    """Zero-seed the gated contingency counters so a secure run's journal
    carries explicit zeros (journal_diff gates them lower-is-better;
    appearing-from-zero trips the gate)."""
    obs_metrics.inc("contingency_escaped_violations_total", 0)
    obs_metrics.inc("contingency_violations_total", 0)
    obs_metrics.inc("screener_accept_total", 0)
    obs_metrics.inc("screener_violation_fallback_total", 0)


# ----------------------------------------------------------- PTDF / LODF
def ptdf_matrix(grid: GridData) -> np.ndarray:
    """Power-transfer distribution factors (n_branch, n_bus): sensitivity
    of each branch flow to a 1 MW injection at each bus (withdrawn at the
    reference bus 0, matching the program's ``theta[0] = 0`` row)."""
    nb = len(grid.buses)
    nl = len(grid.branch_b)
    A = np.zeros((nl, nb))
    rows = np.arange(nl)
    A[rows, np.asarray(grid.branch_from, int)] = 1.0
    A[rows, np.asarray(grid.branch_to, int)] = -1.0
    Bd = np.asarray(grid.branch_b, float)[:, None] * A
    Bbus = A.T @ Bd
    ptdf = np.zeros((nl, nb))
    ptdf[:, 1:] = Bd[:, 1:] @ np.linalg.inv(Bbus[1:, 1:])
    return ptdf


def lodf_matrix(
    grid: GridData, ptdf: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Line-outage distribution factors (n_branch, n_branch):
    ``lodf[m, l]`` is the fraction of branch l's pre-outage flow that
    lands on branch m when l trips. Returns ``(lodf, islanding)`` where
    ``islanding[l]`` marks bridge branches whose removal disconnects the
    network — no redistribution exists for those, their columns are
    zeroed, and :meth:`ContingencySet.n_minus_1` excludes them."""
    if ptdf is None:
        ptdf = ptdf_matrix(grid)
    f = np.asarray(grid.branch_from, int)
    t = np.asarray(grid.branch_to, int)
    H = ptdf[:, f] - ptdf[:, t]  # (monitored m, outaged l)
    denom = 1.0 - np.diag(H)
    islanding = np.abs(denom) < 1e-8
    lodf = H / np.where(islanding, 1.0, denom)[None, :]
    np.fill_diagonal(lodf, -1.0)
    lodf[:, islanding] = 0.0
    return lodf, islanding


# ------------------------------------------------------- contingency set
@dataclasses.dataclass(frozen=True)
class Contingency:
    kind: str  # "branch" | "gen"
    index: int  # branch index / thermal-unit index
    label: str


@dataclasses.dataclass
class ContingencySet:
    """An ordered list of N-1 outages over one grid. Order is identity:
    the batched screen's lane k, the screener's target bit k, and the
    journal's ``ctg`` ids all refer to ``contingencies[k]``."""

    contingencies: List[Contingency]

    @property
    def K(self) -> int:
        return len(self.contingencies)

    def __iter__(self):
        return iter(self.contingencies)

    def __getitem__(self, k: int) -> Contingency:
        return self.contingencies[k]

    def branch_indices(self) -> List[int]:
        return [c.index for c in self.contingencies if c.kind == "branch"]

    def gen_indices(self) -> List[int]:
        return [c.index for c in self.contingencies if c.kind == "gen"]

    @classmethod
    def n_minus_1(
        cls,
        grid: GridData,
        *,
        branches: bool = True,
        gens: bool = True,
        max_k: Optional[int] = None,
    ) -> "ContingencySet":
        """Enumerate the N-1 set: every non-islanding branch outage plus
        every thermal-unit outage. Bridge branches (whose loss splits the
        network) are excluded — load shed there is topology, not
        dispatch, and no preventive cut can fix it."""
        items: List[Contingency] = []
        if branches:
            _, islanding = lodf_matrix(grid)
            items += [
                Contingency("branch", li, f"branch:{li}")
                for li in range(len(grid.branch_b))
                if not islanding[li]
            ]
        if gens:
            items += [
                Contingency("gen", gi, f"gen:{g.name}")
                for gi, g in enumerate(grid.thermal)
            ]
        if max_k is not None:
            items = items[: int(max_k)]
        return cls(items)


def base_operating_point(
    grid: GridData, hour: int = 0
) -> Dict[str, np.ndarray]:
    """One hour's ``load``/``ren_cap``/``commit`` parameter dict from the
    grid's day-ahead data and the merit-order UC — the base SCED
    operating point the drivers and tests secure."""
    from .network import UnitCommitment

    h = int(hour) % grid.da_load.shape[0]
    load = np.zeros(len(grid.buses))
    for c, v in zip(grid.load_bus, grid.da_load[h]):
        load[grid.bus_index(c)] = float(v)
    commit = UnitCommitment(grid).commit(
        grid.da_load.sum(1)[h : h + 1], grid.da_renewables.sum(1)[h : h + 1]
    )[0]
    n_ren = len(grid.renewable)
    ren = (
        np.asarray(grid.da_renewables[h], float)
        if n_ren
        else np.zeros(1)
    )
    return {
        "load": load,
        "ren_cap": ren,
        "commit": np.asarray(commit, float),
    }


# -------------------------------------------- the masked batched program
def contingency_dcopf_program(grid: GridData):
    """Lower the contingency DC-OPF once. Identical economics to
    :func:`dcopf_program` (same params ``load``/``ren_cap``/``commit``,
    same cost), but the network is parametric:

    - ``branch_on`` (n_branch,) 0/1 scales every susceptance in the
      flow-definition rows (``f = on*b*(θ_i - θ_j)``), so an outaged
      branch's flow is pinned to zero by its own row;
    - ``branch_cap`` (n_branch,) carries the flow limits as ≤ rows
      (``f <= cap``, ``f >= -cap``; named regions ``flow_cap_pos`` /
      ``flow_cap_neg``) instead of static variable bounds, so emergency
      ratings are per-contingency data too. Flow variables get wide
      static bounds that never bind.

    One lowered program covers every N-1 topology: contingency k is a
    parameter vector, and K of them stack into one batched ``LPData``
    (see :func:`stack_contingency_lp`) solved by ONE executable.
    """
    from ..core.model import Model

    nb = len(grid.buses)
    nl = len(grid.branch_b)
    m = Model("ctg_dcopf")
    load = m.param("load", nb)
    ren_cap = m.param("ren_cap", max(len(grid.renewable), 1))
    commit = m.param("commit", max(len(grid.thermal), 1))
    branch_on = m.param("branch_on", nl)
    branch_cap = m.param("branch_cap", nl)

    seg_vars, seg_costs, seg_bus = [], [], []
    base_vars = []
    m.mark_rows("base_commit")
    for gi, g in enumerate(grid.thermal):
        base = m.var(f"{g.name}.base")
        m.add_eq(base - commit[gi : gi + 1] * g.p_min)
        base_vars.append(base)
        for si, (wmw, c) in enumerate(zip(g.seg_mw, g.seg_cost)):
            v = m.var(f"{g.name}.seg{si}")
            m.add_le(v - commit[gi : gi + 1] * float(wmw))
            seg_vars.append(v)
            seg_costs.append(float(c))
            seg_bus.append(grid.bus_index(g.bus))

    ren_vars = []
    for ri, u in enumerate(grid.renewable):
        v = m.var(f"{u.name}.p")
        m.add_le(v - ren_cap[ri : ri + 1])
        ren_vars.append(v)

    theta = m.var("theta", nb, lb=-100.0, ub=100.0)
    slack = m.var("shortfall", nb)

    inj = [None] * nb

    def add_inj(i, expr):
        inj[i] = expr if inj[i] is None else inj[i] + expr

    for gi, g in enumerate(grid.thermal):
        add_inj(grid.bus_index(g.bus), base_vars[gi] + 0.0)
    for v, c, bi in zip(seg_vars, seg_costs, seg_bus):
        add_inj(bi, v + 0.0)
    for u, v in zip(grid.renewable, ren_vars):
        add_inj(grid.bus_index(u.bus), v + 0.0)

    # static flow bounds wide enough to never bind: the parametric cap
    # rows (below) are the real limits
    fbig = 4.0 * float(np.sum(np.abs(grid.branch_limit))) + 1.0
    flows = []
    m.mark_rows("flow_def")
    for li in range(nl):
        i, j = int(grid.branch_from[li]), int(grid.branch_to[li])
        b = float(grid.branch_b[li])
        fv = m.var(f"flow{li}", lb=-fbig, ub=fbig)
        m.add_eq(
            fv
            - branch_on[li : li + 1] * (b * theta[i : i + 1])
            + branch_on[li : li + 1] * (b * theta[j : j + 1])
        )
        flows.append((fv, i, j))

    m.mark_rows("ref_angle")
    m.add_eq(theta[0:1])

    m.mark_rows("balance")
    for bi_ in range(nb):
        expr = slack[bi_ : bi_ + 1] - load[bi_ : bi_ + 1]
        if inj[bi_] is not None:
            expr = expr + inj[bi_]
        for fv, i, j in flows:
            if i == bi_:
                expr = expr - fv
            if j == bi_:
                expr = expr + fv
        m.add_eq(expr)

    # parametric flow limits, both directions
    m.mark_rows("flow_cap_pos", kind="le")
    for li, (fv, _i, _j) in enumerate(flows):
        m.add_le(fv - branch_cap[li : li + 1])
    m.mark_rows("flow_cap_neg", kind="le")
    for li, (fv, _i, _j) in enumerate(flows):
        m.add_ge(fv + branch_cap[li : li + 1])

    shortfall_price = 1000.0
    cost = shortfall_price * slack.sum()
    for v, c, _ in zip(seg_vars, seg_costs, seg_bus):
        cost = cost + c * v
    m.expression("total_cost", cost)
    m.minimize(cost)

    prog = m.build()
    prog.balance_row0 = prog.row_ranges["balance"][0]
    prog.n_bus = nb
    prog.n_branch = nl
    prog.flow_cols = np.concatenate(
        [prog.col_index(f"flow{li}") for li in range(nl)]
    )
    return prog


def contingency_params(
    grid: GridData,
    base_params: Dict[str, np.ndarray],
    cset: ContingencySet,
    *,
    rate_factor: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Stack K per-contingency parameter vectors for
    :func:`contingency_dcopf_program` from one base operating point
    (``load``/``ren_cap``/``commit``). ``rate_factor`` scales the branch
    limits post-contingency (emergency ratings: real systems allow
    short-term overloads, e.g. 1.1–1.3x normal)."""
    K = cset.K
    nl = len(grid.branch_b)
    out = {
        "load": np.tile(np.asarray(base_params["load"], float), (K, 1)),
        "ren_cap": np.tile(np.asarray(base_params["ren_cap"], float), (K, 1)),
        "commit": np.tile(np.asarray(base_params["commit"], float), (K, 1)),
        "branch_on": np.ones((K, nl)),
        "branch_cap": np.tile(
            np.asarray(grid.branch_limit, float) * float(rate_factor), (K, 1)
        ),
    }
    for k, c in enumerate(cset):
        if c.kind == "branch":
            out["branch_on"][k, c.index] = 0.0
        else:
            out["commit"][k, c.index] = 0.0
    return out


def stack_contingency_lp(prog, params: Dict[str, np.ndarray],
                         dtype=torch.float64, device="cuda"):
    """Instantiate K parameter rows against the one lowered program as a
    single batched ``LPData`` (leading axis K on every field): one
    `instantiate` with the K rows as its batch axis, the ``branch_on``
    A-matrix group scattered per lane. The shape ``solve_lp_adaptive``
    detects and drives as one batch per ladder bucket, never one solve per
    contingency."""
    lp = prog.instantiate(
        {k: np.asarray(v, float) for k, v in params.items()},
        dtype=dtype, device=device,
    )
    K = lp.b.shape[0]
    # the bounds carry no parameter: give them the lane axis too
    return lp._replace(l=lp.l.expand(K, -1).clone(), u=lp.u.expand(K, -1).clone())


# ------------------------------------------------------ batched K screen
@dataclasses.dataclass
class ScreenResult:
    """One batched K-contingency screen. ``flows``/``binding`` are
    (K, n_branch); ``shed_mw`` is per-contingency total load shed (a
    positive value means the post-contingency network cannot serve load
    within limits even WITH redispatch — corrective infeasibility);
    ``critical`` marks contingencies that shed or bind any branch."""

    cset: ContingencySet
    sol: object  # batched IPMSolution
    flows: np.ndarray
    binding: np.ndarray
    shed_mw: np.ndarray
    objective: np.ndarray
    converged: np.ndarray
    stats: Dict

    @property
    def critical(self) -> np.ndarray:
        return (self.shed_mw > ABS_TOL) | self.binding.any(axis=1)


def screen_contingencies(
    prog,
    grid: GridData,
    cset: ContingencySet,
    base_params: Dict[str, np.ndarray],
    *,
    rate_factor: float = 1.0,
    bind_tol: float = 1e-4,
    engine=None,
    conformance=None,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
) -> ScreenResult:
    """Solve all K contingencies of `cset` as ONE batched LP through the
    adaptive machinery. With ``engine`` set (a dense ``SlotEngine`` from
    ``runtime.adaptive.make_dense_engine``) the K lanes are admitted as
    requests and ride continuous batching instead — the serving-tier
    path, bitwise-identical per lane by the engine's contract. The stack
    is instantiated on `device` (with an engine, rows are admitted from
    the host and solved on the engine's device)."""
    from ..core.program import LPData

    params = contingency_params(
        grid, base_params, cset, rate_factor=rate_factor
    )
    lp = stack_contingency_lp(prog, params, dtype=dtype, device=device)
    stats: Dict = {}
    tracer = get_tracer()
    if engine is not None:
        rows: List = [None] * cset.K
        for k in range(cset.K):
            while engine.free_slots() == 0:
                for tok, row, _ls in engine.step():
                    rows[tok] = row
            engine.admit(k, LPData(*(leaf[k] for leaf in lp)))
        while any(r is None for r in rows):
            harvested = engine.step()
            if not harvested and not engine.active():
                break
            for tok, row, _ls in harvested:
                rows[tok] = row
        sol = type(rows[0])(
            *(
                torch.as_tensor(np.stack([np.asarray(r[i]) for r in rows]))
                for i in range(len(rows[0]))
            )
        )
        stats = {"engine": True, "chunks": engine.chunks}
    else:
        from ..runtime.adaptive import solve_lp_adaptive

        sol = solve_lp_adaptive(
            lp, stats=stats, conformance=conformance, **solver_kw
        )
    obs_metrics.inc("contingency_screen_solves_total", cset.K)
    x_host = sol.x.cpu()  # one device read for the whole stack
    x = x_host.numpy()
    flows = x[..., prog.flow_cols]
    caps = params["branch_cap"]
    live = params["branch_on"] > 0.5
    binding = live & (
        np.abs(flows) >= caps * (1.0 - 1e-9) - max(bind_tol, ABS_TOL)
    )
    shed = prog.extract("shortfall", x_host).numpy().sum(axis=-1)
    result = ScreenResult(
        cset=cset,
        sol=sol,
        flows=flows,
        binding=binding,
        shed_mw=shed,
        objective=sol.obj.cpu().numpy(),
        converged=sol.converged.cpu().numpy(),
        stats=stats,
    )
    extra = {}
    if stats and "buckets" in stats:
        extra["adaptive_stats"] = {
            "lanes_retired": stats.get("lanes_retired"),
            "buckets": stats.get("buckets"),
            "compile_hits": stats.get("compile_hits"),
            "compile_misses": stats.get("compile_misses"),
        }
    tracer.solve_event(
        "contingency_screen", sol, ctg=f"screen[K={cset.K}]", **extra
    )
    tracer.event(
        "contingency_event",
        phase="screen",
        K=cset.K,
        critical=int(result.critical.sum()),
        shed_contingencies=int((shed > ABS_TOL).sum()),
        converged=int(result.converged.sum()),
    )
    return result


# ------------------------------------- constraint generation (secure CG)
def _base_flows(prog, x, nl: int) -> np.ndarray:
    """Gather the nl branch-flow values from a base-program solution."""
    cols = getattr(prog, "_secure_flow_cols", None)
    if cols is None:
        cols = np.concatenate(
            [prog.col_index(f"flow{li}") for li in range(nl)]
        )
        prog._secure_flow_cols = cols
    return x.cpu().numpy()[..., cols].astype(float)


def post_contingency_flows(
    f0: np.ndarray, lodf: np.ndarray, branch_idx: np.ndarray
) -> np.ndarray:
    """LODF projection: base-case flows ``f0`` (n_branch,) → post-outage
    flows (len(branch_idx), n_branch) for each outaged branch, assuming
    no redispatch (the preventive-security model)."""
    return f0[None, :] + lodf[:, branch_idx].T * f0[branch_idx][:, None]


def _find_violations(
    f0: np.ndarray,
    lodf: np.ndarray,
    limits: np.ndarray,
    eval_idx: List[int],
    rel_tol: float,
) -> List[Tuple[int, int, float]]:
    """(outaged branch l, monitored branch m, signed excess) triples for
    every post-contingency overload among the evaluated outages."""
    if not eval_idx:
        return []
    idx = np.asarray(eval_idx, int)
    fpost = post_contingency_flows(f0, lodf, idx)
    tol = np.maximum(rel_tol * limits, ABS_TOL)
    out = []
    for row, l in enumerate(idx):
        over = np.where(np.abs(fpost[row]) > limits + tol)[0]
        for m in over:
            if m == l:
                continue
            out.append((int(l), int(m), float(fpost[row, m])))
    return out


@dataclasses.dataclass
class SecureDispatch:
    """Result of :func:`secure_dispatch`. ``sol`` solves the final
    cut-augmented base SCED; ``feasible`` means the full N-1 branch set
    projects inside limits (``escaped_violations == 0``)."""

    sol: object
    prog: object
    lmp: np.ndarray
    flows: np.ndarray
    cuts: List[Tuple[Dict[int, float], float]]
    rounds: int
    feasible: bool
    escaped_violations: int
    screened: bool
    screen_fallback: bool
    evaluated: int
    total_branch_ctg: int
    conformance: Optional[Dict]
    violated_outages: Tuple[int, ...] = ()
    gen_screen: Optional[ScreenResult] = None

    @property
    def shrink_ratio(self) -> float:
        """Evaluated share of the branch-contingency set (1.0 = full)."""
        if not self.total_branch_ctg:
            return 1.0
        return self.evaluated / float(self.total_branch_ctg)


def _cut_for(l: int, m: int, fpost: float, lodf: np.ndarray,
             limit: float) -> Tuple[Dict[int, float], float]:
    """Preventive cut for overload of monitored branch m under outage of
    branch l: ``±(f_m + lodf[m,l] f_l) <= limit_m``, linear in the base
    flow variables."""
    s = 1.0 if fpost > 0 else -1.0
    return ({m: s, l: s * float(lodf[m, l])}, float(limit))


def secure_dispatch(
    grid: GridData,
    base_params: Dict[str, np.ndarray],
    cset: ContingencySet,
    *,
    screener=None,
    max_rounds: int = 10,
    rel_tol: float = 1e-4,
    conformance=None,
    screen_gens: bool = False,
    ctg_prog=None,
    dtype=torch.float64,
    device="cuda",
    **solver_kw,
):
    """Iterative constraint generation to an N-1 feasible base dispatch.

    Each round solves the (cut-augmented) base ``dcopf_program`` on
    `device`, projects post-contingency flows for the evaluated branch
    outages via the LODF matrix on the host, and appends one preventive
    cut per overload; the loop ends when the evaluated set projects clean.
    With a ``screener`` (`learn/screener.py`: anything with a
    ``screen(lp, cset) -> bool mask | None`` method, or artifact paths)
    only the predicted-critical outages are evaluated inside the loop; the
    final dispatch is then verified against the FULL set, and any
    violation falls back to full-set constraint generation (counted in
    ``screener_violation_fallback_total``), so the screener never gates
    correctness. ``screener=None`` evaluates the full set every round.

    ``screen_gens=True`` additionally runs the batched corrective screen
    over the generator outages of `cset` (one ``solve_lp_adaptive``
    batch; pass ``ctg_prog`` to reuse a lowered
    :func:`contingency_dcopf_program`), reporting per-outage load shed.
    """
    from ..solvers.ipm import solve_lp

    if screener is not None and not hasattr(screener, "screen"):
        # a path (or sequence of paths) to saved screener artifacts
        from ..learn.screener import as_screener

        screener = as_screener(screener, device=device)

    tracer = get_tracer()
    seed_metrics()
    checker = as_conformance(conformance)

    lodf, islanding = lodf_matrix(grid)
    limits = np.asarray(grid.branch_limit, float)
    all_idx = [c.index for c in cset
               if c.kind == "branch" and not islanding[c.index]]
    params = {k: np.asarray(v) for k, v in base_params.items()}

    # screened evaluation set (never gates correctness: full verify below)
    eval_idx = list(all_idx)
    screened = False
    if screener is not None and all_idx:
        base_lp0 = dcopf_program(grid).instantiate(params, dtype=dtype, device=device)
        mask = screener.screen(base_lp0, cset)
        if mask is not None:
            bidx = [c.index for c in cset if c.kind == "branch"]
            eval_idx = [
                l for l, keep in zip(bidx, np.asarray(mask, bool))
                if keep and not islanding[l]
            ]
            screened = len(eval_idx) < len(all_idx)
    obs_metrics.set_gauge(
        "contingency_screened_share",
        (len(eval_idx) / len(all_idx)) if all_idx else 1.0,
    )

    cuts: List[Tuple[Dict[int, float], float]] = []
    seen_cuts = set()
    violated: set = set()
    sol = prog = None
    rounds = 0
    fallback = False
    active_idx = eval_idx

    while rounds < max_rounds:
        rounds += 1
        obs_metrics.inc("contingency_rounds_total")
        prog = dcopf_program(grid, flow_cuts=cuts if cuts else None)
        lp = prog.instantiate(params, dtype=dtype, device=device)
        sol = solve_lp(lp, **solver_kw)
        f0 = _base_flows(prog, sol.x, len(grid.branch_b))
        viols = _find_violations(f0, lodf, limits, active_idx, rel_tol)
        obs_metrics.inc("contingency_violations_total", len(viols))
        fresh = 0
        for l, m, fpost in viols:
            violated.add(l)
            key = (l, m, fpost > 0)
            if key in seen_cuts:
                continue
            seen_cuts.add(key)
            cuts.append(_cut_for(l, m, fpost, lodf, limits[m]))
            fresh += 1
        obs_metrics.inc("contingency_cuts_total", fresh)
        tracer.event(
            "contingency_event",
            phase="round",
            round=rounds,
            evaluated=len(active_idx),
            K=len(all_idx),
            violations=len(viols),
            cuts_added=fresh,
            cuts_total=len(cuts),
            screened=screened and active_idx is eval_idx,
        )
        if not viols:
            if active_idx is eval_idx and screened:
                # screened loop converged: verify the FULL set
                escapes = _find_violations(f0, lodf, limits, all_idx, rel_tol)
                if escapes:
                    fallback = True
                    obs_metrics.inc(
                        "screener_violation_fallback_total", len(escapes)
                    )
                    if hasattr(screener, "note_violation_fallback"):
                        screener.note_violation_fallback(len(escapes))
                    active_idx = all_idx
                    continue
                obs_metrics.inc("screener_accept_total")
                if hasattr(screener, "note_accept"):
                    screener.note_accept()
            break
        if fresh == 0:
            break  # violations persist but generate no new cuts: stuck

    # final full-set projection — the escaped-violation gate
    f0 = _base_flows(prog, sol.x, len(grid.branch_b))
    escapes = _find_violations(f0, lodf, limits, all_idx, rel_tol)
    violated.update(l for l, _, _ in escapes)
    obs_metrics.inc("contingency_escaped_violations_total", len(escapes))

    conf = None
    if checker is not None:
        conf = checker.check_row(lp, sol, entry="secure_dispatch")
    lmp = sol.y[prog.balance_row0 : prog.balance_row0 + prog.n_bus].cpu().numpy()
    tracer.solve_event("secure_dispatch", sol, ctg="screened" if screened else "full",
                       conformance=conf)

    gen_screen = None
    if screen_gens and cset.gen_indices():
        gsub = ContingencySet([c for c in cset if c.kind == "gen"])
        gprog = ctg_prog if ctg_prog is not None \
            else contingency_dcopf_program(grid)
        gen_screen = screen_contingencies(
            gprog, grid, gsub, base_params, dtype=dtype, device=device,
            **solver_kw
        )

    result = SecureDispatch(
        sol=sol,
        prog=prog,
        lmp=lmp,
        flows=f0,
        cuts=cuts,
        rounds=rounds,
        feasible=not escapes,
        escaped_violations=len(escapes),
        screened=screened,
        screen_fallback=fallback,
        evaluated=len(eval_idx),
        total_branch_ctg=len(all_idx),
        conformance=conf,
        violated_outages=tuple(sorted(violated)),
        gen_screen=gen_screen,
    )
    tracer.event(
        "contingency_event",
        phase="final",
        K=len(all_idx),
        rounds=rounds,
        cuts_total=len(cuts),
        feasible=result.feasible,
        escaped=len(escapes),
        screened=screened,
        screen_fallback=fallback,
        shrink=result.shrink_ratio,
    )
    return result
