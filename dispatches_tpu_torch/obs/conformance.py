"""Numerical conformance plane: per-solve KKT certificates (port of
`dispatches_tpu/obs/conformance.py`).

A health verdict (`obs.health`) reads the shape of a trajectory; a solve
that converges cleanly to a slightly wrong optimum is invisible to it.
These certificates are computed from the solution itself, in the
original (unscaled) problem frame:

- **primal feasibility**   ``‖b − Ax‖ / (1 + ‖b‖)``
- **dual feasibility**     ``‖c − Aᵀy − zl + zu‖ / (1 + ‖c‖)`` (IPM) or
  the projected-gradient form ``‖x − Π[l,u](x − (c − Aᵀy))‖ / (1 + ‖x‖)``
  (PDHG, which carries no bound duals)
- **complementarity**      ``|Σ zl·(x−l) + Σ zu·(u−x)| / (1 + |c·x|)``
- **relative duality gap** ``|pobj − dobj| / (1 + |pobj| + |dobj|)``

The three cores (dense, banded, PDHG) run batch-first on the tensors'
device, one (B, 4) result per call, in place of the JAX package's jitted
kernel per (family, batch layout); only four numbers per lane cross to
the host. Infinite bounds carry zero duals, and 0 replaces the bound
BEFORE any product (``0 * inf`` is NaN and would poison the sums even
under a mask). The PDHG core uses the solver's own products
(`solvers.pdhg`), so its residuals are the ones the solver reports.

`ConformanceChecker` scores certificates against a `ConformancePolicy`,
feeds the ``solve_residual_*`` histograms and the
``solve_conformance_total`` / ``solve_inaccurate_total`` counters, and
renders the ``inaccurate`` verdict. The checker only reads solutions, so
``conformance=`` on the adaptive entry points is bitwise-neutral.
`default_conformance_rules` is the alert pack (``accuracy_burn``,
``canary_mismatch``) services install next to
`alerts.default_fleet_rules` when the plane is on.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, fields as _dc_fields
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from . import metrics as obs_metrics
from .alerts import AlertRule
from .health import Verdict, severity

# log-spaced ladder for relative-residual histograms
RESIDUAL_BUCKETS = (
    1e-12, 1e-10, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0,
)

# certificate field order: one (4,) vector per lane
FIELDS = ("res_primal", "res_dual", "comp", "gap")

obs_metrics.describe(
    "solve_residual_primal",
    "Relative primal feasibility ‖b−Ax‖/(1+‖b‖) of harvested solutions, "
    "by entry (solution frame, not the solver's scaled frame).",
)
obs_metrics.describe(
    "solve_residual_dual",
    "Relative dual feasibility of harvested solutions, by entry "
    "(‖c−Aᵀy−zl+zu‖/(1+‖c‖) for IPM; projected-gradient form for PDHG).",
)
obs_metrics.describe(
    "solve_residual_comp",
    "Relative complementarity |Σ zl·(x−l)+Σ zu·(u−x)|/(1+|c·x|) of "
    "harvested solutions, by entry.",
)
obs_metrics.describe(
    "solve_residual_gap",
    "Relative duality gap |pobj−dobj|/(1+|pobj|+|dobj|) of harvested "
    "solutions, by entry.",
)
obs_metrics.describe(
    "solve_conformance_total",
    "Conformance checks by entry and outcome (pass / inaccurate / nonfinite).",
)
obs_metrics.describe(
    "solve_inaccurate_total",
    "Solutions whose KKT certificates violated the conformance policy, by entry.",
)


@dataclass(frozen=True)
class ConformancePolicy:
    """Per-certificate acceptance bounds (relative, solution frame), ~2
    decades above the solvers' tolerances: a healthy f32 solve passes, a
    wrong answer (a perturbed warm start, a mis-mapped lane switch) fails."""

    res_primal: float = 1e-4
    res_dual: float = 1e-4
    comp: float = 1e-4
    gap: float = 1e-4

    def bound(self, name: str) -> float:
        return float(getattr(self, name))

    def to_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name)) for f in _dc_fields(self)}


def as_policy(policy) -> ConformancePolicy:
    if policy is None:
        return ConformancePolicy()
    if isinstance(policy, ConformancePolicy):
        return policy
    if isinstance(policy, Mapping):
        return ConformancePolicy(**{k: float(v) for k, v in policy.items()})
    raise TypeError(f"cannot build a ConformancePolicy from {policy!r}")


# ---------------------------------------------------------------------------
# cores: (B, 4) certificates, original problem frame, batch-first


def _nrm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _box_terms(l, u, x, zl, zu, c_dot_x):
    """(comp, dual bound contribution) with infinite bounds replaced by 0
    before any product."""
    fin_l, fin_u = torch.isfinite(l), torch.isfinite(u)
    l_s = torch.where(fin_l, l, 0.0)
    u_s = torch.where(fin_u, u, 0.0)
    comp_sum = (torch.where(fin_l, zl * (x - l_s), 0.0).sum(-1)
                + torch.where(fin_u, zu * (u_s - x), 0.0).sum(-1))
    comp = comp_sum.abs() / (1.0 + c_dot_x.abs())
    dual_bound = (torch.where(fin_l, zl * l_s, 0.0).sum(-1)
                  - torch.where(fin_u, zu * u_s, 0.0).sum(-1))
    return comp, dual_bound


def _gap_rel(pobj, dobj):
    return (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())


def _dense_core(A, b, c, l, u, c0, x, y, zl, zu):
    rp = _nrm(b - (A @ x[..., None])[..., 0]) / (1.0 + _nrm(b))
    aty = (A.transpose(-1, -2) @ y[..., None])[..., 0]
    rd = _nrm(c - aty - zl + zu) / (1.0 + _nrm(c))
    cx = _dot(c, x)
    comp, dual_bound = _box_terms(l, u, x, zl, zu, cx)
    pobj = cx + c0
    dobj = _dot(b, y) + dual_bound + c0
    return torch.stack([rp, rd, comp, _gap_rel(pobj, dobj)], -1)


def _banded_core(col_pos, Ad, As, Bb, b, c, cb, lt, ut, lb, ub, c0, x, y, zl, zu):
    # the flat [time-blocks | border] layout of solve_lp_banded: reduced
    # vectors (CompiledLP column order) scatter through col_pos; padding
    # rows/columns carry all-zero A entries and zero c/b
    B, Tb, mB, nB = Ad.shape
    p = Bb.shape[-1]
    nt = Tb * nB
    dt = Ad.dtype

    def scatter(v):
        out = torch.zeros(B, nt + p, dtype=dt, device=v.device)
        out[:, col_pos] = v.to(dt)
        return out

    def shift_down(a):  # block t sees block t-1
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)

    def shift_up(a):
        return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)

    x_flat, zl_flat, zu_flat = scatter(x), scatter(zl), scatter(zu)
    yt = y.reshape(B, Tb, mB).to(dt)
    xt = x_flat[:, :nt].reshape(B, Tb, nB)
    xb = x_flat[:, nt:]
    Ax = (torch.einsum("btij,btj->bti", Ad, xt)
          + torch.einsum("btij,btj->bti", As, shift_down(xt))
          + torch.einsum("btip,bp->bti", Bb, xb))
    rp = _nrm((b - Ax).reshape(B, -1)) / (1.0 + _nrm(b.reshape(B, -1)))
    aty_t = torch.einsum("btij,bti->btj", Ad, yt) + shift_up(
        torch.einsum("btij,bti->btj", As, yt))
    aty = torch.cat([aty_t.reshape(B, -1), torch.einsum("btip,bti->bp", Bb, yt)], -1)
    c_all = torch.cat([c.reshape(B, -1), cb], -1)
    rd = _nrm(c_all - aty - zl_flat + zu_flat) / (1.0 + _nrm(c_all))
    l_all = torch.cat([lt.reshape(B, -1), lb], -1)
    u_all = torch.cat([ut.reshape(B, -1), ub], -1)
    cx = _dot(c_all, x_flat)
    comp, dual_bound = _box_terms(l_all, u_all, x_flat, zl_flat, zu_flat, cx)
    pobj = cx + c0
    dobj = (yt * b).sum((-1, -2)) + dual_bound + c0
    return torch.stack([rp, rd, comp, _gap_rel(pobj, dobj)], -1)


def _pdhg_core(rows, cols, vals, b, c, l, u, c0, x, y):
    # the solver's own final residuals (its products, its frame), plus the
    # bound-aware dual objective from the reduced costs' sign
    from ..solvers.pdhg import _Op, _Pattern, _residuals

    M, N = b.shape[-1], c.shape[-1]
    op = _Op(_Pattern(rows, cols, M, N, b.device), vals)
    rp, rd = _residuals(op, b, c, l, u, x, y)
    z = c - op.rmv(y)
    zl = torch.clamp(z, min=0.0)
    zu = torch.clamp(-z, min=0.0)
    cx = _dot(c, x)
    comp, dual_bound = _box_terms(l, u, x, zl, zu, cx)
    pobj = cx + c0
    dobj = _dot(b, y) + dual_bound + c0
    return torch.stack([rp, rd, comp, _gap_rel(pobj, dobj)], -1)


def _family_of(problem) -> str:
    name = type(problem).__name__
    if name == "LPData":
        return "dense"
    if name == "BandedLP":
        return "banded"
    if name == "SparseLP":
        return "pdhg"
    raise TypeError(f"no conformance kernel for problem type {name}")


def _sol_parts(family: str, row):
    if family == "pdhg":
        return (row.x, row.y)
    return (row.x, row.y, row.zl, row.zu)


def kkt_certificates(problem, sol, *, axes=None, meta=None) -> np.ndarray:
    """Certificate vector(s) for `sol` against `problem`: shape ``(4,)``
    for a single lane (``axes=None``) or ``(B, 4)`` for a batch whose
    problem fields carry the batch on axis 0 where `axes` says 0 (None
    entries are shared). Order is `FIELDS`. Banded problems need `meta`
    (the `TimeStructure`) for the reduced-column scatter."""
    from ..solvers.ipm import _LP_NDIM
    from ..solvers.pdhg import _SPARSE_NDIM
    from ..solvers.structured import _BASE_NDIM

    family = _family_of(problem)
    ndim = {"dense": _LP_NDIM, "banded": _BASE_NDIM, "pdhg": _SPARSE_NDIM}[family]
    parts = [torch.as_tensor(p) for p in _sol_parts(family, sol)]
    device = parts[0].device
    single = axes is None
    if single:
        axes = (None,) * len(problem)
        parts = [p.unsqueeze(0) for p in parts]
    B = parts[0].shape[0]
    args = []
    for name, arr, ax in zip(problem._fields, problem, axes):
        arr = torch.as_tensor(arr, device=device)
        if family == "pdhg" and name in ("rows", "cols"):
            args.append(arr)  # one shared pattern
        elif family == "pdhg" and name == "vals":
            args.append(arr if ax == 0 else arr.unsqueeze(0))
        else:
            args.append(arr if ax == 0 else arr.unsqueeze(0).expand(B, *arr.shape))
        if ax == 0 and arr.dim() != ndim[name] + 1:
            raise ValueError(f"{type(problem).__name__}.{name} has no batch axis")
    with torch.no_grad():
        if family == "dense":
            cert = _dense_core(*args, *parts)
        elif family == "pdhg":
            cert = _pdhg_core(*args, *parts)
        else:
            if meta is None:
                raise ValueError("banded conformance checks need meta=")
            col_pos = torch.as_tensor(meta.col_pos, device=device)
            cert = _banded_core(col_pos, *args, *parts)
    cert = cert.cpu().numpy()
    return cert[0] if single else cert


# ---------------------------------------------------------------------------
# checker: policy + metrics + verdicts + aggregate report


def _finite_fields(cert) -> Dict[str, float]:
    return {name: float(v) for name, v in zip(FIELDS, np.asarray(cert))}


class ConformanceChecker:
    """Policy-carrying wrapper around the certificates, the object the
    ``conformance=`` hooks accept. Host-side state is outcome counts and
    per-entry worsts (lock-guarded). `check_row` / `check_batch` return
    plain dicts for `stats` and feed the ``solve_residual_*``
    histograms; solutions are never changed."""

    def __init__(self, policy=None, *, meta=None):
        self.policy = as_policy(policy)
        self.meta = meta
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._worst: Dict[str, Dict[str, float]] = {}
        self._checked = 0

    def score(self, fields: Mapping[str, float]) -> str:
        vals = [fields.get(name) for name in FIELDS]
        if any(v is None or not np.isfinite(v) for v in vals):
            return "nonfinite"
        for name in FIELDS:
            if fields[name] > self.policy.bound(name):
                return "inaccurate"
        return "pass"

    def verdict(self, fields: Mapping[str, Any]) -> Optional[Verdict]:
        """An ``inaccurate`` (or ``nonfinite``) `health.Verdict` for a
        failed check, None for a pass; blame lands on the worst
        certificate relative to its bound."""
        outcome = fields.get("outcome") or self.score(fields)
        if outcome == "pass":
            return None
        if outcome == "nonfinite":
            return Verdict("nonfinite", None, "res_primal",
                           "non-finite conformance certificate")
        worst = max(FIELDS, key=lambda n: fields[n] / self.policy.bound(n))
        return Verdict(
            "inaccurate", None, worst,
            f"{worst}={fields[worst]:.3e} exceeds policy bound "
            f"{self.policy.bound(worst):.1e}",
        )

    def check_row(self, problem, row, *, entry: str, meta=None) -> Dict[str, Any]:
        """Certify one solution row; the fields dict (certificates,
        outcome, ok)."""
        cert = kkt_certificates(problem, row, meta=meta if meta is not None else self.meta)
        return self.note(_finite_fields(cert), entry=entry)

    def check_batch(self, problem, axes, sol, *, entry: str, meta=None) -> Dict[str, Any]:
        """Certify a stacked batch in one call: ``lanes`` (per-lane fields
        in lane order), ``ok`` (every lane passed), ``worst`` (field-wise
        maxima)."""
        certs = kkt_certificates(problem, sol, axes=axes,
                                 meta=meta if meta is not None else self.meta)
        lanes = [self.note(_finite_fields(c), entry=entry) for c in certs]
        worst = {name: max(ln[name] for ln in lanes) for name in FIELDS}
        return {
            "entry": entry,
            "lanes": lanes,
            "ok": all(ln["ok"] for ln in lanes),
            "worst": worst,
        }

    def note(self, fields: Mapping[str, float], *, entry: str) -> Dict[str, Any]:
        """Record precomputed certificates: histograms, outcome counters,
        the aggregate report. Returns the enriched fields dict."""
        outcome = self.score(fields)
        out = {name: float(fields[name]) for name in FIELDS
               if fields.get(name) is not None}
        out["outcome"] = outcome
        out["ok"] = outcome == "pass"
        for name in FIELDS:
            v = out.get(name)
            if v is not None and np.isfinite(v):
                obs_metrics.observe(
                    f"solve_residual_{name.replace('res_', '')}",
                    v, buckets=RESIDUAL_BUCKETS, entry=entry,
                )
        obs_metrics.inc("solve_conformance_total", entry=entry, outcome=outcome)
        if outcome != "pass":
            obs_metrics.inc("solve_inaccurate_total", entry=entry)
        with self._lock:
            self._checked += 1
            self._counts[outcome] = self._counts.get(outcome, 0) + 1
            w = self._worst.setdefault(entry, {})
            for name in FIELDS:
                v = out.get(name)
                if v is not None and np.isfinite(v):
                    w[name] = max(w.get(name, 0.0), v)
        return out

    def seed_metrics(self, entry: str) -> None:
        """Zero-seed the plane's counters (a baseline for rate rules)."""
        obs_metrics.inc("solve_inaccurate_total", 0, entry=entry)
        obs_metrics.inc("solve_conformance_total", 0, entry=entry, outcome="pass")

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "policy": self.policy.to_dict(),
                "checked": self._checked,
                "outcomes": dict(self._counts),
                "worst": {e: dict(w) for e, w in self._worst.items()},
            }


def as_conformance(arg, *, meta=None) -> Optional[ConformanceChecker]:
    """Coerce a ``conformance=`` argument: True gives a default checker, a
    `ConformancePolicy` or mapping a checker with that policy, a checker
    passes through (gaining `meta` if it has none), None/False is None."""
    if arg is None or arg is False:
        return None
    if isinstance(arg, ConformanceChecker):
        if meta is not None and arg.meta is None:
            arg.meta = meta
        return arg
    if arg is True:
        return ConformanceChecker(meta=meta)
    return ConformanceChecker(as_policy(arg), meta=meta)


def escalate_verdict(verdict: str, conf: Optional[Mapping[str, Any]]) -> str:
    """A failed conformance check upgrades a trajectory-healthy verdict to
    ``inaccurate``; a verdict at least as severe keeps its name."""
    if not conf or conf.get("ok", True):
        return verdict
    if severity(verdict) < severity("inaccurate"):
        return "inaccurate"
    return verdict


def default_conformance_rules(*, window: float = 60.0) -> List[AlertRule]:
    """The alert pack services add to `alerts.default_fleet_rules` when
    the conformance plane (or a canary scheduler) is active. Both
    counters are zero-seeded at service build so the rate rules see a
    flat baseline, not an absent series."""
    return [
        AlertRule(
            name="accuracy_burn", series="solve_inaccurate_total",
            kind="rate", op=">", bound=0.0, window=window, for_=0.0,
            severity="page",
            description="harvested solutions are failing their KKT "
            "conformance policy (silent wrong answers reaching callers)",
        ),
        AlertRule(
            name="canary_mismatch", series="canary_mismatch_total",
            kind="rate", op=">", bound=0.0, window=window, for_=0.0,
            severity="page",
            description="a golden canary solve came back outside "
            "tolerance of its certified reference (bad warm artifact, "
            "mis-mapped lane switch, or stale compile cache)",
        ),
    ]
