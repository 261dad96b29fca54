"""Golden canary probing: known-answer solves through the full serve path
(port of `dispatches_tpu/serve/canary.py`).

The conformance plane (`obs.conformance`) certifies that a solution
satisfies *its own* KKT conditions — but a request that was silently
routed to the wrong executable, seeded from a stale warm artifact, or
solved against mis-mapped data can still come back KKT-consistent for
the wrong problem. The canary closes that hole with **golden problems**:
per-family LPs whose reference solutions were certified once (tight
tolerance + KKT certificates) and frozen into a versioned ``.npz``
artifact. A `CanaryScheduler` re-submits them through the ordinary
router→shard→engine path at ``batch`` priority on a cadence, and scores
every answer against the frozen reference:

- ``exact``      — bitwise equal to the reference primal (the serve
  path's bitwise-identity contract holds end to end);
- ``tolerance``  — within the scheduler's relative tolerance (expected
  across backend/batch-width rounding differences);
- ``mismatch``   — outside tolerance: a silent wrong answer is reaching
  callers. Feeds ``canary_mismatch_total`` — the ``canary_mismatch``
  alert pages within one canary period.

The artifact format is the JAX package's, so a golden set certified by
either package loads in the other. Its hygiene follows the JAX package's
`learn.warmstart`: a ``__manifest__``
JSON key, an ``ARTIFACT_VERSION`` gate, and refuse-to-load (raise
`CanaryArtifactMismatch`, never silently degrade) on version skew,
family mismatch, missing arrays, or a content-fingerprint mismatch —
the last recomputed from the loaded LP bytes, so a tampered or
bit-rotted golden can never become the thing we trust.

Each canary submission carries a unique per-round fingerprint
(``__canary__<name>#<round>``), so the service's result cache can never
short-circuit the probe — every round exercises a real solve.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ..core.program import LPData, SparseLP, lp_fingerprint
from ..obs import metrics as obs_metrics
from ..obs.journal import get_tracer

ARTIFACT_VERSION = 1

#: problem families a golden artifact can carry (banded goldens would
#: need the TimeStructure meta, which is not self-contained in arrays)
FAMILY_TYPES = {"dense": LPData, "pdhg": SparseLP}

OUTCOMES = ("exact", "tolerance", "mismatch", "inconclusive")

obs_metrics.describe(
    "canary_rounds_total",
    "Canary rounds injected through the serve path, per scheduler.",
)
obs_metrics.describe(
    "canary_pass_total",
    "Canary solves that matched their certified reference, by golden "
    "and outcome (exact = bitwise; tolerance = within the scheduler's "
    "relative tolerance). Zero-seeded at scheduler build.",
)
obs_metrics.describe(
    "canary_mismatch_total",
    "Canary solves outside tolerance of their certified reference, by "
    "golden — the canary_mismatch alert's numerator (zero-seeded).",
)
obs_metrics.describe(
    "canary_inconclusive_total",
    "Canary solves that returned no usable answer (shed, deadline, "
    "poisoned) — the probe says nothing about accuracy, by golden.",
)


class CanaryArtifactMismatch(ValueError):
    """A golden artifact failed a refuse-to-load check (version skew,
    family mismatch, missing arrays, fingerprint tamper)."""


class GoldenProblem(NamedTuple):
    """One frozen known-answer probe: the problem, its certified
    reference primal/objective, and the content fingerprint binding
    them. `tol` is the per-golden relative acceptance tolerance."""

    name: str
    family: str
    problem: Any  # LPData / SparseLP with numpy leaves
    x_ref: np.ndarray
    obj_ref: float
    fingerprint: str
    tol: float = 1e-6


def certify_golden(
    name: str,
    lp,
    *,
    tol: float = 1e-6,
    certify_tol: float = 1e-9,
    max_iter: int = 200,
    policy=None,
    device="cuda",
) -> GoldenProblem:
    """Solve `lp` once at reference tolerance on `device` and freeze the
    answer as a golden. The reference must converge AND pass its KKT
    certificates under `policy` (default `ConformancePolicy`) — an
    uncertified reference would turn the canary into an oracle of its own
    bugs."""
    import torch

    from ..obs.conformance import ConformanceChecker, kkt_certificates
    from ..runtime.adaptive import _host

    family = _family_of(lp)
    lp_np = type(lp)(*(_host(a) for a in lp))
    lp_t = type(lp)(*(torch.as_tensor(a, device=device) for a in lp_np))
    if family == "dense":
        from ..solvers.ipm import solve_lp

        sol = solve_lp(lp_t, tol=certify_tol, max_iter=max_iter)
    else:
        from ..solvers.pdhg import solve_lp_pdhg

        sol = solve_lp_pdhg(lp_t, tol=certify_tol, max_iter=max_iter)
    sol = type(sol)(*(_host(a) for a in sol))
    if not bool(np.asarray(sol.converged)):
        raise ValueError(
            f"golden {name!r} did not converge at the reference "
            f"tolerance {certify_tol:g} — not certifiable"
        )
    checker = ConformanceChecker(policy)
    cert = kkt_certificates(lp_np, sol)
    fields = dict(zip(("res_primal", "res_dual", "comp", "gap"),
                      (float(v) for v in cert)))
    if checker.score(fields) != "pass":
        raise ValueError(
            f"golden {name!r} reference fails its KKT certificates "
            f"({fields}) — not certifiable"
        )
    return GoldenProblem(
        name=str(name),
        family=family,
        problem=lp_np,
        x_ref=np.asarray(sol.x),
        obj_ref=float(np.asarray(sol.obj)),
        fingerprint=lp_fingerprint(lp_np),
        tol=float(tol),
    )


def _family_of(lp) -> str:
    for family, cls in FAMILY_TYPES.items():
        if type(lp).__name__ == cls.__name__:
            return family
    raise TypeError(
        f"no canary family for problem type {type(lp).__name__} "
        f"(known: {sorted(FAMILY_TYPES)})"
    )


def save_goldens(path: str, goldens: List[GoldenProblem]) -> str:
    """Write a versioned golden artifact (single ``.npz``): per-golden
    problem fields + reference primal under ``<name>/...`` keys, and a
    ``__manifest__`` JSON binding names to families, tolerances,
    objectives, and content fingerprints."""
    if not goldens:
        raise ValueError("refusing to save an empty golden set")
    names = [g.name for g in goldens]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate golden names: {sorted(names)}")
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"version": ARTIFACT_VERSION, "goldens": []}
    for g in goldens:
        fields_cls = FAMILY_TYPES[g.family]
        for fname, arr in zip(fields_cls._fields, g.problem):
            arrays[f"{g.name}/{fname}"] = np.asarray(arr)
        arrays[f"{g.name}/x_ref"] = np.asarray(g.x_ref)
        manifest["goldens"].append({
            "name": g.name,
            "family": g.family,
            "obj_ref": float(g.obj_ref),
            "fingerprint": g.fingerprint,
            "tol": float(g.tol),
        })
    arrays["__manifest__"] = np.asarray(json.dumps(manifest))
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    return path


def load_goldens(
    path: str, expect_family: Optional[str] = None
) -> List[GoldenProblem]:
    """Load a golden artifact with the refuse-to-load checks of
    `learn.warmstart.WarmStartModel.load`, plus a tamper check: every
    golden's content fingerprint is RECOMPUTED from the loaded arrays
    and must equal the manifest's — a flipped bit in the problem or a
    hand-edited manifest raises instead of becoming ground truth."""
    with np.load(path, allow_pickle=False) as z:
        if "__manifest__" not in z:
            raise CanaryArtifactMismatch(
                f"{path}: not a canary golden artifact (no manifest)"
            )
        manifest = json.loads(str(z["__manifest__"]))
        version = manifest.get("version")
        if version != ARTIFACT_VERSION:
            raise CanaryArtifactMismatch(
                f"{path}: artifact version {version} != supported "
                f"{ARTIFACT_VERSION}"
            )
        out: List[GoldenProblem] = []
        for entry in manifest.get("goldens", []):
            name, family = entry["name"], entry["family"]
            if family not in FAMILY_TYPES:
                raise CanaryArtifactMismatch(
                    f"{path}: golden {name!r} has unknown family "
                    f"{family!r}"
                )
            if expect_family is not None and family != expect_family:
                raise CanaryArtifactMismatch(
                    f"{path}: golden {name!r} is family {family!r}, "
                    f"expected {expect_family!r}"
                )
            fields_cls = FAMILY_TYPES[family]
            missing = [
                f for f in fields_cls._fields if f"{name}/{f}" not in z
            ] + ([] if f"{name}/x_ref" in z else ["x_ref"])
            if missing:
                raise CanaryArtifactMismatch(
                    f"{path}: golden {name!r} missing arrays {missing}"
                )
            lp = fields_cls(*(z[f"{name}/{f}"] for f in fields_cls._fields))
            fp = lp_fingerprint(lp)
            if fp != entry["fingerprint"]:
                raise CanaryArtifactMismatch(
                    f"{path}: golden {name!r} content fingerprint "
                    f"mismatch (artifact tampered or bit-rotted)"
                )
            out.append(GoldenProblem(
                name=name, family=family, problem=lp,
                x_ref=z[f"{name}/x_ref"],
                obj_ref=float(entry["obj_ref"]),
                fingerprint=fp, tol=float(entry.get("tol", 1e-6)),
            ))
    if not out:
        raise CanaryArtifactMismatch(f"{path}: artifact holds no goldens")
    return out


class CanaryScheduler:
    """Inject goldens through a service/fleet on a cadence and score the
    answers. Drive it with `tick(now)` from the owner's pump loop (the
    fleet does this automatically when built with ``canary=``): each
    tick first scores any finished probes, then — when `every_s` has
    elapsed and no round is still in flight — injects the next round.
    `inject()` / `collect()` expose the two halves for synchronous
    callers (bench, the self-check tool)."""

    def __init__(
        self,
        goldens,
        *,
        every_s: float = 60.0,
        priority="batch",
        clock=time.monotonic,
        service=None,
        name: str = "canary",
    ):
        if isinstance(goldens, str):
            goldens = load_goldens(goldens)
        self.goldens: List[GoldenProblem] = list(goldens)
        if not self.goldens:
            raise ValueError("CanaryScheduler needs at least one golden")
        self.every_s = float(every_s)
        self.priority = priority
        self.clock = clock
        self.service = service
        self.name = name
        self.rounds = 0
        self.mismatches = 0
        self._last_inject: Optional[float] = None
        self._pending: List[tuple] = []  # (golden, ticket, round)
        self._last: Dict[str, Dict[str, Any]] = {}  # golden -> last score
        # zero-seed per-golden counters so the rate-kind alert rules see
        # a flat baseline instead of an absent series (the fleet does the
        # same for poisoned_requests_total)
        obs_metrics.inc("canary_rounds_total", 0)
        for g in self.goldens:
            obs_metrics.inc("canary_mismatch_total", 0, golden=g.name)
            obs_metrics.inc(
                "canary_pass_total", 0, golden=g.name, outcome="exact"
            )

    def attach(self, service) -> "CanaryScheduler":
        self.service = service
        return self

    # -- the two halves ------------------------------------------------
    def due(self, now: Optional[float] = None) -> bool:
        if self._pending:
            return False  # one round in flight at a time
        if self._last_inject is None:
            return True
        now = self.clock() if now is None else now
        return now - self._last_inject >= self.every_s

    def inject(self, now: Optional[float] = None) -> int:
        """Submit every golden through the attached service at canary
        priority. The per-round fingerprint defeats the result cache, so
        each probe is a real solve. Returns probes submitted."""
        if self.service is None:
            raise RuntimeError("CanaryScheduler has no attached service")
        now = self.clock() if now is None else now
        rnd = self.rounds
        for g in self.goldens:
            ticket = self.service.submit(
                g.problem,
                priority=self.priority,
                fingerprint=f"__canary__{g.name}#{rnd}",
                request_id=f"{self.name}-{g.name}-{rnd}",
            )
            self._pending.append((g, ticket, rnd))
        self.rounds += 1
        self._last_inject = now
        obs_metrics.inc("canary_rounds_total")
        return len(self.goldens)

    def collect(self) -> List[Dict[str, Any]]:
        """Score every finished probe; unfinished ones stay pending."""
        scored, still = [], []
        for g, ticket, rnd in self._pending:
            if ticket.done():
                scored.append(self._score(g, ticket.result(), rnd))
            else:
                still.append((g, ticket, rnd))
        self._pending = still
        return scored

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One scheduler step: score finished probes, inject when due."""
        scored = self.collect()
        now = self.clock() if now is None else now
        if self.due(now):
            self.inject(now)
        return scored

    # -- scoring -------------------------------------------------------
    def _score(self, g: GoldenProblem, result, rnd: int) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "golden": g.name, "round": rnd, "verdict": result.verdict,
        }
        if result.solution is None:
            rec["outcome"] = "inconclusive"
            obs_metrics.inc("canary_inconclusive_total", golden=g.name)
        else:
            x = np.asarray(result.solution.x)
            obj = float(np.asarray(result.solution.obj))
            rel_x = float(
                np.max(np.abs(x - g.x_ref)) / (1.0 + np.max(np.abs(g.x_ref)))
            ) if x.shape == g.x_ref.shape else float("inf")
            rel_obj = abs(obj - g.obj_ref) / (1.0 + abs(g.obj_ref))
            rec.update(rel_x=rel_x, rel_obj=rel_obj)
            if x.shape == g.x_ref.shape and np.array_equal(x, g.x_ref):
                rec["outcome"] = "exact"
            elif rel_x <= g.tol and rel_obj <= g.tol:
                rec["outcome"] = "tolerance"
            else:
                rec["outcome"] = "mismatch"
            if rec["outcome"] == "mismatch":
                self.mismatches += 1
                obs_metrics.inc("canary_mismatch_total", golden=g.name)
            else:
                obs_metrics.inc(
                    "canary_pass_total", golden=g.name,
                    outcome=rec["outcome"],
                )
        get_tracer().event(
            "canary", scheduler=self.name, **{
                k: v for k, v in rec.items() if v is not None
            },
        )
        self._last[g.name] = rec
        return rec

    # -- reporting -----------------------------------------------------
    def report(self) -> Dict[str, Any]:
        return {
            "scheduler": self.name,
            "every_s": self.every_s,
            "rounds": self.rounds,
            "mismatches": self.mismatches,
            "pending": len(self._pending),
            "goldens": {
                g.name: self._last.get(g.name) for g in self.goldens
            },
        }


def as_canary(arg, *, clock=time.monotonic, service=None,
              every_s: float = 60.0) -> Optional[CanaryScheduler]:
    """Coerce a ``canary=`` argument: a `CanaryScheduler` passes through
    (gaining the service), an artifact path or golden list builds one on
    the owner's clock, None/False stays off."""
    if arg is None or arg is False:
        return None
    if isinstance(arg, CanaryScheduler):
        if service is not None and arg.service is None:
            arg.service = service
        return arg
    if isinstance(arg, str):
        arg = load_goldens(arg)
    return CanaryScheduler(
        arg, every_s=every_s, clock=clock, service=service
    )
