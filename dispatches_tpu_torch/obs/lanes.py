"""Lane observatory: routing decision records + shadow-lane regret probes
(port of `dispatches_tpu/obs/lanes.py`).

ROADMAP item 2 wants PDHG to become the *chosen* lane on merit, with
mispredicted routes surfacing as a gated counter instead of a latency
regression. That needs two things nothing measured before this module:

1. **Decision records** — every adaptive/serve solve journals a
   schema-v6 ``lane_decision`` event (chosen lane, `learn.dataset`
   family fingerprint, feature-vector digest, wall, iterations,
   verdict) and bumps ``lane_decisions_total{entry,lane}``. This is the
   labeled-routing substrate the item-2 learned router trains against.
2. **Shadow-lane probes** — a sampled fraction of completed solves is
   re-solved on the *alternate* lane (dense IPM <-> first-order PDHG,
   reusing `runtime.remedy`'s lane-switch program mapping
   ``dense_to_sparse`` / ``sparse_to_dense`` and its row-shape maps) so
   the counterfactual cost of the route actually taken is measured, not
   guessed. Both lanes are re-solved host-side under the same clock —
   the primary path's wall is batch-amortized and not comparable to a
   single-row re-solve — and per-probe regret ``chosen_wall −
   best_wall`` lands in ``lane_regret_seconds{family}`` histograms with
   outcomes in ``lane_shadow_probes_total{family,outcome}``. A probe
   whose lanes disagree in optimum (objective divergence, or the faster
   lane failing its KKT certificates from `obs.conformance`) scores
   ``mismatch``/``alt_failed`` instead of feeding the scoreboard:
   a lane that gets a different answer didn't win anything.

Per-(family, lane) online scoreboards (win counts, wall/iteration
rings) publish ``lane_win_ratio{family,lane}`` gauges and a
hysteresis-damped ``route_advice{family}`` gauge — flip only after
``min_probes`` scored probes, a ``flip_margin`` win-ratio edge, held
for ``hold`` consecutive probes — which `serve.router.Router` and the
adaptive entries consume behind the opt-in ``lane_policy="advice"``
knob.

Design rules, shared with every other plane in `obs`: **off by
default**, and **bitwise-neutral when on** — the observatory only ever
*reads* primary solutions; probes are independent host-side re-solves
at batch priority (budgeted per `tick`, never on the request path) whose
journal fingerprints are cache-defeating (``__laneprobe__…#n``), so
primary results are bitwise identical with the plane off, on, and
probing.

On the card a probe times the device, not the launches: each timed
re-solve starts after `torch.cuda.synchronize()` and ends after it (the
port's solvers return before their last kernels finish), so regret
compares two device walls measured identically. The problems and
solutions are torch tensors; the observatory reads them to the host only
for features, fingerprints, and the scalars it scores.

Probe pairs (features, per-lane walls/iterations, chosen lane) are
retained and exported by `export_dataset` in the `learn.dataset` shard
format — `learn.dataset.load_dataset` ingests them directly, which is
how the item-2 portfolio model gets its training set
(`tools/lane_report.py --export-dataset`).
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, fields as _dc_fields
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import metrics as obs_metrics
from .journal import get_tracer

# The routing lanes (solver families). "banded" has no paired lane —
# remedy's lane-switch rung refuses it too — so it gets decision records
# but never probes.
LANES = ("dense", "banded", "pdhg")
ALTERNATE = {"dense": "pdhg", "pdhg": "dense"}
# Numeric codes for the route_advice gauge (gauges carry floats).
LANE_CODES = {"dense": 0.0, "pdhg": 1.0, "banded": 2.0}
PROBE_OUTCOMES = ("chosen_best", "regret", "alt_failed", "mismatch", "error")

# Regret histogram buckets: sub-millisecond dispatch jitter up to
# year-scale solves.
REGRET_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)

obs_metrics.describe(
    "lane_decisions_total",
    "routed solves by entry point and chosen solver lane",
)
obs_metrics.describe(
    "lane_shadow_probes_total",
    "shadow-lane re-solves by family and outcome (regret = the "
    "alternate lane was measurably faster: a mispredicted route)",
)
obs_metrics.describe(
    "lane_regret_seconds",
    "per-probe routing regret chosen_wall - best_wall (0 when the "
    "chosen lane won its probe)",
)
obs_metrics.describe(
    "lane_win_ratio",
    "per-(family, lane) shadow-probe win ratio",
)
obs_metrics.describe(
    "route_advice",
    "hysteresis-damped advised lane per family "
    "(0=dense, 1=pdhg, 2=banded)",
)
obs_metrics.describe(
    "lane_probe_wall_seconds_total",
    "host wall seconds spent inside shadow-lane probe re-solves "
    "(the observatory's cost; bench gates it as a fraction of "
    "primary solve wall)",
)


@dataclass
class LaneConfig:
    """Knobs for the observatory. Defaults are the cheap-continuous
    setting: probe 5% of eligible solves, at most one probe per tick."""

    probe_fraction: float = 0.05   # of eligible (unbatched, paired-lane) solves
    max_pending: int = 64          # probe queue bound (oldest dropped)
    max_probes_per_tick: int = 1   # batch-priority budget per pump tick
    min_probes: int = 5            # scored probes before advice exists
    flip_margin: float = 0.10      # challenger win-ratio edge to flip
    hold: int = 2                  # consecutive probes the edge must hold
    ring_cap: int = 256            # wall/iteration quantile window
    regret_rel_margin: float = 0.20  # alt must win by >20% of chosen wall
    regret_min_seconds: float = 1e-4  # ... and by an absolute floor
    mismatch_rel_tol: float = 1e-4   # relative objective agreement
    warm_probes: bool = True       # untimed warm-up solve per (lane, shape)
    feature_preview: int = 8       # journaled feature-vector head
    export_cap: int = 1024         # retained probe pairs per family
    seed: int = 0                  # probe-sampling RNG seed

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "LaneConfig":
        known = {f.name for f in _dc_fields(cls)}
        unknown = set(m) - known
        if unknown:
            raise ValueError(f"unknown LaneConfig fields {sorted(unknown)}")
        return cls(**{k: m[k] for k in m})

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in _dc_fields(self)}


def lane_of(problem) -> Optional[str]:
    """Solver lane implied by a problem's type (None when the type has
    no lane — the plane must never raise on an exotic problem)."""
    return {"LPData": "dense", "BandedLP": "banded", "SparseLP": "pdhg"}.get(
        type(problem).__name__
    )


def _ndim(a) -> int:
    return a.dim() if isinstance(a, torch.Tensor) else np.asarray(a).ndim


def _is_row(problem, lane: str) -> bool:
    """True when `problem` is a single unbatched instance (the only
    shape the prober re-solves)."""
    try:
        if lane == "dense":
            return _ndim(problem.A) == 2
        if lane == "pdhg":
            return _ndim(problem.b) == 1
    except Exception:
        return False
    return False


def _sync(problem) -> None:
    """Wait for the card when the problem lives there (a no-op on the
    CPU), so a wall read after it covers the device work."""
    dev = getattr(problem.b, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _LaneStats:
    """Per-(family, lane) online tallies: probe wins + bounded rings of
    measured walls/iterations for the quantile columns."""

    __slots__ = ("wins", "probes", "walls", "iters")

    def __init__(self, ring_cap: int):
        self.wins = 0
        self.probes = 0
        self.walls: deque = deque(maxlen=ring_cap)
        self.iters: deque = deque(maxlen=ring_cap)

    @property
    def ratio(self) -> float:
        return self.wins / self.probes if self.probes else 0.0

    def quantile(self, ring: deque, q: float) -> Optional[float]:
        if not ring:
            return None
        return float(np.quantile(np.asarray(ring, np.float64), q))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "probes": self.probes,
            "wins": self.wins,
            "win_ratio": self.ratio,
            "wall_p50": self.quantile(self.walls, 0.5),
            "wall_p95": self.quantile(self.walls, 0.95),
            "iters_p50": self.quantile(self.iters, 0.5),
            "iters_p95": self.quantile(self.iters, 0.95),
        }


class _Pending:
    __slots__ = ("problem", "lane", "family", "entry", "features",
                 "fingerprint", "problem_type")

    def __init__(self, problem, lane, family, entry, features,
                 fingerprint, problem_type):
        self.problem = problem
        self.lane = lane
        self.family = family
        self.entry = entry
        self.features = features
        self.fingerprint = fingerprint
        self.problem_type = problem_type


class LaneObservatory:
    """The object the ``lanes=`` hooks accept (coerce with `as_lanes`).

    Host-side state only: scoreboards, the pending-probe queue, and
    retained probe pairs, all lock-guarded. The observatory never holds
    device references beyond the problem rows queued for probing, and
    never mutates anything it is shown."""

    def __init__(
        self,
        config: Optional[LaneConfig] = None,
        *,
        clock=time.monotonic,
        conformance=None,
        solver_kw: Optional[Mapping[str, Any]] = None,
    ):
        self.config = config or LaneConfig()
        self.clock = clock
        self.solver_kw = dict(solver_kw or {})
        from .conformance import as_conformance

        # the probe cross-checker: certifies the faster lane's answer
        # before it is allowed to score a win (default policy unless the
        # caller shares the serving checker)
        self.checker = as_conformance(
            conformance if conformance is not None else True
        )
        self._lock = threading.Lock()
        self._rng = random.Random(self.config.seed)
        self._pending: deque = deque(maxlen=self.config.max_pending)
        self._board: Dict[str, Dict[str, _LaneStats]] = {}
        self._ptype: Dict[str, str] = {}
        self._advice: Dict[str, str] = {}
        self._streak: Dict[str, Tuple[str, int]] = {}
        self._pairs: Dict[str, List[Tuple[np.ndarray, float, float,
                                          float, float, float]]] = {}
        self._decisions = 0
        self._probes_run = 0
        self._probe_wall = 0.0
        self._probe_seq = 0
        self._outcomes: Dict[str, int] = {}
        self._forced: Dict[str, str] = {}
        self._warm_keys: set = set()
        # zero-seed the probe counters so rate alerts see a flat
        # baseline, not an absent series (conformance/canary idiom)
        for outcome in PROBE_OUTCOMES:
            obs_metrics.inc("lane_shadow_probes_total", 0, outcome=outcome)

    # -- decision records ----------------------------------------------
    def seed_metrics(self, entry: str, lane: str) -> None:
        """Zero-seed the decision counter for a wired entry point."""
        obs_metrics.inc("lane_decisions_total", 0, entry=entry, lane=lane)

    def note_solve(
        self,
        problem,
        lane: Optional[str] = None,
        *,
        entry: str,
        wall: Optional[float] = None,
        iterations: Optional[int] = None,
        verdict: str = "healthy",
        journal: bool = True,
        predicted_iterations: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Record one completed solve's routing decision. Observational
        only — reads the problem, journals a schema-v6 ``lane_decision``
        event, bumps counters, and maybe enqueues a shadow probe. Never
        raises (a broken observatory must not kill the solve it
        observed). ``predicted_iterations`` is the lane-portfolio
        model's expected iteration count when ``lane_policy="model"``
        routed this solve (the item-4 batch-packing signal) — journaled
        alongside the measured count so mispredictions are auditable.
        Returns the journaled attrs dict, or None when the problem has
        no lane."""
        try:
            return self._note_solve(
                problem, lane, entry=entry, wall=wall,
                iterations=iterations, verdict=verdict, journal=journal,
                predicted_iterations=predicted_iterations,
            )
        except Exception:
            return None

    def _note_solve(self, problem, lane, *, entry, wall, iterations,
                    verdict, journal,
                    predicted_iterations=None) -> Optional[Dict[str, Any]]:
        from ..learn.dataset import family_fingerprint, features_of

        lane = lane or lane_of(problem)
        if lane is None:
            return None
        obs_metrics.inc("lane_decisions_total", entry=entry, lane=lane)
        try:
            family = family_fingerprint(problem)
            feats = features_of(problem)
        except Exception:
            family, feats = None, None
        attrs: Dict[str, Any] = {"entry": entry, "lane": lane,
                                 "verdict": verdict}
        if family is not None:
            attrs["family"] = family
        if feats is not None and feats.size:
            k = self.config.feature_preview
            attrs["feature_dim"] = int(feats.size)
            attrs["feature_preview"] = [float(v) for v in feats[:k]]
            attrs["feature_norm"] = float(np.linalg.norm(feats))
        if wall is not None:
            attrs["wall_s"] = float(wall)
        if iterations is not None:
            attrs["iterations"] = int(iterations)
        if predicted_iterations is not None:
            attrs["predicted_iterations"] = float(predicted_iterations)
        if journal:
            get_tracer().event("lane_decision", **attrs)
        with self._lock:
            self._decisions += 1
            sample = self._rng.random() < self.config.probe_fraction
        if (
            sample
            and family is not None
            and lane in ALTERNATE
            and _is_row(problem, lane)
            and verdict in ("healthy", "slow")
        ):
            self._enqueue_probe(problem, lane, family, entry, feats)
        return attrs

    def _enqueue_probe(self, problem, lane, family, entry, feats) -> None:
        with self._lock:
            self._probe_seq += 1
            fp = f"__laneprobe__{family[:8]}#{self._probe_seq}"
            self._pending.append(_Pending(
                problem, lane, family, entry, feats, fp,
                type(problem).__name__,
            ))

    # -- probing -------------------------------------------------------
    def due(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Run up to ``max_probes_per_tick`` queued probes. The serving
        pumps call this once per cycle, after primary dispatch — batch
        priority by construction: a probe only ever spends host time the
        request path has already given up."""
        return self.run_probes(limit=self.config.max_probes_per_tick)

    def run_probes(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Drain queued probes (all of them when `limit` is None) and
        return their scored records. Tests and `tools/lane_report.py`
        call this directly; services go through `tick`."""
        out: List[Dict[str, Any]] = []
        while limit is None or len(out) < limit:
            with self._lock:
                if not self._pending:
                    break
                p = self._pending.popleft()
            out.append(self._run_probe(p))
        return out

    def _maybe_warm(self, lane: str, problem, solve) -> None:
        """One untimed solve per (lane, shape/dtype signature) so the
        first timed probe of a family doesn't charge XLA compile time to
        the lane that happened to compile — regret must compare steady
        states, and the fingerprint-affinity serving tier runs warm."""
        if not self.config.warm_probes:
            return
        key = (lane,) + tuple(
            (np.shape(f), str(getattr(f, "dtype", type(f)))) for f in problem
        )
        with self._lock:
            if key in self._warm_keys:
                return
            self._warm_keys.add(key)
        solve(problem)
        _sync(problem)

    def _timed(self, lane, problem, fn):
        self._maybe_warm(lane, problem, fn)
        _sync(problem)
        t0 = self.clock()
        sol = fn(problem)
        _sync(problem)  # the device's work, not the launches
        return sol, self.clock() - t0

    def _solve_dense(self, lp):
        from ..solvers.ipm import solve_lp

        tol = float(self.solver_kw.get("tol") or 1e-8)
        return self._timed("dense", lp, lambda p: solve_lp(p, tol=tol))

    def _solve_pdhg(self, slp):
        from ..solvers.pdhg import solve_lp_pdhg

        tol = max(float(self.solver_kw.get("tol") or 1e-6), 1e-6)
        return self._timed("pdhg", slp, lambda p: solve_lp_pdhg(p, tol=tol))

    def _certify(self, problem, sol) -> bool:
        """True when `sol` passes the KKT certificate policy for
        `problem` (native form). Certification failures count as not
        passing — a lane can't win a probe with an unverifiable answer."""
        if self.checker is None:
            return True
        try:
            from .conformance import FIELDS, kkt_certificates

            cert = kkt_certificates(problem, sol)
            fields = {n: float(v) for n, v in zip(FIELDS, cert)}
            return self.checker.score(fields) == "pass"
        except Exception:
            return False

    def _run_probe(self, p: _Pending) -> Dict[str, Any]:
        """Re-solve one sampled problem on BOTH lanes under the same
        host clock and score the route that was taken. The primary
        solve's wall is batch-amortized (and possibly warm-started), so
        fairness demands the chosen lane be re-measured cold alongside
        its alternate — regret is the difference of two walls measured
        identically."""
        from ..runtime.remedy import dense_to_sparse, sparse_to_dense

        alt = ALTERNATE[p.lane]
        rec: Dict[str, Any] = {
            "family": p.family, "entry": p.entry, "lane": p.lane,
            "alt_lane": alt, "fingerprint": p.fingerprint,
        }
        t_probe = self.clock()
        try:
            # a numpy row (a fleet parent's) re-solves on the CPU; a tensor
            # row on its own device
            problem = type(p.problem)(*(torch.as_tensor(a) for a in p.problem))
            if p.lane == "dense":
                lp, slp = problem, dense_to_sparse(problem)
            else:
                lp, slp = sparse_to_dense(problem), problem
            isol, wall_dense = self._solve_dense(lp)
            psol, wall_pdhg = self._solve_pdhg(slp)
            walls = {"dense": wall_dense, "pdhg": wall_pdhg}
            iters = {"dense": int(isol.iterations), "pdhg": int(psol.iterations)}
            objs = {"dense": float(isol.obj), "pdhg": float(psol.obj)}
            conv = {"dense": bool(isol.converged), "pdhg": bool(psol.converged)}
            sols = {"dense": (lp, isol), "pdhg": (slp, psol)}
            rec.update(
                wall_chosen=walls[p.lane], wall_alt=walls[alt],
                iters_chosen=iters[p.lane], iters_alt=iters[alt],
                obj_chosen=objs[p.lane], obj_alt=objs[alt],
            )
            outcome, regret = self._score(
                p, alt, walls, objs, conv, sols
            )
        except Exception as e:
            outcome, regret = "error", None
            rec["error"] = f"{type(e).__name__}: {e}"
            walls = iters = None
        probe_wall = self.clock() - t_probe
        rec["outcome"] = outcome
        if regret is not None:
            rec["regret_s"] = regret
        fam8 = p.family[:8]
        obs_metrics.inc(
            "lane_shadow_probes_total", family=fam8, outcome=outcome
        )
        obs_metrics.inc("lane_probe_wall_seconds_total", probe_wall)
        if regret is not None:
            obs_metrics.observe(
                "lane_regret_seconds", regret,
                buckets=REGRET_BUCKETS, family=fam8,
            )
        with self._lock:
            self._probes_run += 1
            self._probe_wall += probe_wall
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        if outcome in ("chosen_best", "regret", "alt_failed"):
            self._update_board(p, walls, iters, outcome)
        if outcome in ("chosen_best", "regret"):
            self._retain_pair(p, walls, iters)
        get_tracer().event("lane_probe", **rec)
        return rec

    def _score(self, p, alt, walls, objs, conv, sols):
        """Outcome + regret for one probe. Precedence: an alternate that
        fails (divergence or certificates) can't generate regret; lanes
        that disagree in optimum are a mismatch, not a win."""
        cfg = self.config
        if not conv[alt] or not self._certify(*sols[alt]):
            return "alt_failed", None
        denom = max(abs(objs[p.lane]), abs(objs[alt]), 1.0)
        if abs(objs[p.lane] - objs[alt]) / denom > cfg.mismatch_rel_tol:
            return "mismatch", None
        regret = max(0.0, walls[p.lane] - walls[alt])
        if (
            walls[alt] < walls[p.lane] * (1.0 - cfg.regret_rel_margin)
            and regret > cfg.regret_min_seconds
        ):
            return "regret", regret
        return "chosen_best", regret

    # -- scoreboards + advice ------------------------------------------
    def _update_board(self, p, walls, iters, outcome) -> None:
        fam8 = p.family[:8]
        with self._lock:
            board = self._board.setdefault(p.family, {})
            self._ptype.setdefault(p.family, p.problem_type)
            for lane in ("dense", "pdhg"):
                ls = board.setdefault(lane, _LaneStats(self.config.ring_cap))
                ls.probes += 1
                if walls is not None and outcome != "alt_failed":
                    ls.walls.append(walls[lane])
                    ls.iters.append(iters[lane])
            if outcome == "alt_failed":
                winner = p.lane
            else:
                winner = min(walls, key=walls.get)
            board[winner].wins += 1
            for lane, ls in board.items():
                obs_metrics.set_gauge(
                    "lane_win_ratio", ls.ratio, family=fam8, lane=lane
                )
            self._eval_advice_locked(p.family)

    def _eval_advice_locked(self, family: str) -> None:
        forced = self._forced.get(family)
        board = self._board.get(family, {})
        if not board:
            return
        nprobes = max(ls.probes for ls in board.values())
        if forced is not None:
            self._set_advice_locked(family, forced)
            return
        if nprobes < self.config.min_probes:
            return
        best = max(board, key=lambda l: board[l].ratio)
        cur = self._advice.get(family)
        if cur is None:
            self._set_advice_locked(family, best)
            return
        if (
            best == cur
            or board[best].ratio < board[cur].ratio + self.config.flip_margin
        ):
            self._streak.pop(family, None)
            return
        cand, n = self._streak.get(family, (best, 0))
        n = n + 1 if cand == best else 1
        if n >= self.config.hold:
            self._streak.pop(family, None)
            self._set_advice_locked(family, best)
        else:
            self._streak[family] = (best, n)

    def _set_advice_locked(self, family: str, lane: str) -> None:
        prev = self._advice.get(family)
        self._advice[family] = lane
        obs_metrics.set_gauge(
            "route_advice", LANE_CODES[lane], family=family[:8]
        )
        if prev is not None and prev != lane:
            get_tracer().event(
                "lane_advice_flip", family=family, previous=prev, lane=lane,
            )

    def force_advice(self, family: str, lane: Optional[str]) -> None:
        """Pin (or with None, unpin) the advised lane for a family —
        the `--self-check` harness uses this to install a deliberately
        wrong route and prove measured regret overturns it."""
        with self._lock:
            if lane is None:
                self._forced.pop(family, None)
            else:
                if lane not in LANES:
                    raise ValueError(f"unknown lane {lane!r}")
                self._forced[family] = lane
                self._set_advice_locked(family, lane)

    def advice(self, family: Optional[str]) -> Optional[str]:
        """The advised lane for a family fingerprint (None = no advice
        yet: not enough scored probes)."""
        if family is None:
            return None
        with self._lock:
            return self._advice.get(family)

    def advice_for(self, problem) -> Optional[str]:
        """`advice` keyed by a problem instance (computes its family)."""
        try:
            from ..learn.dataset import family_fingerprint

            return self.advice(family_fingerprint(problem))
        except Exception:
            return None

    # -- dataset export -------------------------------------------------
    def _retain_pair(self, p, walls, iters) -> None:
        if p.features is None or not p.features.size:
            return
        row = (
            np.asarray(p.features, np.float64),
            float(walls["dense"]), float(walls["pdhg"]),
            float(iters["dense"]), float(iters["pdhg"]),
            LANE_CODES[p.lane],
        )
        with self._lock:
            pairs = self._pairs.setdefault(p.family, [])
            pairs.append(row)
            if len(pairs) > self.config.export_cap:
                del pairs[0]

    def export_dataset(self, directory: str,
                       family: Optional[str] = None) -> List[str]:
        """Write retained probe pairs as `learn.dataset`-format shards
        (one per family; `learn.dataset.load_dataset` ingests them).
        X = the solve's feature vector (`features_of` schema); Y =
        ``[wall_dense, wall_pdhg, iters_dense, iters_pdhg, chosen]`` —
        exactly the per-lane outcome labels the item-2 portfolio model
        trains on. Returns the written shard paths."""
        from ..learn.dataset import DEFAULT_VARYING

        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        targets = [["wall_dense", 1], ["wall_pdhg", 1],
                   ["iters_dense", 1], ["iters_pdhg", 1], ["chosen", 1]]
        with self._lock:
            items = [
                (fam, list(rows)) for fam, rows in self._pairs.items()
                if rows and (family is None or fam == family)
            ]
            ptypes = dict(self._ptype)
        paths: List[str] = []
        for fam, rows in items:
            dim = rows[0][0].size
            usable = [r for r in rows if r[0].size == dim]
            X = np.stack([r[0] for r in usable])
            Y = np.asarray([r[1:] for r in usable], np.float64)
            seq = 1 + max(
                (int(n.split("-")[1].split(".")[0])
                 for n in os.listdir(directory)
                 if n.startswith("shard-") and n.endswith(".npz")),
                default=0,
            )
            final = os.path.join(directory, f"shard-{seq:06d}.npz")
            tmp = f"{final}.{os.getpid()}.tmp"
            meta = {
                "kind": "lane_probe_dataset_shard",
                "version": 1,
                "family": fam,
                "problem_type": ptypes.get(fam, "LPData"),
                "varying": list(DEFAULT_VARYING),
                "targets": targets,
            }
            np.savez(
                tmp, X=X, Y=Y,
                iters=np.full((X.shape[0],), np.nan),
                __meta__=np.asarray(json.dumps(meta)),
            )
            tmp_written = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(tmp_written, final)
            try:
                get_tracer().event(
                    "dataset_shard", path=final, family=fam,
                    rows=int(X.shape[0]), kind="lane_probe",
                )
            except Exception:
                pass
            paths.append(final)
        return paths

    # -- reporting ------------------------------------------------------
    def scoreboard(self) -> Dict[str, Any]:
        """Per-family ledger: per-lane tallies + current advice."""
        with self._lock:
            return {
                fam: {
                    "lanes": {l: ls.to_dict() for l, ls in board.items()},
                    "advice": self._advice.get(fam),
                    "forced": self._forced.get(fam),
                    "problem_type": self._ptype.get(fam),
                    "pairs_retained": len(self._pairs.get(fam, ())),
                }
                for fam, board in self._board.items()
            }

    def report(self) -> Dict[str, Any]:
        """The exporter's ``/lanes`` payload."""
        with self._lock:
            base = {
                "config": self.config.to_dict(),
                "decisions": self._decisions,
                "probes_run": self._probes_run,
                "probe_wall_seconds": self._probe_wall,
                "pending_probes": len(self._pending),
                "outcomes": dict(self._outcomes),
            }
        base["scoreboard"] = self.scoreboard()
        return base


def as_lanes(arg, *, clock=time.monotonic, conformance=None,
             solver_kw=None) -> Optional[LaneObservatory]:
    """Coerce a ``lanes=`` argument: True → default observatory, a
    `LaneConfig`/mapping → configured observatory, an existing
    observatory passes through, None/False → None (the plane stays
    off)."""
    if arg is None or arg is False:
        return None
    if isinstance(arg, LaneObservatory):
        return arg
    if arg is True:
        cfg = None
    elif isinstance(arg, LaneConfig):
        cfg = arg
    elif isinstance(arg, Mapping):
        cfg = LaneConfig.from_mapping(arg)
    else:
        raise TypeError(f"cannot coerce {type(arg).__name__} to lanes=")
    return LaneObservatory(
        cfg, clock=clock, conformance=conformance, solver_kw=solver_kw
    )


def default_lane_rules(*, window: float = 60.0) -> List[Any]:
    """The alert pack services append when the lane observatory is
    active. `lane_shadow_probes_total{outcome="regret"}` is zero-seeded
    at observatory construction, so the rate rule sees a flat baseline
    until a genuinely mispredicted route is measured."""
    from .alerts import AlertRule

    return [
        AlertRule(
            name="lane_regret_burn", series="lane_shadow_probes_total",
            kind="rate", labels={"outcome": "regret"},
            op=">", bound=0.0, window=window, for_=0.0,
            severity="warn",
            description="shadow probes are finding the alternate solver "
            "lane measurably faster than the routed one (mispredicted "
            "routes: revisit route_advice / the routing policy)",
        ),
    ]
