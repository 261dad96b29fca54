"""Learned lane-portfolio routing: predict the fastest solver lane (port
of `dispatches_tpu/learn/laneroute.py`).

The lane observatory (`obs/lanes.py`) measures per-family routing
regret with shadow probes and exports labeled probe pairs —
``X = features_of(problem)``, ``Y = [wall_dense, wall_pdhg, iters_dense,
iters_pdhg, chosen]`` — as `learn.dataset`-format shards. This module
closes the loop: train a small portfolio model on those shards that
predicts per-lane wall time and iteration count from the schema-v6
feature vector, and serve it as ``lane_policy="model"``
(`runtime/adaptive.py`, `serve/fleet.py`).

The plumbing deliberately mirrors `learn.warmstart`:

- the training loop is `surrogates.train.train_surrogate` (same MLP,
  same Adam/MSE full-batch loop);
- the artifact is a single ``.npz`` with ``__manifest__`` JSON +
  ``scale/<k>`` + ``w/<path>`` keys, versioned, refusing to load on a
  version/kind/family mismatch (`ArtifactMismatch` — a structurally
  wrong artifact is an operator error, never a silent cold path);
- serving-side inference (`LaneRouter`) never raises and never gates
  correctness: an unseen family or a feature-shape mismatch falls back
  to the observatory's measured ``advice`` scoreboards, counted under
  ``lane_model_fallback_total``. Mispredictions surface through the
  existing shadow-probe machinery as
  ``lane_shadow_probes_total{outcome="regret"}`` — routed solves still
  flow through `LaneObservatory.note_solve`, so the model is audited by
  the same measurement plane that trained it.

The predicted iteration count rides along (``RoutePrediction.iterations``,
journaled on the ``lane_decision`` event) as the batch-packing signal for
ROADMAP item 4.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import WarmStartDataset
from .warmstart import _load_artifact, _predict, _save_artifact

LANEROUTE_VERSION = 1
LANEROUTE_KIND = "laneroute"

# Column order of the lane-observatory probe-pair shards
# (obs.lanes.LaneObservatory.export_dataset); the model trains on the
# first four, "chosen" is the historical route, not ground truth.
PROBE_TARGETS = (
    ("wall_dense", 1), ("wall_pdhg", 1),
    ("iters_dense", 1), ("iters_pdhg", 1), ("chosen", 1),
)
ROUTE_LANES = ("dense", "pdhg")

_SCALE_KEYS = ("xm_inputs", "xstd_inputs", "xmin", "xmax", "y_mean", "y_std")

from ..obs import metrics as obs_metrics

obs_metrics.describe(
    "lane_model_route_total",
    "solves routed by the learned lane-portfolio model, by predicted lane",
)
obs_metrics.describe(
    "lane_model_fallback_total",
    "lane-model consultations that fell back to the observatory's "
    "advice scoreboards (unseen family, feature mismatch, or prediction "
    "error) — the model never gates correctness",
)


class RoutePrediction(Tuple):
    """``(lane, iterations)`` with named access."""

    __slots__ = ()

    def __new__(cls, lane: str, iterations: float):
        return tuple.__new__(cls, (lane, float(iterations)))

    @property
    def lane(self) -> str:
        return self[0]

    @property
    def iterations(self) -> float:
        return self[1]


class LaneRouteModel:
    """A trained per-family lane-portfolio predictor plus its manifest.

    ``manifest`` keys: ``version``, ``kind`` (= "laneroute"),
    ``family``, ``problem_type``, ``varying``, ``targets`` (the
    four-column wall/iters layout), ``feature_dim``, ``target_dim``,
    ``hidden``, ``train_best_lane`` (majority measured winner over the
    training pairs — the family-level advice a fleet router consumes
    when it only knows the family, not the instance), ``lane_share``
    (that winner's share of training rows), and ``metrics``."""

    def __init__(self, surrogate, manifest: Dict):
        self.surrogate = surrogate
        self.manifest = dict(manifest)

    # -- manifest accessors -------------------------------------------
    @property
    def family(self) -> str:
        return self.manifest["family"]

    @property
    def varying(self) -> Tuple[str, ...]:
        return tuple(self.manifest["varying"])

    @property
    def feature_dim(self) -> int:
        return int(self.manifest["feature_dim"])

    @property
    def train_best_lane(self) -> str:
        return str(self.manifest["train_best_lane"])

    # -- inference -----------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """(batch, feature_dim) -> (batch, 4) predicted
        ``[wall_dense, wall_pdhg, iters_dense, iters_pdhg]``."""
        return _predict(self.surrogate, X, self.feature_dim)

    def route(self, X: np.ndarray) -> List[RoutePrediction]:
        """Per-row ``RoutePrediction``: the lane with the smaller
        predicted wall, and that lane's predicted iteration count
        (clamped to >= 1)."""
        pred = self.predict(X)
        out: List[RoutePrediction] = []
        for row in pred:
            k = int(np.argmin(row[:2]))
            out.append(RoutePrediction(
                ROUTE_LANES[k], max(1.0, float(row[2 + k]))
            ))
        return out

    # -- persistence (the warmstart artifact layout) -------------------
    def save(self, path: str) -> str:
        return _save_artifact(self.surrogate, self.manifest, path)

    @classmethod
    def load(cls, path: str, expect_family: Optional[str] = None,
             device="cuda") -> "LaneRouteModel":
        """Reload an artifact onto `device`; raises `ArtifactMismatch` on
        an unknown version, a non-laneroute kind, a family disagreement,
        or missing weights."""
        sur, manifest = _load_artifact(
            path, "lane-route", LANEROUTE_KIND, LANEROUTE_VERSION,
            expect_family, device,
        )
        return cls(sur, manifest)


def _route_accuracy(pred: np.ndarray, truth: np.ndarray) -> float:
    """Share of rows where the predicted-fastest lane matches the
    measured-fastest lane (columns 0/1 = wall_dense/wall_pdhg)."""
    return float(np.mean(
        np.argmin(pred[:, :2], axis=1) == np.argmin(truth[:, :2], axis=1)
    ))


def train_laneroute_model(
    dataset: WarmStartDataset,
    *,
    hidden: Sequence[int] = (32, 32),
    epochs: int = 300,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_frac: float = 0.2,
    verbose: bool = False,
    device="cuda",
) -> Tuple[LaneRouteModel, Dict]:
    """Train one per-family portfolio model from a lane-probe dataset
    (`obs.lanes.export_dataset` shards loaded through
    `learn.dataset.load_dataset`). Trains on the four wall/iters columns;
    metrics report holdout MSE plus ``route_accuracy`` (predicted-fastest
    vs measured-fastest lane). Returns ``(model, metrics)``."""
    from ..surrogates.train import train_surrogate

    want = [[n, d] for n, d in PROBE_TARGETS]
    got = [[str(n), int(d)] for n, d in dataset.targets]
    if got != want:
        raise ValueError(
            f"not a lane-probe dataset: targets {got} != {want}"
        )
    Y4 = np.asarray(dataset.Y, np.float64)[:, :4]
    ds4 = WarmStartDataset(
        dataset.X, Y4, family=dataset.family, varying=dataset.varying,
        targets=list(PROBE_TARGETS[:4]), problem_type=dataset.problem_type,
        iters=dataset.iters, sources=dataset.sources,
        skipped=dataset.skipped,
    )
    train, hold = ds4.split(holdout_frac=holdout_frac, seed=seed)
    sur, train_metrics = train_surrogate(
        train.X, train.Y, hidden=tuple(hidden), epochs=epochs, lr=lr,
        seed=seed, verbose=verbose, device=device,
    )
    feature_dim = int(dataset.X.shape[1])
    metrics: Dict = {
        "rows_train": len(train),
        "rows_holdout": len(hold),
        "train_R2_mean": float(np.mean(np.asarray(train_metrics["R2"]))),
        "train_route_accuracy": _route_accuracy(
            _predict(sur, train.X, feature_dim), train.Y
        ),
    }
    if len(hold):
        pred = _predict(sur, hold.X, feature_dim)
        err = pred - hold.Y
        metrics["holdout_mse"] = float(np.mean(err**2))
        metrics["route_accuracy"] = _route_accuracy(pred, hold.Y)
    wins = np.argmin(Y4[:, :2], axis=1)
    best = int(np.bincount(wins, minlength=2).argmax())
    manifest = {
        "version": LANEROUTE_VERSION,
        "kind": LANEROUTE_KIND,
        "family": dataset.family,
        "problem_type": dataset.problem_type,
        "varying": list(dataset.varying),
        "targets": [[n, d] for n, d in PROBE_TARGETS[:4]],
        "feature_dim": feature_dim,
        "target_dim": 4,
        "hidden": list(int(h) for h in hidden),
        "train_best_lane": ROUTE_LANES[best],
        "lane_share": float(np.mean(wins == best)),
        "metrics": metrics,
    }
    return LaneRouteModel(sur, manifest), metrics


class LaneRouter:
    """Serving-side lane-model registry: family fingerprint ->
    `LaneRouteModel`, with an optional ``fallback`` (family -> lane, the
    lane observatory's ``advice``) consulted when the model has nothing.

    ``route`` and ``advice`` NEVER raise — a broken router must not kill
    the solve it was routing; failures degrade to the fallback (counted
    under ``lane_model_fallback_total``) or to None (native lane).
    Construction from explicit artifact paths, by contrast, raises
    `ArtifactMismatch` loudly: pointing a fleet at a wrong artifact is an
    operator error."""

    def __init__(self, models: Iterable[LaneRouteModel] = (),
                 fallback: Optional[Callable[[str], Optional[str]]] = None):
        self._models: Dict[str, LaneRouteModel] = {}
        for m in models:
            self._models[m.family] = m
        self.fallback = fallback
        # zero-seed so rate alerts see a flat baseline, not an absent
        # series (the lane-observatory counter idiom)
        for lane in ROUTE_LANES:
            obs_metrics.inc("lane_model_route_total", 0, lane=lane)
        for reason in ("unseen_family", "feature_mismatch", "error"):
            obs_metrics.inc("lane_model_fallback_total", 0, reason=reason)

    @classmethod
    def from_paths(cls, paths, fallback=None, device="cuda") -> "LaneRouter":
        if isinstance(paths, (str, bytes)):
            paths = [paths]
        return cls(
            (LaneRouteModel.load(str(p), device=device) for p in paths),
            fallback=fallback,
        )

    @property
    def families(self) -> Tuple[str, ...]:
        return tuple(self._models)

    def model_for(self, family: str) -> Optional[LaneRouteModel]:
        return self._models.get(family)

    def route(self, problem) -> Optional[RoutePrediction]:
        """Per-instance prediction for a problem row, or None when the
        caller should use its fallback/native path."""
        try:
            from .dataset import family_fingerprint, features_of

            family = family_fingerprint(problem)
            model = self._models.get(family)
            if model is None:
                obs_metrics.inc(
                    "lane_model_fallback_total", reason="unseen_family"
                )
                return None
            feats = features_of(problem, varying=model.varying)
            if feats.size != model.feature_dim:
                obs_metrics.inc(
                    "lane_model_fallback_total", reason="feature_mismatch"
                )
                return None
            pred = model.route(feats[None])[0]
            obs_metrics.inc("lane_model_route_total", lane=pred.lane)
            return pred
        except Exception:
            obs_metrics.inc("lane_model_fallback_total", reason="error")
            return None

    def advice(self, family: Optional[str]) -> Optional[str]:
        """Family-level advised lane for fleet routing (the
        ``Router.advice_fn`` shape): the model's majority measured winner
        when the family is known, else the fallback scoreboard."""
        try:
            if family is not None:
                model = self._models.get(family)
                if model is not None:
                    lane = model.train_best_lane
                    obs_metrics.inc("lane_model_route_total", lane=lane)
                    return lane
                obs_metrics.inc(
                    "lane_model_fallback_total", reason="unseen_family"
                )
            if self.fallback is not None:
                return self.fallback(family)
            return None
        except Exception:
            obs_metrics.inc("lane_model_fallback_total", reason="error")
            return None


def as_laneroute(arg, fallback=None, device="cuda") -> Optional[LaneRouter]:
    """Coerce a ``lane_model=`` argument: None passes through, a
    `LaneRouter` is returned as-is (its fallback updated if unset), a
    path or sequence of paths loads artifacts (raising `ArtifactMismatch`
    on structurally wrong ones)."""
    if arg is None:
        return None
    if isinstance(arg, LaneRouter):
        if arg.fallback is None and fallback is not None:
            arg.fallback = fallback
        return arg
    return LaneRouter.from_paths(arg, fallback=fallback, device=device)
