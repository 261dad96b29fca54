"""Learned warm-start subsystem (port of `dispatches_tpu/learn/`): train
primal-dual predictors from journaled solves, serve them through the
safeguarded warm-start path.

- `learn.dataset` — supervised (parameters -> converged iterate) pairs
  from journals, recorder captures, and `DatasetWriter` shard archives,
  keyed by structural `family_fingerprint`.
- `learn.warmstart` — per-family MLP training (reusing the surrogate
  loop) and the versioned, refuse-to-load-on-mismatch ``.npz`` artifact.
- `learn.predictor` — batch-safe online inference feeding the solvers'
  safeguarded ``warm_start=`` plumbing; bad predictions degrade to the
  cold path, never to wrong answers.
- `learn.laneroute` — lane-portfolio model trained on the lane
  observatory's probe-pair shards, predicting ``(best_lane,
  expected_iterations)`` per problem; served as ``lane_policy="model"``
  with fallback to the measured advice scoreboards.
- `learn.screener` — per-family N-1 criticality predictor trained on
  full `secure_dispatch` runs, shrinking the contingency screen; every
  screened solve is verified post-solve against the full set, so a bad
  screen costs a re-solve, never a missed violation.

See docs/learned_warmstarts.md and docs/market.md; the port's CLIs are
tools/torch_train_warmstart.py, tools/torch_train_laneroute.py, and
tools/torch_train_screener.py.
"""
from .dataset import (
    DatasetWriter,
    WarmStartDataset,
    family_fingerprint,
    family_fingerprints,
    features_batch,
    features_of,
    load_dataset,
    targets_of,
)
from .warmstart import (
    ARTIFACT_VERSION,
    ArtifactMismatch,
    WarmStartModel,
    train_warmstart_model,
)
from .predictor import WarmStartPredictor
from .laneroute import (
    LANEROUTE_VERSION,
    LaneRouteModel,
    LaneRouter,
    RoutePrediction,
    as_laneroute,
    train_laneroute_model,
)
from .screener import (
    SCREENER_VERSION,
    ContingencyScreener,
    ScreenerModel,
    as_screener,
    screen_targets,
    train_screener_model,
)

__all__ = [
    "ARTIFACT_VERSION",
    "ArtifactMismatch",
    "ContingencyScreener",
    "DatasetWriter",
    "LANEROUTE_VERSION",
    "LaneRouteModel",
    "LaneRouter",
    "RoutePrediction",
    "SCREENER_VERSION",
    "ScreenerModel",
    "WarmStartDataset",
    "WarmStartModel",
    "WarmStartPredictor",
    "as_laneroute",
    "as_screener",
    "family_fingerprint",
    "family_fingerprints",
    "features_batch",
    "features_of",
    "load_dataset",
    "screen_targets",
    "targets_of",
    "train_laneroute_model",
    "train_screener_model",
    "train_warmstart_model",
]
