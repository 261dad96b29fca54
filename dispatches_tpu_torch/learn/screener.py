"""Learned N-1 constraint screening for security-constrained dispatch
(port of `dispatches_tpu/learn/screener.py`).

*Machine Learning for Electricity Market Clearing* (PAPERS.md) observes
that the binding-constraint set of a security-constrained economic
dispatch is highly predictable from the operating point. This module
applies that observation to `market.contingency.secure_dispatch`: a
per-family model maps the base-case SCED parameter vector
(``features_of(lp, varying=("b",))`` — load, renewable caps, and commit
status all enter the lowered program on the b side) to a per-outage
criticality score over the branch contingencies of a `ContingencySet`,
so the constraint-generation loop evaluates a *shrunk* outage set first.

The plumbing deliberately mirrors `learn.laneroute` / `learn.warmstart`:

- training pairs are `learn.dataset` shards — features are the base-case
  LP's b-vector, targets are the 0/1 critical-outage indicator observed
  by a *full* (unscreened) `secure_dispatch` run
  (``SecureDispatch.violated_outages`` -> :func:`screen_targets`);
- the artifact is a single ``.npz`` with ``__manifest__`` JSON +
  ``scale/<k>`` + ``w/<path>`` keys, versioned, refusing to load on a
  version/kind/family mismatch (`ArtifactMismatch` — a structurally
  wrong artifact is an operator error, never a silent cold path);
- serving-side inference (`ContingencyScreener.screen`) never raises and
  never gates correctness: an unseen family or a shape mismatch returns
  None (full evaluation, counted under ``screener_fallback_total``), and
  even an *accepted* screen is verified post-solve against the full
  contingency set inside `secure_dispatch` — any escaped violation
  triggers ``note_violation_fallback`` and a full re-solve. The model
  can only ever cost a wasted screened solve, never a missed violation.

Screening is biased toward recall: the default decision threshold is
deliberately low (a missed critical outage costs a full re-solve; a
spurious one costs a single extra LODF row in the screen), and training
metrics report ``recall`` / ``shrink`` so operators can see the trade.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .dataset import WarmStartDataset
from .warmstart import _load_artifact, _predict, _save_artifact

SCREENER_VERSION = 1
SCREENER_KIND = "ctg_screener"

# All dcopf_program parameters (load / ren_cap / commit) lower onto the
# constraint right-hand side, so the family feature vector is b-only.
SCREEN_VARYING = ("b",)

# Serve-side decision threshold on the predicted criticality score.
# Indicators are 0/1; biased low for recall (see module docstring).
DEFAULT_THRESHOLD = 0.3

_SCALE_KEYS = ("xm_inputs", "xstd_inputs", "xmin", "xmax", "y_mean", "y_std")

from ..obs import metrics as obs_metrics

obs_metrics.describe(
    "screener_accept_total",
    "screened secure-dispatch solves whose full-set verification came "
    "back clean (the screen saved work and escaped nothing)",
)
obs_metrics.describe(
    "screener_violation_fallback_total",
    "post-solve full-set violations found after a screened solve — each "
    "one forced a fall back to full evaluation; the safeguard that keeps "
    "the screener from ever gating correctness",
)
obs_metrics.describe(
    "screener_fallback_total",
    "screen consultations that returned no mask (unseen family, shape "
    "mismatch, or prediction error) — the dispatch ran unscreened",
)
obs_metrics.describe(
    "screener_screen_total",
    "screen consultations that produced a criticality mask",
)


def screen_targets(cset, violated_outages: Iterable[int]) -> np.ndarray:
    """0/1 criticality indicator over the *branch* contingencies of
    `cset`, in cset order — the training target for one operating point.
    ``violated_outages`` is `SecureDispatch.violated_outages` from a full
    (unscreened) run: the branch indices whose post-contingency flows
    violated a limit at any round."""
    hot = set(int(v) for v in violated_outages)
    return np.asarray(
        [1.0 if c.index in hot else 0.0
         for c in cset if c.kind == "branch"],
        np.float64,
    )


class ScreenerModel:
    """A trained per-family criticality predictor plus its manifest.

    ``manifest`` keys: ``version``, ``kind`` (= "ctg_screener"),
    ``family``, ``problem_type``, ``varying``, ``feature_dim``,
    ``target_dim`` (the branch-contingency count the indicator was
    trained over — serve-side masks are only valid for a
    `ContingencySet` with the same branch count), ``hidden``,
    ``threshold`` (the recall-biased serve default), ``train_critical_share``
    (share of training indicator bits set), and ``metrics``."""

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
    def target_dim(self) -> int:
        return int(self.manifest["target_dim"])

    @property
    def threshold(self) -> float:
        return float(self.manifest.get("threshold", DEFAULT_THRESHOLD))

    # -- inference -----------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """(batch, feature_dim) -> (batch, target_dim) criticality
        scores (trained on 0/1 indicators; not calibrated
        probabilities)."""
        return _predict(self.surrogate, X, self.feature_dim)

    def critical_mask(
        self, X: np.ndarray, threshold: Optional[float] = None
    ) -> np.ndarray:
        """(batch, feature_dim) -> (batch, target_dim) bool mask of
        outages to evaluate (True = predicted critical)."""
        thr = self.threshold if threshold is None else float(threshold)
        return self.predict(X) >= thr

    # -- persistence (the warmstart artifact layout) -------------------
    def save(self, path: str) -> str:
        return _save_artifact(self.surrogate, self.manifest, path)

    @classmethod
    def load(cls, path: str, expect_family: Optional[str] = None,
             device="cuda") -> "ScreenerModel":
        """Reload an artifact onto `device`; raises `ArtifactMismatch` on
        an unknown version, a non-screener kind, a family disagreement,
        or missing weights."""
        sur, manifest = _load_artifact(
            path, "screener", SCREENER_KIND, SCREENER_VERSION, expect_family,
            device,
        )
        return cls(sur, manifest)


def _screen_quality(
    pred: np.ndarray, truth: np.ndarray, thr: float
) -> Dict[str, float]:
    """Recall / shrink / false-negative count of a thresholded score
    matrix against the 0/1 indicator truth."""
    mask = pred >= thr
    crit = truth >= 0.5
    n_crit = int(crit.sum())
    caught = int((mask & crit).sum())
    return {
        "recall": (caught / n_crit) if n_crit else 1.0,
        "shrink": float(mask.mean()),
        "missed_critical": n_crit - caught,
    }


def train_screener_model(
    dataset: WarmStartDataset,
    *,
    hidden: Sequence[int] = (32, 32),
    epochs: int = 300,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_frac: float = 0.2,
    threshold: float = DEFAULT_THRESHOLD,
    verbose: bool = False,
    device="cuda",
) -> Tuple[ScreenerModel, Dict]:
    """Train one per-family screener from a criticality-indicator
    dataset (`screen_targets` rows written through `learn.dataset`
    shards, loaded via `load_dataset(..., varying=SCREEN_VARYING)`).
    Metrics report holdout ``recall`` (share of truly-critical outages
    the thresholded screen keeps — the safety-relevant number),
    ``shrink`` (share of outages kept — the work saved), and
    ``missed_critical``. Returns ``(model, metrics)``."""
    from ..surrogates.train import train_surrogate

    if len(dataset.targets) != 1 or dataset.targets[0][0] != "x":
        raise ValueError(
            f"not a screener dataset: targets {dataset.targets} "
            "(expected one 'x' indicator block)"
        )
    target_dim = int(dataset.targets[0][1])
    train, hold = dataset.split(holdout_frac=holdout_frac, seed=seed)
    sur, train_metrics = train_surrogate(
        train.X, train.Y, hidden=tuple(hidden), epochs=epochs, lr=lr,
        seed=seed, verbose=verbose, device=device,
    )
    feature_dim = int(dataset.X.shape[1])
    thr = float(threshold)
    metrics: Dict = {
        "rows_train": len(train),
        "rows_holdout": len(hold),
        "train_R2_mean": float(np.mean(np.asarray(train_metrics["R2"]))),
        "threshold": thr,
    }
    metrics.update({
        f"train_{k}": v for k, v in _screen_quality(
            _predict(sur, train.X, feature_dim), train.Y, thr
        ).items()
    })
    if len(hold):
        pred = _predict(sur, hold.X, feature_dim)
        metrics["holdout_mse"] = float(np.mean((pred - hold.Y) ** 2))
        metrics.update(_screen_quality(pred, hold.Y, thr))
    manifest = {
        "version": SCREENER_VERSION,
        "kind": SCREENER_KIND,
        "family": dataset.family,
        "problem_type": dataset.problem_type,
        "varying": list(dataset.varying),
        "feature_dim": feature_dim,
        "target_dim": target_dim,
        "hidden": list(int(h) for h in hidden),
        "threshold": thr,
        "train_critical_share": float(np.mean(dataset.Y >= 0.5)),
        "metrics": metrics,
    }
    return ScreenerModel(sur, manifest), metrics


class ContingencyScreener:
    """Serving-side screener registry: family fingerprint ->
    `ScreenerModel`, implementing the duck interface
    `market.contingency.secure_dispatch` consumes —
    ``screen(base_lp, cset)`` plus the ``note_accept`` /
    ``note_violation_fallback`` outcome hooks.

    ``screen`` NEVER raises and never gates correctness — a broken
    screener must not kill the dispatch it was shrinking; failures
    return None (full evaluation, counted under
    ``screener_fallback_total``), and accepted screens are still
    verified post-solve against the full set by the caller.
    Construction from explicit artifact paths, by contrast, raises
    `ArtifactMismatch` loudly: pointing a dispatch at a wrong artifact
    is an operator error."""

    def __init__(self, models: Iterable[ScreenerModel] = (),
                 threshold: Optional[float] = None):
        self._models: Dict[str, ScreenerModel] = {}
        for m in models:
            self._models[m.family] = m
        self.threshold = threshold  # None -> each artifact's own default
        # zero-seed so rate alerts see a flat baseline, not an absent
        # series (the lane-observatory counter idiom)
        obs_metrics.inc("screener_accept_total", 0)
        obs_metrics.inc("screener_violation_fallback_total", 0)
        obs_metrics.inc("screener_screen_total", 0)
        for reason in ("unseen_family", "feature_mismatch",
                       "ctg_mismatch", "error"):
            obs_metrics.inc("screener_fallback_total", 0, reason=reason)

    @classmethod
    def from_paths(cls, paths, threshold=None, device="cuda") -> "ContingencyScreener":
        if isinstance(paths, (str, bytes)):
            paths = [paths]
        return cls(
            (ScreenerModel.load(str(p), device=device) for p in paths),
            threshold=threshold,
        )

    @property
    def families(self) -> Tuple[str, ...]:
        return tuple(self._models)

    def model_for(self, family: str) -> Optional[ScreenerModel]:
        return self._models.get(family)

    # -- the secure_dispatch duck interface ---------------------------
    def screen(self, problem, cset) -> Optional[np.ndarray]:
        """Bool mask over the branch contingencies of `cset` (in cset
        order; True = evaluate), or None when the caller should
        evaluate the full set."""
        try:
            from .dataset import family_fingerprint, features_of

            family = family_fingerprint(problem, SCREEN_VARYING)
            model = self._models.get(family)
            if model is None:
                obs_metrics.inc(
                    "screener_fallback_total", reason="unseen_family"
                )
                return None
            feats = features_of(problem, varying=model.varying)
            if feats.size != model.feature_dim:
                obs_metrics.inc(
                    "screener_fallback_total", reason="feature_mismatch"
                )
                return None
            n_branch = sum(1 for c in cset if c.kind == "branch")
            if n_branch != model.target_dim:
                obs_metrics.inc(
                    "screener_fallback_total", reason="ctg_mismatch"
                )
                return None
            mask = model.critical_mask(feats[None], self.threshold)[0]
            obs_metrics.inc("screener_screen_total")
            return mask
        except Exception:
            obs_metrics.inc("screener_fallback_total", reason="error")
            return None

    # outcome hooks: `secure_dispatch` owns the
    # ``screener_{accept,violation_fallback}_total`` counters (so ANY
    # duck-typed screener is measured identically); these exist for
    # subclasses that want to adapt on outcomes (e.g. online threshold
    # tuning)
    def note_accept(self) -> None:
        pass

    def note_violation_fallback(self, n: int = 1) -> None:
        pass


def as_screener(arg, threshold=None, device="cuda") -> Optional[ContingencyScreener]:
    """Coerce a ``screener=`` argument: None passes through, a
    `ContingencyScreener` is returned as-is, a path or sequence of paths
    loads artifacts (raising `ArtifactMismatch` on structurally wrong
    ones)."""
    if arg is None:
        return None
    if isinstance(arg, ContingencyScreener):
        return arg
    return ContingencyScreener.from_paths(arg, threshold=threshold, device=device)
