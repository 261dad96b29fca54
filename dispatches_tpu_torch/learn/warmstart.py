"""Per-family warm-start predictor training and versioned artifacts (port
of `dispatches_tpu/learn/warmstart.py`).

The model is the market surrogates' (`surrogates/train.py`): a small
sigmoid `SurrogateMLP` trained full-batch with Adam on standardized
inputs/outputs, by `train_surrogate` itself. What this module adds is
the contract around it:

- a train/holdout split with holdout MSE / R² reported (a warm-start
  artifact that only memorized its training sweep would poison serving);
- a single-file ``.npz`` artifact carrying weights + scaling + the
  feature schema + a **family-compatibility manifest** — the
  `learn.dataset.family_fingerprint` of the LP family it was trained on,
  the varying-field feature schema, the target layout, and the measured
  cold-iteration baseline used for ``warm_start_iters_saved_total``
  attribution;
- refuse-to-load semantics: `WarmStartModel.load` raises
  `ArtifactMismatch` on a version or family mismatch, or missing
  weights, rather than serving a predictor into the wrong program.

The artifact keeps the JAX package's keys exactly — ``__manifest__``
JSON, ``scale/<k>``, ``w/['params']/['Dense_i']/['kernel'|'bias']`` with
Flax's (in, out) kernel layout — so an artifact trained by either package
loads in the other (`_save_artifact`, `_load_artifact`, shared with
`learn.screener` and `learn.laneroute`). A loaded model predicts in
float64 on the device it was loaded to (`TrainedSurrogate.predict`).

Serving-side inference lives in `learn.predictor`.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import WarmStartDataset

ARTIFACT_VERSION = 1

_SCALE_KEYS = ("xm_inputs", "xstd_inputs", "xmin", "xmax", "y_mean", "y_std")


class ArtifactMismatch(ValueError):
    """A warm-start artifact whose version or family manifest does not
    match what the caller is serving. Never caught into a silent cold
    path by the loaders — mismatched artifacts are configuration errors."""


def _save_artifact(surrogate, manifest: Dict, path: str) -> str:
    """One ``.npz``: ``__manifest__`` (JSON) + ``scale/<k>`` arrays +
    ``w/<Flax parameter path>`` weights, the JAX package's keys."""
    payload = {}
    for i, lin in enumerate(surrogate.model.layers):
        payload[f"w/['params']/['Dense_{i}']/['bias']"] = \
            lin.bias.detach().cpu().numpy()
        payload[f"w/['params']/['Dense_{i}']/['kernel']"] = \
            lin.weight.detach().cpu().numpy().T
    for k in _SCALE_KEYS:
        payload[f"scale/{k}"] = np.asarray(surrogate.scaling[k])
    payload["__manifest__"] = np.asarray(json.dumps(manifest))
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **payload)
    return path


def _load_artifact(path: str, what: str, kind: Optional[str], version: int,
                   expect_family: Optional[str], device):
    """Read an artifact and run every refuse-to-load check: not an
    artifact, kind (when `kind` is given), version, family, missing
    scaling or weights. Returns ``(TrainedSurrogate, manifest)``."""
    from ..convert import mlp_from_flax
    from ..surrogates.train import TrainedSurrogate

    with np.load(path, allow_pickle=False) as dat:
        if "__manifest__" not in dat.files:
            raise ArtifactMismatch(f"{path}: not a {what} artifact")
        manifest = json.loads(str(dat["__manifest__"]))
        weights = {
            k[2:]: np.asarray(dat[k]) for k in dat.files if k.startswith("w/")
        }
        scaling = {
            k.split("/", 1)[1]: np.asarray(dat[k])
            for k in dat.files if k.startswith("scale/")
        }
    if kind is not None and manifest.get("kind") != kind:
        raise ArtifactMismatch(
            f"{path}: artifact kind {manifest.get('kind')!r}, "
            f"expected {kind!r}"
        )
    ver = manifest.get("version")
    if ver != version:
        raise ArtifactMismatch(
            f"{path}: artifact version {ver!r}, this build reads {version}"
        )
    if expect_family is not None and manifest.get("family") != expect_family:
        raise ArtifactMismatch(
            f"{path}: trained for family {manifest.get('family')!r:.24}..., "
            f"caller is serving family {expect_family!r:.24}..."
        )
    missing = [k for k in _SCALE_KEYS if k not in scaling]
    if missing or not weights:
        raise ArtifactMismatch(
            f"{path}: artifact missing {missing or ['weights']}"
        )
    model = mlp_from_flax(
        _unflatten(weights), tuple(manifest["hidden"]),
        int(manifest["target_dim"]), device=device,
    )
    scl = {k: v.tolist() for k, v in scaling.items()}
    return TrainedSurrogate(model, scl), manifest


def _predict(surrogate, X: np.ndarray, feature_dim: int) -> np.ndarray:
    """(batch, feature_dim) host features -> (batch, out) host f64."""
    import torch

    X = np.asarray(X, np.float64)
    if X.ndim != 2 or X.shape[1] != feature_dim:
        raise ValueError(
            f"feature shape {X.shape} does not match artifact "
            f"feature_dim={feature_dim}"
        )
    with torch.no_grad():
        out = surrogate.predict(X).cpu().numpy().astype(np.float64)
    return out.reshape(X.shape[0], -1)


class WarmStartModel:
    """A trained per-family warm-start predictor plus its manifest.

    ``manifest`` keys: ``version``, ``family``, ``problem_type``,
    ``varying``, ``targets`` (``[[part, dim], ...]`` concatenation
    layout), ``feature_dim``, ``target_dim``, ``hidden``,
    ``cold_iters_mean`` (mean solver iterations over the training pairs —
    the iters-saved baseline; None when the dataset carried no counts),
    and ``metrics`` from training."""

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
    def targets(self) -> List[Tuple[str, int]]:
        return [(str(n), int(d)) for n, d in self.manifest["targets"]]

    @property
    def problem_type(self) -> str:
        return self.manifest.get("problem_type", "LPData")

    @property
    def feature_dim(self) -> int:
        return int(self.manifest["feature_dim"])

    @property
    def cold_iters_mean(self) -> Optional[float]:
        v = self.manifest.get("cold_iters_mean")
        return None if v is None else float(v)

    # -- inference -----------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        """(batch, feature_dim) -> (batch, target_dim) host array."""
        return _predict(self.surrogate, X, self.feature_dim)

    def predict_parts(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        """Prediction split back into named iterate parts per the
        manifest's target layout: ``{"x": (batch, n), "y": (batch, m),
        ...}``."""
        out = self.predict(X)
        parts, off = {}, 0
        for name, dim in self.targets:
            parts[name] = out[:, off:off + dim]
            off += dim
        return parts

    # -- persistence ---------------------------------------------------
    def save(self, path: str) -> str:
        """Single-file versioned artifact: ``__manifest__`` (JSON) +
        ``scale/<k>`` arrays + ``w/<flattened-param-path>`` weights."""
        return _save_artifact(self.surrogate, self.manifest, path)

    @classmethod
    def load(cls, path: str, expect_family: Optional[str] = None,
             device="cuda") -> "WarmStartModel":
        """Reload an artifact onto `device`; raises `ArtifactMismatch`
        when the version is unknown, `expect_family` disagrees with the
        manifest, or the weights or scaling are missing."""
        sur, manifest = _load_artifact(
            path, "warm-start", None, ARTIFACT_VERSION, expect_family, device,
        )
        return cls(sur, manifest)


def _unflatten(flat: Dict[str, np.ndarray]):
    """Invert the key join of `_save_artifact` (and of the JAX package's
    `tree_flatten_with_path`): keys look like
    ``['params']/['Dense_0']/['kernel']``."""
    tree: Dict = {}
    for key, arr in flat.items():
        parts = [
            m.group(1) for m in re.finditer(r"\['([^']+)'\]", key)
        ] or key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr)
    return tree


def train_warmstart_model(
    dataset: WarmStartDataset,
    *,
    hidden: Sequence[int] = (64, 64),
    epochs: int = 300,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_frac: float = 0.2,
    verbose: bool = False,
    device="cuda",
) -> Tuple[WarmStartModel, Dict]:
    """Train one per-family predictor on `device`: split, run the
    `surrogates.train.train_surrogate` loop on the train rows, score the
    holdout, and wrap the result with its compatibility manifest. Returns
    ``(model, metrics)`` with ``metrics = {"rows_train", "rows_holdout",
    "train_R2_mean", "holdout_mse", "holdout_rel_err", "cold_iters_mean"}``."""
    from ..surrogates.train import train_surrogate

    train, hold = dataset.split(holdout_frac=holdout_frac, seed=seed)
    sur, train_metrics = train_surrogate(
        train.X, train.Y, hidden=tuple(hidden), epochs=epochs, lr=lr,
        seed=seed, verbose=verbose, device=device,
    )
    feature_dim = int(dataset.X.shape[1])
    metrics: Dict = {
        "rows_train": len(train),
        "rows_holdout": len(hold),
        "train_R2_mean": float(np.mean(np.asarray(train_metrics["R2"]))),
    }
    if len(hold):
        pred = _predict(sur, hold.X, feature_dim)
        err = pred - hold.Y
        metrics["holdout_mse"] = float(np.mean(err**2))
        metrics["holdout_rel_err"] = float(
            np.linalg.norm(err) / (1.0 + np.linalg.norm(hold.Y))
        )
    cold = dataset.cold_iters_mean()
    metrics["cold_iters_mean"] = cold
    manifest = {
        "version": ARTIFACT_VERSION,
        "family": dataset.family,
        "problem_type": dataset.problem_type,
        "varying": list(dataset.varying),
        "targets": [[n, d] for n, d in dataset.targets],
        "feature_dim": feature_dim,
        "target_dim": int(dataset.Y.shape[1]),
        "hidden": list(int(h) for h in hidden),
        "cold_iters_mean": cold,
        "metrics": metrics,
    }
    return WarmStartModel(sur, manifest), metrics
