"""Representative-day time-series clustering: k-means on a device (port of
`dispatches_tpu/surrogates/clustering.py`).

Parity with the reference's
`dispatches/workflow/train_market_surrogates/dynamic/Time_Series_Clustering.py:28-726`:
slice annual hourly capacity-factor series into 24-h days, set the all-zero
and all-full days apart in bins of their own (`:287-362`), fit Euclidean
k-means over the remaining days (the reference uses tslearn
`TimeSeriesKMeans`; here k-means++ and Lloyd iterations over the restarts
as one batch, one (n_days, 24) x (k, 24) distance product a step), and
persist the model as JSON (the JAX package's format).
"""
from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Tuple

import numpy as np
import torch


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (k, d)
    labels: torch.Tensor  # (n,)
    inertia: torch.Tensor  # ()


def _d2(X, x2, centers):
    """Squared distances in matmul form, (..., n, k): an (n, k) product a
    restart, never the (n, k, d) broadcast (at sweep scale, millions of
    days, the broadcast form is tens of GB)."""
    return x2[:, None] - 2 * X @ centers.transpose(-1, -2) + (centers**2).sum(-1)[..., None, :]


def kmeans(
    X,
    k: int,
    n_iter: int = 100,
    seed: int = 42,
    n_init: int = 10,
    device=None,
) -> KMeansResult:
    """Euclidean k-means with k-means++ init, best of `n_init` restarts.

    `X` (n, d) runs on its own device when it is a tensor, else on `device`
    (the card by default). The restarts' picks come from one
    `torch.Generator` seeded with `seed` on that device; all restarts run
    as one batch."""
    dev = X.device if isinstance(X, torch.Tensor) and device is None else torch.device(device or "cuda")
    X = torch.as_tensor(X).to(dev)
    n, d = X.shape
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x2 = (X**2).sum(1)
    R = n_init
    ks = torch.arange(k, device=dev)

    # k-means++: the first center uniform, each next one drawn with
    # probability proportional to the squared distance to the nearest chosen
    idx0 = torch.randint(0, n, (R,), generator=gen, device=dev)
    centers = torch.zeros(R, k, d, dtype=X.dtype, device=dev)
    centers[:, 0] = X[idx0]
    for i in range(1, k):
        d2 = _d2(X, x2, centers) + torch.where(ks >= i, torch.inf, 0.0).to(X.dtype)
        # the matmul form can go slightly negative
        d2 = torch.clamp_min(d2.amin(-1), 0.0)
        probs = d2 / torch.clamp_min(d2.sum(-1, keepdim=True), 1e-30)
        idx = torch.multinomial(probs, 1, generator=gen)[:, 0]
        centers[:, i] = X[idx]

    for _ in range(n_iter):
        lab = _d2(X, x2, centers).argmin(-1)
        one_hot = torch.nn.functional.one_hot(lab, k).to(X.dtype)  # (R, n, k)
        counts = one_hot.sum(1)
        sums = one_hot.transpose(1, 2) @ X
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp_min(counts[..., None], 1.0), centers)
    d2 = _d2(X, x2, centers)
    labels = d2.argmin(-1)
    inertia = d2.amin(-1).sum(-1)
    best = torch.argmin(inertia)
    return KMeansResult(centers[best], labels[best], inertia[best])


@dataclasses.dataclass
class TimeSeriesClustering:
    """Day-slicing + filtering + k-means over a sweep of annual series."""

    num_clusters: int
    filter_opt: bool = True
    metric: str = "euclidean"

    def transform_data(
        self, cf_series: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(n_runs, 8736) capacity factors -> stacked (N_days, 24) day
        matrix, plus per-run counts of filtered all-zero and all-max days
        (`Time_Series_Clustering.py:287-362`)."""
        runs, T = cf_series.shape
        days = cf_series.reshape(runs, T // 24, 24)
        if not self.filter_opt:
            return days.reshape(-1, 24), np.zeros(runs), np.zeros(runs)
        day_sums = days.sum(axis=2)
        zero_mask = day_sums < 1e-8
        full_mask = (days > 1 - 1e-3).all(axis=2)
        keep = ~(zero_mask | full_mask)
        flat = days[keep]
        return flat, zero_mask.sum(axis=1), full_mask.sum(axis=1)

    def clustering_data(
        self, cf_series: np.ndarray, seed: int = 42, device="cuda", **kmeans_kw
    ) -> dict:
        """Filter and cluster the days on `device`; the result is numpy."""
        flat, zero_days, full_days = self.transform_data(np.asarray(cf_series))
        res = kmeans(torch.as_tensor(flat).to(device), self.num_clusters, seed=seed,
                     **kmeans_kw)
        self.result = {
            "centers": res.centers.cpu().numpy(),
            "labels": res.labels.cpu().numpy(),
            "inertia": float(res.inertia),
            "zero_days": zero_days,
            "full_days": full_days,
        }
        return self.result

    def save_clustering_model(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "n_clusters": self.num_clusters,
                    "metric": self.metric,
                    "filter_opt": self.filter_opt,
                    "cluster_centers": self.result["centers"].tolist(),
                    "inertia": self.result["inertia"],
                },
                f,
            )

    @staticmethod
    def load_clustering_model(path: str) -> dict:
        with open(path) as f:
            d = json.load(f)
        d["cluster_centers"] = np.asarray(d["cluster_centers"])
        return d

    def assign_labels(self, days, centers):
        """Nearest-center labels in matmul form (O(n*k) memory at sweep
        scale): numpy in, numpy out; tensors in, a tensor on their device
        out."""
        if isinstance(days, torch.Tensor):
            c = torch.as_tensor(centers, dtype=days.dtype, device=days.device)
            return _d2(days, (days**2).sum(1), c).argmin(-1)
        d2 = (
            (days**2).sum(1)[:, None]
            - 2.0 * days @ centers.T
            + (centers**2).sum(1)[None, :]
        )
        return d2.argmin(axis=1)
