"""Synthetic-history integration: trained price model -> clustered LMP sets
(port of `dispatches_tpu/tea/syn_hist.py`).

Parity with the reference's `util/syn_hist_integration.py`
(`SynHist_integration`): the reference loads a pickled RAVEN ARMA ROM and
returns a nested dict of per-year representative-day LMPs with cluster
weights and day maps (``weights_days[year][cluster]``,
``LMP[year][cluster][hour]`` with 1-based cluster/hour keys,
``cluster_map[year][cluster]``), which the price-taker workflow consumes.
Here the trained model is `tea/arma.py`'s ARMAModel (saved as JSON, the JAX
package's format), sampling runs on a device, and the per-year day
clustering is `surrogates.clustering.kmeans`.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..surrogates.clustering import kmeans
from .arma import ARMAModel, generate


def save_arma(model: ARMAModel, path: str) -> None:
    """Serialize a trained ARMAModel to JSON (the analogue of RAVEN's
    pickledROM artifact; portable, human-readable, no pickle)."""
    with open(path, "w") as f:
        json.dump(
            {k: np.asarray(torch.as_tensor(v).cpu()).tolist()
             for k, v in model._asdict().items()},
            f,
        )


def load_arma(path: str) -> ARMAModel:
    with open(path) as f:
        d = json.load(f)
    return ARMAModel(**{k: torch.as_tensor(np.asarray(v, float)) for k, v in d.items()})


class SynHistIntegration:
    """Load a saved ARMA price model and emit workflow-shaped synthetic
    histories (`syn_hist_integration.py:36-127` surface), on `device`."""

    def __init__(self, target_file: str, device="cuda"):
        self.target_file = target_file
        self.model = load_arma(target_file)
        self.device = torch.device(device)

    def generate_synthetic_history(
        self,
        signal_name: str,
        set_years,
        n_clusters: int = 20,
        hours_per_day: int = 24,
        days_per_year: int = 365,
        seed: int = 0,
    ) -> dict:
        """One ARMA realization per requested year (drawn in turn from one
        generator seeded with `seed`), clustered into `n_clusters`
        representative days. Returns the reference's nested dict: 1-based
        cluster ids and hours, per-cluster day counts as weights, and the
        day -> cluster membership map."""
        if signal_name != "LMP":
            raise KeyError(
                f"signal name {signal_name!r} not in this model (signals: "
                "['LMP'])"
            )
        T = days_per_year * hours_per_day
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        out = {"weights_days": {}, "LMP": {}, "cluster_map": {}}
        for year in set_years:
            series = generate(self.model, T, gen, device=self.device)[0]
            days = series.reshape(days_per_year, hours_per_day)
            res = kmeans(days, n_clusters, n_iter=50, seed=seed)
            labels = res.labels.cpu().numpy()
            centers = res.centers.cpu().numpy()
            out["weights_days"][year] = {}
            out["cluster_map"][year] = {}
            out["LMP"][year] = {}
            for c in range(n_clusters):
                members = np.where(labels == c)[0]
                out["weights_days"][year][c + 1] = int(members.size)
                out["cluster_map"][year][c + 1] = members.tolist()
                out["LMP"][year][c + 1] = {
                    h + 1: float(centers[c, h]) for h in range(hours_per_day)
                }
        return out
