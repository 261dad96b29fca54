"""Market-surrogate training: MLPs for dispatch frequency and revenue
(port of `dispatches_tpu/surrogates/train.py`).

Parity with the reference's
`dispatches/workflow/train_market_surrogates/dynamic/Train_NN_Surrogates.py:31-730`:
sigmoid-MLP surrogates (Adam, MSE, 500 epochs by default) mapping sweep
inputs to per-cluster dispatch-day frequencies (`train_NN_frequency:356-441`)
or annual revenue (`train_NN_revenue:444-516`), with R^2 reporting and the
scaling-params JSON schema {"xm_inputs", "xstd_inputs", "xmin", "xmax",
"y_mean", "y_std"} that the design-optimization scripts consume
(`save_model:516-565`).

The JAX package's Flax `Dense`-sigmoid stack is an `nn.Module` of
`nn.Linear` layers here (Flax's initialization: LeCun-normal weights, zero
biases), trained full-batch in float32 by `torch.optim.Adam` with optax's
defaults (betas 0.9 / 0.999, eps 1e-8 outside the square root) on one
device. `TrainedSurrogate.save` writes the JAX package's `.npz` keys
(Flax's kernel layout, (in, out)), so saved weights read in both packages.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# Flax's `lecun_normal`: a normal truncated at two standard deviations,
# rescaled so that the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class SurrogateMLP(nn.Module):
    """Dense-sigmoid stack: sigmoid(Linear) for each hidden width, then a
    linear output layer."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.out_dim = int(out_dim)
        widths = (int(in_dim),) + self.hidden + (self.out_dim,)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        with torch.no_grad():
            for lin in self.layers:
                std = (1.0 / lin.in_features) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                lin.bias.zero_()

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = torch.sigmoid(lin(x))
        return self.layers[-1](x)


def _r2(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    ss_res = np.sum((y_true - y_pred) ** 2, axis=0)
    ss_tot = np.sum((y_true - np.mean(y_true, axis=0)) ** 2, axis=0)
    # a constant output (e.g. a cluster-frequency bin that never occurs in
    # the sweep) has ss_tot ~ 0 and an undefined R2; score it by the
    # residual against the output's overall scale instead of its variance
    scale = np.maximum(np.sum(y_true**2, axis=0), np.ones_like(ss_tot) * y_true.shape[0] * 1e-12)
    degenerate = ss_tot < 1e-9 * scale
    return np.where(degenerate, 1.0 - ss_res / scale, 1.0 - ss_res / np.maximum(ss_tot, 1e-30))


class TrainedSurrogate:
    """A trained MLP and its scaling. `predict` standardizes the inputs,
    runs the network and un-standardizes the outputs in float64 (the JAX
    package's promotion of its float32 weights against float64 scaling),
    on the network's device; it is a torch function of its input that
    `torch.func` transforms pass through."""

    def __init__(self, model: SurrogateMLP, scaling: Dict):
        self.model = model
        self.scaling = scaling
        # the float64 network with frozen weights and the scaling tensors,
        # made here, outside any `torch.func` transform (which forbids a
        # module's `.to`)
        self._net = copy.deepcopy(model).to(torch.float64).requires_grad_(False)
        dev = next(self._net.parameters()).device
        self._scale = {k: torch.as_tensor(np.asarray(scaling[k], float), device=dev)
                       for k in ("xm_inputs", "xstd_inputs", "y_mean", "y_std")}

    def predict(self, X):
        t = self._scale
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X, float), device=t["y_std"].device)
        Xs = (X.to(torch.float64) - t["xm_inputs"]) / t["xstd_inputs"]
        return self._net(Xs) * t["y_std"] + t["y_mean"]

    def save(self, weights_path: str, scaling_path: str):
        """The weights as `.npz` under the JAX package's keys and layout
        (``['params']/['Dense_0']/['kernel']``, a kernel (in, out)) and the
        scaling JSON."""
        flat = {}
        for i, lin in enumerate(self.model.layers):
            flat[f"['params']/['Dense_{i}']/['bias']"] = lin.bias.detach().cpu().numpy()
            flat[f"['params']/['Dense_{i}']/['kernel']"] = lin.weight.detach().cpu().numpy().T
        np.savez(weights_path, **flat)
        with open(scaling_path, "w") as f:
            scl = {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in self.scaling.items()
            }
            json.dump(scl, f)


def train_surrogate(
    X: np.ndarray,
    y: np.ndarray,
    hidden: Sequence[int] = (100, 100),
    epochs: int = 500,
    lr: float = 1e-3,
    seed: int = 0,
    mesh: Optional[object] = None,
    verbose: bool = False,
    device=None,
    init_model: Optional[SurrogateMLP] = None,
) -> Tuple[TrainedSurrogate, Dict]:
    """Full-batch Adam on standardized inputs and outputs, in float32 on
    `device`. Returns the trained surrogate and metrics {"R2": per-output
    array}. The weights start from Flax's initialization drawn from a
    generator seeded with `seed`, or from a copy of `init_model` (e.g. one
    carried across from the JAX package by `convert.mlp_from_flax`).
    ``mesh=`` (a `parallel.mesh.DeviceMesh`, where the JAX package shards
    the batch over its devices) trains on the mesh's one device, bitwise
    as ``mesh=None`` on that device; a `device` other than the mesh's
    raises. Without a mesh, `device` defaults to the card."""
    if mesh is not None:
        if mesh.size != 1:
            raise ValueError(f"train_surrogate: a mesh of {mesh.size} devices; the "
                             "port trains on one")
        if device is not None:
            asked, own = torch.device(device), mesh.device
            if asked.type != own.type or asked.index not in (None, own.index):
                raise ValueError(f"train_surrogate: device {asked} is not the mesh's "
                                 f"device {own}")
        device = mesh.device
    elif device is None:
        device = "cuda"
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if y.ndim == 1:
        y = y[:, None]
    xm, xs = X.mean(0), X.std(0) + 1e-12
    ym, ys = y.mean(0), y.std(0) + 1e-12
    dev = torch.device(device)
    Xs = torch.as_tensor((X - xm) / xs, device=dev)
    Ys = torch.as_tensor((y - ym) / ys, device=dev)

    if init_model is not None:
        model = copy.deepcopy(init_model).to(device=dev, dtype=torch.float32)
    else:
        gen = torch.Generator().manual_seed(int(seed))
        model = SurrogateMLP(X.shape[1], hidden, y.shape[1], generator=gen).to(dev)
    model.requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           fused=dev.type == "cuda")
    losses = []
    for e in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(Xs) - Ys) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if verbose and e % 100 == 0:
            print(f"epoch {e}: mse {float(loss):.6f}")

    scaling = {
        "xm_inputs": xm.tolist(),
        "xstd_inputs": xs.tolist(),
        "xmin": ((X.min(0) - xm) / xs).tolist(),
        "xmax": ((X.max(0) - xm) / xs).tolist(),
        "y_mean": ym.tolist() if ym.size > 1 else float(ym.item()),
        "y_std": ys.tolist() if ys.size > 1 else float(ys.item()),
    }
    sur = TrainedSurrogate(model, scaling)
    with torch.no_grad():
        pred = sur.predict(torch.as_tensor(X, device=dev)).cpu().numpy()
    metrics = {
        "R2": _r2(y.astype(np.float64), pred),
        "loss": torch.stack(losses).cpu().numpy() if losses else np.zeros(0),
    }
    if verbose:
        print("R2:", metrics["R2"])
    return sur, metrics


class TrainNNSurrogates:
    """Reference-API front end (`Train_NN_Surrogates.py:37`): makes the label
    data from a clustering model and trains frequency/revenue surrogates
    on `device`."""

    def __init__(self, simulation_data, clustering_model: Optional[dict] = None,
                 device="cuda"):
        self.simulation_data = simulation_data
        self.clustering_model = clustering_model
        self.device = torch.device(device)

    def generate_label_data_frequency(self) -> np.ndarray:
        """Per-run cluster frequencies with the synthetic 0/1-cf bins
        (`_generate_label_data:208-322`): output dim k + 2, rows sum to 1.
        Every kept day is labelled at once on the device: one (N, k)
        product and a bincount, not a loop over runs."""
        sd = self.simulation_data
        cf = sd.dispatch_capacity_factors()
        runs, T = cf.shape
        centers = np.asarray(self.clustering_model["cluster_centers"])
        k = centers.shape[0]
        freqs = np.zeros((runs, k + 2))
        days = cf.reshape(runs, T // 24, 24)
        day_sums = days.sum(axis=2)
        zero_mask = day_sums < 1e-8
        full_mask = (days > 1 - 1e-3).all(axis=2)
        n_days = days.shape[1]
        freqs[:, 0] = zero_mask.sum(axis=1) / n_days
        freqs[:, k + 1] = full_mask.sum(axis=1) / n_days
        keep_flat = ~(zero_mask | full_mask).reshape(-1)
        if keep_flat.any():
            from .clustering import TimeSeriesClustering

            kept = torch.as_tensor(days.reshape(-1, 24)[keep_flat]).to(self.device)
            lab = TimeSeriesClustering(k).assign_labels(kept, centers)
            run_ids = torch.as_tensor(np.repeat(np.arange(runs), n_days)[keep_flat],
                                      device=self.device)
            counts = torch.bincount(run_ids * k + lab, minlength=runs * k)
            freqs[:, 1 : k + 1] = counts.reshape(runs, k).cpu().numpy() / n_days
        return freqs

    def train_NN_frequency(self, hidden=(100, 100), epochs=500, **kw):
        X = self.simulation_data.inputs
        y = self.generate_label_data_frequency()
        kw.setdefault("device", self.device)
        return train_surrogate(X, y, hidden=hidden, epochs=epochs, **kw)

    def train_NN_revenue(self, revenue: np.ndarray, hidden=(100, 100), epochs=500, **kw):
        X = self.simulation_data.inputs
        kw.setdefault("device", self.device)
        return train_surrogate(X, np.asarray(revenue), hidden=hidden, epochs=epochs, **kw)
