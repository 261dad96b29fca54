"""Scenario batches on one device (port of `dispatches_tpu/parallel/mesh.py`).

The JAX package shards a scenario-batched solve over a device mesh: each
chip runs the vmapped IPM on its shard of the batch axis, and a batch
that does not divide the device count is edge-padded (`pad_batch`). The
port runs every batch on one card, so its mesh describes that one device
and `solve_lp_sharded` is a padded `solve_lp_batch` on it: each lane is
bitwise the lane of `solve_lp_batch` over the same batch.

`shard_device_env` (the serving fleet's per-child placement) is
`serve.shard.shard_device_env`, re-exported. The JAX package's
`force_virtual_cpu_mesh` sets an XLA host flag for a virtual CPU mesh and
has no counterpart (ROADMAP, "Not ported, by decision").
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.program import LPData
from ..serve.shard import shard_device_env
from ..solvers.ipm import _LP_NDIM, IPMSolution, solve_lp_batch

__all__ = ["DeviceMesh", "pad_batch", "scenario_mesh", "shard_device_env",
           "solve_lp_sharded"]


class DeviceMesh:
    """The devices a batch runs on, with the name of its batch axis: the
    port's counterpart of a one-axis `jax.sharding.Mesh`, holding one
    device."""

    def __init__(self, devices: List[torch.device], axis: str = "scenario"):
        self.devices = list(devices)
        self.axis_names = (str(axis),)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def scenario_mesh(n_devices: Optional[int] = None, axis: str = "scenario",
                  device="cuda") -> DeviceMesh:
    """The one-device mesh on `device` (the card unless asked otherwise).
    `n_devices` may be None or 1; more devices than the machine has raise,
    and so do more than one: the port runs a batch on one device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("scenario_mesh: a CUDA device was asked for and none "
                               "is available; pass device='cpu' for the CPU")
        available = torch.cuda.device_count()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        available = 1
    n = 1 if n_devices is None else int(n_devices)
    if n < 1 or n > available:
        raise ValueError(f"scenario_mesh: {n} devices asked, the machine has "
                         f"{available} of type {device.type}")
    if n > 1:
        raise ValueError(f"scenario_mesh: {n} devices asked; the port runs a batch "
                         "on one device (the lanes of one batch)")
    return DeviceMesh([device], axis)


def pad_batch(arr: torch.Tensor, multiple: int, axis: int = 0):
    """Pad a batch axis up to a multiple of `multiple` by repeating its last
    entry; returns ``(padded, original size)``."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    last = arr.narrow(axis, n - 1, 1)
    reps = [1] * arr.dim()
    reps[axis] = rem
    return torch.cat([arr, last.repeat(*reps)], dim=axis), n


def solve_lp_sharded(lp: LPData, mesh: DeviceMesh, axis: str = "scenario",
                     **solver_kw) -> IPMSolution:
    """Solve a scenario-batched LP on the mesh's device: batched fields
    (a leading axis above their base rank) are padded to a multiple of
    the mesh size and moved there with the shared fields, the batch is one
    `solve_lp_batch`, and the padded lanes are sliced off, one result row
    per input scenario. `axis` names the mesh's batch axis, as in the JAX
    package."""
    if axis not in mesh.axis_names:
        raise ValueError(f"solve_lp_sharded: the mesh has no axis {axis!r}")
    batched = [a.dim() == _LP_NDIM[n] + 1 for n, a in zip(LPData._fields, lp)]
    if not any(batched):
        raise ValueError("no batched field to shard over")
    n_orig = next(a.shape[0] for a, b in zip(lp, batched) if b)
    lp = LPData(*(
        (pad_batch(a, mesh.size)[0] if b else a).to(mesh.device)
        for a, b in zip(lp, batched)
    ))
    out = solve_lp_batch(lp, **solver_kw)
    if out.x.shape[0] != n_orig:
        out = type(out)(*(a[:n_orig] for a in out))
    return out
