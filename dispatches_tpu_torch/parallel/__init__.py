"""Parallelism layer (port of `dispatches_tpu/parallel/`): scenario batches
and the time-axis horizon decomposition on one card. The JAX package
shards the scenario axis and the horizon's chunks over a
`jax.sharding.Mesh`; the port runs each as the lanes of one batch on one
device (`mesh.DeviceMesh`). Case-specific horizon solves live with their
case studies (`case_studies/renewables/horizon.py`)."""

from .mesh import DeviceMesh, pad_batch, scenario_mesh, shard_device_env, solve_lp_sharded
from .time_axis import HorizonSolution, solve_horizon_admm
