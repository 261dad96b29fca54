"""Asynchronous dispatch serving: single-engine service + sharded fleet
(port of `dispatches_tpu/serve`). The engines run on the card unless a
caller asks for the CPU (``device="cpu"``).

Accepts solve requests — a `CompiledLP` + params or a prebuilt problem
row — queues them with priority classes and per-request deadlines, and
micro-batches them onto the runtime's fixed-bucket `SlotEngine`:
retired lanes' slots are back-filled from the queue between chunks, so
the device's batch stays full under sustained load. Admission control
sheds lowest-priority work when the bounded queue overflows; deadline
enforcement returns the best iterate so far with a
``deadline_exceeded`` verdict; a fingerprint-keyed LRU cache returns
previously solved answers bitwise.

Two deployment shapes share the ticket contract:

- `DispatchService` / `make_dense_service` — one in-process engine.
- `FleetService` / `make_dense_fleet` — N shard child processes, each a
  crash domain (`serve.shard`) with its own CUDA context, balanced by
  `serve.router.Router`, with per-tenant fairness and rate limits
  (`serve.queue.FairQueue`), shard respawn with bounded backoff, and
  automatic requeue of a crashed shard's in-flight lanes.

See `docs/serving.md`.
"""

from .cache import ResultCache
from .fleet import FleetService, make_dense_fleet
from .queue import AdmissionQueue, FairQueue, TenantConfig, TokenBucket
from .request import (
    PRIORITY_CLASSES,
    SolveRequest,
    SolveResult,
    Ticket,
    priority_name,
    priority_value,
)
from .router import Router
from .service import DispatchService, make_dense_service
from .shard import ShardProcess, shard_device_env

__all__ = [
    "AdmissionQueue",
    "DispatchService",
    "FairQueue",
    "FleetService",
    "PRIORITY_CLASSES",
    "ResultCache",
    "Router",
    "ShardProcess",
    "SolveRequest",
    "SolveResult",
    "TenantConfig",
    "Ticket",
    "TokenBucket",
    "make_dense_fleet",
    "make_dense_service",
    "priority_name",
    "priority_value",
    "shard_device_env",
]
