"""Shard selection for the serving fleet.

Port of `dispatches_tpu/serve/router.py`: pure Python, copied as it is.

The router answers one question per dispatch: which up shard gets this
request? Four signals, in order of force:

1. **Capacity** — only shards with a free lane (in-flight < bucket) are
   candidates; the fleet holds the request queued otherwise.
2. **Priority class** — interactive requests always go to the
   least-loaded candidate: latency work buys the shortest line, never a
   warm cache.
3. **Lane advice** — when the fleet wires `advice_fn` (the lane
   observatory's damped `route_advice` under `lane_policy="advice"`, or
   the trained lane-portfolio model's per-family route under
   `lane_policy="model"` — `learn.laneroute.LaneRouter.advice`, which
   itself degrades to the scoreboards when the artifact refuses or the
   family is unseen) and the request carries a `family`, shards whose
   `lane` attribute matches the advised lane are preferred among the
   free set. Today's dense fleets expose a single lane, so this is
   dormant until heterogeneous shards arrive — but the plumbing is
   load-bearing and tested.
4. **Bucket affinity** — other classes prefer the shard that last
   solved this fingerprint (its executables and result paths are warm),
   unless that shard's queue depth exceeds the least-loaded candidate
   by more than `affinity_slack` lanes — affinity is a tiebreak, not a
   hotspot generator.

Ties break round-robin so identical shards share load instead of
convoying onto shard 0. The affinity table is a bounded LRU with an
optional TTL: entries record `(shard_id, last_seen)` and expire after
`affinity_ttl` seconds, so a workload that rotates between problem
families does not keep pinning requests to a shard whose warmth for
that fingerprint evaporated long ago. A crashed shard's entries are
dropped by the fleet on respawn (a fresh process has nothing warm)."""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple


class Router:
    def __init__(self, *, affinity_capacity: int = 1024,
                 affinity_slack: int = 2,
                 affinity_ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.affinity_capacity = int(affinity_capacity)
        self.affinity_slack = int(affinity_slack)
        self.affinity_ttl = None if affinity_ttl is None else float(affinity_ttl)
        self.clock = clock
        self._aff: "OrderedDict[str, Tuple[int, float]]" = OrderedDict()
        self._rr = 0
        # Wired by the fleet under lane_policy="advice" (observatory
        # scoreboards) or lane_policy="model" (trained lane portfolio);
        # takes a family fingerprint and returns the advised lane name
        # (or None).
        self.advice_fn: Optional[Callable[[str], Optional[str]]] = None

    def _fresh(self, fp: str, now: float) -> Optional[int]:
        """The affinity entry for `fp` if present and unexpired, else
        None (expired entries are evicted on sight)."""
        ent = self._aff.get(fp)
        if ent is None:
            return None
        sid, stamp = ent
        if self.affinity_ttl is not None and now - stamp > self.affinity_ttl:
            del self._aff[fp]
            return None
        return sid

    def _sweep(self, now: float) -> None:
        """Evict expired entries from the cold end of the LRU. Entries
        are re-stamped on every dispatch, so insertion order is also
        last-seen order and the sweep stops at the first fresh entry."""
        if self.affinity_ttl is None:
            return
        while self._aff:
            fp, (_, stamp) = next(iter(self._aff.items()))
            if now - stamp <= self.affinity_ttl:
                break
            del self._aff[fp]

    def pick(self, req, shards: List[Any]) -> Optional[Any]:
        """Choose a shard for `req` from `shards` (the fleet passes only
        up shards). Returns None when every shard is at capacity."""
        free = [s for s in shards if s.inflight() < s.bucket]
        if not free:
            return None
        self._rr += 1
        if self.advice_fn is not None:
            fam = getattr(req, "family", None)
            if fam is not None:
                advised = self.advice_fn(fam)
                if advised is not None:
                    lane_free = [
                        s for s in free
                        if getattr(s, "lane", None) == advised
                    ]
                    if lane_free:
                        free = lane_free
        least = min(
            free,
            key=lambda s: (s.inflight(), (s.shard_id - self._rr) % 997),
        )
        if req.priority <= 0 or req.fingerprint is None:
            return least
        aff_id = self._fresh(req.fingerprint, self.clock())
        if aff_id is not None:
            for s in free:
                if s.shard_id == aff_id:
                    if s.inflight() <= least.inflight() + self.affinity_slack:
                        return s
                    break
        return least

    def note_dispatch(self, req, shard) -> None:
        """Record where a fingerprint landed (LRU bounded by capacity,
        entries stamped for TTL eviction)."""
        if req.fingerprint is None:
            return
        now = self.clock()
        self._aff.pop(req.fingerprint, None)
        self._aff[req.fingerprint] = (shard.shard_id, now)
        self._sweep(now)
        while len(self._aff) > self.affinity_capacity:
            self._aff.popitem(last=False)

    def forget_shard(self, shard_id: int) -> None:
        """Drop every affinity entry for a crashed shard — its respawned
        process has nothing warm to prefer."""
        stale = [fp for fp, (sid, _) in self._aff.items() if sid == shard_id]
        for fp in stale:
            del self._aff[fp]
