"""LRU result cache keyed by content fingerprint.

Port of `dispatches_tpu/serve/cache.py`: pure Python, copied as it is.

Keys come from `core.program.lp_fingerprint` / `CompiledLP.fingerprint`,
which hash problem bytes, dtypes/shapes (precision), and solver options
— so an f32 and an f64 instance of the same model can never share an
entry, and neither can the same bytes solved under different tolerances.
Values are completed `SolveResult`s with numpy leaves: a hit returns the
stored arrays untouched, so cached answers are bitwise-identical to the
solve that populated them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..obs import metrics as obs_metrics
from .request import SolveResult


class ResultCache:
    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"cache capacity must be positive (got {capacity})")
        self.capacity = int(capacity)
        self._d: "OrderedDict[str, SolveResult]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, fingerprint: Optional[str]) -> Optional[SolveResult]:
        if fingerprint is None:
            return None
        hit = self._d.get(fingerprint)
        if hit is None:
            self.misses += 1
            obs_metrics.inc("serve_cache_miss_total")
            return None
        self._d.move_to_end(fingerprint)
        self.hits += 1
        obs_metrics.inc("serve_cache_hit_total")
        return hit

    def put(self, fingerprint: Optional[str], result: SolveResult) -> None:
        if fingerprint is None:
            return
        self._d[fingerprint] = result
        self._d.move_to_end(fingerprint)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        obs_metrics.set_gauge("serve_cache_entries", len(self._d))

    def stats(self) -> dict:
        return {
            "entries": len(self._d),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
        }
