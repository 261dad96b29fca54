"""Online warm-start inference for the adaptive and serving paths (port of
`dispatches_tpu/learn/predictor.py`).

`WarmStartPredictor` adapts a trained `learn.warmstart.WarmStartModel` to
the ``warm_start=`` plumbing of `runtime.adaptive` and the SlotEngine
cold dispatch of `serve/`: given a batch of problems it returns per-lane
solution-frame seeds plus the accept verdict the solver's own safeguard
will reach.

Safety contract (the load-bearing part):

- A prediction NEVER gates correctness. Seeds always flow through the
  clip + per-lane wholesale-rejection safeguard inside the solvers
  (`solvers.ipm._warm_safeguard`, the PDHG projection/finite fallback);
  the predictor merely *also* evaluates `solvers.ipm.warm_start_accept`
  so accept/reject is observable (``learned_warm_accept_total`` /
  ``learned_warm_reject_total``).
- Degradation is always toward the cold path. Family mismatch, feature
  dimension drift, a wrong problem type, non-finite model output, or any
  internal error produce NaN seeds — which the solver rejects wholesale
  per lane, landing bitwise on the cold start.
- ``seed_rows`` / ``seed_batch`` never raise: serving must not crash on a
  bad artifact.

One path: ``seed_batch`` takes one batched problem with its per-field
batch axes (the adaptive entries), whose fingerprints come from
`learn.dataset.family_fingerprints`, a shared field copied to the host
and hashed once for all lanes; ``seed_rows`` (single-lane problems, the
serving engine's admitted rows) stacks them and calls it, and
``seed_stacked`` stacks its seeds. ``last_fingerprint_s`` holds the seconds
the last call spent fingerprinting.

A `BandedLP` seed is shaped by the banded solver's frame (``x``, ``zl``,
``zu`` over the reduced columns, ``y`` over the banded rows), which the
row alone does not give: ``seed_batch`` takes the entry's `TimeStructure`
as ``meta=``, which also gives the banded safeguard's exact verdict
(`solvers.structured.banded_warm_accept`). The JAX package shapes a
banded NaN seed from ``c``'s last axis (a block's width), a shape its
banded solver cannot take, and counts a finite banded seed as accepted;
without `meta` the port returns no seeds for a `BandedLP` and the caller
runs cold.

The iters-saved attribution baseline (``cold_iters_mean``) rides in the
artifact manifest; `SlotEngine` uses it to credit
``warm_start_iters_saved_total{source="learned"}`` at harvest.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from .dataset import _np_dtype, family_fingerprints, features_batch
from .warmstart import ArtifactMismatch, WarmStartModel

obs_metrics.describe(
    "learned_warm_accept_total",
    "learned warm-start seeds the solver safeguard accepted",
)
obs_metrics.describe(
    "learned_warm_reject_total",
    "learned warm-start seeds rejected to the cold path (per lane)",
)

# iterate parts a seed must supply per problem type (= the solver's
# warm_start tuple layout)
_PARTS_BY_TYPE = {
    "LPData": ("x", "y", "zl", "zu"),
    "BandedLP": ("x", "y", "zl", "zu"),
    "SparseLP": ("x", "y"),
}


class WarmStartPredictor:
    """Batch-safe online inference over one warm-start artifact.

    `model` is a `WarmStartModel` or a path to a saved artifact (loaded
    onto `device` with `expect_family` forwarded, so a wrong artifact
    refuses at construction, not at request time). `source` labels the
    obs counters and journal fields; `check_family` hashes each lane's
    structural fingerprint against the manifest (exact; disable only when
    the caller guarantees the family by construction)."""

    def __init__(
        self,
        model: Any,
        *,
        expect_family: Optional[str] = None,
        source: str = "learned",
        check_family: bool = True,
        device="cuda",
    ):
        if isinstance(model, (str, bytes)):
            model = WarmStartModel.load(
                str(model), expect_family=expect_family, device=device,
            )
        elif expect_family is not None and model.family != expect_family:
            raise ArtifactMismatch(
                f"predictor family {model.family!r:.24}... != expected "
                f"{expect_family!r:.24}..."
            )
        self.model = model
        self.source = str(source)
        self.check_family = bool(check_family)
        self._parts = dict(self.model.targets)
        self.last_fingerprint_s = 0.0

    @property
    def cold_iters_mean(self) -> Optional[float]:
        return self.model.cold_iters_mean

    # -- internals -----------------------------------------------------
    @staticmethod
    def _nan_seed(ptype: str, n: int, m: int, dtype) -> Tuple[np.ndarray, ...]:
        """A seed the solver safeguard is guaranteed to reject, shaped
        from the PROBLEM (never the manifest — a family-mismatched
        artifact must not leak its shapes into the solver)."""
        nan = lambda k: np.full((k,), np.nan, dtype)  # noqa: E731
        if ptype == "SparseLP":
            return (nan(n), nan(m))
        return (nan(n), nan(m), nan(n), nan(n))

    def _seeds(self, ptype, fams, feats, n, m, dtype, accept_fn, entry):
        """Seeds and verdicts for lanes of one problem type: ``fams[i]`` /
        ``feats[i]`` are lane i's fingerprint (None to skip the check) and
        features; every lane shares the dims ``(n, m)`` and `dtype`."""
        parts_needed = _PARTS_BY_TYPE[ptype]
        nlanes = len(feats)
        mdl = self.model
        fallback = self._nan_seed(ptype, n, m, dtype)
        seeds: List[Tuple[np.ndarray, ...]] = [fallback] * nlanes
        usable = ptype == mdl.problem_type and all(
            p in self._parts for p in parts_needed
        )
        good = [
            i for i in range(nlanes)
            if usable and feats[i] is not None
            and feats[i].size == mdl.feature_dim
            and np.all(np.isfinite(feats[i]))
            and (fams[i] is None or fams[i] == mdl.family)
        ]
        if good:
            parts = mdl.predict_parts(np.stack([feats[i] for i in good]))
            for j, i in enumerate(good):
                seed = tuple(
                    np.asarray(parts[p][j], dtype) for p in parts_needed
                )
                if tuple(a.shape for a in seed) == tuple(
                    a.shape for a in fallback
                ):
                    # a wrong-shape artifact keeps the NaN seed: rejected
                    # here, not in a crash
                    seeds[i] = seed
        # accept verdicts: exact (solver-identical) for dense IPM and banded
        # seeds, a finite check for PDHG's (it projects any finite seed)
        try:
            if accept_fn is not None:
                accepted = accept_fn(seeds)
            else:
                accepted = [
                    all(bool(np.all(np.isfinite(a))) for a in s) for s in seeds
                ]
        except Exception:
            accepted = [False] * nlanes
        labels = {"source": self.source}
        if entry:
            labels["entry"] = entry
        n_acc = sum(accepted)
        if n_acc:
            obs_metrics.inc("learned_warm_accept_total", n_acc, **labels)
        if nlanes - n_acc:
            obs_metrics.inc("learned_warm_reject_total", nlanes - n_acc, **labels)
        return seeds, accepted

    def _reject_all(self, nlanes, ptype, n, m, dtype, entry):
        try:
            seeds = [self._nan_seed(ptype, n, m, dtype)] * nlanes
            obs_metrics.inc(
                "learned_warm_reject_total", nlanes, source=self.source,
                **({"entry": entry} if entry else {}),
            )
            return seeds, [False] * nlanes
        except Exception:
            return None, None

    @staticmethod
    def _accept_fn(ptype, problem, meta):
        """The solver's own per-lane verdict on a batched problem: the dense
        IPM's safeguard replayed for `LPData`, the banded solver's (on
        `meta`'s frame) for `BandedLP`; None (a finite check) for the
        rest, since PDHG projects any finite seed."""
        if ptype == "LPData":
            from ..solvers.ipm import _LP_NDIM, _broadcast_batch, warm_start_accept

            lp, accept = _broadcast_batch(problem, _LP_NDIM)[0], warm_start_accept
        elif ptype == "BandedLP":
            from ..solvers.structured import banded_warm_accept

            lp = problem
            accept = lambda p, w: banded_warm_accept(meta, p, w)  # noqa: E731
        else:
            return None
        like = lp.b

        def verdicts(seeds):
            warm = tuple(
                torch.as_tensor(np.stack([s[j] for s in seeds]),
                                dtype=like.dtype, device=like.device)
                for j in range(4)
            )
            return [bool(v) for v in accept(lp, warm).cpu().tolist()]

        return verdicts

    # -- public API ----------------------------------------------------
    def seed_rows(
        self, rows: Sequence[Any], entry: Optional[str] = None
    ) -> Tuple[Optional[List[Tuple[np.ndarray, ...]]], Optional[List[bool]]]:
        """Per-lane seeds for single-lane problems (the serving engine's
        admitted rows): `seed_batch` of the rows stacked on a new leading
        axis. Returns ``(seeds, accepted)`` — ``seeds[i]`` is the solver
        warm_start tuple for lane i (NaN tuple when the lane is
        unservable, which the solver rejects to the cold path),
        ``accepted[i]`` the safeguard verdict. Returns ``(None, None)``
        only when even a NaN fallback cannot be built (an unknown problem
        layout, or a `BandedLP`, whose seed dims need its `TimeStructure`)
        — callers then run plainly cold. Rows that do not stack (fields of
        other shapes) are all rejected. Increments the accept/reject
        counters; never raises."""
        try:
            rows = list(rows)
            if not rows:
                return [], []
            ptype = type(rows[0]).__name__
            if ptype not in _PARTS_BY_TYPE or ptype == "BandedLP":
                return None, None
            n, m = int(rows[0].c.shape[-1]), int(rows[0].b.shape[-1])
            dtype = _np_dtype(rows[0].b)
        except Exception:
            return None, None
        try:
            dev = next((f.device for f in rows[0] if isinstance(f, torch.Tensor)),
                       torch.device("cpu"))
            stacked = type(rows[0])(*(
                torch.stack([torch.as_tensor(f, device=dev) for f in col])
                for col in zip(*rows)
            ))
        except Exception:
            return self._reject_all(len(rows), ptype, n, m, dtype, entry)
        return self.seed_batch(stacked, [0] * len(stacked), len(rows), entry=entry)

    def seed_batch(
        self, problem, axes: Sequence[Optional[int]], batch: int,
        entry: Optional[str] = None, meta=None,
    ) -> Tuple[Optional[List[Tuple[np.ndarray, ...]]], Optional[List[bool]]]:
        """`seed_rows` for one batched problem (`axes`: 0 on the fields
        that carry the leading batch axis of `batch` lanes, None on shared
        ones), without unstacking it into rows: the fingerprints hash a
        shared field once. A `BandedLP` needs its `TimeStructure` `meta`:
        the seed's lengths (the reduced column count and the banded row
        count) and the banded safeguard's verdict come from it."""
        try:
            ptype = type(problem).__name__
            if ptype not in _PARTS_BY_TYPE or (ptype == "BandedLP" and meta is None):
                return None, None
            m = int(np.prod(problem.b.shape[-2:])) if ptype == "BandedLP" \
                else int(problem.b.shape[-1])
            n = len(meta.col_pos) if ptype == "BandedLP" else int(problem.c.shape[-1])
            dtype = _np_dtype(problem.b)
        except Exception:
            return None, None
        try:
            varying = self.model.varying
            t0 = time.perf_counter()
            fams = (family_fingerprints(problem, axes, batch, varying)
                    if self.check_family else [None] * batch)
            feats = features_batch(problem, axes, batch, varying)
            self.last_fingerprint_s = time.perf_counter() - t0
            return self._seeds(ptype, fams, feats, n, m, dtype,
                               self._accept_fn(ptype, problem, meta), entry)
        except Exception:
            return self._reject_all(batch, ptype, n, m, dtype, entry)

    def seed_stacked(
        self, rows: Sequence[Any], entry: Optional[str] = None
    ) -> Optional[Tuple[np.ndarray, ...]]:
        """`seed_rows` stacked into the batched ``warm_start=`` tuple the
        adaptive entry points take (None -> caller stays cold)."""
        seeds, _ = self.seed_rows(rows, entry=entry)
        if not seeds:
            return None
        k = len(seeds[0])
        return tuple(np.stack([s[j] for s in seeds]) for j in range(k))
