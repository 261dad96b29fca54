"""Supervised warm-start datasets from journaled solves (port of
`dispatches_tpu/learn/dataset.py`).

The learned-warm-start subsystem (docs/learned_warmstarts.md) trains a
per-LP-family predictor mapping problem parameters -> a converged
primal-dual point. This module owns the data side:

- **Family identity.** `family_fingerprint` hashes a problem NamedTuple's
  *structure* — type, per-field dtype/shape, and the bytes of every field
  that is NOT declared varying — so all instances of one parametric
  program (same `CompiledLP`, different LMP/CF parameter values) share a
  fingerprint while any structural drift (a new constraint row, a dtype
  flip, changed bounds) breaks it. It is the compatibility key baked into
  trained artifacts (`learn.warmstart`) and checked at load/predict time.
- **Pairs.** Features are the flattened varying fields (default
  ``("b", "c")`` — the RHS carries the capacity-factor series and the
  objective carries the LMP vector for pricetaker programs); targets are
  the concatenated converged iterate parts (``x, y, zl, zu`` for IPM
  solutions, ``x, y`` for PDHG).
- **Sources.** `DatasetWriter` is the recorder's complement: an opt-in,
  atomically-written shard archive of HEALTHY solves (the flight recorder
  only keeps failures, which make poor supervision). `load_dataset`
  ingests a mix of shard files, shard/capture directories, and JSONL
  journals — journals are followed through their ``dataset_shard`` /
  ``capture`` events' ``path`` fields to the arrays on disk.

Nothing here touches a solver: extraction is pure host-side numpy. The
port's problems hold torch tensors, on the card or the CPU; every field is
read to the host (`_host`) and hashed under numpy's dtype name
(``float64``, not ``torch.float64``), so a fingerprint is the JAX
package's for the same values, and artifacts cross between the packages.
The port's `LPData`, `SparseLP` and `BandedLP` have the JAX package's
fields, order and per-lane layout. `family_fingerprints` hashes a batched
problem once per lane without copying a shared field per lane: a field
that carries no batch axis, or an expanded one (stride 0), goes to the
host and into the hash once.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_VARYING = ("b", "c")

# target layout per solution kind, in concatenation order; dims are read
# from the first pair and pinned in the dataset / artifact manifest
_TARGET_PARTS = ("x", "y", "zl", "zu")


def _host(a) -> np.ndarray:
    """A field as a host numpy array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np_dtype(a) -> np.dtype:
    """numpy's dtype for a field, without copying its values."""
    if isinstance(a, torch.Tensor):
        return torch.empty(0, dtype=a.dtype).numpy().dtype
    return np.asarray(a).dtype


def _family_head(problem_type: str, varying: Sequence[str]):
    h = hashlib.sha256()
    h.update(b"warmstart-family-v1:")
    h.update(problem_type.encode())
    h.update(repr(tuple(varying)).encode())
    return h


def _feed(h, name: str, a: np.ndarray, with_bytes: bool) -> None:
    h.update(name.encode())
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    if with_bytes:
        h.update(a.tobytes())


def family_fingerprint(problem, varying: Sequence[str] = DEFAULT_VARYING) -> str:
    """Structural content hash of a problem NamedTuple, parameterized by
    which fields are allowed to vary across instances. Two LPs share a
    family iff they have the same type, every field agrees on dtype and
    shape, the varying-field *names* agree, and every non-varying field is
    byte-identical. Contrast `core.program.lp_fingerprint`, which hashes
    the full instance (the dedup/cache key); this is the *generalization*
    key a trained predictor is valid for. `family_fingerprints` of the
    problem as a batch of one."""
    return family_fingerprints(problem, [None] * len(problem), 1, varying)[0]


def family_fingerprints(problem, axes: Sequence[Optional[int]], batch: int,
                        varying: Sequence[str] = DEFAULT_VARYING) -> List[str]:
    """`family_fingerprint` of every lane of a batched problem (`axes`: 0
    where a field carries the leading batch axis, None where it is
    shared). Equal to hashing each lane's row, but a shared field, or a
    batched one whose lanes are one expanded tensor (stride 0 on the batch
    axis), is copied to the host and hashed once: while every field so far
    is the same for all lanes the lanes share one running hash, and it
    forks only at the first field whose lanes differ."""
    hs = [_family_head(type(problem).__name__, varying)]
    for name, arr, ax in zip(problem._fields, problem, axes):
        shared = ax is None or (
            isinstance(arr, torch.Tensor) and arr.dim() > 0 and arr.stride(0) == 0
        )
        with_bytes = name not in varying
        if shared or not with_bytes:
            # one host copy (only the shape and dtype when the field varies)
            one = arr if ax is None else arr[0]
            a = np.ascontiguousarray(_host(one)) if with_bytes else np.empty(
                tuple(np.shape(one)), dtype=_np_dtype(one))
            for h in hs:
                _feed(h, name, a, with_bytes)
            continue
        if len(hs) == 1:
            hs = [hs[0].copy() for _ in range(batch)]
        full = _host(arr)
        for k, h in enumerate(hs):
            _feed(h, name, np.ascontiguousarray(full[k]), True)
    if len(hs) == 1:
        return [hs[0].hexdigest()] * batch
    return [h.hexdigest() for h in hs]


def features_of(problem, varying: Sequence[str] = DEFAULT_VARYING) -> np.ndarray:
    """Flattened varying-field feature vector (f64 host array) for one
    problem instance — the predictor's input: `features_batch` of the
    problem as a batch of one."""
    return features_batch(problem, [None] * len(problem), 1, varying)[0]


def features_batch(problem, axes: Sequence[Optional[int]], batch: int,
                   varying: Sequence[str] = DEFAULT_VARYING) -> List[np.ndarray]:
    """`features_of` of every lane of a batched problem (`axes` as in
    `family_fingerprints`), each varying field copied to the host once."""
    cols = []
    for f in varying:
        ax = axes[problem._fields.index(f)]
        a = _host(getattr(problem, f)).astype(np.float64)
        cols.append([np.ravel(a[k] if ax == 0 else a) for k in range(batch)])
    return [np.concatenate([c[k] for c in cols]) if cols else np.zeros((0,), np.float64)
            for k in range(batch)]


def _sol_part(solution, name: str):
    if isinstance(solution, dict):
        return solution.get(name)
    return getattr(solution, name, None)


def targets_of(solution) -> Tuple[np.ndarray, List[Tuple[str, int]]]:
    """Concatenated converged-iterate target vector plus its layout
    ``[(part, dim), ...]``. IPM solutions contribute ``x, y, zl, zu``;
    PDHG solutions (no bound duals) contribute ``x, y``. `solution` may be
    a solution NamedTuple or a ``{name: array}`` dict (capture form)."""
    vec, layout = [], []
    for name in _TARGET_PARTS:
        part = _sol_part(solution, name)
        if part is None:
            continue
        a = np.ravel(_host(part).astype(np.float64))
        vec.append(a)
        layout.append((name, int(a.size)))
    if not layout:
        raise ValueError("solution has none of x/y/zl/zu to learn from")
    return np.concatenate(vec), layout


class WarmStartDataset:
    """In-memory (X, Y) pair matrix for one LP family.

    ``X``: (rows, feature_dim) f64; ``Y``: (rows, target_dim) f64;
    ``iters``: per-row solver iteration counts where known (NaN where
    not — the artifact's ``cold_iters_mean`` baseline comes from here);
    ``targets``: the Y layout ``[(part, dim), ...]``; ``skipped``: rows
    the loaders dropped (family mismatch / unusable capture)."""

    def __init__(
        self,
        X: np.ndarray,
        Y: np.ndarray,
        *,
        family: str,
        varying: Sequence[str],
        targets: Sequence[Tuple[str, int]],
        problem_type: str,
        iters: Optional[np.ndarray] = None,
        sources: Optional[List[str]] = None,
        skipped: int = 0,
    ):
        self.X = np.asarray(X, np.float64)
        self.Y = np.asarray(Y, np.float64)
        if self.X.shape[0] != self.Y.shape[0]:
            raise ValueError("X/Y row mismatch")
        self.family = family
        self.varying = tuple(varying)
        self.targets = [(str(n), int(d)) for n, d in targets]
        self.problem_type = problem_type
        self.iters = (
            np.full((self.X.shape[0],), np.nan)
            if iters is None else np.asarray(iters, np.float64)
        )
        self.sources = list(sources or [])
        self.skipped = int(skipped)

    def __len__(self) -> int:
        return int(self.X.shape[0])

    def cold_iters_mean(self) -> Optional[float]:
        good = self.iters[np.isfinite(self.iters)]
        return float(good.mean()) if good.size else None

    def _take(self, idx: np.ndarray) -> "WarmStartDataset":
        return WarmStartDataset(
            self.X[idx], self.Y[idx], family=self.family,
            varying=self.varying, targets=self.targets,
            problem_type=self.problem_type, iters=self.iters[idx],
            sources=self.sources, skipped=self.skipped,
        )

    def split(
        self, holdout_frac: float = 0.2, seed: int = 0
    ) -> Tuple["WarmStartDataset", "WarmStartDataset"]:
        """Deterministic shuffled train/holdout split. The holdout gets at
        least one row whenever ``holdout_frac > 0`` and there are >= 2
        rows (an unvalidated artifact reports no generalization error)."""
        n = len(self)
        perm = np.random.default_rng(seed).permutation(n)
        n_hold = int(round(n * holdout_frac))
        if holdout_frac > 0 and n >= 2:
            n_hold = min(max(n_hold, 1), n - 1)
        else:
            n_hold = 0
        return self._take(perm[n_hold:]), self._take(perm[:n_hold])


class DatasetWriter:
    """Opt-in shard archive of healthy solves for warm-start training.

    `add(problem, solution, iterations=...)` extracts one (features,
    targets) pair; every `shard_rows` pairs a ``shard-NNNNNN.npz`` is
    written atomically (tmp + ``os.replace``, the flight-recorder idiom)
    and announced on the journal as a ``dataset_shard`` event, so
    `load_dataset` can follow a run's journal straight to its training
    data. The first pair pins the family; later pairs from a different
    family are counted in ``skipped`` and dropped (one writer = one
    family = one artifact)."""

    def __init__(
        self,
        directory: str,
        varying: Sequence[str] = DEFAULT_VARYING,
        shard_rows: int = 256,
    ):
        self.directory = os.path.abspath(directory)
        self.varying = tuple(varying)
        self.shard_rows = int(shard_rows)
        os.makedirs(self.directory, exist_ok=True)
        self.family: Optional[str] = None
        self.problem_type: Optional[str] = None
        self.targets: Optional[List[Tuple[str, int]]] = None
        self.skipped = 0
        self.rows_written = 0
        self._X: List[np.ndarray] = []
        self._Y: List[np.ndarray] = []
        self._it: List[float] = []

    def add(self, problem, solution, iterations: Optional[float] = None) -> bool:
        """Buffer one pair: `add_batch` of the problem as a batch of one.
        Returns False when dropped (family/layout mismatch or feature
        extraction failure — never raises: dataset collection must not
        kill the run it observes)."""
        try:
            lane = {n: _host(p)[None] for n in _TARGET_PARTS
                    if (p := _sol_part(solution, n)) is not None}
        except Exception:
            lane = {}
        return self.add_batch(problem, lane, [None] * len(problem), 1,
                              None if iterations is None else [iterations]) == 1

    def add_batch(self, problem, solution, axes: Sequence[Optional[int]], batch: int,
                  iterations: Optional[Sequence[float]] = None) -> int:
        """Buffer the pair of every lane of a batched problem and its
        batched solution (`axes` as in `family_fingerprints`), without
        unstacking the problem into rows: a shared field is copied to the
        host and hashed once. The first pair pins the family; a lane of
        another family or layout, or without a solution part to learn
        from, is counted in ``skipped``. Returns the lanes kept; never
        raises."""
        try:
            fams = family_fingerprints(problem, axes, batch, self.varying)
            feats = features_batch(problem, axes, batch, self.varying)
            parts = {n: _host(p) for n in _TARGET_PARTS
                     if (p := _sol_part(solution, n)) is not None}
        except Exception:
            self.skipped += batch
            return 0
        kept = 0
        for k in range(batch):
            try:
                y, layout = targets_of({n: p[k] for n, p in parts.items()})
            except Exception:
                self.skipped += 1
                continue
            if self.family is None:
                self.family, self.problem_type, self.targets = (
                    fams[k], type(problem).__name__, layout)
            elif fams[k] != self.family or layout != self.targets:
                self.skipped += 1
                continue
            self._X.append(feats[k])
            self._Y.append(y)
            self._it.append(float(iterations[k]) if iterations is not None else np.nan)
            kept += 1
            if len(self._X) >= self.shard_rows:
                self.flush()
        return kept

    def flush(self) -> Optional[str]:
        """Write buffered pairs as one shard; returns its path (None when
        the buffer is empty or the write failed)."""
        if not self._X:
            return None
        try:
            seq = 1 + max(
                (int(n.split("-")[1].split(".")[0])
                 for n in os.listdir(self.directory)
                 if n.startswith("shard-") and n.endswith(".npz")),
                default=0,
            )
            final = os.path.join(self.directory, f"shard-{seq:06d}.npz")
            tmp = f"{final}.{os.getpid()}.tmp"
            meta = {
                "kind": "warmstart_dataset_shard",
                "version": 1,
                "family": self.family,
                "problem_type": self.problem_type,
                "varying": list(self.varying),
                "targets": [[n, d] for n, d in (self.targets or [])],
            }
            np.savez(
                tmp,
                X=np.stack(self._X),
                Y=np.stack(self._Y),
                iters=np.asarray(self._it, np.float64),
                __meta__=np.asarray(json.dumps(meta)),
            )
            # np.savez appends .npz when missing; the tmp name has no such
            # suffix ambiguity since it already ends in .tmp -> .tmp.npz
            tmp_written = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(tmp_written, final)
            self.rows_written += len(self._X)
            self._X, self._Y, self._it = [], [], []
            try:
                from ..obs.journal import get_tracer

                get_tracer().event(
                    "dataset_shard", path=final, family=self.family,
                    rows=self.rows_written,
                )
            except Exception:
                pass
            return final
        except Exception:
            return None

    close = flush


def _expand_sources(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """Resolve user-facing paths into typed leaf sources:
    ``("shard", f)`` / ``("capture", d)``. Journals are followed through
    their ``dataset_shard``/``capture`` event paths; directories are
    scanned for shards and captures one level deep."""
    out: List[Tuple[str, str]] = []
    for p in paths:
        p = os.path.abspath(os.path.expanduser(p))
        if os.path.isdir(p):
            if os.path.exists(os.path.join(p, "meta.json")):
                out.append(("capture", p))
                continue
            for n in sorted(os.listdir(p)):
                sub = os.path.join(p, n)
                if n.startswith("shard-") and n.endswith(".npz"):
                    out.append(("shard", sub))
                elif n.startswith("cap-") and os.path.isdir(sub):
                    out.append(("capture", sub))
        elif p.endswith(".npz"):
            out.append(("shard", p))
        elif p.endswith((".jsonl", ".json")):
            try:
                from ..obs.journal import read_journal

                recs = read_journal(p)
            except Exception:
                continue
            for r in recs:
                if r.get("name") in ("dataset_shard", "capture") and r.get("path"):
                    rp = r["path"]
                    if os.path.isdir(rp):
                        out.append(("capture", rp))
                    elif os.path.exists(rp):
                        out.append(("shard", rp))
    # dedup, order-preserving (a journal may announce one shard many times)
    seen, uniq = set(), []
    for src in out:
        if src not in seen:
            seen.add(src)
            uniq.append(src)
    return uniq


def _pairs_from_capture(
    path: str, varying: Sequence[str], healthy_only: bool
) -> Optional[Tuple[np.ndarray, np.ndarray, float, str, List[Tuple[str, int]], str]]:
    from ..obs.recorder import load_capture

    cap = load_capture(path)
    problem = cap.get("problem")
    sol = cap.get("solution") or {}
    if problem is None or not hasattr(problem, "_fields") or "x" not in sol:
        return None
    if healthy_only:
        # captures are mostly failures by construction; only a converged
        # solution is usable supervision unless the caller opts out
        conv = sol.get("converged")
        if conv is None or not bool(np.all(conv)):
            return None
    x = features_of(problem, varying)
    y, layout = targets_of(sol)
    if not np.all(np.isfinite(x)) or not np.all(np.isfinite(y)):
        return None
    it = sol.get("iterations")
    return (
        x, y, float(it) if it is not None else np.nan,
        family_fingerprint(problem, varying), layout,
        type(problem).__name__,
    )


def load_dataset(
    paths: Sequence[str],
    *,
    varying: Sequence[str] = DEFAULT_VARYING,
    family: Optional[str] = None,
    healthy_only: bool = True,
) -> WarmStartDataset:
    """Build a `WarmStartDataset` from a mix of shard files, shard /
    capture directories, and JSONL journals. The family is pinned by
    `family` or by the first usable source; pairs from other families are
    counted in ``skipped`` and dropped. Raises ValueError when nothing
    usable is found (an empty artifact helps nobody)."""
    Xs: List[np.ndarray] = []
    Ys: List[np.ndarray] = []
    its: List[float] = []
    sources: List[str] = []
    skipped = 0
    pinned = family
    targets: Optional[List[Tuple[str, int]]] = None
    ptype: Optional[str] = None

    for kind, src in _expand_sources(paths):
        if kind == "shard":
            try:
                with np.load(src, allow_pickle=False) as dat:
                    meta = json.loads(str(dat["__meta__"]))
                    if tuple(meta.get("varying", ())) != tuple(varying):
                        skipped += int(dat["X"].shape[0])
                        continue
                    fam = meta.get("family")
                    layout = [(str(n), int(d)) for n, d in meta.get("targets", [])]
                    if pinned is None:
                        pinned = fam
                    if fam != pinned or (targets is not None and layout != targets):
                        skipped += int(dat["X"].shape[0])
                        continue
                    targets = targets or layout
                    ptype = ptype or meta.get("problem_type")
                    Xs.extend(np.asarray(dat["X"], np.float64))
                    Ys.extend(np.asarray(dat["Y"], np.float64))
                    its.extend(np.asarray(dat["iters"], np.float64))
                    sources.append(src)
            except Exception:
                skipped += 1
        else:
            try:
                pair = _pairs_from_capture(src, varying, healthy_only)
            except Exception:
                pair = None
            if pair is None:
                skipped += 1
                continue
            x, y, it, fam, layout, pt = pair
            if pinned is None:
                pinned = fam
            if fam != pinned or (targets is not None and layout != targets):
                skipped += 1
                continue
            targets = targets or layout
            ptype = ptype or pt
            Xs.append(x)
            Ys.append(y)
            its.append(it)
            sources.append(src)

    if not Xs:
        raise ValueError(
            f"no usable warm-start pairs in {list(paths)!r} "
            f"({skipped} sources/rows skipped)"
        )
    return WarmStartDataset(
        np.stack(Xs), np.stack(Ys), family=pinned, varying=varying,
        targets=targets or [], problem_type=ptype or "LPData",
        iters=np.asarray(its, np.float64), sources=sources, skipped=skipped,
    )
