"""API-parity dataset layer over the bundled RTS-format data.

The reference wraps its Prescient data download in three classes
(`dispatches/workflow/workflow.py:23-101`: ``ManagedWorkflow`` memoizes
``Dataset`` objects built by ``DatasetFactory``, whose "rts-gmlc" entry
downloads the full RTS-GMLC tree). Those three names stay importable —
user scripts written against the reference keep working — but the
machinery here is a flat registry of builder functions over the
zero-egress resolution chain in :func:`rts_gmlc.download` (bundled
5-bus tree / ``$DISPATCHES_RTS_GMLC_DIR`` / caller path).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


class Dataset:
    """A named bag of metadata describing one resolved data source."""

    def __init__(self, name: str):
        self.name = name
        self._meta: Dict[str, Any] = {}

    @property
    def meta(self) -> Dict[str, Any]:
        return dict(self._meta)  # a view the caller can't mutate through

    def add_meta(self, key: str, value: Any) -> None:
        self._meta[key] = value

    def __str__(self) -> str:
        body = "".join(f"{k}:\n{v}\n" for k, v in self._meta.items())
        return f"Metadata\n--------\n{body}".rstrip("\n")


def _build_rts_gmlc(**kwargs: Any) -> Dataset:
    """Resolve the RTS-format directory and describe its contents."""
    from . import rts_gmlc

    path = rts_gmlc.download(**kwargs)
    ds = Dataset("rts-gmlc")
    ds.add_meta("directory", path)
    ds.add_meta("files", sorted(os.listdir(path)))
    return ds


#: type name -> builder; "null" deliberately builds nothing (the
#: reference's no-op dataset used by workflows that bring their own data)
_BUILDERS: Dict[str, Callable[..., Optional[Dataset]]] = {
    "rts-gmlc": _build_rts_gmlc,
    "null": lambda **kwargs: None,
}


class DatasetFactory:
    """Reference-parity shim: ``DatasetFactory(t).create(**kw)`` invokes
    the registered builder for ``t``; unknown types raise ``KeyError`` at
    construction (not at ``create`` time), matching the reference."""

    def __init__(self, type_: str, workflow: "ManagedWorkflow | None" = None):
        builder = _BUILDERS.get(type_)
        if builder is None:
            raise KeyError(f"Cannot create dataset of type '{type_}'")
        self.create = builder
        self._wf = workflow


class ManagedWorkflow:
    """A named workspace handing out datasets by type name, memoized so
    repeated ``get_dataset`` calls share one resolved instance."""

    def __init__(self, name: str, workspace_name: str):
        self.name = name
        self.workspace_name = workspace_name
        self._cache: Dict[str, Optional[Dataset]] = {}

    def get_dataset(self, type_: str, **kwargs: Any) -> Optional[Dataset]:
        if self._cache.get(type_) is None:
            factory = DatasetFactory(type_, workflow=self)
            self._cache[type_] = factory.create(**kwargs)
        return self._cache[type_]
