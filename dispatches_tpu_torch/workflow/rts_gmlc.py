"""RTS-GMLC data resolution — parity with `dispatches/workflow/rts_gmlc.py:21-26`.

The reference wraps Prescient's RTS-GMLC downloader. This environment has no
egress, so `download` resolves, in order: an explicit ``path`` argument, the
``DISPATCHES_RTS_GMLC_DIR`` environment variable (a pre-downloaded tree), or
the bundled 5-bus RTS-format dataset (`dispatches_tpu/data/five_bus`).
"""
from __future__ import annotations

import os
from pathlib import Path

from ..market.network import FIVE_BUS_DIR


def download(path=None, **_kwargs) -> str:
    """Return a directory containing an RTS-GMLC-format dataset."""
    if path is not None:
        p = Path(path)
        if not p.is_dir():
            raise FileNotFoundError(f"RTS-GMLC directory not found: {p}")
        return str(p)
    env = os.environ.get("DISPATCHES_RTS_GMLC_DIR")
    if env:
        return download(env)
    return str(FIVE_BUS_DIR)
