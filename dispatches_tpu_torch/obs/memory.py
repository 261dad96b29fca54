"""Best-effort device-memory watermarks (port of
`dispatches_tpu/obs/memory.py`).

The CUDA caching allocator reports its statistics through
`torch.cuda.memory_stats` and `torch.cuda.max_memory_allocated`. Both are
read only when CUDA is already initialized in this process: a journal
span or manifest never creates a CUDA context. Without a card, or before
the first CUDA operation, everything here returns None.
"""
from __future__ import annotations

from typing import Optional

import torch


def _live_devices() -> list:
    """Indices of the CUDA devices, only when CUDA is already initialized
    (else [])."""
    if not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def device_memory_stats() -> Optional[dict]:
    """Per-device allocator statistics (the integer entries of
    `torch.cuda.memory_stats`) keyed by ``cuda:<i>``, or None."""
    out = {}
    for i in _live_devices():
        st = torch.cuda.memory_stats(i)
        if st:
            out[f"cuda:{i}"] = {k: int(v) for k, v in st.items() if isinstance(v, int)}
    return out or None


def memory_watermark_bytes() -> Optional[int]:
    """The largest `max_memory_allocated` across devices (the peak since
    the process started or since its last `reset_peak_memory_stats`), or
    None without an initialized CUDA device."""
    peaks = [int(torch.cuda.max_memory_allocated(i)) for i in _live_devices()]
    return max(peaks) if peaks else None
