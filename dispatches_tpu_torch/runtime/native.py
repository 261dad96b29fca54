"""The crash-tolerant result store for sweep checkpoints (port of the
ResultStore half of `dispatches_tpu/runtime/native.py`).

Records are appended to one binary file, in the reference's
`result_*.json` skip idiom (`run_pricetaker_wind_PEM.py:43-50`) made
binary: per record a little-endian ``<IQQ`` header (magic 0xD15BA7C5, key,
value count), the float64 payload, and the CRC32 of key and payload. The
format is the JAX package's byte for byte, so a store written by either
package resumes in the other. The traffic is a few short records per
sweep point, so the port reads and writes it in Python; the JAX package's
C++ library (`csrc/dispatches_native.cpp`) does the same I/O.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0xD15BA7C5


class ResultStore:
    """Crash-tolerant append-only store of keyed float64 records. Duplicate
    keys: the LAST record wins (re-runs overwrite). A torn or corrupt tail
    ends the scan; the records before it stay readable."""

    def __init__(self, path: str):
        self.path = str(path)

    def append(self, key: int, values) -> None:
        payload = np.ascontiguousarray(values, dtype=np.float64).ravel().tobytes()
        crc = zlib.crc32(struct.pack("<Q", int(key)) + payload) & 0xFFFFFFFF
        with open(self.path, "ab") as f:
            f.write(struct.pack("<IQQ", MAGIC, int(key), len(payload) // 8))
            f.write(payload)
            f.write(struct.pack("<I", crc))

    def keys(self):
        """Ordered list of record keys (including duplicates)."""
        return [k for k, _ in self._records()]

    def load(self) -> dict:
        """{key: values} with last-record-wins semantics. One file pass."""
        return dict(self._records())

    def _records(self):
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            return
        with f:
            while True:
                head = f.read(20)
                if len(head) < 20:
                    return
                magic, key, ln = struct.unpack("<IQQ", head)
                if magic != MAGIC:
                    return
                payload = f.read(8 * ln)
                tail = f.read(4)
                if len(payload) < 8 * ln or len(tail) < 4:
                    return
                (crc,) = struct.unpack("<I", tail)
                if zlib.crc32(struct.pack("<Q", key) + payload) & 0xFFFFFFFF != crc:
                    return
                yield int(key), np.frombuffer(payload, dtype=np.float64).copy()
