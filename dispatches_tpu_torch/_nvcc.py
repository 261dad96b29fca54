"""Build a CUDA source of ``csrc/`` into a shared library with a plain C
interface (nvcc for sm_90a), once per source content, into ``_build/``."""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _text(src: Path, seen=None) -> bytes:
    """The source's bytes and those of the local headers it includes
    (``#include "..."``, relative to the including file), recursively."""
    seen = set() if seen is None else seen
    if src in seen:
        return b""
    seen.add(src)
    data = src.read_bytes()
    for name in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', data, re.M):
        data += _text((src.parent / name.decode()).resolve(), seen)
    return data


def build(source: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<source>`` (or ``source``, where it is an absolute
    path) and return the shared library's path; a library built from the
    same source, local headers and flags is reused."""
    src = CSRC / source
    tag = hashlib.sha256(_text(src) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out
