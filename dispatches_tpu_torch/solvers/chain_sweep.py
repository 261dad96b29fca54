"""Fused block-bidiagonal sweep chains: CUDA kernel, plain version, wrapper.

Port of `dispatches_tpu/solvers/pallas_sweep.py`. With inverse block
factors (`structured._block_chol(..., inv=True)`: J_t = L_t^{-1} and the
sub-diagonal blocks C_t) every banded KKT solve is two sweeps over time:

    forward:  v_t = J_t   (r_t - C_t v_{t-1}),        t ascending
    backward: x_t = J_t^T (v_t - C_{t+1}^T x_{t+1}),  t descending

`chain_sweep(J, C, R, reverse)` runs one sweep over every chain of a
(..., S, m, m) factor stack, one chain per leading index. On a CUDA tensor
it launches the hand-written kernel of ``csrc/chain_sweep.cu`` (built with
nvcc at first use) or raises; on a CPU tensor it runs the plain PyTorch
version, `chain_sweep_reference`, the recurrence of the TPU kernel in its
row form ``OUT_t = (IN_t - CARRY @ B_t) @ A_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "chain_sweep.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the chain-sweep kernel cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/chain_sweep.cu`` into ``_build/`` (once per source
    content) and return the shared library's path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libchain_sweep_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.chain_sweep_f32
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def chain_sweep_reference(RT, BT, AT):
    """Plain version of the TPU kernel's recurrence over (..., S) chains:
    ``OUT_t = (IN_t - CARRY @ B_t) @ A_t``, ``CARRY := OUT_t``, with the
    carry zero at step 0 of every chain. RT: (..., S, k, m) row-form
    right-hand sides; BT, AT: (..., S, m, m). Returns (..., S, k, m)."""
    out = torch.empty_like(RT)
    carry = torch.zeros_like(RT[..., 0, :, :])
    for s in range(RT.shape[-3]):
        carry = (RT[..., s, :, :] - carry @ BT[..., s, :, :]) @ AT[..., s, :, :]
        out[..., s, :, :] = carry
    return out


def _sweep_plain(J, C, R, reverse):
    """`chain_sweep` through `chain_sweep_reference`, with the TPU kernel's
    pre-transpose and time-flip plumbing (`pallas_sweep._prep_factors`)."""
    JT, CT, RT = (a.transpose(-1, -2) for a in (J, C, R))
    if not reverse:
        return chain_sweep_reference(RT, CT, JT).transpose(-1, -2)
    Cnext = torch.cat([C[..., 1:, :, :], torch.zeros_like(C[..., :1, :, :])], dim=-3)
    flip = (-3,)
    xT = chain_sweep_reference(
        torch.flip(RT, flip), torch.flip(Cnext, flip), torch.flip(J, flip)
    )
    return torch.flip(xT, flip).transpose(-1, -2)


def chain_sweep(J, C, R, reverse: bool = False):
    """One sweep over every chain. J, C: (..., S, m, m) inverse diagonal
    factors and sub-diagonal blocks; R: (..., S, m, k). Forward
    (``reverse=False``): ``out_t = J_t (R_t - C_t out_{t-1})``; backward:
    ``out_t = J_t^T (R_t - C_{t+1}^T out_{t+1})`` over descending t.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (f32, contiguous) on the current stream or raise."""
    if R.device.type == "cpu":
        return _sweep_plain(J, C, R, reverse)
    if R.device.type != "cuda":
        raise ValueError(f"chain_sweep: unsupported device {R.device}")
    *lead, S, m, k = R.shape
    if J.shape != (*lead, S, m, m) or C.shape != J.shape:
        raise ValueError(
            f"chain_sweep: J {tuple(J.shape)} / C {tuple(C.shape)} do not "
            f"match R {tuple(R.shape)}"
        )
    for name, a in (("J", J), ("C", C), ("R", R)):
        if a.dtype != torch.float32:
            raise TypeError(f"chain_sweep: {name} must be float32, got {a.dtype}")
        if a.device != R.device:
            raise ValueError(f"chain_sweep: {name} is on {a.device}, R on {R.device}")
        if not a.is_contiguous():
            raise ValueError(f"chain_sweep: {name} must be contiguous")
    out = torch.empty_like(R)
    chains = 1
    for d in lead:
        chains *= d
    if out.numel() == 0:
        return out
    fn = _library().chain_sweep_f32
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = fn(J.data_ptr(), C.data_ptr(), R.data_ptr(), out.data_ptr(),
                 chains, S, m, k, int(bool(reverse)), stream)
    if err != 0:
        raise RuntimeError(f"chain_sweep kernel launch failed: cudaError {err}")
    chain_sweep.launches += 1
    return out


chain_sweep.launches = 0


def chain_solve(J, C, r):
    """Solve the factored block-tridiagonal system (forward then backward
    sweep), the counterpart of `structured._bt_solve(..., inv=True)` and of
    the JAX `_prep_factors` solve. J, C: (..., S, m, m); r: (..., S, m) or
    (..., S, m, k). Any k runs through the kernel on the card."""
    vec = r.dim() == J.dim() - 1
    if vec:
        r = r[..., None]
    x = chain_sweep(J, C, chain_sweep(J, C, r.contiguous()), reverse=True)
    return x[..., 0] if vec else x
