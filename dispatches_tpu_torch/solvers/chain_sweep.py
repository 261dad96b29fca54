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

The kernel streams the factors with TMA, whose copies need rows 16 bytes
apart: it takes J and C in the padded layout of `sweep_factors`, rows
``m_pad = ceil(m / 4) * 4`` floats apart. `launch_plan` sizes each launch:
one thread-block cluster per chain, the cluster size, the output entries
each block owns, and the ring of shared-memory stages.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from .. import _nvcc as _nv

_SRC = _nv.CSRC / "chain_sweep.cu"
_BUILD_DIR = _nv.BUILD_DIR
_NVCC_FLAGS = _nv.NVCC_FLAGS
_nvcc = _nv.nvcc
_lib = None
_lock = threading.Lock()

# The card and the kernel's limits (mirrored in csrc/chain_sweep.cu)
MAX_SMEM = 232448  # dynamic shared memory one block may use on sm_90
MAX_CLUSTER = 16  # non-portable thread-block cluster size limit
MAX_BOX = 256  # TMA box extent limit per dimension
SMS = 132  # H100 SXM
STAGE_BYTES = 65536  # target bytes per ring stage
MAX_STAGES = 32  # ring depth limit
CONSUMER_WARPS = 8  # the source's default CS_CONSUMER_WARPS


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/chain_sweep.cu`` into ``_build/`` (once per source
    content) and return the shared library's path."""
    return _nv.build("chain_sweep.cu", verbose=verbose)


def bind(path) -> ctypes.CDLL:
    """Load a built chain-sweep library and declare its C functions."""
    lib = ctypes.CDLL(str(path))
    lib.chain_sweep_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, *[ctypes.c_int] * 9, ctypes.c_void_p,
    ]
    lib.chain_sweep_f32.restype = ctypes.c_int
    lib.chain_sweep_max_clusters.argtypes = [ctypes.c_int] * 4
    lib.chain_sweep_max_clusters.restype = ctypes.c_int
    lib.chain_sweep_consumer_warps.argtypes = []
    lib.chain_sweep_consumer_warps.restype = ctypes.c_int
    lib.chain_sweep_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.chain_sweep_smem_bytes.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


class LaunchPlan(NamedTuple):
    cluster: int  # blocks per chain (one thread-block cluster)
    width: int  # output entries each block owns, a multiple of 4
    m_pad: int  # row stride of the factors and length of the carry copies
    stages: int  # ring depth
    smem_bytes: int  # dynamic shared memory per block
    stage_rows: int  # factor rows one ring stage holds
    kt: int  # right-hand-side columns per pass (k is tiled by kt)


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def k_tile(k: int) -> int:
    return 1 if k <= 1 else 2 if k <= 2 else 4 if k <= 4 else 8


def _geometry(m, kt, reverse, cluster, consumers=32 * CONSUMER_WARPS,
              stage_bytes=STAGE_BYTES) -> Optional[LaunchPlan]:
    """The plan for `cluster` blocks per chain, or None if the kernel cannot
    take it. The shared-memory formula is the kernel's (`geometry` in
    csrc/chain_sweep.cu; `_device_plan` checks that the two agree): ring |
    tmp, carry | sums | right-hand sides | two mbarriers per stage and two
    for the exchange."""
    w = _up(-(-m // cluster), 4)
    if -(-m // w) != cluster or (reverse and w > MAX_BOX):
        return None  # a block would own nothing, or a box would be too wide
    vlen = _up(m, 4)
    npan = -(-vlen // MAX_BOX)
    pw = _up(-(-vlen // npan), 4)
    rows, row_bytes = (m, 4 * w) if reverse else (w, 4 * npan * pw)
    chunks = max(-(-rows * row_bytes // stage_bytes), -(-rows // MAX_BOX))
    sr = -(-rows // chunks)
    stride = _up(4 * sr * w, 128) if reverse else npan * _up(4 * sr * pw, 128)
    groups = min(consumers // (w // 4), sr) if reverse else 1
    fixed = 4 * (2 * kt * vlen + groups * kt * w + w * kt) + 128 + 16
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // (stride + 16))
    if stages < 2 or groups < 1:
        return None
    smem = stages * (stride + 16) + fixed
    return LaunchPlan(cluster, w, vlen, stages, smem, sr, kt)


def launch_plan(
    chains: int, S: int, m: int, k: int, reverse: bool = False, *,
    max_clusters: Optional[Callable[[int, int], int]] = None,
    consumer_warps: int = CONSUMER_WARPS,
) -> LaunchPlan:
    """How the kernel runs `chains` chains of S steps of m x m blocks with
    k right-hand sides: the largest cluster (up to 16 blocks) for which all
    ``chains x cluster`` blocks are resident in one wave, else the smallest
    one. ``max_clusters(cluster, smem_bytes)`` says how many such clusters
    the card holds at once (the wrapper asks the card's occupancy query);
    the default models one block per SM on 132 SMs. ``consumer_warps`` is
    the built kernel's (`chain_sweep_consumer_warps`). Raises ValueError if
    no plan fits."""
    del S  # the plan does not depend on the chain length
    kt = k_tile(k)
    fits = max_clusters or (lambda c, smem: SMS // c)
    cands, seen = [], set()
    for c in range(MAX_CLUSTER, 0, -1):
        w = _up(-(-m // c), 4)
        ce = -(-m // w)  # blocks that own entries at this width
        if ce in seen:
            continue
        seen.add(ce)
        plan = _geometry(m, kt, reverse, ce, 32 * consumer_warps)
        if plan is not None:
            cands.append(plan)
    if not cands:
        raise ValueError(f"chain_sweep: no launch plan fits m={m}, k={k}")
    for plan in cands:  # largest cluster first
        if fits(plan.cluster, plan.smem_bytes) >= chains:
            return plan
    return cands[-1]


def sweep_factors(a, dtype=torch.float32, pad: Optional[bool] = None):
    """`a` (..., m, m) cast to `dtype` in the layout the kernel streams:
    a view of the same shape whose rows are ``m_pad = ceil(m / 4) * 4``
    floats apart, the padding columns zero, written in one pass. ``pad``
    defaults to whether `a` lies on a CUDA device; CPU tensors keep the
    natural layout."""
    if not (a.is_cuda if pad is None else pad):
        return a.to(dtype)
    m = a.shape[-1]
    buf = torch.empty((*a.shape[:-1], _up(m, 4)), dtype=dtype, device=a.device)
    buf[..., m:].zero_()
    view = buf[..., :m]
    view.copy_(a)
    return view


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


def kernel_stride(J, C) -> int:
    """The row stride the kernel is given for J and C, which it takes as
    (..., S, m, m) stacks of blocks m x ld floats apart whose rows are ld
    floats apart: ld a multiple of 4 (16-byte rows, as TMA asks), the last
    dimension unit-stride, a 16-byte aligned base (`sweep_factors` makes
    this layout). Raises ValueError for anything else."""
    m = J.shape[-1]
    ld = J.stride(-2)
    for name, a in (("J", J), ("C", C)):
        if a.stride(-1) != 1:
            raise ValueError(f"chain_sweep: {name}'s last dimension must be unit-stride")
        if a.stride(-2) % 4 or a.stride(-2) < m:
            raise ValueError(
                f"chain_sweep: {name}'s row stride {a.stride(-2)} is not a multiple "
                f"of 4 floats >= m={m}; make the factors with sweep_factors()"
            )
        if a.stride(-2) != ld:
            raise ValueError("chain_sweep: J and C must share one row stride")
        want = m * ld  # blocks, then chains, densely packed
        for size, stride in zip(reversed(a.shape[:-2]), reversed(a.stride()[:-2])):
            if size > 1 and stride != want:
                raise ValueError(f"chain_sweep: {name}'s blocks must be m x {ld} floats apart")
            want *= size
        if a.data_ptr() % 16:
            raise ValueError(f"chain_sweep: {name} must be 16-byte aligned")
    return ld


_plans: dict = {}


def _device_plan(chains, S, m, k, reverse, lib) -> LaunchPlan:
    """`launch_plan` with the current card's occupancy query, cached. Raises
    if the built kernel lays out a different amount of shared memory for the
    plan than `_geometry` computed (the two formulas have drifted apart)."""
    key = (chains, m, k_tile(k), bool(reverse), torch.cuda.current_device())
    plan = _plans.get(key)
    if plan is None:
        def fits(c, smem):
            n = lib.chain_sweep_max_clusters(c, smem, k, int(bool(reverse)))
            if n < 0:
                raise RuntimeError(f"chain_sweep occupancy query failed: cudaError {-n}")
            return n

        plan = launch_plan(
            chains, S, m, k, reverse, max_clusters=fits,
            consumer_warps=lib.chain_sweep_consumer_warps(),
        )
        smem = lib.chain_sweep_smem_bytes(m, k, int(bool(reverse)), plan.cluster,
                                          plan.width, plan.stage_rows, plan.stages)
        if smem != plan.smem_bytes:
            raise RuntimeError(
                f"chain_sweep: the kernel lays out {smem} bytes of shared memory for "
                f"{plan}, launch_plan computed {plan.smem_bytes}")
        _plans[key] = plan
    return plan


def chain_sweep(J, C, R, reverse: bool = False):
    """One sweep over every chain. J, C: (..., S, m, m) inverse diagonal
    factors and sub-diagonal blocks; R: (..., S, m, k). Forward
    (``reverse=False``): ``out_t = J_t (R_t - C_t out_{t-1})``; backward:
    ``out_t = J_t^T (R_t - C_{t+1}^T out_{t+1})`` over descending t.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream or raise: f32 throughout, R contiguous, J and C in
    the layout of `kernel_stride` (`sweep_factors`)."""
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
    if not R.is_contiguous():
        raise ValueError("chain_sweep: R must be contiguous")
    ld = kernel_stride(J, C)
    out = torch.empty_like(R)
    chains = math.prod(lead)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(R.device):
        plan = _device_plan(chains, S, m, k, reverse, lib)
        stream = torch.cuda.current_stream(R.device).cuda_stream
        err = lib.chain_sweep_f32(
            J.data_ptr(), C.data_ptr(), R.data_ptr(), out.data_ptr(), chains, S,
            m, k, ld, int(bool(reverse)), plan.cluster, plan.width,
            plan.stage_rows, plan.stages, stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_sweep kernel launch failed: cudaError {err}")
    chain_sweep.launches += 1
    by = chain_sweep.launches_by_chains
    by[chains] = by.get(chains, 0) + 1
    flops, nbytes = sweep_work(chains, S, m, k)
    chain_sweep.flops += flops
    chain_sweep.bytes += nbytes
    return out


# launches of the kernel, in all and by the launch's chain count, and the
# work they did (`sweep_work`; `obs.cost` adds it to what the dispatcher
# counts, as the kernel runs outside it)
chain_sweep.launches = 0
chain_sweep.launches_by_chains = {}
chain_sweep.flops = 0
chain_sweep.bytes = 0


def sweep_work(chains: int, S: int, m: int, k: int):
    """``(flops, bytes)`` of one sweep over `chains` chains of `S` steps:
    a product with each of the 2S - 1 factor blocks of a chain it reads
    (neither direction needs C_0), 2 m^2 k flops each; the bytes are those
    blocks, R read once and the output written once, in f32."""
    flops = 2 * (2 * S - 1) * chains * m * m * k
    nbytes = 4 * ((2 * S - 1) * chains * m * m + 2 * chains * S * m * k)
    return flops, nbytes


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
