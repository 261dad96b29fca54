#!/usr/bin/env python3
"""Time compile-time variants of the chain-sweep CUDA kernel on the card.

Builds `dispatches_tpu_torch/csrc/chain_sweep.cu` once per variant (the
CS_* macros at the top of the source), all builds in parallel, then times
every variant's forward and backward sweep at the year shape (8 chains of
365 steps, m = 241, k = 1 and 3) with CUDA events, each checked against
the plain PyTorch version. Prints one line per variant and shape and writes
the table to ``--out``.

    python3 tools/torch_chain_sweep_tune.py --out chain_sweep_tune.json
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "default": {},
    "t1024_split4": {"CS_THREADS": 1024, "CS_SPLIT": 4},
    "t1024_split4_ahead1": {"CS_THREADS": 1024, "CS_SPLIT": 4, "CS_AHEAD": 1},
    "t1024_split4_ahead3": {"CS_THREADS": 1024, "CS_SPLIT": 4, "CS_AHEAD": 3},
    "t1024_split4_rows2": {"CS_THREADS": 1024, "CS_SPLIT": 4, "CS_ROWS": 2},
    "t1024_split4_unrollN4": {"CS_THREADS": 1024, "CS_SPLIT": 4, "CS_UNROLL_N": 4},
    "t1024_split8_unrollT8": {"CS_THREADS": 1024, "CS_SPLIT": 8, "CS_UNROLL_T": 8},
    "t768_split3": {"CS_THREADS": 768, "CS_SPLIT": 3},
}
SHAPES = [(8, 365, 241, 1), (8, 365, 241, 3)]


def build(name, macros, src, out_dir, nvcc):
    out = os.path.join(out_dir, f"libchain_sweep_tune_{name}.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *[f"-D{k}={v}" for k, v in macros.items()], "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    spills = [ln.strip() for ln in proc.stderr.splitlines() if "spill" in ln]
    return out, spills


def warm_up(torch, seconds=3.0):
    """Keep the card busy so that its clocks are up before timing."""
    import time

    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="chain_sweep_tune.json")
    args = ap.parse_args()

    import torch

    from dispatches_tpu_torch.solvers import chain_sweep as cs
    from dispatches_tpu_torch.solvers.structured import _block_chol

    names = args.variants.split(",")
    out_dir = os.path.join(os.path.dirname(cs._SRC), "..", "_build")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build(n, VARIANTS[n], str(cs._SRC), out_dir, cs._nvcc()), names
        )))
    fns = {}
    for n, (path, spills) in built.items():
        fn = ctypes.CDLL(path).chain_sweep_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[n] = fn
        print(f"[build] {n}: {spills}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    warm_up(torch)
    rows = []
    for D, S, m, k in SHAPES:
        M1 = torch.randn(D, S, m, m, device="cuda", generator=gen)
        Ds = M1 @ M1.transpose(-1, -2) + m * torch.eye(m, device="cuda")
        Es = 0.3 * torch.randn(D, S, m, m, device="cuda", generator=gen)
        J, C = _block_chol(Ds, Es, inv=True)
        R = torch.randn(D, S, m, k, device="cuda", generator=gen)
        for reverse in (0, 1):
            ref = cs._sweep_plain(J, C, R, bool(reverse))
            outs = {n: torch.empty_like(R) for n in names}

            def run(n):
                err = fns[n](J.data_ptr(), C.data_ptr(), R.data_ptr(), outs[n].data_ptr(),
                             D, S, m, k, reverse, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{n}: cudaError {err}")

            times = {n: [] for n in names}
            for _ in range(args.rounds):
                for n in names:
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.reps):
                        run(n)
                    stop.record()
                    torch.cuda.synchronize()
                    times[n].append(start.elapsed_time(stop) / args.reps)
            for n in names:
                err = float((outs[n] - ref).abs().max())
                row = dict(variant=n, shape=[D, S, m, k], reverse=reverse,
                           ms=float(np.median(times[n])), ms_rounds=times[n],
                           max_abs_err=err, ok=err <= 1e-4 * float(ref.abs().max()))
                rows.append(row)
                print(json.dumps({k_: v for k_, v in row.items() if k_ != "ms_rounds"}),
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "variants": VARIANTS,
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
