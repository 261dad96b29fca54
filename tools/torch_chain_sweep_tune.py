#!/usr/bin/env python3
"""Time variants of the chain-sweep CUDA kernel on the card.

Builds `dispatches_tpu_torch/csrc/chain_sweep.cu` once per consumer-warp
count (the CS_CONSUMER_WARPS macro), all builds in parallel, and times each
build's forward and backward sweep under every launch plan the card's
occupancy query allows (cluster sizes whose blocks are resident in one
wave) and several ring-stage sizes, at the main-path shapes (40 chains of
72 steps, m = 241) and the one-chain year shape (8 x 365), k = 1 and 3.
When ``dispatches_tpu_torch/_build/chain_sweep_prev.cu`` is present (an
earlier version of the kernel with the older interface: one block per
chain on the natural layout), it is built and timed in the same turns as
variant ``prev``. Every timing is a median over rounds of
CUDA-event timings after a warm-up, each variant checked against the plain
PyTorch version. Prints one line per row and writes the table to ``--out``.

    python3 tools/torch_chain_sweep_tune.py --out chain_sweep_tune.json
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARPS = (4, 8, 16)
STAGE_BYTES = (16384, 32768, 65536)
SHAPES = [(40, 72, 241, 1), (40, 72, 241, 3), (8, 365, 241, 1), (8, 365, 241, 3)]
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build(src, out, macros, nvcc):
    cmd = [nvcc, *FLAGS, *[f"-D{k}={v}" for k, v in macros.items()], "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{out}: nvcc failed\n{proc.stderr}")
    return [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln]


def warm_up(torch, seconds=3.0):
    """Keep the card busy so that its clocks are up before timing."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--shapes", default=None, help="e.g. 40x72x241x1,8x365x241x3")
    ap.add_argument("--out", default="chain_sweep_tune.json")
    args = ap.parse_args()

    import torch

    from chip_smoke import bound_ms
    from dispatches_tpu_torch.solvers import chain_sweep as cs
    from dispatches_tpu_torch.solvers.structured import _block_chol

    shapes = SHAPES if not args.shapes else [
        tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    out_dir = cs._BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {f"w{w}": (str(cs._SRC), str(out_dir / f"libchain_sweep_tune_w{w}.so"),
                      {"CS_CONSUMER_WARPS": w}) for w in WARPS}
    prev = out_dir / "chain_sweep_prev.cu"
    if prev.exists():
        jobs["prev"] = (str(prev), str(out_dir / "libchain_sweep_tune_prev.so"), {})
    with ThreadPoolExecutor(len(jobs)) as pool:
        ptx = dict(zip(jobs, pool.map(lambda j: build(*j, cs._nvcc()), jobs.values())))
    libs = {}
    for name, (_, path, _) in jobs.items():
        print(f"[build] {name}: {ptx[name]}", flush=True)
        if name == "prev":
            lib = ctypes.CDLL(path)
            lib.chain_sweep_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
                [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.chain_sweep_f32.restype = ctypes.c_int
        else:
            lib = cs.bind(path)
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    warm_up(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    rows = []
    for D, S, m, k in shapes:
        M1 = torch.randn(D, S, m, m, device="cuda", generator=gen)
        Ds = M1 @ M1.transpose(-1, -2) + m * torch.eye(m, device="cuda")
        Es = 0.3 * torch.randn(D, S, m, m, device="cuda", generator=gen)
        Es[:, 0] = 0.0
        J, C = _block_chol(Ds, Es, inv=True)
        del M1, Ds, Es
        Jp, Cp = cs.sweep_factors(J), cs.sweep_factors(C)
        R = torch.randn(D, S, m, k, device="cuda", generator=gen)
        bound = bound_ms(D, S, m, k)[0]
        for reverse in (0, 1):
            ref = cs._sweep_plain(J, C, R, bool(reverse))
            runs = {}
            for name, lib in libs.items():
                if name == "prev":
                    out = torch.empty_like(R)
                    runs[name] = (lambda lib=lib, out=out: lib.chain_sweep_f32(
                        J.data_ptr(), C.data_ptr(), R.data_ptr(), out.data_ptr(), D, S, m, k,
                        reverse, torch.cuda.current_stream().cuda_stream), out, None)
                    continue
                consumers = 32 * lib.chain_sweep_consumer_warps()
                for sb in STAGE_BYTES:
                    for c in range(cs.MAX_CLUSTER, 0, -1):
                        plan = cs._geometry(m, cs.k_tile(k), reverse, c, consumers, sb)
                        if plan is None:
                            continue
                        n_fit = lib.chain_sweep_max_clusters(c, plan.smem_bytes, k, reverse)
                        print(f"[occupancy] {name} {(D, S, m, k)} reverse={reverse} "
                              f"stage {sb}: cluster {plan.cluster} x {n_fit} resident",
                              flush=True)
                        if n_fit < D:
                            continue
                        out = torch.empty_like(R)
                        key = f"{name}_c{plan.cluster}_sb{sb}"
                        runs[key] = (lambda lib=lib, out=out, plan=plan: lib.chain_sweep_f32(
                            Jp.data_ptr(), Cp.data_ptr(), R.data_ptr(), out.data_ptr(), D, S,
                            m, k, Jp.stride(-2), reverse, plan.cluster, plan.width,
                            plan.stage_rows, plan.stages,
                            torch.cuda.current_stream().cuda_stream), out, plan)
            times = {n: [] for n in runs}
            for n, (fn, _, _) in runs.items():  # first call: compile paths, errors
                err = fn()
                if err:
                    raise RuntimeError(f"{n} at {(D, S, m, k)}: cudaError {err}")
            torch.cuda.synchronize()
            for _ in range(args.rounds):
                for n, (fn, _, _) in runs.items():
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(args.reps):
                        fn()
                    stop.record()
                    torch.cuda.synchronize()
                    times[n].append(start.elapsed_time(stop) / args.reps)
            for n, (_, out, plan) in runs.items():
                err = float((out - ref).abs().max())
                ms = float(np.median(times[n]))
                row = dict(variant=n, shape=[D, S, m, k], reverse=reverse, ms=ms,
                           bound_ms=bound, share_of_bound=bound / ms,
                           max_abs_err=err, ok=err <= 1e-4 * float(ref.abs().max()),
                           plan=plan._asdict() if plan else None)
                rows.append(row)
                print(json.dumps({k_: v for k_, v in row.items() if k_ != "plan"}),
                      flush=True)
            del runs, ref
        del J, C, Jp, Cp, R
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi.strip(), "ptxas": ptx, "rows": rows}, f, indent=1)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        print(f"[tune] {len(bad)} rows disagree with the plain version", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
