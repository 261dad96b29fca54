// Dependent latencies of the steps on the tes_chain kernel's critical path,
// measured on the card: `chip_smoke.py`'s plants phase builds this file
// (`dispatches_tpu_torch/_nvcc.py`) and times each op with CUDA events over k
// dependent repetitions, so a repetition's time is the op's latency at the
// card's running clock. Ops 3-5 run the kernel's own code
// (`dispatches_tpu_torch/csrc/tes_chain_step.cuh`).
//
//   op 0: x = d / x                        (an f64 division)
//   op 1: x = d + shfl_xor(x, 1 << (i%5))  (one level of the warp butterfly)
//   op 2: x = x + d                        (an f64 add)
//   op 3: T = newton_step(region 1)        (h_cp + update + clamp, 19.6 MPa, h = d)
//   op 4: T = newton_step(region 2)        (the same with the ideal-gas part, 0.85 MPa)
//   op 5: x = ladder<6>(x, e)              (the power ladder alone, a thread's region-1 |J - 2|)
//   op 6: one bisection step on the plateau (midpoint, weight, residual at T_sat, select)
//   op 7: one round's sign exchange at 31 warps (a sign a warp to shared memory,
//         __syncthreads, the 5-level walk of the tree with those signs)
//
// Ops 0-6 run one warp, op 7 a block of 31. Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "../dispatches_tpu_torch/csrc/tes_chain_step.cuh"

namespace {

using namespace tes;

__global__ void latency_probe_kernel(int op, int k, double d, double* out) {
    __shared__ unsigned char sgn[2][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double x = 1.25;
    if (op == 0) {
#pragma unroll 8
        for (int i = 0; i < k; ++i) x = d / x;
    } else if (op == 1) {
#pragma unroll 5
        for (int i = 0; i < k; ++i) x = d + __shfl_xor_sync(0xffffffffu, x, 1 << (i % 5));
    } else if (op == 2) {
#pragma unroll 8
        for (int i = 0; i < k; ++i) x = x + d;
    } else if (op == 3) {
        Terms t;
        liquid_terms(t, 19.6e6, lane);
        x = 400.0;
#pragma unroll 1
        for (int i = 0; i < k; ++i) x = newton_step<false>(t, d, x, 1386.0, 1.222, 647.0);
    } else if (op == 4) {
        Terms t;
        vapor_terms(t, 8.5e5, lane);
        x = 460.0;
#pragma unroll 1
        for (int i = 0; i < k; ++i) x = newton_step<true>(t, d, x, 540.0, 0.5, 2273.15);
    } else if (op == 5) {
        Terms t;
        liquid_terms(t, 19.6e6, lane);
        const unsigned e = t.e[0] < 0 ? -t.e[0] : t.e[0];
        x = d;
#pragma unroll 4
        for (int i = 0; i < k; ++i) x = ladder<6>(x, e);
    } else if (op == 6) {
        double lo = 1.0e6, hi = 2.0e6, wl = 1.0, wh = 0.0;
#pragma unroll 4
        for (int i = 0; i < k; ++i) {
            const double mid = 0.5 * (lo + hi);
            const double wm = 0.5 * (wl + wh);
            if (mid - d - 0.5 * (500.0 - 450.0) < 0) {
                lo = mid;
                wl = wm;
            } else {
                hi = mid;
                wh = wm;
            }
        }
        x = lo + wl;
    } else {
        double lo = 1.0e6, hi = 2.0e6;
        int buf = 0;
#pragma unroll 1
        for (int i = 0; i < k; ++i) {
            if (lane == 0) sgn[buf][warp] = lo + warp * 1.0e3 - d < 0;
            __syncthreads();
            for (int j = 0, n = 1; j < 5; ++j) {
                const double mid = 0.5 * (lo + hi);
                const bool down = sgn[buf][(n - 1) & 31];
                if (down)
                    lo = mid;
                else
                    hi = mid;
                n = 2 * n + down;
            }
            buf ^= 1;
        }
        x = lo;
    }
    if (warp == 0) out[lane] = x;
}

}  // namespace

extern "C" int latency_probe(int op, int k, double d, double* out, void* stream) {
    latency_probe_kernel<<<1, op == 7 ? 31 * 32 : 32, 0, static_cast<cudaStream_t>(stream)>>>(
        op, k, d, out);
    return static_cast<int>(cudaGetLastError());
}
