// Dependent latencies of the f64 steps on the tes_chain kernel's critical
// path, measured on the card: `chip_smoke.py`'s plants phase builds this
// file (`dispatches_tpu_torch/_nvcc.py`) and times each op with CUDA events
// over k dependent repetitions in one warp, so a repetition's time is the
// op's latency at the card's running clock.
//
//   op 0: x = d / x                       (an f64 division)
//   op 1: x = d + shfl_xor(x, 1 << (i%5))  (one level of the warp butterfly)
//   op 2: x = x + d                       (an f64 add)
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void latency_probe_kernel(int op, int k, double d, double* out) {
    double x = 1.25;
    if (op == 0) {
#pragma unroll 8
        for (int i = 0; i < k; ++i) x = d / x;
    } else if (op == 1) {
#pragma unroll 5
        for (int i = 0; i < k; ++i) x = d + __shfl_xor_sync(0xffffffffu, x, 1 << (i % 5));
    } else {
#pragma unroll 8
        for (int i = 0; i < k; ++i) x = x + d;
    }
    out[threadIdx.x] = x;
}

}  // namespace

extern "C" int latency_probe(int op, int k, double d, double* out, void* stream) {
    latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(op, k, d, out);
    return static_cast<int>(cudaGetLastError());
}
