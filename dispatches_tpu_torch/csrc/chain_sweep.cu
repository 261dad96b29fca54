// Fused block-bidiagonal sweep chains for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dispatches_tpu/solvers/pallas_sweep.py::
// chain_sweep`. The banded IPM's KKT solves factor a block-tridiagonal
// matrix into inverse diagonal factors J_t = L_t^{-1} and sub-diagonal
// blocks C_t; each solve is then two sweeps over the time blocks:
//
//   forward  (reverse = 0): out_t = J_t   (r_t - C_t     out_{t-1}),  t = 0..S-1
//   backward (reverse = 1): out_t = J_t^T (r_t - C_{t+1}^T out_{t+1}), t = S-1..0
//
// with the carry (out of the previous step) zero at the first step of each
// chain. J and C are read in their natural (D, S, m, m) row-major layout
// for both directions: the backward sweep indexes C_{t+1} itself, so no
// transposed, shifted or time-flipped copy is made per factorization, and m
// is not padded (the TPU kernel pads m to 128 lanes, which multiplies the
// streamed bytes by (mp/m)^2).
//
// Design: one thread block per chain; the step loop runs inside the block;
// the carry and the intermediate (k x m f32 each) live in shared memory.
// A step is two dependent matrix-vector products, so its time is memory
// latency, not bandwidth: the design keeps many independent loads in
// flight and shortens their latency.
//   - Products with the matrix as stored (forward): each warp takes kRows
//     rows at a time and issues kRows x kUnrollN loads before it sums;
//     lanes run along the rows (coalesced), then a shuffle reduction.
//   - Products with its transpose (backward): a thread per output column
//     (coalesced across the warp), the rows split over kSplit thread
//     groups, kUnrollT loads in flight per thread, partial sums combined
//     through shared memory.
//   - The blocks of step t + kAhead are prefetched into L2 while step t
//     computes: they do not depend on the carry.
// The right-hand sides are tiled over k inside the kernel (KT columns at a
// time), so any k runs here. f32 FMA accumulation throughout, never TF32.
//
// Bound: HBM bytes. Each sweep streams the two m x m f32 blocks of every
// step once per k-tile, 2 * S * m^2 * 4 bytes per chain (about 170 MB for a
// year LP: S = 365, m = 241), against 4 * S * m^2 * k flops. With one block
// per chain a batch of 8 chains runs on 8 of 132 SMs, so the kernel stays
// latency-bound far from that bound; splitting a step across a cluster
// (distributed shared memory) and TMA block prefetch are later work.
#include <cuda_runtime.h>

namespace {

// Tuning knobs (compile-time; tools/torch_chain_sweep_tune.py sweeps them)
// Defaults: the fastest set measured at the year shape on an H100 80GB HBM3
// (700 W), tools/torch_chain_sweep_tune.py; see PERF.md.
#ifndef CS_THREADS
#define CS_THREADS 1024
#endif
#ifndef CS_ROWS
#define CS_ROWS 4
#endif
#ifndef CS_UNROLL_N
#define CS_UNROLL_N 4
#endif
#ifndef CS_SPLIT
#define CS_SPLIT 4
#endif
#ifndef CS_UNROLL_T
#define CS_UNROLL_T 16
#endif
#ifndef CS_AHEAD
#define CS_AHEAD 2
#endif
constexpr int kThreads = CS_THREADS;  // a multiple of 32 * CS_SPLIT
constexpr int kRows = CS_ROWS;          // forward: rows per warp pass
constexpr int kUnrollN = CS_UNROLL_N;   // forward: loads in flight per row and lane
constexpr int kSplit = CS_SPLIT;        // backward: row groups per column
constexpr int kUnrollT = CS_UNROLL_T;   // backward: loads in flight per thread
constexpr int kAhead = CS_AHEAD;        // steps prefetched into L2
constexpr int kColsT = kThreads / kSplit;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void prefetch_l2(const float* block, size_t n,
                                            int tid) {
  const char* p = reinterpret_cast<const char*>(block);
  for (size_t off = (size_t)tid * 128; off < n * sizeof(float);
       off += (size_t)kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
}

// Forward product, rows [i0, i0 + kRows) of M (as stored) times v[c][:]:
// acc[r][c] = sum_l M[i0 + r, l] * v[c][l], summed over the warp.
template <int KT>
__device__ __forceinline__ void rows_dot(const float* __restrict__ M, int i0,
                                         const float* v, int m, int lane,
                                         float (&acc)[kRows][KT]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = 0.f;
  for (int l0 = 0; l0 < m; l0 += 32 * kUnrollN) {
    float a[kRows][kUnrollN];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kUnrollN; ++u) {
        const int l = l0 + lane + 32 * u;
        a[r][u] = (i0 + r < m && l < m) ? __ldg(M + (size_t)(i0 + r) * m + l)
                                        : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kUnrollN; ++u) {
      const int l = l0 + lane + 32 * u;
      if (l < m) {
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const float x = v[c * m + l];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(a[r][u], x, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[r][c] = warp_sum(acc[r][c]);
}

// Backward product, column j of M over rows [lo, hi) times v[c][:]:
// acc[c] = sum_{l in [lo, hi)} M[l, j] * v[c][l]  (one thread).
template <int KT>
__device__ __forceinline__ void col_dot(const float* __restrict__ M, int j,
                                        int lo, int hi, const float* v, int m,
                                        float (&acc)[KT]) {
#pragma unroll
  for (int c = 0; c < KT; ++c) acc[c] = 0.f;
  for (int l0 = lo; l0 < hi; l0 += kUnrollT) {
    float a[kUnrollT];
#pragma unroll
    for (int u = 0; u < kUnrollT; ++u)
      a[u] = (l0 + u < hi) ? __ldg(M + (size_t)(l0 + u) * m + j) : 0.f;
#pragma unroll
    for (int u = 0; u < kUnrollT; ++u) {
      if (l0 + u < hi) {
#pragma unroll
        for (int c = 0; c < KT; ++c)
          acc[c] = fmaf(a[u], v[c * m + l0 + u], acc[c]);
      }
    }
  }
}

// dst[c][i] = (base ? base[i][c] : 0) + sign * (M v)[c][i]  (forward form)
template <int KT>
__device__ __forceinline__ void forward_product(
    const float* __restrict__ M, const float* v, float* dst,
    const float* __restrict__ base, float sign, float* __restrict__ out,
    int m, int k, int kt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * kRows; i0 < m; i0 += (kThreads / 32) * kRows) {
    float acc[kRows][KT];
    rows_dot<KT>(M, i0, v, m, lane, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (lane == r && i < m) {
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          const float b = (base && c < kt) ? base[(size_t)i * k + c] : 0.f;
          const float y = b + sign * acc[r][c];
          dst[c * m + i] = y;
          if (out && c < kt) out[(size_t)i * k + c] = y;
        }
      }
    }
  }
}

// The same with the transpose of M (backward form); `part` is kSplit x KT x m
// shared scratch. Ends with a barrier.
template <int KT>
__device__ __forceinline__ void backward_product(
    const float* __restrict__ M, const float* v, float* dst, float* part,
    const float* __restrict__ base, float sign, float* __restrict__ out,
    int m, int k, int kt) {
  const int g = threadIdx.x / kColsT, jt = threadIdx.x % kColsT;
  const int span = (m + kSplit - 1) / kSplit;
  const int lo = g * span, hi = min(m, lo + span);
  for (int j = jt; j < m; j += kColsT) {
    float acc[KT];
    col_dot<KT>(M, j, lo, hi, v, m, acc);
#pragma unroll
    for (int c = 0; c < KT; ++c) part[(g * KT + c) * m + j] = acc[c];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float s = 0.f;
#pragma unroll
      for (int gg = 0; gg < kSplit; ++gg) s += part[(gg * KT + c) * m + j];
      const float b = (base && c < kt) ? base[(size_t)j * k + c] : 0.f;
      const float y = b + sign * s;
      dst[c * m + j] = y;
      if (out && c < kt) out[(size_t)j * k + c] = y;
    }
  }
  __syncthreads();
}

// One kernel per direction, so that each gets its own register allocation.
template <int KT, bool REVERSE>
__global__ void __launch_bounds__(kThreads)
chain_sweep_kernel(const float* __restrict__ J, const float* __restrict__ C,
                   const float* __restrict__ R, float* __restrict__ out,
                   int S, int m, int k) {
  extern __shared__ float smem[];
  float* carry = smem;               // [KT][m]: out of the previous step
  float* tmp = smem + KT * m;        // [KT][m]: r_t minus the coupling term
  float* part = smem + 2 * KT * m;   // [kSplit][KT][m]: backward partial sums

  const size_t mm = (size_t)m * m;
  const size_t chain = blockIdx.x;
  const float* Jc = J + chain * S * mm;
  const float* Cc = C + chain * S * mm;
  const float* Rc = R + chain * S * (size_t)m * k;
  float* Oc = out + chain * S * (size_t)m * k;
  const int tid = threadIdx.x;

  for (int k0 = 0; k0 < k; k0 += KT) {
    const int kt = min(KT, k - k0);
    for (int s = 0; s < kAhead && s < S; ++s) {
      const int t = REVERSE ? S - 1 - s : s;
      prefetch_l2(Jc + (size_t)t * mm, mm, tid);
      prefetch_l2(Cc + (size_t)t * mm, mm, tid);
    }
    for (int step = 0; step < S; ++step) {
      const int t = REVERSE ? S - 1 - step : step;
      const float* Rt = Rc + (size_t)t * m * k + k0;
      float* Ot = Oc + (size_t)t * m * k + k0;
      const float* Jt = Jc + (size_t)t * mm;
      if (step + kAhead < S) {
        const int ta = REVERSE ? t - kAhead : t + kAhead;
        prefetch_l2(Jc + (size_t)ta * mm, mm, tid);
        // forward reads C_ta; backward reads C_{ta+1}
        prefetch_l2(Cc + (size_t)(REVERSE ? ta + 1 : ta) * mm, mm, tid);
      }

      // phase A: tmp = r_t - coupling(carry); no coupling at a chain start
      if (step == 0) {
        for (int i = tid; i < m; i += kThreads) {
#pragma unroll
          for (int c = 0; c < KT; ++c)
            tmp[c * m + i] = c < kt ? Rt[(size_t)i * k + c] : 0.f;
        }
        __syncthreads();
      } else if constexpr (!REVERSE) {
        forward_product<KT>(Cc + (size_t)t * mm, carry, tmp, Rt, -1.f,
                            nullptr, m, k, kt);
        __syncthreads();
      } else {
        backward_product<KT>(Cc + (size_t)(t + 1) * mm, carry, tmp, part, Rt,
                             -1.f, nullptr, m, k, kt);
      }

      // phase B: carry = J_t tmp (forward) or J_t^T tmp (backward)
      if constexpr (!REVERSE) {
        forward_product<KT>(Jt, tmp, carry, nullptr, 1.f, Ot, m, k, kt);
        __syncthreads();
      } else {
        backward_product<KT>(Jt, tmp, carry, part, nullptr, 1.f, Ot, m, k, kt);
      }
    }
  }
}

template <int KT>
cudaError_t launch(const float* J, const float* C, const float* R, float* out,
                   long long chains, int S, int m, int k, int reverse,
                   cudaStream_t stream) {
  const size_t smem = (2 + kSplit) * (size_t)KT * m * sizeof(float);
  auto kernel = reverse ? chain_sweep_kernel<KT, true> : chain_sweep_kernel<KT, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)chains, kThreads, smem, stream>>>(J, C, R, out, S, m, k);
  return cudaGetLastError();
}

}  // namespace

// J, C: (chains, S, m, m); R, out: (chains, S, m, k); all contiguous f32 on
// the device. Launches on `stream`, allocates nothing, does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int chain_sweep_f32(const float* J, const float* C, const float* R,
                               float* out, long long chains, int S, int m,
                               int k, int reverse, void* stream) {
  if (chains <= 0 || S <= 0 || m <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 1)
    e = launch<1>(J, C, R, out, chains, S, m, k, reverse, s);
  else if (k <= 2)
    e = launch<2>(J, C, R, out, chains, S, m, k, reverse, s);
  else if (k <= 4)
    e = launch<4>(J, C, R, out, chains, S, m, k, reverse, s);
  else
    e = launch<8>(J, C, R, out, chains, S, m, k, reverse, s);
  return static_cast<int>(e);
}
