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
// chain. Both directions read J and C as stored; the backward sweep indexes
// C_{t+1} itself, so nothing is transposed, shifted or flipped.
//
// Bound: HBM bytes. A sweep streams the two m x m f32 blocks of every step
// once per k-tile (about 1.34 GB for 40 chains of 72 steps at m = 241)
// against 4 m^2 k flops a step: one flop per byte at k = 1, so tensor cores
// buy nothing; f32 FMA accumulation throughout, never TF32.
//
// Design. Only the two matrix-vector products of a step depend on the
// carry; the factor blocks do not, so they stream ahead as far as shared
// memory allows, and a step's work is spread over a cluster of SMs:
//   - One thread-block cluster per chain. Block `rank` owns the output
//     entries [rank * w, rank * w + w): forward it reads those rows of C_t
//     and J_t, backward those columns of C_{t+1} and J_t, so no partial sum
//     crosses blocks. The cluster size and w come from the caller's launch
//     plan (`solvers/chain_sweep.py::launch_plan`), which takes the largest
//     cluster whose blocks are resident in one wave.
//   - A ring of shared-memory stages fed by TMA. One producer thread copies
//     the block's tiles of steps t, t+1, ... in chunks of `stage_rows` rows
//     (`cp.async.bulk.tensor.2d` over the (chains*S*m, m) view of a factor
//     stack whose rows are `ld` floats apart), one mbarrier per stage; the
//     consumer warps compute from shared memory and release each stage.
//     The tensor map's column extent is m, so padding columns are never
//     read (TMA fills what lies beyond with zeros).
//   - The carry is exchanged in distributed shared memory. Every block keeps
//     a full copy of the intermediate `tmp` and of the carry (KT x m f32).
//     After each product a block pushes its slice into every peer's copy
//     with `st.async`, which completes bytes on the receiver's mbarrier;
//     a block goes on once its copy holds all m entries. Each product thus
//     ends in one wait on a local barrier, and the producer warp never takes
//     part in step synchronisation.
// The right-hand sides are tiled over k inside the kernel (KT columns at a
// time), so any k runs; their next step is prefetched with `cp.async`.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// Consumer warps per block (compile-time; tools/torch_chain_sweep_tune.py
// sweeps it). The launch plan reads it through chain_sweep_consumer_warps().
#ifndef CS_CONSUMER_WARPS
#define CS_CONSUMER_WARPS 8
#endif
constexpr int kConsumerWarps = CS_CONSUMER_WARPS;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxSmem = 232448;           // per block on sm_90
constexpr int kMaxCluster = 16;            // non-portable cluster size limit
constexpr int kMaxBox = 256;               // TMA box extent limit

struct Params {
  CUtensorMap tmJ;  // (chains*S*m rows, m cols) views, rows `ld` floats apart
  CUtensorMap tmC;
  const float* R;   // (chains, S, m, k) contiguous
  float* out;       // (chains, S, m, k) contiguous
  int S, m, k;
  int vlen;          // row length of the tmp / carry copies: m rounded up to 4
  int w;             // output entries per block (a multiple of 4)
  int sr;            // rows per ring stage
  int ns;            // ring depth (stages)
  int npan, pw;      // forward: column panels per stage and their width
  int groups;        // backward: row groups per column quad
  int pan_stride;    // forward: bytes between panels (a multiple of 128)
  int stage_bytes;   // bytes one stage's copies deliver (its expect-tx count)
  int stage_stride;  // bytes between stages (a multiple of 128)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;"
               ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase differs from `parity` (CTA scope: the ring).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// The same with cluster-scope acquire: the exchange, fed by peers' st.async.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 4 bytes into a cluster peer's shared memory, completing on its mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(dst), "l"(src)
               : "memory");
}

// One kernel per direction, so that each gets its own register allocation.
template <int KT, bool REVERSE>
__global__ void __launch_bounds__(kThreads, 1)
chain_sweep_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  // layout: ring | tmp | carry | res | rbuf | barriers (sized by `geometry`)
  float* ring = reinterpret_cast<float*>(base);
  float* tmp = reinterpret_cast<float*>(base + (size_t)p.ns * p.stage_stride);
  float* carry = tmp + KT * p.vlen;
  float* res = carry + KT * p.vlen;  // product sums [groups][KT][w]
  float* rbuf = res + p.groups * KT * p.w;  // right-hand sides [w][KT]
  uint64_t* full = reinterpret_cast<uint64_t*>(rbuf + p.w * KT);
  uint64_t* empty = full + p.ns;
  uint64_t* xbar = empty + p.ns;  // [0]: tmp complete, [1]: carry complete

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank(), ncl = cluster_blocks();
  const long long chain = cluster_id();
  const int S = p.S, m = p.m, k = p.k, sr = p.sr;
  const int o0 = rank * p.w;                       // first owned output entry
  const int own = max(0, min(p.w, m - o0));        // owned output entries
  const int tile_rows = REVERSE ? m : own;         // factor rows a tile holds
  const int nch = (tile_rows + sr - 1) / sr;       // stages per tile

  if (tid == 0) {
    for (int i = 0; i < p.ns; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), kConsumerWarps);
    }
    mbar_init(smem_u32(xbar), 1);
    mbar_init(smem_u32(xbar + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * KT * p.vlen; i += kThreads) tmp[i] = 0.f;
  cluster_sync();  // peers' barriers and copies are ready before any st.async

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumers) {
      int seq = 0;
      for (int k0 = 0; k0 < k; k0 += KT) {
        for (int s = 0; s < S; ++s) {
          const int t = REVERSE ? S - 1 - s : s;
          for (int mat = (s == 0 ? 1 : 0); mat < 2; ++mat) {  // C (not at s = 0), J
            const CUtensorMap* tm = mat == 0 ? &p.tmC : &p.tmJ;
            const int blk = (mat == 0 && REVERSE) ? t + 1 : t;
            const int row0 = (int)((chain * S + blk) * m) + (REVERSE ? 0 : o0);
            for (int ch = 0; ch < nch; ++ch, ++seq) {
              const int slot = seq % p.ns;
              mbar_wait(smem_u32(empty + slot), ((seq / p.ns) & 1) ^ 1);
              const uint32_t fb = smem_u32(full + slot);
              mbar_expect_tx(fb, p.stage_bytes);
              const uint32_t dst = smem_u32(ring) + slot * p.stage_stride;
              if (REVERSE) {
                tma_load_2d(dst, tm, fb, o0, row0 + ch * sr);
              } else {
                for (int pan = 0; pan < p.npan; ++pan)
                  tma_load_2d(dst + pan * p.pan_stride, tm, fb, pan * p.pw,
                              row0 + ch * sr);
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    const int warp = tid >> 5, lane = tid & 31;
    const int nq = p.w / 4;  // backward: column quads
    const int g = tid / nq, q = tid % nq;
    const bool active = !REVERSE || g < p.groups;
    // Entries e = r * KT + c this block finishes: `tpe` threads (a power of
    // two, lanes of one warp) share each, summing the row groups' partials
    // and sending the value to the cluster's blocks between them.
    const int nent = own * KT;
    int tpe = 1;
    while (tpe < 32 && tpe * 2 <= max(p.groups, (int)ncl) && tpe * 2 * nent <= kConsumers)
      tpe *= 2;
    const int slots = kConsumers / tpe, sub = tid % tpe, e_of = tid / tpe;
    int seq = 0;
    uint32_t par_tmp = 0, par_carry = 0;

    // R entries of step s (k-tile k0) into rbuf, by the threads that read them
    auto prefetch_r = [&](int k0, int s) {
      const int t = REVERSE ? S - 1 - s : s;
      const float* Rt = p.R + (((size_t)chain * S + t) * m + o0) * k + k0;
      if (sub == 0) {
        for (int e = e_of; e < nent; e += slots) {
          const int r = e / KT, c = e % KT;
          if (k0 + c < k) cp_async4(smem_u32(rbuf + e), Rt + (size_t)r * k + c);
          else rbuf[e] = 0.f;
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };

    // forward: this lane's float4s of the input vector, kept in registers
    constexpr bool kCacheX = KT <= 4;
    const int hl = lane & 15;
    float4 xv[4][kCacheX ? KT : 1];
    auto load_x = [&](const float* vin, int pan, int n4) {
      if constexpr (kCacheX) {
        const float4* v = reinterpret_cast<const float4*>(vin + pan * p.pw);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < KT; ++c)
            xv[u][c] = hl + 16 * u < n4 ? v[c * (p.vlen / 4) + hl + 16 * u]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };

    // One product of the block's tile of a factor block with `vin`, over
    // nch ring stages; the sums land in `res`.
    auto product = [&](const float* vin) {
      float acc[4][KT];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < KT; ++c) acc[j][c] = 0.f;
      for (int ch = 0; ch < nch; ++ch, ++seq) {
        const int slot = seq % p.ns;
        mbar_wait(smem_u32(full + slot), (seq / p.ns) & 1);
        const float* st = ring + (size_t)slot * (p.stage_stride / 4);
        const int valid = min(sr, tile_rows - ch * sr);
        if (!REVERSE) {
          // half a warp per row, two rows per warp at a time; lane hl takes
          // the row's float4s hl, hl + 16, hl + 32, hl + 48 of each panel
          // (a panel is at most 64 float4s), then a 4-step shuffle sum
          for (int pan = 0; pan < p.npan; ++pan) {
            const int n4 = min(p.pw, p.vlen - pan * p.pw) / 4;
            if (ch == 0 || p.npan > 1) load_x(vin, pan, n4);
            for (int r0 = 2 * warp; r0 < valid; r0 += 2 * kConsumerWarps) {
              const int rl = r0 + (lane >> 4);
              const float4* row = reinterpret_cast<const float4*>(
                  st + pan * (p.pan_stride / 4) + rl * p.pw);
              float a4[KT];
#pragma unroll
              for (int c = 0; c < KT; ++c) a4[c] = 0.f;
              if (rl < valid) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int f = hl + 16 * u;
                  if (f < n4) {
                    const float4 a = row[f];
#pragma unroll
                    for (int c = 0; c < KT; ++c) {
                      const float4 x = kCacheX ? xv[u][kCacheX ? c : 0]
                          : reinterpret_cast<const float4*>(vin + pan * p.pw)[c * (p.vlen / 4) + f];
                      a4[c] = fmaf(a.x, x.x, a4[c]);
                      a4[c] = fmaf(a.y, x.y, a4[c]);
                      a4[c] = fmaf(a.z, x.z, a4[c]);
                      a4[c] = fmaf(a.w, x.w, a4[c]);
                    }
                  }
                }
              }
#pragma unroll
              for (int c = 0; c < KT; ++c)
#pragma unroll
                for (int o = 8; o > 0; o >>= 1) a4[c] += __shfl_xor_sync(0xffffffffu, a4[c], o);
              if (hl == 0 && rl < valid) {
#pragma unroll
                for (int c = 0; c < KT; ++c) {
                  float* dst = res + c * p.w + ch * sr + rl;
                  *dst = pan == 0 ? a4[c] : *dst + a4[c];
                }
              }
            }
          }
        } else if (active) {
          // a thread per column quad and row group; rows of the stage split
          // over the groups
          for (int rl = g; rl < valid; rl += p.groups) {
            const float4 a = *reinterpret_cast<const float4*>(st + rl * p.w + 4 * q);
            const int l = ch * sr + rl;
#pragma unroll
            for (int c = 0; c < KT; ++c) {
              const float x = vin[c * p.vlen + l];
              acc[0][c] = fmaf(a.x, x, acc[0][c]);
              acc[1][c] = fmaf(a.y, x, acc[1][c]);
              acc[2][c] = fmaf(a.z, x, acc[2][c]);
              acc[3][c] = fmaf(a.w, x, acc[3][c]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(empty + slot));
      }
      if (REVERSE && active) {
#pragma unroll
        for (int c = 0; c < KT; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) res[(g * KT + c) * p.w + 4 * q + j] = acc[j][c];
      }
    };

    // Finish every owned entry: value = base + sign * (sum of the groups'
    // partials), into every block's copy of `vec` (and the first `kv`
    // columns into `outp`); `base` is the prefetched right-hand side (phase
    // A) or none (phase B). The loop's trip count is the same for all
    // lanes, as the shuffles need.
    auto finish = [&](float* vec, uint32_t bar, bool with_r, bool with_sum,
                      float* outp, int kv) {
      for (int e0 = 0; e0 < nent; e0 += slots) {
        const int e = e0 + e_of;
        const bool live = e < nent;
        const int r = e / KT, c = e % KT;
        float v = 0.f;
        if (live && with_sum)
          for (int gg = sub; gg < p.groups; gg += tpe) v -= res[(gg * KT + c) * p.w + r];
        if (!with_r) v = -v;
        else if (live && sub == 0) v += rbuf[e];
        for (int o = tpe / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (live) {
          if (outp && sub == 0 && c < kv) outp[(size_t)r * k + c] = v;
          const uint32_t a = smem_u32(vec + c * p.vlen + o0 + r);
          for (uint32_t b = sub; b < ncl; b += tpe)
            st_async(map_rank(a, b), v, map_rank(bar, b));
        }
      }
    };

    const uint32_t bar_tmp = smem_u32(xbar), bar_carry = smem_u32(xbar + 1);
    const uint32_t vec_bytes = KT * m * 4;  // what each copy receives per product
    prefetch_r(0, 0);
    for (int k0 = 0; k0 < k; k0 += KT) {
      for (int s = 0; s < S; ++s) {
        const int t = REVERSE ? S - 1 - s : s;
        // phase A: tmp = r_t - coupling(carry); no coupling at a chain start
        if (tid == 0) mbar_expect_tx(bar_tmp, vec_bytes);
        if (s > 0) product(carry);
        consumers_sync();
        asm volatile("cp.async.wait_all;" ::: "memory");
        finish(tmp, bar_tmp, true, s > 0, nullptr, 0);
        if (s + 1 < S) prefetch_r(k0, s + 1);
        else if (k0 + KT < k) prefetch_r(k0 + KT, 0);
        mbar_wait_cluster(bar_tmp, par_tmp);
        par_tmp ^= 1;

        // phase B: carry = J_t tmp (forward) or J_t^T tmp (backward)
        if (tid == 0) mbar_expect_tx(bar_carry, vec_bytes);
        product(tmp);
        consumers_sync();
        finish(carry, bar_carry, false, true,
               p.out + (((size_t)chain * S + t) * m + o0) * k + k0, k - k0);
        mbar_wait_cluster(bar_carry, par_carry);
        par_carry ^= 1;
      }
    }
  }
  cluster_sync();  // no block leaves while a peer may still write into it
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool make_map(CUtensorMap* tm, const float* base, long long rows, int m, int ld,
              int box_cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)m, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Derived geometry of a plan; false if it is not one the kernel takes.
// solvers/chain_sweep.py::_geometry computes the same shared-memory size,
// and the wrapper checks the two against each other through
// chain_sweep_smem_bytes before a plan's first launch.
bool geometry(Params& p, int kt, int reverse, int cluster, int width,
              int stage_rows, int stages, size_t* smem) {
  const int m = p.m;
  if (cluster < 1 || cluster > kMaxCluster || width < 4 || width % 4 ||
      (long long)cluster * width < m || (long long)(cluster - 1) * width >= m ||
      stage_rows < 1 || stage_rows > kMaxBox || stages < 1)
    return false;
  if (reverse && width > kMaxBox) return false;
  p.vlen = round_up(m, 4);
  p.w = width;
  p.sr = stage_rows;
  p.ns = stages;
  p.npan = (p.vlen + kMaxBox - 1) / kMaxBox;
  p.pw = round_up((p.vlen + p.npan - 1) / p.npan, 4);
  p.groups = reverse ? min(kConsumers / (width / 4), stage_rows) : 1;
  p.pan_stride = round_up(4 * stage_rows * p.pw, 128);
  p.stage_bytes = 4 * stage_rows * (reverse ? width : p.npan * p.pw);
  p.stage_stride = reverse ? round_up(p.stage_bytes, 128) : p.npan * p.pan_stride;
  const size_t res = (size_t)p.groups * kt * width;
  *smem = (size_t)stages * p.stage_stride +
          4 * (2 * (size_t)kt * p.vlen + res + (size_t)width * kt) +
          8 * (2 * (size_t)stages + 2) + 128;
  return *smem <= (size_t)kMaxSmem;
}

// The kernel instance, its attributes set once per device (they do not
// change between launches).
template <int KT, bool REVERSE>
cudaError_t prepare(const void** fn) {
  static std::atomic<uint64_t> ready{0};  // a bit per device
  auto kernel = chain_sweep_kernel<KT, REVERSE>;
  *fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit && (ready.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return e;
}

cudaError_t kernel_for(int kt, int reverse, const void** fn) {
  switch (kt * 2 + (reverse ? 1 : 0)) {
    case 2: return prepare<1, false>(fn);
    case 3: return prepare<1, true>(fn);
    case 4: return prepare<2, false>(fn);
    case 5: return prepare<2, true>(fn);
    case 8: return prepare<4, false>(fn);
    case 9: return prepare<4, true>(fn);
    case 16: return prepare<8, false>(fn);
    case 17: return prepare<8, true>(fn);
    default: return cudaErrorInvalidValue;
  }
}

int k_tile(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : 8; }

cudaLaunchConfig_t config(long long chains, int cluster, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(chains * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int chain_sweep_consumer_warps() { return kConsumerWarps; }

// Dynamic shared memory the kernel lays out for a plan, or -1 if it does
// not take the plan (arguments as chain_sweep_f32's).
extern "C" int chain_sweep_smem_bytes(int m, int k, int reverse, int cluster, int width,
                                      int stage_rows, int stages) {
  if (m <= 0 || k <= 0) return -1;
  Params p;
  p.m = m;
  size_t smem = 0;
  return geometry(p, k_tile(k), reverse, cluster, width, stage_rows, stages, &smem)
             ? (int)smem : -1;
}

// How many clusters of `cluster` blocks with `smem` bytes of dynamic shared
// memory each fit on the current device at once (negative: -cudaError_t).
extern "C" int chain_sweep_max_clusters(int cluster, int smem, int k, int reverse) {
  const void* fn;
  cudaError_t e = kernel_for(k_tile(k), reverse, &fn);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(1, cluster, smem, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// J, C: (chains, S, m, m) f32 on the device whose rows are `ld` floats apart
// (ld a multiple of 4, >= m; blocks m * ld floats apart; 16-byte aligned
// base); R, out: (chains, S, m, k) contiguous f32. The plan (cluster size,
// entries per block, rows per stage, ring depth) is launch_plan's.
// Launches on `stream`, allocates nothing, does not synchronise. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a layout or plan the
// kernel does not take).
extern "C" int chain_sweep_f32(const float* J, const float* C, const float* R,
                               float* out, long long chains, int S, int m, int k,
                               int ld, int reverse, int cluster, int width,
                               int stage_rows, int stages, void* stream) {
  if (chains <= 0 || S <= 0 || m <= 0 || k <= 0) return 0;
  if (ld < m || ld % 4 || reinterpret_cast<uintptr_t>(J) % 16 ||
      reinterpret_cast<uintptr_t>(C) % 16 || chains * S * (long long)m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int kt = k_tile(k);
  Params p;
  p.R = R;
  p.out = out;
  p.S = S;
  p.m = m;
  p.k = k;
  size_t smem = 0;
  if (!geometry(p, kt, reverse, cluster, width, stage_rows, stages, &smem))
    return (int)cudaErrorInvalidValue;
  const long long rows = chains * S * (long long)m;
  const int box_cols = reverse ? width : p.pw;
  if (!make_map(&p.tmJ, J, rows, m, ld, box_cols, stage_rows) ||
      !make_map(&p.tmC, C, rows, m, ld, box_cols, stage_rows))
    return (int)cudaErrorInvalidValue;
  const void* fn;
  cudaError_t e = kernel_for(kt, reverse, &fn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(chains, cluster, smem,
                                  static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
