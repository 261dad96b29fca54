// Tube-side chain of the concrete thermal store: CUDA kernel for sm_90a.
//
// Replaces no TPU kernel. The JAX package runs this chain as a `lax.scan`
// over the tube's segments (`dispatches_tpu/units/concrete_tes.py`,
// `tube_side_profile`) that XLA compiles into one program; run eagerly in
// PyTorch it would be ~10^7 small launches an hour. This kernel is the
// sequential part only: for each lane (one side of one store) it walks the
// segments in the order it is given and, for each segment, runs the
// fixed-count bisection of
//
//     f(h) = h - h_in - c (t_wall - T(P, h)),   bracket [min(h_in, h_eq), max(h_in, h_eq)]
//
// where T(P, h) is the IF97 inversion of `properties/steam.py::temperature_ph_fn`:
// the plateau T_sat between h_f and h_g, else 12 Newton steps of the region-1
// (from 400 K) or region-2 (from max(T_sat + 10, 300) K) Gibbs form
// (`tes_chain_step.cuh`). It writes the segment's outlet enthalpy h_out and
// the weight `a`, the coefficient of the segment's inlet in h_out as an affine
// mix of the two starting endpoints (the gradient of the bisection, whose
// predicate carries none; 1/2 at a tie of h_in and h_eq, the even split of
// min/max).
//
// What bounds it: latency. It moves ~1.4 KB and does ~10^8 flops, and each
// lane is one dependent chain: segment after segment, halving after halving,
// each halving off the plateau 12 dependent Newton steps.
//
// Design: a midpoint tree per round. After m halvings from a bracket (lo, hi)
// the candidate midpoints form a fixed binary tree: the root 0.5 (lo + hi),
// each child 0.5 (l + r) of the two endpoints its path leaves it. So a round
// evaluates f at all 2^m - 1 tree points at once, a warp a point (each warp
// walks the path bits of its node to its bracket with the serial loop's own
// expressions), writes the signs to shared memory, and then every thread walks
// the tree with the signs, applying m halvings (and the weights' `0.5 (wl +
// wh)`) exactly as the serial loop would. Every point goes through the same
// Newton code, so the outlets and weights are bitwise those of the serial
// bisection, in any m: `levels` = 1 with one warp is the serial algorithm.
// A segment takes ceil(bisect_iters / m) rounds (8 at m = 6, not 48), each one
// dependent Newton chain long; segments stay sequential (h_in = the previous
// h_out). The region choice is warp-uniform (a point a warp), so points on
// both sides of h_f / h_g do not diverge inside a warp. The per-thread IF97
// factors (`Terms`) of both regions are computed once a block into shared
// memory, and a warp loads its point's region only.
//
// What sets a round's time on the card: with more than ~8 warps an SM, the
// step's ~200 instructions a warp (f64 arithmetic, selects, shuffles) share
// the SM's issue slots; on an H100 a round's Newton step takes ~0.54 us at one
// warp, ~0.73 us at 8 warps a block and ~0.93 us at 16 (`chip_smoke.py`
// plants (c), each levels timed; PERF.md §6). So a lane's points are spread over
// a thread-block cluster of the fewest blocks (1, 2, 4 or 8) that leaves at
// most 8 warps a block, each block on its own SM: each warp writes its sign
// into every block's shared memory (distributed shared memory), and one
// cluster barrier (release / acquire) a round makes them visible. At m = 6,
// 8 blocks of 8 warps. One block (m <= 3) uses a block barrier, no cluster.
//
// Tensor cores do not apply: a round's IF97 sums are a product with two output
// columns in f64, too small for DMMA. TMA does not apply either: the kernel
// reads ~1 KB and writes ~0.6 KB.
//
// Plain C interface, loaded with ctypes (dispatches_tpu_torch/units/concrete_tes.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tes_chain_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tes;

constexpr int MAX_LEVELS = 7;
constexpr int MAX_POINTS = (1 << MAX_LEVELS) - 1;

// One region's Terms for the 32 thread positions of a warp, as arrays
// (conflict-free loads: thread i reads entry i).
struct TermTable {
    double c1[2][32], c2[2][32], k1[32], k2[32];
    int e[2][32], e0[32];

    __device__ void store(const Terms& t, int i) {
        for (int r = 0; r < 2; ++r) {
            c1[r][i] = t.c1[r];
            c2[r][i] = t.c2[r];
            e[r][i] = t.e[r];
        }
        k1[i] = t.k1;
        k2[i] = t.k2;
        e0[i] = t.e0;
    }

    __device__ Terms load(int i) const {
        Terms t;
        for (int r = 0; r < 2; ++r) {
            t.c1[r] = c1[r][i];
            t.c2[r] = c2[r][i];
            t.e[r] = e[r][i];
        }
        t.k1 = k1[i];
        t.k2 = k2[i];
        t.e0 = e0[i];
        return t;
    }
};

// at most 16 warps a block, so a thread may keep 128 registers (at 32 warps,
// 64 spill)
__global__ void __launch_bounds__(512, 1)
tes_chain_kernel(const double* __restrict__ t_wall, const double* __restrict__ h_eq,
                 const double* __restrict__ par, double* __restrict__ h_out,
                 double* __restrict__ a_out, int segs, int bisect_iters, int levels,
                 int blocks) {
    __shared__ TermTable table[2];                    // [0] region 1, [1] region 2
    __shared__ unsigned char neg[2][MAX_POINTS + 1];  // a round's signs, double-buffered

    // a lane's `blocks` blocks are one cluster (consecutive blocks); its warps
    // share the tree's points, and each sign goes to every block of the cluster
    const int lane_id = blockIdx.x / blocks;
    const int rank = blockIdx.x % blocks;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const int lane_warp = rank * warps + warp;
    const double* p = par + 6 * lane_id;  // h_in0, c, P, T_sat, h_f, h_g
    const double c = p[1], P = p[2], Tsat = p[3], hf = p[4], hg = p[5];
    if (warp == 0) {
        Terms t;
        liquid_terms(t, P, lane);
        table[0].store(t, lane);
        vapor_terms(t, P, lane);
        table[1].store(t, lane);
    }
    // a block's shared memory takes remote signs only once the whole cluster runs
    if (blocks > 1)
        cg::this_cluster().sync();
    else
        __syncthreads();
    const double T0_vap = fmax(Tsat + 10.0, 300.0);
    const double* tw_lane = t_wall + lane_id * segs;
    const double* he_lane = h_eq + lane_id * segs;

    double h_in = p[0];
    double tw = tw_lane[0], he = he_lane[0];
    int buf = 0;
    for (int s = 0; s < segs; ++s) {
        // the next segment's inputs, read while this one runs
        const double tw_next = s + 1 < segs ? tw_lane[s + 1] : 0.0;
        const double he_next = s + 1 < segs ? he_lane[s + 1] : 0.0;
        double lo = fmin(h_in, he), hi = fmax(h_in, he);
        double wl = 1.0, wh = 0.0;  // coefficients of the starting lo in lo, hi
        for (int it = 0; it < bisect_iters; it += levels) {
            const int depth = min(levels, bisect_iters - it);
            const int points = (1 << depth) - 1;
            // f at the round's tree points, a warp a point: node n = q + 1 in
            // heap order, the bits of n below its top bit its path (1: the
            // right half)
            const int q = lane_warp;
            if (q < points) {
                const int n = q + 1;
                double l = lo, r = hi;
                for (int k = 30 - __clz(n); k >= 0; --k) {
                    const double mid = 0.5 * (l + r);
                    if ((n >> k) & 1)
                        l = mid;
                    else
                        r = mid;
                }
                const double mid = 0.5 * (l + r);
                double T;
                if (mid <= hf)
                    T = t_liquid(table[0].load(lane), mid);
                else if (mid >= hg)
                    T = t_vapor(table[1].load(lane), mid, T0_vap);
                else
                    T = Tsat;
                const double f = mid - h_in - c * (tw - T);
                if (lane == 0) {
                    if (blocks > 1) {
                        cg::cluster_group cluster = cg::this_cluster();
                        for (int b = 0; b < blocks; ++b)
                            *cluster.map_shared_rank(&neg[buf][q], b) = f < 0;
                    } else {
                        neg[buf][q] = f < 0;
                    }
                }
            }
            if (blocks > 1)
                cg::this_cluster().sync();  // release / acquire: the remote signs land
            else
                __syncthreads();
            // the serial loop's halvings, with the signs of the round
            for (int k = 0, n = 1; k < depth; ++k) {
                const double mid = 0.5 * (lo + hi);
                const double wm = 0.5 * (wl + wh);
                const bool down = neg[buf][n - 1];
                if (down) {
                    lo = mid;
                    wl = wm;
                } else {
                    hi = mid;
                    wh = wm;
                }
                n = 2 * n + down;
            }
            buf ^= 1;  // the next round writes the other buffer: one barrier a round
        }
        const double ho = 0.5 * (lo + hi);
        const double w = 0.5 * (wl + wh);
        if (rank == 0 && threadIdx.x == 0) {
            h_out[lane_id * segs + s] = ho;
            a_out[lane_id * segs + s] = h_in < he ? w : (h_in > he ? 1.0 - w : 0.5);
        }
        h_in = ho;
        tw = tw_next;
        he = he_next;
    }
}

}  // namespace

// levels (m): halvings a round, 1..7. A lane's 2^m - 1 points take a cluster
// of the fewest blocks (1, 2, 4 or 8) that leaves at most 8 warps a block
// (16 at m = 7): a Newton step keeps its pace up to ~8 warps an SM.
extern "C" int tes_chain_f64(const double* t_wall, const double* h_eq, const double* par,
                             double* h_out, double* a, int lanes, int segs, int bisect_iters,
                             int levels, void* stream) {
    if (levels < 1 || levels > MAX_LEVELS || bisect_iters < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (lanes <= 0 || segs <= 0) return 0;
    const int points = (1 << levels) - 1;
    int blocks = 1;
    while (blocks < 8 && 8 * blocks < points) blocks *= 2;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(lanes * blocks);
    cfg.blockDim = dim3(32 * ((points + blocks - 1) / blocks));
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = blocks > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, tes_chain_kernel, t_wall, h_eq, par, h_out,
                                               a, segs, bisect_iters, levels, blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
