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
// the plateau T_sat between h_f and h_g, else NEWTON_ITERS (12) Newton steps of
// the region-1 (from 400 K) or region-2 (from max(T_sat + 10, 300) K) Gibbs
// form. It writes the segment's outlet enthalpy h_out and the weight `a`,
// the coefficient of the segment's inlet in h_out as an affine mix of the two
// starting endpoints (the gradient of the bisection, whose predicate carries
// none; 1/2 at a tie of h_in and h_eq, the even split of min/max).
//
// What bounds it: latency. Each lane is one dependent chain of
// segs x bisect_iters x NEWTON_ITERS Newton steps (20 x 48 x 12 = 11,520 at
// the reference geometry); it moves a few KB and does ~10^7 flops.
// `chip_smoke.py` (plants (c)) holds its time against that chain's latency
// bound, from the dependent latencies `tools/latency_probe.cu` measures. Design:
// one warp per lane; the IF97 sums (34 terms in region 1, 43 + 9 in
// region 2) are spread over the warp's 32 threads (at most two residual
// terms and one ideal-gas term a thread), with the pressure-only factors
// n J pi^I hoisted into registers once per lane and integer powers taken by
// repeated squaring, not pow(). The two sums of a step are reduced by an
// xor-butterfly of shuffles: floating-point addition is commutative, so
// every thread ends with the same bits and the scalar Newton/bisection
// state stays identical (and warp-uniform) across the warp.
//
// Plain C interface, loaded with ctypes (dispatches_tpu_torch/units/concrete_tes.py).

#include <cuda_runtime.h>

namespace {

constexpr double R_WATER = 461.526;
constexpr int NEWTON_ITERS = 12;  // `temperature_ph_fn(P, iters=12)`
constexpr int N_R1 = 34;
constexpr int N_R2 = 43;
constexpr int N_R0 = 9;

__constant__ int I1[N_R1] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                             2, 2, 3, 3, 3, 4, 4, 4, 5, 8, 8, 21, 23, 29, 30, 31, 32};
__constant__ int J1[N_R1] = {-2, -1, 0, 1, 2, 3, 4, 5, -9, -7, -1, 0, 1, 3, -3, 0, 1,
                             3, 17, -4, 0, 6, -5, -2, 10, -8, -11, -6, -29, -31, -38,
                             -39, -40, -41};
__constant__ double N1[N_R1] = {
    0.14632971213167, -0.84548187169114, -0.37563603672040e1,
    0.33855169168385e1, -0.95791963387872, 0.15772038513228,
    -0.16616417199501e-1, 0.81214629983568e-3, 0.28319080123804e-3,
    -0.60706301565874e-3, -0.18990068218419e-1, -0.32529748770505e-1,
    -0.21841717175414e-1, -0.52838357969930e-4, -0.47184321073267e-3,
    -0.30001780793026e-3, 0.47661393906987e-4, -0.44141845330846e-5,
    -0.72694996297594e-15, -0.31679644845054e-4, -0.28270797985312e-5,
    -0.85205128120103e-9, -0.22425281908000e-5, -0.65171222895601e-6,
    -0.14341729937924e-12, -0.40516996860117e-6, -0.12734301741641e-8,
    -0.17424871230634e-9, -0.68762131295531e-18, 0.14478307828521e-19,
    0.26335781662795e-22, -0.11947622640071e-22, 0.18228094581404e-23,
    -0.93537087292458e-25};

__constant__ int J0[N_R0] = {0, 1, -5, -4, -3, -2, -1, 2, 3};
__constant__ double N0[N_R0] = {
    -0.96927686500217e1, 0.10086655968018e2, -0.56087911283020e-2,
    0.71452738081455e-1, -0.40710498223928, 0.14240819171444e1,
    -0.43839511319450e1, -0.28408632460772, 0.21268463753307e-1};

__constant__ int I2[N_R2] = {1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 5, 6, 6, 6,
                             7, 7, 7, 8, 8, 9, 10, 10, 10, 16, 16, 18, 20, 20, 20, 21, 22,
                             23, 24, 24, 24};
__constant__ int J2[N_R2] = {0, 1, 2, 3, 6, 1, 2, 4, 7, 36, 0, 1, 3, 6, 35, 1, 2, 3, 7, 3, 16,
                             35, 0, 11, 25, 8, 36, 13, 4, 10, 14, 29, 50, 57, 20, 35, 48, 21,
                             53, 39, 26, 40, 58};
__constant__ double N2[N_R2] = {
    -0.17731742473213e-2, -0.17834862292358e-1, -0.45996013696365e-1,
    -0.57581259083432e-1, -0.50325278727930e-1, -0.33032641670203e-4,
    -0.18948987516315e-3, -0.39392777243355e-2, -0.43797295650573e-1,
    -0.26674547914087e-4, 0.20481737692309e-7, 0.43870667284435e-6,
    -0.32277677238570e-4, -0.15033924542148e-2, -0.40668253562649e-1,
    -0.78847309559367e-9, 0.12790717852285e-7, 0.48225372718507e-6,
    0.22922076337661e-5, -0.16714766451061e-10, -0.21171472321355e-2,
    -0.23895741934104e2, -0.59059564324270e-17, -0.12621808899101e-5,
    -0.38946842435739e-1, 0.11256211360459e-10, -0.82311340897998e1,
    0.19809712802088e-7, 0.10406965210174e-18, -0.10234747095929e-12,
    -0.10018179379511e-8, -0.80882908646985e-10, 0.10693031879409,
    -0.33662250574171, 0.89185845355421e-24, 0.30629316876232e-12,
    -0.42002467698208e-5, -0.59056029685639e-25, 0.37826947613457e-5,
    -0.12768608934681e-14, 0.73087610595061e-28, 0.55414715350778e-16,
    -0.94369707241210e-6};

// x^n for an integer n (negative n through 1/x), by repeated squaring
__device__ __forceinline__ double ipow(double x, int n) {
    double base = n < 0 ? 1.0 / x : x;
    unsigned e = n < 0 ? -n : n;
    double r = 1.0;
    while (e) {
        if (e & 1u) r *= base;
        base *= base;
        e >>= 1;
    }
    return r;
}

// sum over the warp; every thread ends with the same bits
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// One thread's share of the IF97 tau-derivative sums: up to two terms of a
// residual part (coefficients with the pressure factor folded in, exponent
// J - 2) and, in region 2, one ideal-gas term.
struct Terms {
    double c1[2], c2[2];  // n J pi^I, n J (J - 1) pi^I
    int e[2];             // J - 2
    double k1, k2;        // ideal part: n0 J0, n0 J0 (J0 - 1) (region 2 only)
    int e0;               // J0 - 2
};

__device__ void liquid_terms(Terms& t, double P, int lane) {
    double a = 7.1 - P / 16.53e6;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int k = lane + 32 * r;
        if (k < N_R1) {
            double aI = ipow(a, I1[k]);
            t.c1[r] = N1[k] * J1[k] * aI;
            t.c2[r] = N1[k] * J1[k] * (J1[k] - 1) * aI;
            t.e[r] = J1[k] - 2;
        } else {
            t.c1[r] = t.c2[r] = 0.0;
            t.e[r] = 0;
        }
    }
    t.k1 = t.k2 = 0.0;
    t.e0 = 0;
}

__device__ void vapor_terms(Terms& t, double P, int lane) {
    double pi = P / 1e6;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int k = lane + 32 * r;
        if (k < N_R2) {
            double pI = ipow(pi, I2[k]);
            t.c1[r] = N2[k] * J2[k] * pI;
            t.c2[r] = N2[k] * J2[k] * (J2[k] - 1) * pI;
            t.e[r] = J2[k] - 2;
        } else {
            t.c1[r] = t.c2[r] = 0.0;
            t.e[r] = 0;
        }
    }
    int j = lane - (N_R2 - 32);  // threads 11..19 take the ideal-gas terms
    if (j >= 0 && j < N_R0) {
        t.k1 = N0[j] * J0[j];
        t.k2 = N0[j] * J0[j] * (J0[j] - 1);
        t.e0 = J0[j] - 2;
    } else {
        t.k1 = t.k2 = 0.0;
        t.e0 = 0;
    }
}

// (h, cp) at T: tau = tstar / T, residual base b = tau - shift
__device__ __forceinline__ void h_cp(const Terms& t, double T, double tstar, double shift,
                                     double& h, double& cp) {
    double tau = tstar / T;
    double b = tau - shift;
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        double bJ2 = ipow(b, t.e[r]);
        s1 += t.c1[r] * (bJ2 * b);
        s2 += t.c2[r] * bJ2;
    }
    double tJ2 = ipow(tau, t.e0);
    s1 += t.k1 * (tJ2 * tau);
    s2 += t.k2 * tJ2;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    h = R_WATER * T * tau * s1;
    cp = -R_WATER * tau * tau * s2;
}

__device__ double newton(const Terms& t, double h_target, double T, double tstar,
                         double shift, double t_max) {
#pragma unroll 1
    for (int i = 0; i < NEWTON_ITERS; ++i) {
        double h, cp;
        h_cp(t, T, tstar, shift, h, cp);
        T = fmin(fmax(T - (h - h_target) / cp, 273.16), t_max);
    }
    return T;
}

__global__ void tes_chain_kernel(const double* __restrict__ t_wall,
                                 const double* __restrict__ h_eq,
                                 const double* __restrict__ par,
                                 double* __restrict__ h_out, double* __restrict__ a_out,
                                 int segs, int bisect_iters) {
    const int lane_id = blockIdx.x;
    const int lane = threadIdx.x;
    const double* p = par + 6 * lane_id;  // h_in0, c, P, T_sat, h_f, h_g
    const double c = p[1], P = p[2], Tsat = p[3], hf = p[4], hg = p[5];
    Terms liq, vap;
    liquid_terms(liq, P, lane);
    vapor_terms(vap, P, lane);
    const double T0_vap = fmax(Tsat + 10.0, 300.0);

    double h_in = p[0];
    for (int s = 0; s < segs; ++s) {
        const double tw = t_wall[lane_id * segs + s];
        const double he = h_eq[lane_id * segs + s];
        double lo = fmin(h_in, he), hi = fmax(h_in, he);
        double wl = 1.0, wh = 0.0;  // coefficients of the starting lo in lo, hi
        for (int it = 0; it < bisect_iters; ++it) {
            const double mid = 0.5 * (lo + hi);
            const double wm = 0.5 * (wl + wh);
            double T;
            if (mid <= hf)
                T = newton(liq, mid, 400.0, 1386.0, 1.222, 647.0);
            else if (mid >= hg)
                T = newton(vap, mid, T0_vap, 540.0, 0.5, 2273.15);
            else
                T = Tsat;
            const double f = mid - h_in - c * (tw - T);
            if (f < 0) {
                lo = mid;
                wl = wm;
            } else {
                hi = mid;
                wh = wm;
            }
        }
        const double ho = 0.5 * (lo + hi);
        const double w = 0.5 * (wl + wh);
        if (lane == 0) {
            h_out[lane_id * segs + s] = ho;
            a_out[lane_id * segs + s] = h_in < he ? w : (h_in > he ? 1.0 - w : 0.5);
        }
        h_in = ho;
    }
}

}  // namespace

extern "C" int tes_chain_f64(const double* t_wall, const double* h_eq, const double* par,
                             double* h_out, double* a, int lanes, int segs,
                             int bisect_iters, void* stream) {
    if (lanes <= 0 || segs <= 0) return 0;
    tes_chain_kernel<<<lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        t_wall, h_eq, par, h_out, a, segs, bisect_iters);
    return static_cast<int>(cudaGetLastError());
}
