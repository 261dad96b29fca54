// The IF97 Newton step of the tube-side chain kernel (csrc/tes_chain.cu),
// shared with `tools/latency_probe.cu`, which times it on the card as the
// kernel runs it.
//
// T(P, h) off the two-phase plateau is NEWTON_ITERS (12) Newton steps of the
// region-1 or region-2 Gibbs form, as `properties/steam.py::temperature_ph_fn`.
// A step's IF97 tau-derivative sums (34 terms in region 1, 43 + 9 in region 2)
// are spread over a warp's 32 threads (at most two residual terms and one
// ideal-gas term a thread), with the pressure-only factors n J pi^I hoisted
// into `Terms` once per lane. The two sums are reduced by an interleaved
// xor-butterfly of shuffles: floating-point addition is commutative, so every
// thread ends with the same bits and the Newton state stays identical (and
// warp-uniform) across the warp.
//
// A step's dependent path: tau = T*/T, b = tau - shift, 1/b (one reciprocal a
// thread, shared by its terms), a fixed six-step square-and-multiply ladder
// per term, the products, the 5-level butterfly, h and cp, and the update
// T - (h - h_target)/cp with its clamp. The ladder's multiplies are those of a
// loop that stops at the exponent's top bit, predicated instead of branched
// on, so the powers keep their bits.

#pragma once

#include <cuda_runtime.h>

namespace tes {

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

// base^e for 0 <= e < 2^BITS: a square-and-multiply ladder of BITS fixed
// steps, each multiply of r predicated on its bit of e
template <int BITS>
__device__ __forceinline__ double ladder(double base, unsigned e) {
    double r = 1.0;
#pragma unroll
    for (int k = 0; k < BITS; ++k) {
        r = (e >> k) & 1u ? r * base : r;
        base *= base;
    }
    return r;
}

// x^n for an integer n (negative n through 1/x), by repeated squaring
__device__ __forceinline__ double ipow(double x, int n) {
    return ladder<6>(n < 0 ? 1.0 / x : x, n < 0 ? -n : n);
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

// (h, cp) at T: tau = tstar / T, residual base b = tau - shift. IDEAL adds
// region 2's ideal-gas part; region 1's Terms hold none (k1 = k2 = 0, whose
// products would add +0 to each sum).
template <bool IDEAL>
__device__ __forceinline__ void h_cp(const Terms& t, double T, double tstar, double shift,
                                     double& h, double& cp) {
    const double tau = tstar / T;
    const double b = tau - shift;
    const double rb = 1.0 / b;
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const double bJ2 = ladder<6>(t.e[r] < 0 ? rb : b, t.e[r] < 0 ? -t.e[r] : t.e[r]);
        s1 += t.c1[r] * (bJ2 * b);
        s2 += t.c2[r] * bJ2;
    }
    if (IDEAL) {  // |J0 - 2| <= 7: three bits
        const double tJ2 = t.e0 < 0 ? ladder<3>(1.0 / tau, -t.e0) : ladder<3>(tau, t.e0);
        s1 += t.k1 * (tJ2 * tau);
        s2 += t.k2 * tJ2;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {  // the two butterflies, interleaved
        const double o1 = __shfl_xor_sync(0xffffffffu, s1, m);
        const double o2 = __shfl_xor_sync(0xffffffffu, s2, m);
        s1 += o1;
        s2 += o2;
    }
    h = R_WATER * T * tau * s1;
    cp = -R_WATER * tau * tau * s2;
}

// one Newton step of T toward h(P, T) = h_target, clamped to [273.16, t_max]
template <bool IDEAL>
__device__ __forceinline__ double newton_step(const Terms& t, double h_target, double T,
                                              double tstar, double shift, double t_max) {
    double h, cp;
    h_cp<IDEAL>(t, T, tstar, shift, h, cp);
    return fmin(fmax(T - (h - h_target) / cp, 273.16), t_max);
}

// T(P, h) in region 1 (from 400 K) and region 2 (from T0, max(T_sat + 10, 300) K)
__device__ __forceinline__ double t_liquid(const Terms& t, double h) {
    double T = 400.0;
#pragma unroll 1
    for (int i = 0; i < NEWTON_ITERS; ++i) T = newton_step<false>(t, h, T, 1386.0, 1.222, 647.0);
    return T;
}

__device__ __forceinline__ double t_vapor(const Terms& t, double h, double T0) {
    double T = T0;
#pragma unroll 1
    for (int i = 0; i < NEWTON_ITERS; ++i) T = newton_step<true>(t, h, T, 540.0, 0.5, 2273.15);
    return T;
}

}  // namespace tes
