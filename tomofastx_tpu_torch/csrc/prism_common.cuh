// Device functions shared by kernel B2 (prism_matvec.cuh, the per-cell
// matrix-free operator) and kernel B3 (lattice_matvec.cu, the corner-lattice
// one): the physics families, the field, the armored logarithms and wrapped
// arc tangents of ops/prism.py, the magnetic tensor's combination with the
// field, and the Gauss-Legendre quadrature of the far cells. ops/_cuda_build.py
// hashes this header with each source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace {

// Physics families and modes (ops/prism_matvec.py and ops/lattice_matvec.py:
// GZ .. MAG, CLOSED, BLEND).
enum Family { GZ = 0, GZZ = 1, FTG = 2, MAG = 3 };
enum Mode { CLOSED = 0, BLEND = 1 };

// CASE(FAM, NMC, NDC) for each (family, model components, data components)
// the kernels are built for: g_z, Gzz, FTG-6, and the susceptibility or the
// magnetization vector against TMI or three components.
#define FOR_EACH_FAMILY(CASE) \
    CASE(GZ, 1, 1) CASE(GZZ, 1, 1) CASE(FTG, 1, 6) CASE(MAG, 1, 1) CASE(MAG, 1, 3) CASE(MAG, 3, 1) CASE(MAG, 3, 3)

constexpr double G_GRAV = 6.674e-11;
constexpr double TWO_PI = 6.283185307179586;      // 2 * math.pi
constexpr double GL2_NODE = 0.5773502691896258;   // 1.0 / math.sqrt(3.0)
constexpr double GL3_NODE = 0.7745966692414834;   // math.sqrt(3.0 / 5.0)
constexpr double GL3_W_OUT = 5.0 / 9.0;
constexpr double GL3_W_MID = 8.0 / 9.0;

struct Field {
    double m0, m1, m2;  // direction cosines of the field (magv)
    double s4pi;        // scale / (4 pi): the intensity, or mu0 * 1e9 for a magnetization vector
    int handle_inside;  // the 6-subprism borehole branch (kernel B2 only)
};

template <typename U>
struct Tensor3 {  // sharmbox's rows: t[0] = (txx, txy, txz), t[1] = (tyx, tyy, tyz), t[2] = (tzx, tzy, tzz)
    U t[3][3];
};

template <typename T>
__device__ __forceinline__ T at(const void* p, int i) {
    return __ldg(static_cast<const T*>(p) + i);
}

// ---------------------------------------------------------------- helpers (ops/prism.py)

// Products and sums rounded one at a time, never contracted into a fused
// multiply-add: each as PyTorch's elementwise kernels round it, so that a
// potential whose terms cancel comes out as the plain version's does.
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }

// a*a + b*b (+ c*c), rounded as written.
template <typename U>
__device__ __forceinline__ U sq2(U a, U b) {
    return rn_add(rn_mul(a, a), rn_mul(b, b));
}
template <typename U>
__device__ __forceinline__ U sq3(U a, U b, U c) {
    return rn_add(sq2(a, b), rn_mul(c, c));
}

// a0*b0 + a1*b1 + a2*b2, rounded as written.
template <typename U>
__device__ __forceinline__ U dot3(U a0, U b0, U a1, U b1, U a2, U b2) {
    return rn_add(rn_add(rn_mul(a0, b0), rn_mul(a1, b1)), rn_mul(a2, b2));
}

template <typename U>
__device__ __forceinline__ U wrap_atan2(U y, U x) {
    const U a = atan2(y, x);
    return a < U(0) ? a + U(TWO_PI) : a;
}

template <typename U>
__device__ __forceinline__ U wrap_neg_atan2(U y, U x) {
    const U v = -atan2(y, x);
    return v < U(0) ? v + U(TWO_PI) : v;
}

// log(Rs + t): the literal form in double, the cancellation-armored one in
// float (ops/prism.py _log_R_plus).
__device__ __forceinline__ double log_R_plus(double Rs, double t, double) { return log(Rs + t); }
__device__ __forceinline__ float log_R_plus(float Rs, float t, float o2) {
    return logf(t < 0.0f ? o2 / (Rs - t) : Rs + t);
}

// 0.5 * log((Rs - t) / (Rs + t)) (ops/prism.py _half_log_ratio).
__device__ __forceinline__ double half_log_ratio(double Rs, double t, double) {
    return 0.5 * log((Rs - t) / (Rs + t));
}
__device__ __forceinline__ float half_log_ratio(float Rs, float t, float o2) {
    const float big = t < 0.0f ? Rs - t : Rs + t;
    const float ratio = t < 0.0f ? big * big / o2 : o2 / (big * big);
    return 0.5f * logf(ratio);
}

// combine_mag_tensor: the susceptibility or magnetization-vector x TMI or
// three-component rows of a tensor (magnetic_field.f90:118-297), rounded as
// written.
template <typename U, int NMC, int NDC>
__device__ __forceinline__ void combine(const Tensor3<U>& T3, const Field& f, U row[NMC][NDC]) {
    const U m0 = U(f.m0), m1 = U(f.m1), m2 = U(f.m2), s = U(f.s4pi);
    const U(&tx)[3] = T3.t[0];
    const U(&ty)[3] = T3.t[1];
    const U(&tz)[3] = T3.t[2];
    if constexpr (NMC == 1) {
        const U mx = dot3(tx[0], m0, tx[1], m1, tx[2], m2);
        const U my = dot3(ty[0], m0, ty[1], m1, ty[2], m2);
        const U mz = dot3(tz[0], m0, tz[1], m1, tz[2], m2);
        if constexpr (NDC == 1) {
            row[0][0] = dot3(mx, m0, my, m1, mz, m2) * s;
        } else {
            row[0][0] = mx * s;
            row[0][1] = my * s;
            row[0][2] = mz * s;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            if constexpr (NDC == 1) {
                row[k][0] = dot3(tx[k], m0, ty[k], m1, tz[k], m2) * s;
            } else {
                row[k][0] = tx[k] * s;
                row[k][1] = ty[k] * s;
                row[k][2] = tz[k] * s;
            }
        }
    }
}

// ---------------------------------------------------------------- the Gauss-Legendre rules (float)

// 1/sqrt(x) on the special function unit without rsqrtf's fix-up for a
// denormal x (PTX rsqrt.approx.ftz): the same value for every normal x, and a
// quadrature point's squared distance is never denormal. (A host
// compilation takes rsqrtf.)
__device__ __forceinline__ float rsqrt_ftz(float x) {
#ifdef __CUDA_ARCH__
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
#else
    return rsqrtf(x);
#endif
}

// x^2 + y^2 of each pair of an O-point rule's x and y offsets.
template <int O>
__device__ __forceinline__ void square_sums(const float (&px)[O], const float (&py)[O], float (&xy)[O][O]) {
#pragma unroll
    for (int iu = 0; iu < O; ++iu)
#pragma unroll
        for (int iv = 0; iv < O; ++iv) xy[iu][iv] = px[iu] * px[iu] + py[iv] * py[iv];
}

// _quad_accumulate with the family's point function over an O^3 rule, in
// float: px, py, pz the O source points' offsets from the observation along
// each axis (source - observation), xy their square_sums, w1 the rule's 1-D
// weights, vol8 the cell's volume / 8; the row of a far pair.
template <int FAM, int NMC, int NDC, int O>
__device__ __forceinline__ void quad_points(const float (&px)[O], const float (&py)[O], const float (&pz)[O],
                                            const float (&xy)[O][O], const double (&w1)[O], float vol8,
                                            const Field& f, float row[NMC][NDC]) {
    constexpr int NOUT = FAM == GZ || FAM == GZZ ? 1 : 6;
    float acc[NOUT];
#pragma unroll
    for (int o = 0; o < NOUT; ++o) acc[o] = 0.0f;
#pragma unroll
    for (int iu = 0; iu < O; ++iu)
#pragma unroll
        for (int iv = 0; iv < O; ++iv)
#pragma unroll
            for (int iw = 0; iw < O; ++iw) {
                const float x = px[iu], y = py[iv], z = pz[iw];
                const float wgt = float(w1[iu] * w1[iv] * w1[iw]);
                const float r2 = xy[iu][iv] + z * z;
                const float ir = rsqrt_ftz(r2);
                if constexpr (FAM == GZ) {
                    acc[0] = acc[0] + wgt * (z * (ir * ir * ir));
                } else {
                    const float ir2 = ir * ir;
                    const float ir5 = ir2 * ir2 * ir;
                    if constexpr (FAM == GZZ) {
                        acc[0] = acc[0] + wgt * ((3.0f * z * z - r2) * ir5);
                    } else {
                        acc[0] = acc[0] + wgt * ((3.0f * x * x - r2) * ir5);
                        acc[1] = acc[1] + wgt * ((3.0f * y * y - r2) * ir5);
                        acc[2] = acc[2] + wgt * ((3.0f * z * z - r2) * ir5);
                        acc[3] = acc[3] + wgt * (3.0f * x * y * ir5);
                        acc[4] = acc[4] + wgt * (3.0f * y * z * ir5);
                        acc[5] = acc[5] + wgt * (3.0f * x * z * ir5);
                    }
                }
            }
    if constexpr (FAM == GZ || FAM == GZZ) {
        row[0][0] = float(G_GRAV) * (acc[0] * vol8);
    } else if constexpr (FAM == FTG) {
#pragma unroll
        for (int o = 0; o < 6; ++o) row[0][o] = float(G_GRAV) * (acc[o] * vol8);
    } else {
        // (xx, yy, zz, xy, yz, zx) -> ((xx, xy, zx), (xy, yy, yz), (zx, yz, zz))
        const float xx = acc[0] * vol8, yy = acc[1] * vol8, zz = acc[2] * vol8;
        const float xy = acc[3] * vol8, yz = acc[4] * vol8, zx = acc[5] * vol8;
        const Tensor3<float> T3 = {{{xx, xy, zx}, {xy, yy, yz}, {zx, yz, zz}}};
        combine<float, NMC, NDC>(T3, f, row);
    }
}

// ---------------------------------------------------------------- the blend's near passes

// One row of a near pass, a warp's: an observation of the matvec (NSUM = ndc
// sums) or a cell of the rmatvec (NSUM = nmc). A row with no list position
// (p0 == end) writes zeros and leaves at once. Otherwise open() loads what
// the row's terms share (the observation, or the cell), each lane adds the
// terms of every 32nd position from p0 to end in order, term(opened, p, acc)
// adding position p's in double where its pair is near, then the warp's
// shuffle tree, and lane 0 writes out[j * stride]. No atomics: two launches
// agree to the last bit.
template <int NSUM, typename Open, typename Term>
__device__ __forceinline__ void near_warp_row(int p0, int end, Open open, Term term, double* __restrict__ out,
                                              size_t stride) {
    const int lane = threadIdx.x & 31;
    double acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0;
    if (p0 == end) {  // the whole warp
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < NSUM; ++j) out[j * stride] = 0.0;
        }
        return;
    }
    const auto opened = open();
    for (int p = p0 + lane; p < end; p += 32) term(opened, p, acc);
#pragma unroll
    for (int j = 0; j < NSUM; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
        if (lane == 0) out[j * stride] = acc[j];
    }
}

// A near matvec's terms of cell n: d[j] += row[k][j] * xw[k, n] over k, in
// double; xw (nmc, N).
template <int NMC, int NDC>
__device__ __forceinline__ void add_matvec_terms(const float (&row)[NMC][NDC], const float* __restrict__ xw,
                                                 size_t N, int n, double (&d)[NDC]) {
#pragma unroll
    for (int k = 0; k < NMC; ++k) {
        const double v = static_cast<double>(__ldg(xw + k * N + n));
#pragma unroll
        for (int j = 0; j < NDC; ++j) d[j] += static_cast<double>(row[k][j]) * v;
    }
}

// A near rmatvec's terms of observation b: acc[k] += row[k][j] * u[b, j] over
// j, in double; u (nrows, ndc).
template <int NMC, int NDC>
__device__ __forceinline__ void add_rmatvec_terms(const float (&row)[NMC][NDC], const float* __restrict__ u, int b,
                                                  double (&acc)[NMC]) {
#pragma unroll
    for (int j = 0; j < NDC; ++j) {
        const double v = static_cast<double>(__ldg(u + static_cast<size_t>(b) * NDC + j));
#pragma unroll
        for (int k = 0; k < NMC; ++k) acc[k] += static_cast<double>(row[k][j]) * v;
    }
}

}  // namespace
