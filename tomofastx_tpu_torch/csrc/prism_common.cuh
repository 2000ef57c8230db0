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

// A blended operator's near rows are stored once, when it is built
// (ops/matrixfree.py near_row_layout): each near pair's closed forms in
// double, rounded to float, in two orders. A near pass is then a streaming
// read of them, bound by bytes: no closed form is evaluated in a product.
//
// One order of the stored rows: segment s holds the pairs ptr[s] ..
// ptr[s + 1] - 1, idx[p] the pair's cell (by observation: the matvec's) or
// observation (by cell: the rmatvec's), val[p] its row (nmc, ndc), and, by
// cell, seg[s] the segment's cell; `segments` segments.
struct NearRows {
    const int* ptr;
    const int* idx;
    const float* val;
    const int* seg;
    int segments;
};

constexpr int STREAM_THREADS = 256;  // threads of a near pass's block

// One segment of a near pass for each group of G lanes (G in 1, 2, 4, 8, 16,
// 32 or 256: ops/matrixfree.py stream_lanes, from the mean pairs a segment).
// Each lane sums the terms of every G-th pair from the segment's first, in
// order, in double; then the group's shuffle tree (the warp's, then, for a
// group of several warps, their sums in order), and its first lane writes:
//   MATVEC:  out[s, j] = sum_p sum_k val[p, k, j] * xw[k, idx[p]]   (every row)
//   rmatvec: out[k, seg[s]] = sum_p sum_j val[p, k, j] * u[idx[p], j]
// (the rmatvec's caller clears the cells no segment names). No atomics: two
// launches agree to the last bit.
template <int NMC, int NDC, int G, bool MATVEC>
__device__ __forceinline__ void near_stream(const NearRows& r, const float* __restrict__ vin,
                                            double* __restrict__ out, size_t N) {
    constexpr int NSUM = MATVEC ? NDC : NMC;
    constexpr int NV = NMC * NDC;
    static_assert(G == 256 || (G >= 1 && G <= 32 && (G & (G - 1)) == 0), "lanes of a group");
    const int tid = threadIdx.x;
    const int s = blockIdx.x * (STREAM_THREADS / G) + tid / G;
    const int lane = tid % G;
    double acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0;
    if (s < r.segments) {
        const int p1 = __ldg(r.ptr + s + 1);
        for (int p = __ldg(r.ptr + s) + lane; p < p1; p += G) {
            const size_t i = static_cast<size_t>(__ldg(r.idx + p));
            float v[NV];
#pragma unroll
            for (int q = 0; q < NV; ++q) v[q] = __ldg(r.val + static_cast<size_t>(p) * NV + q);
            if constexpr (MATVEC) {
#pragma unroll
                for (int k = 0; k < NMC; ++k) {
                    const double x = static_cast<double>(__ldg(vin + k * N + i));
#pragma unroll
                    for (int j = 0; j < NDC; ++j) acc[j] += static_cast<double>(v[k * NDC + j]) * x;
                }
            } else {
#pragma unroll
                for (int j = 0; j < NDC; ++j) {
                    const double u = static_cast<double>(__ldg(vin + i * NDC + j));
#pragma unroll
                    for (int k = 0; k < NMC; ++k) acc[k] += static_cast<double>(v[k * NDC + j]) * u;
                }
            }
        }
    }
    if constexpr (G > 1) {
        constexpr int W = G < 32 ? G : 32;  // every lane of the warp takes part
#pragma unroll
        for (int j = 0; j < NSUM; ++j)
#pragma unroll
            for (int off = W / 2; off > 0; off >>= 1) acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off, W);
    }
    if constexpr (G > 32) {
        __shared__ double red[STREAM_THREADS / 32][NSUM];
        if ((tid & 31) == 0) {
#pragma unroll
            for (int j = 0; j < NSUM; ++j) red[tid >> 5][j] = acc[j];
        }
        __syncthreads();
        if (lane == 0) {
            const int w0 = tid >> 5;
#pragma unroll
            for (int j = 0; j < NSUM; ++j) {
                acc[j] = red[w0][j];
                for (int w = 1; w < G / 32; ++w) acc[j] += red[w0 + w][j];
            }
        }
    }
    if (lane == 0 && s < r.segments) {
        if constexpr (MATVEC) {
#pragma unroll
            for (int j = 0; j < NDC; ++j) out[static_cast<size_t>(s) * NDC + j] = acc[j];
        } else {
            const size_t n = static_cast<size_t>(__ldg(r.seg + s));
#pragma unroll
            for (int k = 0; k < NMC; ++k) out[k * N + n] = acc[k];
        }
    }
}

// Launch<MATVEC, NMC, NDC, G>::run(rows, vin, out, N, stream) launches the
// family's near-pass kernel (each source names its own, for the profiler)
// on (segments + per block - 1) / per block blocks.
template <template <bool, int, int, int> class Launch, bool MATVEC, int NMC, int NDC>
int near_stream_lanes(int lanes, const NearRows& r, const float* vin, double* out, size_t N, cudaStream_t stream) {
    switch (lanes) {
        case 1: Launch<MATVEC, NMC, NDC, 1>::run(r, vin, out, N, stream); break;
        case 2: Launch<MATVEC, NMC, NDC, 2>::run(r, vin, out, N, stream); break;
        case 4: Launch<MATVEC, NMC, NDC, 4>::run(r, vin, out, N, stream); break;
        case 8: Launch<MATVEC, NMC, NDC, 8>::run(r, vin, out, N, stream); break;
        case 16: Launch<MATVEC, NMC, NDC, 16>::run(r, vin, out, N, stream); break;
        case 32: Launch<MATVEC, NMC, NDC, 32>::run(r, vin, out, N, stream); break;
        case 256: Launch<MATVEC, NMC, NDC, 256>::run(r, vin, out, N, stream); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// A near pass over stored rows: the matvec's (segments = the operator's
// rows, out (segments, ndc)) or the rmatvec's (segments = the cells that
// have a near pair, out (nmc, N), cleared first by a memset on the stream,
// which a CUDA graph captures as it does a kernel).
template <template <bool, int, int, int> class Launch, bool MATVEC>
int near_stream_pass(int nmc, int ndc, int lanes, const NearRows& r, const void* vin, void* out, int N,
                     cudaStream_t stream) {
    // (idx and val are null where no pair is stored: then no lane reads them.)
    if (N <= 0 || r.segments < 0 || r.ptr == nullptr || vin == nullptr || out == nullptr ||
        (!MATVEC && r.segments > 0 && r.seg == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const float* v = static_cast<const float*>(vin);
    double* o = static_cast<double*>(out);
    if (!MATVEC) {
        const cudaError_t err = cudaMemsetAsync(o, 0, sizeof(double) * static_cast<size_t>(nmc) * N, stream);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (r.segments == 0) return static_cast<int>(cudaGetLastError());
#define NEAR_STREAM_CASE(NMC, NDC) \
    if (nmc == NMC && ndc == NDC) return near_stream_lanes<Launch, MATVEC, NMC, NDC>(lanes, r, v, o, N, stream);
    NEAR_STREAM_CASE(1, 1) NEAR_STREAM_CASE(1, 3) NEAR_STREAM_CASE(1, 6) NEAR_STREAM_CASE(3, 1) NEAR_STREAM_CASE(3, 3)
#undef NEAR_STREAM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of a near pass of `segments` segments, G lanes each.
template <int G>
unsigned near_stream_blocks(int segments) {
    constexpr int PER = STREAM_THREADS / G;
    return static_cast<unsigned>((segments + PER - 1) / PER);
}

}  // namespace
