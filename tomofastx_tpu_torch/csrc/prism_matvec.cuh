// Kernel B2: the two products of the per-cell matrix-free operator, for Hopper
// (sm_90a), with every far (observation, cell) pair's prism response evaluated
// in registers and never stored. Two sources include this header, each for one
// type, so that nvcc builds them in parallel: prism_matvec_f32.cu (the float
// operators: the blend, its near rows and near passes, and the float closed
// forms) and prism_matvec_f64.cu (the double closed forms).
//
// Replaces the XLA fusion of the JAX package's per-cell operator:
// tomofastx_tpu/ops/matrixfree.py:244 MatrixFreeKernel.matvec and :283 rmatvec,
// built on the rows of :59 _rows_for_point and :84 _corr_rows_for_point and on
// the quadrature of tomofastx_tpu/ops/prism.py:529 _quad_accumulate. Its plain
// versions are the port's chunk loop (tomofastx_tpu_torch/ops/matrixfree.py,
// MatrixFreeKernel._partial_matvec and _partial_rmatvec), which materialises
// (chunk, N, nmc, ndc) rows a chunk of observations, and, for the blend, the
// same split as the kernels' (_split_matvec, _split_rmatvec, _near_matvec,
// _near_rmatvec).
//
//   matvec:  d[b, j] = sum_n sum_k R[b, n, k, j] * xw[k, n]     (nrows, ndc)
//   rmatvec: g[k, n] = sum_b sum_j R[b, n, k, j] * u[b, j]      (nmc, N)
//
//   R[b, n]  the prism response of cell n (bounds X1..Z2 (N,)) at observation b
//            (xd, yd, zd (nrows,)): gravity g_z, Gzz, the six FTG components,
//            or the magnetic tensor combined with the field (nmc, ndc in 1, 3);
//   xw, u    in the operator's type T (float or double); the column weight and
//            the row weights are applied by the caller, as around the loop.
//
// What R is, pair by pair, as the plain version evaluates it:
//   CLOSED (T = double, or a float operator without the blend): the closed
//     forms in T. In double they are the reference's literal formulas, which
//     the plain float64 path keeps for bit-parity; in float the logs take the
//     cancellation-armored forms of ops/prism.py.
//   BLEND (the float operator's compensated blend): a cell whose centre lies
//     within FAR_QUAD_RADIUS = 4 half-diagonals of the observation (the far
//     mask of ops/prism.py, evaluated in float in the same order, with rounded
//     operations that the compiler may not contract, so that both pick the same
//     cells) takes the closed forms in double, rounded to float; every other
//     cell the 27-point Gauss-Legendre rule in float.
//
// What bounds it: operations. A product reads a few megabytes (the bounds, the
// observations, the vectors) and evaluates nrows x N pairs: 1.07e9 at 4096 x
// 262144. A far pair of the blend costs 27 reciprocal square roots (the special
// function unit: 16 a clock an SM) and some 6-15 float operations a point; a
// closed-form pair costs 8 corners of square roots, arc tangents and logs in
// double. So the design keeps every pair's work in registers and nothing but
// the inputs in memory.
//
// What the design does about it.
// matvec: a thread an observation, 128 a block; the grid is (observation tiles
// x cell splits). A block stages 128 cells at a time in shared memory (their
// bounds, centres, half-widths, blend threshold and cw*x values, computed once
// a cell), and every thread runs through them, the staged cell read by all
// lanes at once (a broadcast). Each thread sums its observation's terms in
// double and writes them to a (splits, nrows, ndc) buffer of partial sums; a
// second kernel adds the splits of each output in split order. The number of
// splits is a function of the shape (ops/prism_matvec.py::matvec_splits).
// rmatvec: a thread a cell, its cell in registers, 128 a block; the block
// stages 128 observations (coordinates and weighted residuals) at a time in
// shared memory and every thread runs through all of them, summing in double
// and rounding once at the end.
// The blend's main loops give a near pair zero, by a select (its 27-point value
// may be non-finite), and hold no double closed forms. The near pairs (0.04 %
// of the pairs at the smoke shape, 0.53 % on a grid of growing cells) are
// stored: prism_matvec_f32.cu builds their rows once, with the operator, over
// the near candidates (ops/matrixfree.py near_cell_indices), each tested with
// the main loop's own is_far and evaluated by near_row, in two orders (by
// observation and by cell); a near pass is then a streaming read of them
// (prism_common.cuh near_stream). The matvec's writes one more split of the
// buffer, (splits + 1, nrows, ndc), the last one summed; the rmatvec's writes
// the near terms' (nmc, N) double sums, from which the main loop's sums start.
// No atomics anywhere: every sum has one fixed order, so two runs agree to the
// last bit. The closed forms are device functions kept out of line
// (__noinline__), so that each is compiled once a type whatever calls it.
//
// Built without --use_fast_math: a boundary-coincident observation gives a
// log(0) and so a non-finite product, which the operator's construction probe
// must see (ops/matrixfree.py PROBE_ABORT).

#pragma once

#include <cuda_runtime.h>

#include "prism_common.cuh"

namespace {

constexpr int THREADS = 128;  // threads of every block; cells or observations staged at a time

template <typename U>
struct Six {
    U v[6];
};

// ---------------------------------------------------------------- helpers

// log((t_num + a_num) / (t_den + a_den)) (ops/prism.py _log_ratio_pp).
__device__ __forceinline__ double log_ratio_pp(double tn, double an, double td, double ad, double, double) {
    return log((tn + an) / (td + ad));
}
__device__ __forceinline__ float stab(float t, float a, float o2) { return t < 0.0f ? o2 / (a - t) : t + a; }
__device__ __forceinline__ float log_ratio_pp(float tn, float an, float td, float ad, float o2n, float o2d) {
    return logf(stab(tn, an, o2n) / stab(td, ad, o2d));
}

// (-1)^(K+L+M+1) of the corner (K, L, M).
__device__ __forceinline__ int corner_sign(int K, int L, int M) { return ((K + L + M + 1) & 1) ? -1 : 1; }

// ---------------------------------------------------------------- closed forms (ops/prism.py)

// gravi_z: g_z of a unit-density prism, G included (gravity_field.f90:131-195).
template <typename U>
__device__ __noinline__ U gravi_z(U xd, U yd, U zd, U X1, U X2, U Y1, U Y2, U Z1, U Z2) {
    const U XX[2] = {xd - X1, xd - X2}, YY[2] = {yd - Y1, yd - Y2}, ZZ[2] = {zd - Z1, zd - Z2};
    U gz = U(0);
#pragma unroll
    for (int K = 0; K < 2; ++K)
#pragma unroll
        for (int L = 0; L < 2; ++L)
#pragma unroll
            for (int M = 0; M < 2; ++M) {
                const U x = XX[K], y = YY[L], z = ZZ[M];
                const U Rs = sqrt(x * x + y * y + z * z);
                const U arg3 = wrap_atan2(x * y, z * Rs);
                const U arg4 = log_R_plus(Rs, x, y * y + z * z);
                const U arg5 = log_R_plus(Rs, y, x * x + z * z);
                gz = gz + U(corner_sign(K, L, M)) * (z * arg3 - x * arg5 - y * arg4);
            }
    return U(G_GRAV) * gz;
}

// gradi_zz: Gzz, with the reference's internal flip of z (gravity_field.f90:314-364).
template <typename U>
__device__ __noinline__ U gradi_zz(U xd, U yd, U zd, U X1, U X2, U Y1, U Y2, U Z1, U Z2) {
    const U XX[2] = {xd - X1, xd - X2}, YY[2] = {yd - Y1, yd - Y2}, ZZ[2] = {-(zd - Z1), -(zd - Z2)};
    U gzz = U(0);
#pragma unroll
    for (int K = 0; K < 2; ++K)
#pragma unroll
        for (int L = 0; L < 2; ++L)
#pragma unroll
            for (int M = 0; M < 2; ++M) {
                const U x = XX[K], y = YY[L], z = ZZ[M];
                const U Rs = sqrt(x * x + y * y + z * z);
                gzz = gzz + U(corner_sign(K, L, M)) * wrap_neg_atan2(x * y, Rs * z);
            }
    return U(G_GRAV) * gzz;
}

// gradi_full: (Gxx, Gyy, Gzz, Gxy, Gyz, Gzx) by the corner potentials of
// ftg_corner_potentials (gravity_field.f90:207-309).
template <typename U>
__device__ __noinline__ Six<U> gradi_full(U xd, U yd, U zd, U X1, U X2, U Y1, U Y2, U Z1, U Z2) {
    const U XX[2] = {xd - X1, xd - X2}, YY[2] = {yd - Y1, yd - Y2}, ZZ[2] = {-(zd - Z1), -(zd - Z2)};
    Six<U> g;
#pragma unroll
    for (int c = 0; c < 6; ++c) g.v[c] = U(0);
#pragma unroll
    for (int K = 0; K < 2; ++K)
#pragma unroll
        for (int L = 0; L < 2; ++L)
#pragma unroll
            for (int M = 0; M < 2; ++M) {
                const U x = XX[K], y = YY[L], z = ZZ[M];
                const U mu = U(corner_sign(K, L, M));
                const U Rs = sqrt(x * x + y * y + z * z);
                const U p[6] = {
                    wrap_atan2(x * y, x * x + Rs * z + z * z),
                    wrap_atan2(x * y, Rs * Rs + Rs * z - x * x),
                    wrap_neg_atan2(x * y, Rs * z),
                    log_R_plus(Rs, z, x * x + y * y),
                    half_log_ratio(Rs, x, y * y + z * z),
                    half_log_ratio(Rs, y, x * x + z * z),
                };
#pragma unroll
                for (int c = 0; c < 6; ++c) g.v[c] = g.v[c] + mu * p[c];
            }
#pragma unroll
    for (int c = 0; c < 6; ++c) g.v[c] = U(G_GRAV) * g.v[c];
    return g;
}

// sharmbox: the magnetic tensor of a prism (Sharma 1966; magnetic_field.f90:321-457).
template <typename U>
__device__ __noinline__ Tensor3<U> sharmbox(U x0, U y0, U z0, U x1, U x2, U y1, U y2, U z1, U z2) {
    const U rx1 = x1 - x0, rx2 = x2 - x0, ry1 = y1 - y0, ry2 = y2 - y0, rz1 = z1 - z0, rz2 = z2 - z0;
    const U rx1s = rx1 * rx1, rx2s = rx2 * rx2, ry1s = ry1 * ry1, ry2s = ry2 * ry2;
    const U rz1s = rz1 * rz1, rz2s = rz2 * rz2;

    U R1 = ry2s + rx2s, R2 = ry2s + rx1s, R3 = ry1s + rx2s, R4 = ry1s + rx1s;
    const U a1 = sqrt(rz2s + R2), a2 = sqrt(rz2s + R1), a3 = sqrt(rz1s + R1), a4 = sqrt(rz1s + R2);
    const U a5 = sqrt(rz2s + R3), a6 = sqrt(rz2s + R4), a7 = sqrt(rz1s + R4), a8 = sqrt(rz1s + R3);

    const U txx = atan2(ry1 * rz2, rx2 * a5) - atan2(ry2 * rz2, rx2 * a2) + atan2(ry2 * rz1, rx2 * a3)
                  - atan2(ry1 * rz1, rx2 * a8) + atan2(ry2 * rz2, rx1 * a1) - atan2(ry1 * rz2, rx1 * a6)
                  + atan2(ry1 * rz1, rx1 * a7) - atan2(ry2 * rz1, rx1 * a4);
    const U tyx = log_ratio_pp(rz2, a2, rz1, a3, R1, R1) - log_ratio_pp(rz2, a1, rz1, a4, R2, R2)
                  + log_ratio_pp(rz2, a6, rz1, a7, R4, R4) - log_ratio_pp(rz2, a5, rz1, a8, R3, R3);
    const U tyy = atan2(rx1 * rz2, ry2 * a1) - atan2(rx2 * rz2, ry2 * a2) + atan2(rx2 * rz1, ry2 * a3)
                  - atan2(rx1 * rz1, ry2 * a4) + atan2(rx2 * rz2, ry1 * a5) - atan2(rx1 * rz2, ry1 * a6)
                  + atan2(rx1 * rz1, ry1 * a7) - atan2(rx2 * rz1, ry1 * a8);

    R1 = ry2s + rz1s;
    R2 = ry2s + rz2s;
    R3 = ry1s + rz1s;
    R4 = ry1s + rz2s;
    const U b1 = sqrt(rx1s + R1), b2 = sqrt(rx2s + R1), b3 = sqrt(rx1s + R2), b4 = sqrt(rx2s + R2);
    const U b5 = sqrt(rx1s + R3), b6 = sqrt(rx2s + R3), b7 = sqrt(rx1s + R4), b8 = sqrt(rx2s + R4);
    const U tyz = log_ratio_pp(rx1, b1, rx2, b2, R1, R1) - log_ratio_pp(rx1, b3, rx2, b4, R2, R2)
                  + log_ratio_pp(rx1, b7, rx2, b8, R4, R4) - log_ratio_pp(rx1, b5, rx2, b6, R3, R3);

    R1 = rx2s + rz1s;
    R2 = rx2s + rz2s;
    R3 = rx1s + rz1s;
    R4 = rx1s + rz2s;
    const U c1 = sqrt(ry1s + R1), c2 = sqrt(ry2s + R1), c3 = sqrt(ry1s + R2), c4 = sqrt(ry2s + R2);
    const U c5 = sqrt(ry1s + R3), c6 = sqrt(ry2s + R3), c7 = sqrt(ry1s + R4), c8 = sqrt(ry2s + R4);
    const U txz = log_ratio_pp(ry1, c1, ry2, c2, R1, R1) - log_ratio_pp(ry1, c3, ry2, c4, R2, R2)
                  + log_ratio_pp(ry1, c7, ry2, c8, R4, R4) - log_ratio_pp(ry1, c5, ry2, c6, R3, R3);

    const U tzz = -(txx + tyy);
    Tensor3<U> out = {{{txx, tyx, txz}, {tyx, tyy, tyz}, {txz, tyz, tzz}}};
    return out;
}

// magnetic_tensor: sharmbox, or for an observation inside the cell the sum of
// the 6 sub-prisms around a small void (magnetic_field.f90:135-238).
template <typename U>
__device__ __noinline__ Tensor3<U> magnetic_tensor(U xd, U yd, U zd, U X1, U X2, U Y1, U Y2, U Z1, U Z2,
                                                   int handle_inside) {
    if (handle_inside && (X1 < xd) && (X2 > xd) && (Y1 < yd) && (Y2 > yd) && (Z1 < zd) && (Z2 > zd)) {
        const U min_clr = fmin(fmin(fabs(xd - X1), fabs(xd - X2)),
                               fmin(fmin(fabs(yd - Y1), fabs(yd - Y2)), fmin(fabs(zd - Z1), fabs(zd - Z2))));
        const U width = U(0.1) > min_clr ? U(0.5) * min_clr : U(0.1);
        const U b[6][6] = {
            {X1, X2, Y1, Y2, Z1, zd - width},                                              // top
            {X1, X2, Y1, Y2, zd + width, Z2},                                              // bottom
            {X1, xd - width, Y1, Y2, zd - width, zd + width},                              // west
            {xd + width, X2, Y1, Y2, zd - width, zd + width},                              // east
            {xd - width, xd + width, Y1, yd - width, zd - width, zd + width},              // south
            {xd - width, xd + width, yd + width, Y2, zd - width, zd + width},              // north
        };
        Tensor3<U> sub;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) sub.t[r][c] = U(0);
        for (int s = 0; s < 6; ++s) {
            const Tensor3<U> t = sharmbox(xd, yd, zd, b[s][0], b[s][1], b[s][2], b[s][3], b[s][4], b[s][5]);
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
                for (int c = 0; c < 3; ++c) sub.t[r][c] = sub.t[r][c] + t.t[r][c];
        }
        return sub;
    }
    return sharmbox(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2);
}

// The closed-form row of one pair in U (forward_rows without the blend).
template <typename U, int FAM, int NMC, int NDC>
__device__ __forceinline__ void closed_row(U xd, U yd, U zd, U X1, U X2, U Y1, U Y2, U Z1, U Z2, const Field& f,
                                           U row[NMC][NDC]) {
    if constexpr (FAM == GZ) {
        row[0][0] = gravi_z(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2);
    } else if constexpr (FAM == GZZ) {
        row[0][0] = gradi_zz(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2);
    } else if constexpr (FAM == FTG) {
        const Six<U> g = gradi_full(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2);
#pragma unroll
        for (int c = 0; c < 6; ++c) row[0][c] = g.v[c];
    } else {
        combine<U, NMC, NDC>(magnetic_tensor(xd, yd, zd, X1, X2, Y1, Y2, Z1, Z2, f.handle_inside), f, row);
    }
}

// ---------------------------------------------------------------- the 27-point rule (float)

// A staged cell: its bounds, and for the blend its centre, half-widths and
// threshold (FAR_QUAD_RADIUS^2 x squared half-diagonal), each computed as
// ops/prism.py far_mask computes it.
template <typename T>
struct Cell {
    T X1, X2, Y1, Y2, Z1, Z2;
    T cx, cy, cz, hx, hy, hz, thr;
};

template <typename T>
__device__ __forceinline__ Cell<T> make_cell(T X1, T X2, T Y1, T Y2, T Z1, T Z2);

template <>
__device__ __forceinline__ Cell<float> make_cell(float X1, float X2, float Y1, float Y2, float Z1, float Z2) {
    const float hx = __fmul_rn(0.5f, __fsub_rn(X2, X1));
    const float hy = __fmul_rn(0.5f, __fsub_rn(Y2, Y1));
    const float hz = __fmul_rn(0.5f, __fsub_rn(Z2, Z1));
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), __fmul_rn(hz, hz));
    return {X1, X2, Y1, Y2, Z1, Z2,
            __fmul_rn(0.5f, __fadd_rn(X1, X2)), __fmul_rn(0.5f, __fadd_rn(Y1, Y2)), __fmul_rn(0.5f, __fadd_rn(Z1, Z2)),
            hx, hy, hz, __fmul_rn(16.0f, d2)};  // thr = (FAR_QUAD_RADIUS * FAR_QUAD_RADIUS) * d2
}

// The closed forms alone read a double cell.
template <>
__device__ __forceinline__ Cell<double> make_cell(double X1, double X2, double Y1, double Y2, double Z1, double Z2) {
    return {X1, X2, Y1, Y2, Z1, Z2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
}

// far_mask: centre distance > FAR_QUAD_RADIUS x half-diagonal, in float, in
// the order of ops/prism.py and with no contraction.
__device__ __forceinline__ bool is_far(const Cell<float>& c, float xo, float yo, float zo) {
    const float dx = __fsub_rn(c.cx, xo), dy = __fsub_rn(c.cy, yo), dz = __fsub_rn(c.cz, zo);
    const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    return r2 > c.thr;
}

// The 27-point rule at a far pair (prism_common.cuh quad_points).
template <int FAM, int NMC, int NDC>
__device__ __forceinline__ void quad_row(const Cell<float>& c, float xo, float yo, float zo, const Field& f,
                                         float row[NMC][NDC]) {
    const float node[3] = {float(-GL3_NODE), 0.0f, float(GL3_NODE)};
    const double wgt1[3] = {GL3_W_OUT, GL3_W_MID, GL3_W_OUT};
    float px[3], py[3], pz[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        px[i] = c.cx + node[i] * c.hx - xo;
        py[i] = c.cy + node[i] * c.hy - yo;
        pz[i] = c.cz + node[i] * c.hz - zo;
    }
    float xy[3][3];
    square_sums<3>(px, py, xy);
    quad_points<FAM, NMC, NDC, 3>(px, py, pz, xy, wgt1, c.hx * c.hy * c.hz, f, row);
}

// The row of one pair in the main loops: the closed forms, or, in the blend,
// the 27-point rule and zero where the pair is near (the near pass evaluates
// it), never a product with zero (a near pair's 27-point value may be
// non-finite). FAR_FIRST: is_far decides before the rule, a branch (the
// rmatvec's: a lane holds a cell, its near observations come in runs);
// otherwise the rule is evaluated and zeroed by a select (the matvec's: a
// lane holds an observation). Each is the faster of the two for its kernel
// (scripts/probe_torch_prism_matvec.py).
template <typename T, int FAM, int NMC, int NDC, int MODE, bool FAR_FIRST>
__device__ __forceinline__ void pair_row(const Cell<T>& c, T xo, T yo, T zo, const Field& f, T row[NMC][NDC]) {
    if constexpr (MODE == BLEND && FAR_FIRST) {
        if (is_far(c, xo, yo, zo)) {
            quad_row<FAM, NMC, NDC>(c, xo, yo, zo, f, row);
        } else {
#pragma unroll
            for (int k = 0; k < NMC; ++k)
#pragma unroll
                for (int j = 0; j < NDC; ++j) row[k][j] = T(0);
        }
    } else if constexpr (MODE == BLEND) {
        quad_row<FAM, NMC, NDC>(c, xo, yo, zo, f, row);
        const bool far = is_far(c, xo, yo, zo);
#pragma unroll
        for (int k = 0; k < NMC; ++k)
#pragma unroll
            for (int j = 0; j < NDC; ++j) row[k][j] = far ? row[k][j] : T(0);
    } else {
        closed_row<T, FAM, NMC, NDC>(xo, yo, zo, c.X1, c.X2, c.Y1, c.Y2, c.Z1, c.Z2, f, row);
    }
}

// The row of a near candidate (the build of the stored near rows): the closed
// forms in double, rounded to float, where the main loop's is_far calls the
// pair near; false (and no row) where not.
template <int FAM, int NMC, int NDC>
__device__ __forceinline__ bool near_row(const Cell<float>& c, float xo, float yo, float zo, const Field& f,
                                         float row[NMC][NDC]) {
    if (is_far(c, xo, yo, zo)) return false;
    double r64[NMC][NDC];
    closed_row<double, FAM, NMC, NDC>(xo, yo, zo, c.X1, c.X2, c.Y1, c.Y2, c.Z1, c.Z2, f, r64);
#pragma unroll
    for (int k = 0; k < NMC; ++k)
#pragma unroll
        for (int j = 0; j < NDC; ++j) row[k][j] = float(r64[k][j]);
    return true;
}

// ---------------------------------------------------------------- the kernels

struct Geometry {
    const void *X1, *X2, *Y1, *Y2, *Z1, *Z2;  // (N,) cell bounds
    const void *xd, *yd, *zd;                 // (nrows,) observations
};

// matvec, pass 1: partial[s, b, j] = sum over split s's cells n of R[b, n, :, j] . xw[:, n].
template <typename T, int FAM, int NMC, int NDC, int MODE>
__global__ void __launch_bounds__(THREADS) prism_matvec_partials(Geometry g, const T* __restrict__ xw,
                                                                 double* __restrict__ partial, int N, int nrows,
                                                                 int cells_per_split, Field f) {
    __shared__ Cell<T> cells[THREADS];
    __shared__ T xs[NMC][THREADS];
    const int b = blockIdx.x * THREADS + threadIdx.x;
    const bool live = b < nrows;
    const T xo = live ? at<T>(g.xd, b) : T(0), yo = live ? at<T>(g.yd, b) : T(0), zo = live ? at<T>(g.zd, b) : T(0);
    const int c0 = blockIdx.y * cells_per_split;
    const int c1 = min(N, c0 + cells_per_split);
    double acc[NDC];
#pragma unroll
    for (int j = 0; j < NDC; ++j) acc[j] = 0.0;
    for (int base = c0; base < c1; base += THREADS) {
        const int n = base + threadIdx.x;
        __syncthreads();
        if (n < c1) {
            cells[threadIdx.x] = make_cell<T>(at<T>(g.X1, n), at<T>(g.X2, n), at<T>(g.Y1, n), at<T>(g.Y2, n),
                                              at<T>(g.Z1, n), at<T>(g.Z2, n));
#pragma unroll
            for (int k = 0; k < NMC; ++k) xs[k][threadIdx.x] = xw[static_cast<size_t>(k) * N + n];
        }
        __syncthreads();
        if (live) {
            const int count = min(THREADS, c1 - base);
            for (int i = 0; i < count; ++i) {
                T row[NMC][NDC];
                pair_row<T, FAM, NMC, NDC, MODE, false>(cells[i], xo, yo, zo, f, row);
#pragma unroll
                for (int k = 0; k < NMC; ++k) {
                    const double v = static_cast<double>(xs[k][i]);
#pragma unroll
                    for (int j = 0; j < NDC; ++j) acc[j] += static_cast<double>(row[k][j]) * v;
                }
            }
        }
    }
    if (live) {
#pragma unroll
        for (int j = 0; j < NDC; ++j) partial[(static_cast<size_t>(blockIdx.y) * nrows + b) * NDC + j] = acc[j];
    }
}

// matvec, pass 2: out[b, j] = sum over the splits, in split order.
template <typename T>
__global__ void __launch_bounds__(THREADS) prism_matvec_reduce(const double* __restrict__ partial, T* __restrict__ out,
                                                               int nout, int splits) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= nout) return;
    double s = 0.0;
    for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * nout + i];
    out[i] = static_cast<T>(s);
}

// rmatvec: g[k, n] = sum over the observations b of R[b, n, k, :] . u[b, :];
// the blend's sums start from its near pass's, near (nmc, N).
template <typename T, int FAM, int NMC, int NDC, int MODE>
__global__ void __launch_bounds__(THREADS) prism_rmatvec_kernel(Geometry g, const T* __restrict__ u,
                                                                const double* __restrict__ near,
                                                                T* __restrict__ out, int N, int nrows, Field f) {
    __shared__ T ox[THREADS], oy[THREADS], oz[THREADS];
    __shared__ T us[NDC][THREADS];
    const int n = blockIdx.x * THREADS + threadIdx.x;
    const bool live = n < N;
    Cell<T> cell{};
    if (live) {
        cell = make_cell<T>(at<T>(g.X1, n), at<T>(g.X2, n), at<T>(g.Y1, n), at<T>(g.Y2, n), at<T>(g.Z1, n),
                            at<T>(g.Z2, n));
    }
    double acc[NMC];
#pragma unroll
    for (int k = 0; k < NMC; ++k) acc[k] = MODE == BLEND && live ? near[static_cast<size_t>(k) * N + n] : 0.0;
    for (int base = 0; base < nrows; base += THREADS) {
        const int b = base + threadIdx.x;
        __syncthreads();
        if (b < nrows) {
            ox[threadIdx.x] = at<T>(g.xd, b);
            oy[threadIdx.x] = at<T>(g.yd, b);
            oz[threadIdx.x] = at<T>(g.zd, b);
#pragma unroll
            for (int j = 0; j < NDC; ++j) us[j][threadIdx.x] = u[static_cast<size_t>(b) * NDC + j];
        }
        __syncthreads();
        if (live) {
            const int count = min(THREADS, nrows - base);
            for (int i = 0; i < count; ++i) {
                T row[NMC][NDC];
                pair_row<T, FAM, NMC, NDC, MODE, true>(cell, ox[i], oy[i], oz[i], f, row);
#pragma unroll
                for (int j = 0; j < NDC; ++j) {
                    const double v = static_cast<double>(us[j][i]);
#pragma unroll
                    for (int k = 0; k < NMC; ++k) acc[k] += static_cast<double>(row[k][j]) * v;
                }
            }
        }
    }
    if (live) {
#pragma unroll
        for (int k = 0; k < NMC; ++k) out[static_cast<size_t>(k) * N + n] = static_cast<T>(acc[k]);
    }
}

// ---------------------------------------------------------------- dispatch

struct Launch {
    Geometry g;
    const void* vin;  // xw (nmc, N) or u (nrows, ndc)
    double* partial;  // the matvec's (splits (+ 1 for the blend), nrows, ndc); the blend rmatvec's near sums (nmc, N)
    void* out;        // (nrows, ndc) or (nmc, N)
    int N, nrows, splits, cells_per_split;
    Field f;
    cudaStream_t stream;
};

template <typename T, int FAM, int NMC, int NDC, int MODE>
void launch_matvec(const Launch& a) {
    const dim3 grid((a.nrows + THREADS - 1) / THREADS, a.splits);
    prism_matvec_partials<T, FAM, NMC, NDC, MODE><<<grid, THREADS, 0, a.stream>>>(
        a.g, static_cast<const T*>(a.vin), a.partial, a.N, a.nrows, a.cells_per_split, a.f);
    const int nout = a.nrows * NDC;
    // The blend's near pass wrote the last split before this launch.
    prism_matvec_reduce<T><<<(nout + THREADS - 1) / THREADS, THREADS, 0, a.stream>>>(
        a.partial, static_cast<T*>(a.out), nout, a.splits + (MODE == BLEND));
}

template <typename T, int FAM, int NMC, int NDC, int MODE>
void launch_rmatvec(const Launch& a) {
    prism_rmatvec_kernel<T, FAM, NMC, NDC, MODE><<<(a.N + THREADS - 1) / THREADS, THREADS, 0, a.stream>>>(
        a.g, static_cast<const T*>(a.vin), a.partial, static_cast<T*>(a.out), a.N, a.nrows, a.f);
}

template <bool MATVEC, typename T, int MODE>
int launch_family(int family, int nmc, int ndc, const Launch& a) {
#define PRISM_CASE(FAM, NMC, NDC)                                                   \
    if (family == FAM && nmc == NMC && ndc == NDC) {                                \
        if (MATVEC) launch_matvec<T, FAM, NMC, NDC, MODE>(a);                       \
        else launch_rmatvec<T, FAM, NMC, NDC, MODE>(a);                             \
        return static_cast<int>(cudaGetLastError());                                \
    }
    FOR_EACH_FAMILY(PRISM_CASE)
#undef PRISM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

Launch make_launch(const void* X1, const void* X2, const void* Y1, const void* Y2, const void* Z1, const void* Z2,
                   const void* xd, const void* yd, const void* zd, const void* vin, void* partial, void* out, int N,
                   int nrows, int splits, int cells_per_split, double m0, double m1, double m2, double s4pi,
                   int handle_inside, void* stream) {
    Launch a;
    a.g = Geometry{X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd};
    a.vin = vin;
    a.partial = static_cast<double*>(partial);
    a.out = out;
    a.N = N;
    a.nrows = nrows;
    a.splits = splits;
    a.cells_per_split = cells_per_split;
    a.f = Field{m0, m1, m2, s4pi, handle_inside};
    a.stream = static_cast<cudaStream_t>(stream);
    return a;
}

}  // namespace

// One signature for both products' entry points (the rmatvec ignores splits
// and cells_per_split, and reads partial only in the blend: its near sums).
// is_double: the operator's type; family: Family; mode: Mode.
#define PRISM_ARGS                                                                                               \
    int is_double, int family, int nmc, int ndc, int mode, int handle_inside, const void *X1, const void *X2,    \
        const void *Y1, const void *Y2, const void *Z1, const void *Z2, const void *xd, const void *yd,          \
        const void *zd, const void *vin, void *partial, void *out, int N, int nrows, int splits,                 \
        int cells_per_split, double m0, double m1, double m2, double s4pi, void *stream
#define PRISM_LAUNCH                                                                                             \
    make_launch(X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd, vin, partial, out, N, nrows, splits, cells_per_split, m0, m1, \
                m2, s4pi, handle_inside, stream)
#define PRISM_CHECK_MATVEC                                                           \
    if (N <= 0 || nrows <= 0 || splits <= 0 || cells_per_split <= 0) return static_cast<int>(cudaErrorInvalidValue)
#define PRISM_CHECK_RMATVEC \
    if (N <= 0 || nrows <= 0) return static_cast<int>(cudaErrorInvalidValue)
