// Kernel B3: the two products of the corner-lattice matrix-free operator, for
// Hopper (sm_90a), with every far (observation, cell) pair's response
// evaluated on the fly and never stored.
//
// Replaces the XLA fusion of the JAX package's lattice operator:
// tomofastx_tpu/ops/matrixfree.py:570 LatticeMatrixFreeKernel, :724 matvec and
// :762 rmatvec, built on the rows of :394 _lattice_closed_rows and the tiered
// blend of :646-700. Its plain versions are the port's chunk loop
// (tomofastx_tpu_torch/ops/matrixfree.py, LatticeMatrixFreeKernel.
// _partial_matvec and _partial_rmatvec), which materialises (chunk, nz, ny,
// nx, nmc, ndc) rows a chunk of observations, and, for the blend, the same
// split as the kernels' (_split_matvec, _split_rmatvec, _near_matvec,
// _near_rmatvec).
//
//   matvec:  d[b, j] = sum_n sum_k R[b, n, k, j] * xw[k, n]     (nrows, ndc)
//   rmatvec: g[k, n] = sum_b sum_j R[b, n, k, j] * u[b, j]      (nmc, N)
//
//   n = (iz, iy, ix), a cell of the lattice of edges xe (nx+1,), ye (ny+1,),
//            ze (nz+1,), N = nz ny nx cells in that order;
//   b        an observation (xd, yd, zd (nrows,));
//   xw, u    in the operator's type T (float or double); the column weight and
//            the row weights are applied by the caller, as around the loop.
//
// What R is, as the plain version evaluates it:
//   CLOSED (T = double, or a float operator without the blend): the corner-
//     difference closed forms. A potential F_b (gz_corner_potential,
//     ftg_corner_potentials at the flipped z, or the magnetic corner
//     potentials at s = corner - observation combined with the field) is
//     evaluated at each lattice corner, and a cell's value is the alternating
//     difference of its own 8 corners (_diff3: along z, then y, then x), times
//     -G for gravity. Never a sum of F against a differenced model vector: each
//     cell is a difference of its own corners (ops/matrixfree.py explains why).
//   BLEND (the float operator's tiered blend): a cell outside b's window
//     (wi0[b] + [0, win) on each axis) takes the 8-point Gauss rule, a window
//     cell the 27-point rule, or, if it is near (its centre within
//     FAR_QUAD_RADIUS = 4 half-diagonals, evaluated in float in the plain
//     version's order with rounded operations the compiler may not contract,
//     so that both pick the same cells), the closed forms in double, rounded to
//     float. The plain loop adds where(near, closed, quad3) - quad2 to quad2
//     on the window; the kernels pick the rule directly.
//
// What bounds it: operations. A product reads a few megabytes and evaluates
// nrows x N pairs, 1.07e9 at 4096 x 262144. A pair of the blend costs 8 (or, in
// the window, 27) reciprocal square roots on the special function unit (16 a
// clock an SM) and some 7 float operations a point; the closed forms cost a
// square root, an arc tangent and one or two logs in double at each corner.
//
// What the design does about it. A block is a tile of TZ x 8 x 8 cells (TZ = 8,
// or 4 where a corner holds 9 values) and a split of the observations; its 128
// threads own 4 (or 2) cells each, a column of one (y, x) at every second z,
// and a warp a 1 x 4 x 8 box. The block runs through its observations, 32
// staged at a time in shared memory:
//   CLOSED: the threads evaluate F_b once at each of the tile's (TZ+1) x 9 x 9
//     corners into shared memory (1.4 evaluations a cell, where per-cell rows
//     take 8), then each thread differences its cells' 8 corners;
//   BLEND: each thread evaluates its cells' rules, the x and y offsets of the
//     nodes and their square sums once for its column; a warp sees one
//     observation, so it splits between the rules only where the window's
//     boundary crosses its box. A near cell contributes zero to this main
//     loop, by a select (its 27-point value may be non-finite), so that the
//     loop holds no float64 code and no registers for it (0.04 % of the pairs
//     at the smoke shape). The near cells' rows are stored: built once, with
//     the operator, over near lists (ops/matrixfree.py lattice_near_lists:
//     each observation's window cells within 1.001 times the near radius),
//     each candidate tested with the main loop's own near test (is_near) and
//     the near ones' 8 corners evaluated in double (near_cell), in two orders
//     (by observation and by cell); a near pass is a streaming read of them
//     (prism_common.cuh near_stream), bound by bytes.
// matvec: each thread holds its cells' xw; an observation's terms are summed in
// double over the thread's cells, then the warp (shuffles in a fixed tree),
// then the block's 4 warps in order, into a (tiles, nrows, ndc) buffer that a
// second kernel sums over the tiles in order; the blend's near pass writes one
// more slot of that buffer, (tiles + 1, nrows, ndc), the last one summed.
// rmatvec: each thread sums its cells' terms in double over its split's
// observations in order, into a (splits, nmc, N) buffer that a second kernel
// sums over the splits in order; the near pass writes one more split, the
// last one summed. The tiles and splits are functions of the shape
// (ops/lattice_matvec.py), no atomics anywhere: two launches agree to the last
// bit. The corner potentials are device functions kept out of line
// (__noinline__), compiled once a type.
//
// Built without --use_fast_math: an observation on a lattice corner gives a
// log(0) and so a non-finite product, which the operator's construction probe
// must see (ops/matrixfree.py PROBE_ABORT).
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError().

#include <cuda_runtime.h>

#include "prism_common.cuh"

namespace {

constexpr int THREADS = 128;  // threads of every block
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 32;  // observations staged at a time
constexpr int TY = 8, TX = 8;

// The tile's depth in z: 8, or 4 where a corner holds more than 6 values
// (the magnetization vector's three components), so that the corners of a
// tile fit in 48 KB of shared memory in double (ops/lattice_matvec.py
// tile_shape).
__host__ __device__ constexpr int tile_z(int nv) { return nv > 6 ? 4 : 8; }

constexpr float FAR2 = 16.0f;  // FAR_QUAD_RADIUS^2

template <typename U, int NV>
struct Vals {
    U v[NV];
};

// One axis of a tile: its cells' edges and, for the blend, their centres,
// half-widths and quadrature nodes, each rounded as ops/prism.py rounds it
// (0.5 * (X1 + X2), 0.5 * (X2 - X1), cx + u * hx).
template <typename T>
struct Axis {
    T e[9];  // local cell l lies between e[l] and e[l + 1]
    float c[8], h[8], p2[8][2], p3[8][3];
};

// ---------------------------------------------------------------- corner potentials (ops/prism.py)

// gz_corner_potential at (x, y, z) = observation - corner. The potentials
// round every product and sum as written (rn_mul, sq3, ...): their terms
// cancel, and the 8-corner difference of a far cell cancels again.
template <typename U>
__device__ __noinline__ U gz_corner(U x, U y, U z) {
    const U Rs = sqrt(sq3(x, y, z));
    const U arg3 = wrap_atan2(x * y, z * Rs);
    const U arg4 = log_R_plus(Rs, x, sq2(y, z));
    const U arg5 = log_R_plus(Rs, y, sq2(x, z));
    return rn_sub(rn_sub(rn_mul(z, arg3), rn_mul(x, arg5)), rn_mul(y, arg4));
}

// ftg_corner_potentials (xx, yy, zz, xy, yz, xz) at the flipped z; Gzz alone
// when NDC is 1.
template <typename U, int NDC>
__device__ __noinline__ Vals<U, NDC> ftg_corner(U x, U y, U z) {
    const U Rs = sqrt(sq3(x, y, z));
    Vals<U, NDC> p;
    if constexpr (NDC == 1) {
        p.v[0] = wrap_neg_atan2(x * y, Rs * z);
    } else {
        p.v[0] = wrap_atan2(x * y, rn_add(rn_add(rn_mul(x, x), rn_mul(Rs, z)), rn_mul(z, z)));
        p.v[1] = wrap_atan2(x * y, rn_sub(rn_add(rn_mul(Rs, Rs), rn_mul(Rs, z)), rn_mul(x, x)));
        p.v[2] = wrap_neg_atan2(x * y, Rs * z);
        p.v[3] = log_R_plus(Rs, z, sq2(x, y));
        p.v[4] = half_log_ratio(Rs, x, sq2(y, z));
        p.v[5] = half_log_ratio(Rs, y, sq2(x, z));
    }
    return p;
}

// mag_corner_potentials at s = corner - observation, combined with the field
// as _lattice_closed_rows combines them: txx = f1, txy = -f3, txz = -f5,
// tyy = f2, tyz = -f4, tzz = -(f1 + f2); the rows (k, j) flattened.
template <typename U, int NMC, int NDC>
__device__ __noinline__ Vals<U, NMC * NDC> mag_corner(U rx, U ry, U rz, Field f) {
    const U R = sqrt(sq3(rx, ry, rz));
    const U f1 = atan2(ry * rz, rx * R);
    const U f2 = atan2(rx * rz, ry * R);
    const U f3 = log_R_plus(R, rz, sq2(rx, ry));
    const U f4 = log_R_plus(R, rx, sq2(ry, rz));
    const U f5 = log_R_plus(R, ry, sq2(rx, rz));
    const Tensor3<U> T3 = {{{f1, -f3, -f5}, {-f3, f2, -f4}, {-f5, -f4, -(f1 + f2)}}};
    U row[NMC][NDC];
    combine<U, NMC, NDC>(T3, f, row);
    Vals<U, NMC * NDC> out;
#pragma unroll
    for (int k = 0; k < NMC; ++k)
#pragma unroll
        for (int j = 0; j < NDC; ++j) out.v[k * NDC + j] = row[k][j];
    return out;
}

// The family's corner values at (cx, cy, cz) = observation - corner.
template <typename U, int FAM, int NMC, int NDC>
__device__ __forceinline__ Vals<U, NMC * NDC> corner_values(U cx, U cy, U cz, const Field& f) {
    if constexpr (FAM == GZ) {
        return Vals<U, 1>{{gz_corner(cx, cy, cz)}};
    } else if constexpr (FAM == GZZ || FAM == FTG) {
        return ftg_corner<U, NDC>(cx, cy, -cz);
    } else {
        return mag_corner<U, NMC, NDC>(-cx, -cy, -cz, f);
    }
}

// _diff3 of one cell's corners F[K][L][M] (K along z, L along y, M along x):
// along z, then y, then x; times -G for gravity.
template <typename U, int FAM>
__device__ __forceinline__ U cell_value(U a0, U a1) {
    const U d = a0 - a1;
    return FAM == MAG ? d : U(-G_GRAV) * d;
}

// The closed-form row of a cell from the tile's shared corners F
// ((TZ+1) x 9 x 9 corners of NV values each).
template <typename T, int FAM, int NV>
__device__ __forceinline__ void closed_cell(const T* F, int lz, int ly, int lx, T out[NV]) {
    constexpr int SY = (TX + 1) * NV, SZ = (TY + 1) * SY;
    const T* f = F + lz * SZ + ly * SY + lx * NV;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
        const T a0 = (f[v] - f[SZ + v]) - (f[SY + v] - f[SZ + SY + v]);
        const T a1 = (f[NV + v] - f[SZ + NV + v]) - (f[SY + NV + v] - f[SZ + SY + NV + v]);
        out[v] = cell_value<T, FAM>(a0, a1);
    }
}

// A near cell of the blend (the build of the stored near rows evaluates it):
// its own 8 corners in double, differenced in the same order, rounded to
// float.
// (x, y, z)[M] = observation - edge.
template <int FAM, int NMC, int NDC>
__device__ __forceinline__ void near_cell(const double (&x)[2], const double (&y)[2], const double (&z)[2],
                                          const Field& f, float out[NMC * NDC]) {
    constexpr int NV = NMC * NDC;
    double a[2][NV];  // a[M]: the z- and y-differences at x corner M
#pragma unroll
    for (int M = 0; M < 2; ++M) {
        double g[2][NV];  // g[L]: F[0][L][M] - F[1][L][M]
#pragma unroll
        for (int L = 0; L < 2; ++L) {
            const Vals<double, NV> top = corner_values<double, FAM, NMC, NDC>(x[M], y[L], z[0], f);
            const Vals<double, NV> bottom = corner_values<double, FAM, NMC, NDC>(x[M], y[L], z[1], f);
#pragma unroll
            for (int v = 0; v < NV; ++v) g[L][v] = top.v[v] - bottom.v[v];
        }
#pragma unroll
        for (int v = 0; v < NV; ++v) a[M][v] = g[0][v] - g[1][v];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) out[v] = float(cell_value<double, FAM>(a[0][v], a[1][v]));
}

// A cell's centre and half-width along one axis from its edges e0 < e1,
// rounded as ops/prism.py rounds them: the main loop's tile axes and the near
// pass's cells take them from here alike.
__device__ __forceinline__ void centre_half(float e0, float e1, float& c, float& h) {
    c = __fmul_rn(0.5f, __fadd_rn(e0, e1));
    h = __fmul_rn(0.5f, __fsub_rn(e1, e0));
}

// Whether a window cell is near its observation: the far mask's complement,
// in its order, from dxy = dx^2 + dy^2 and hxy = hx^2 + hy^2 (each rounded as
// column_of rounds it), the centre's z offset dz and half-width hz. The main
// loop zeroes the cells it calls near and the build of the near rows keeps
// them: one function, so the two cannot disagree on a cell.
__device__ __forceinline__ bool is_near(float dxy, float hxy, float dz, float hz) {
    const float r2 = __fadd_rn(dxy, __fmul_rn(dz, dz));
    return r2 <= __fmul_rn(FAR2, __fadd_rn(hxy, __fmul_rn(hz, hz)));
}

// x^2 + y^2 rounded as written (no contraction).
__device__ __forceinline__ float rn_sq2(float x, float y) { return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)); }

// The blend's view of one observation from a thread's column of cells (one
// x and one y cell, several z cells): the offsets of the rules' x and y nodes
// and their square sums, the centre's x and y offsets, and whether the
// column lies in the observation's window along x and y. Shared by the
// thread's cells, which differ in z alone.
struct Column {
    float px2[2], py2[2], xy2[2][2];
    float px3[3], py3[3], xy3[3][3];
    float dxy;  // (cx - xo)^2 + (cy - yo)^2, rounded as far_mask rounds it
    bool in_xy;
};

__device__ __forceinline__ Column column_of(const Axis<float>* ax, int ly, int lx, float xo, float yo,
                                            bool in_xy) {
    Column col;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        col.px2[u] = __fsub_rn(ax[2].p2[lx][u], xo);
        col.py2[u] = __fsub_rn(ax[1].p2[ly][u], yo);
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
        col.px3[u] = __fsub_rn(ax[2].p3[lx][u], xo);
        col.py3[u] = __fsub_rn(ax[1].p3[ly][u], yo);
    }
    square_sums<2>(col.px2, col.py2, col.xy2);
    square_sums<3>(col.px3, col.py3, col.xy3);
    const float dx = __fsub_rn(ax[2].c[lx], xo), dy = __fsub_rn(ax[1].c[ly], yo);
    col.dxy = rn_sq2(dx, dy);
    col.in_xy = in_xy;
    return col;
}

// The main loop's row of the cell at depth lz of a column: the 8-point rule
// outside the window; inside it the 27-point rule, and zero, by a select,
// where the cell is near (is_near: the near pass adds its stored row).
template <int FAM, int NMC, int NDC>
__device__ __forceinline__ void blend_row(const Axis<float>* ax, const Column& col, float hxy, int lz, bool in_z,
                                          float zo, float vol8, const Field& f, float row[NMC][NDC]) {
    if (!(col.in_xy && in_z)) {
        const float pz[2] = {__fsub_rn(ax[0].p2[lz][0], zo), __fsub_rn(ax[0].p2[lz][1], zo)};
        const double w[2] = {1.0, 1.0};
        quad_points<FAM, NMC, NDC, 2>(col.px2, col.py2, pz, col.xy2, w, vol8, f, row);
        return;
    }
    const float pz[3] = {__fsub_rn(ax[0].p3[lz][0], zo), __fsub_rn(ax[0].p3[lz][1], zo),
                         __fsub_rn(ax[0].p3[lz][2], zo)};
    const double w[3] = {GL3_W_OUT, GL3_W_MID, GL3_W_OUT};
    quad_points<FAM, NMC, NDC, 3>(col.px3, col.py3, pz, col.xy3, w, vol8, f, row);
    const bool near = is_near(col.dxy, hxy, __fsub_rn(ax[0].c[lz], zo), ax[0].h[lz]);
#pragma unroll
    for (int k = 0; k < NMC; ++k)
#pragma unroll
        for (int j = 0; j < NDC; ++j) row[k][j] = near ? 0.0f : row[k][j];
}

// ---------------------------------------------------------------- the kernels

struct Lattice {
    const void *xe, *ye, *ze;  // edges (nx+1,), (ny+1,), (nz+1,)
    const void *xd, *yd, *zd;  // (nrows,) observations
    const int* wi0;            // (nrows, 3) window starts (z, y, x), the blend only
    int nx, ny, nz, nrows;
    int wz, wy, wx;  // window sizes, the blend only
    int per;         // observations of a split
};

// One block of either product: tile blockIdx.x of the lattice, observation
// split blockIdx.y. MATVEC: vin = xw (nmc, N), partial (tiles, nrows, ndc).
// Otherwise vin = u (nrows, ndc), partial (splits, nmc, N).
template <typename T, int FAM, int NMC, int NDC, int MODE, bool MATVEC>
__device__ __forceinline__ void lattice_block(const Lattice& L, const T* __restrict__ vin,
                                              double* __restrict__ partial, const Field& f) {
    constexpr int NV = NMC * NDC;
    constexpr int TZ = tile_z(NV);
    constexpr int CPT = TZ * TY * TX / THREADS;  // cells a thread
    constexpr int NCORNER = (TZ + 1) * (TY + 1) * (TX + 1);
    __shared__ Axis<T> ax[3];  // z, y, x
    __shared__ T ox[BATCH], oy[BATCH], oz[BATCH];
    __shared__ int ow[BATCH][3];
    __shared__ double ou[MATVEC ? 1 : BATCH][NDC];
    __shared__ double red[MATVEC ? WARPS : 1][BATCH][NDC];
    __shared__ T F[MODE == CLOSED ? NCORNER : 1][NV];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ntx = (L.nx + TX - 1) / TX, nty = (L.ny + TY - 1) / TY;
    const int tile = blockIdx.x;
    const int z0 = (tile / (ntx * nty)) * TZ, y0 = ((tile / ntx) % nty) * TY, x0 = (tile % ntx) * TX;
    const size_t N = static_cast<size_t>(L.nx) * L.ny * L.nz;

    // The tile's axes (edges past the lattice repeat its last one: no live
    // cell reads them).
    if (tid < 3) {
        const int t0 = tid == 0 ? z0 : tid == 1 ? y0 : x0;
        const int n = tid == 0 ? L.nz : tid == 1 ? L.ny : L.nx;
        const int w = tid == 0 ? TZ : tid == 1 ? TY : TX;
        const void* e = tid == 0 ? L.ze : tid == 1 ? L.ye : L.xe;
        Axis<T>& A = ax[tid];
        for (int l = 0; l <= w; ++l) A.e[l] = at<T>(e, min(t0 + l, n));
        if constexpr (MODE == BLEND) {
            const float n2[2] = {float(-GL2_NODE), float(GL2_NODE)};
            const float n3[3] = {float(-GL3_NODE), 0.0f, float(GL3_NODE)};
            for (int l = 0; l < w; ++l) {
                float c, h;
                centre_half(A.e[l], A.e[l + 1], c, h);
                A.c[l] = c;
                A.h[l] = h;
                for (int u = 0; u < 2; ++u) A.p2[l][u] = __fadd_rn(c, __fmul_rn(n2[u], h));
                for (int u = 0; u < 3; ++u) A.p3[l][u] = __fadd_rn(c, __fmul_rn(n3[u], h));
            }
        }
    }

    // The thread's cells: local q = tid + c * THREADS, x fastest; a column of
    // one (y, x) and CPT depths lz0 + c * ZSTEP.
    static_assert(THREADS % (TY * TX) == 0, "a thread's cells share their x and y");
    constexpr int ZSTEP = THREADS / (TY * TX);
    const int lx = tid % TX, ly = (tid / TX) % TY, lz0 = tid / (TY * TX);
    int lz[CPT];
    bool live[CPT];
    size_t cell[CPT];
    double xv[MATVEC ? CPT : 1][NMC];  // the matvec's xw, exact in double
    double acc[MATVEC ? 1 : CPT][NMC];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        lz[c] = lz0 + c * ZSTEP;
        live[c] = z0 + lz[c] < L.nz && y0 + ly < L.ny && x0 + lx < L.nx;
        cell[c] = (static_cast<size_t>(z0 + lz[c]) * L.ny + (y0 + ly)) * L.nx + (x0 + lx);
#pragma unroll
        for (int k = 0; k < NMC; ++k) {
            if constexpr (MATVEC) {
                xv[c][k] = live[c] ? static_cast<double>(vin[k * N + cell[c]]) : 0.0;
            } else {
                acc[c][k] = 0.0;
            }
        }
    }
    __syncthreads();
    float vol8[MODE == BLEND ? CPT : 1], hxy = 0.0f;
    if constexpr (MODE == BLEND) {
        const float hx = ax[2].h[lx], hy = ax[1].h[ly];
        hxy = rn_sq2(hx, hy);
#pragma unroll
        for (int c = 0; c < CPT; ++c) vol8[c] = __fmul_rn(__fmul_rn(hx, hy), ax[0].h[lz[c]]);
    }

    const int b0 = blockIdx.y * L.per, b1 = min(L.nrows, b0 + L.per);
    for (int base = b0; base < b1; base += BATCH) {
        const int count = min(BATCH, b1 - base);
        __syncthreads();  // the previous batch is read and reduced
        if (tid < count) {
            const int b = base + tid;
            ox[tid] = at<T>(L.xd, b);
            oy[tid] = at<T>(L.yd, b);
            oz[tid] = at<T>(L.zd, b);
            if constexpr (MODE == BLEND) {
#pragma unroll
                for (int a = 0; a < 3; ++a) ow[tid][a] = __ldg(L.wi0 + 3 * static_cast<size_t>(b) + a);
            }
            if constexpr (!MATVEC) {
#pragma unroll
                for (int j = 0; j < NDC; ++j) ou[tid][j] = static_cast<double>(vin[static_cast<size_t>(b) * NDC + j]);
            }
        }
        __syncthreads();
        for (int i = 0; i < count; ++i) {
            const T xo = ox[i], yo = oy[i], zo = oz[i];
            if constexpr (MODE == CLOSED) {
                for (int q = tid; q < NCORNER; q += THREADS) {
                    const int qz = q / ((TY + 1) * (TX + 1)), qy = (q / (TX + 1)) % (TY + 1), qx = q % (TX + 1);
                    if (z0 + qz <= L.nz && y0 + qy <= L.ny && x0 + qx <= L.nx) {
                        const Vals<T, NV> v = corner_values<T, FAM, NMC, NDC>(xo - ax[2].e[qx], yo - ax[1].e[qy],
                                                                              zo - ax[0].e[qz], f);
#pragma unroll
                        for (int w = 0; w < NV; ++w) F[q][w] = v.v[w];
                    }
                }
                __syncthreads();
            }
            int wz0 = 0;
            Column col;
            if constexpr (MODE == BLEND) {
                wz0 = ow[i][0];
                const bool in_xy = static_cast<unsigned>(y0 + ly - ow[i][1]) < static_cast<unsigned>(L.wy) &&
                                   static_cast<unsigned>(x0 + lx - ow[i][2]) < static_cast<unsigned>(L.wx);
                col = column_of(ax, ly, lx, xo, yo, in_xy);
            }
            double d[NDC];
#pragma unroll
            for (int j = 0; j < NDC; ++j) d[j] = 0.0;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                if (!live[c]) continue;
                T row[NMC][NDC];
                if constexpr (MODE == CLOSED) {
                    closed_cell<T, FAM, NV>(&F[0][0], lz[c], ly, lx, &row[0][0]);
                } else {
                    const bool in_z = static_cast<unsigned>(z0 + lz[c] - wz0) < static_cast<unsigned>(L.wz);
                    blend_row<FAM, NMC, NDC>(ax, col, hxy, lz[c], in_z, zo, vol8[c], f, row);
                }
#pragma unroll
                for (int k = 0; k < NMC; ++k) {
#pragma unroll
                    for (int j = 0; j < NDC; ++j) {
                        if constexpr (MATVEC) {
                            d[j] += static_cast<double>(row[k][j]) * xv[c][k];
                        } else {
                            acc[c][k] += static_cast<double>(row[k][j]) * ou[i][j];
                        }
                    }
                }
            }
            if constexpr (MATVEC) {
#pragma unroll
                for (int j = 0; j < NDC; ++j) {
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1) d[j] += __shfl_down_sync(0xffffffffu, d[j], off);
                    if (lane == 0) red[warp][i][j] = d[j];
                }
            }
            if constexpr (MODE == CLOSED) __syncthreads();  // F is read before the next observation's
        }
        if constexpr (MATVEC) {
            __syncthreads();
            for (int t = tid; t < count * NDC; t += THREADS) {
                const int i = t / NDC, j = t % NDC;
                double s = red[0][i][j];
#pragma unroll
                for (int w = 1; w < WARPS; ++w) s += red[w][i][j];
                partial[(static_cast<size_t>(tile) * L.nrows + base + i) * NDC + j] = s;
            }
        }
    }
    if constexpr (!MATVEC) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            if (!live[c]) continue;
#pragma unroll
            for (int k = 0; k < NMC; ++k) partial[(static_cast<size_t>(blockIdx.y) * NMC + k) * N + cell[c]] = acc[c][k];
        }
    }
}

template <typename T, int FAM, int NMC, int NDC, int MODE>
__global__ void __launch_bounds__(THREADS) lattice_matvec_partials(Lattice L, const T* __restrict__ xw,
                                                                   double* __restrict__ partial, Field f) {
    lattice_block<T, FAM, NMC, NDC, MODE, true>(L, xw, partial, f);
}

template <typename T, int FAM, int NMC, int NDC, int MODE>
__global__ void __launch_bounds__(THREADS) lattice_rmatvec_partials(Lattice L, const T* __restrict__ u,
                                                                    double* __restrict__ partial, Field f) {
    lattice_block<T, FAM, NMC, NDC, MODE, false>(L, u, partial, f);
}

// ---------------------------------------------------------------- the near rows (the blend's)

// The near lists (ops/matrixfree.py lattice_near_lists): a CSR of the
// candidates by observation, ptr (nrows + 1,) and idx (ptr[nrows],) in int32,
// each observation's candidate cells (flat) in increasing order.
struct Near {
    const float *xe, *ye, *ze;  // edges (nx+1,), (ny+1,), (nz+1,)
    const float *xd, *yd, *zd;  // (nrows,) observations
    const int *ptr, *idx;
    int nx, ny, nz, nrows;
};

// A cell of the near rows: its edges and, from them, the centre offsets and
// half-widths the main loop's near test reads.
struct NearCell {
    float e[3][2];  // (x, y, z) x (lower, upper) edges
    float c[3], h[3], hxy;
};

__device__ __forceinline__ NearCell near_cell_of(const Near& L, int n) {
    const int ix = n % L.nx, iy = (n / L.nx) % L.ny, iz = n / (L.nx * L.ny);
    NearCell c;
    const float* edges[3] = {L.xe, L.ye, L.ze};
    const int at3[3] = {ix, iy, iz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        c.e[a][0] = __ldg(edges[a] + at3[a]);
        c.e[a][1] = __ldg(edges[a] + at3[a] + 1);
        centre_half(c.e[a][0], c.e[a][1], c.c[a], c.h[a]);
    }
    c.hxy = rn_sq2(c.h[0], c.h[1]);
    return c;
}

// Whether the main loop's test (is_near) calls a candidate pair near.
__device__ __forceinline__ bool near_test(const NearCell& c, float xo, float yo, float zo) {
    const float dxy = rn_sq2(__fsub_rn(c.c[0], xo), __fsub_rn(c.c[1], yo));
    return is_near(dxy, c.hxy, __fsub_rn(c.c[2], zo), c.h[2]);
}

// The row of a candidate pair: the closed forms in double rounded to float
// where the main loop's test calls it near; false (and no row) where not.
template <int FAM, int NMC, int NDC>
__device__ __forceinline__ bool near_row(const NearCell& c, float xo, float yo, float zo, const Field& f,
                                         float row[NMC][NDC]) {
    if (!near_test(c, xo, yo, zo)) return false;
    const double x[2] = {double(xo) - double(c.e[0][0]), double(xo) - double(c.e[0][1])};
    const double y[2] = {double(yo) - double(c.e[1][0]), double(yo) - double(c.e[1][1])};
    const double z[2] = {double(zo) - double(c.e[2][0]), double(zo) - double(c.e[2][1])};
    near_cell<FAM, NMC, NDC>(x, y, z, f, &row[0][0]);
    return true;
}

// The near rows' build, once with the operator (ops/lattice_matvec.py
// lattice_near_build). First the candidates: flag[p] = 1 where the main
// loop's test calls candidate p near; a warp an observation.
__global__ void __launch_bounds__(THREADS) lattice_near_mark_kernel(Near L, unsigned char* __restrict__ flag) {
    const int b = (blockIdx.x * THREADS + threadIdx.x) >> 5;
    if (b >= L.nrows) return;  // a whole warp
    const float xo = __ldg(L.xd + b), yo = __ldg(L.yd + b), zo = __ldg(L.zd + b);
    const int end = __ldg(L.ptr + b + 1);
    for (int p = __ldg(L.ptr + b) + (threadIdx.x & 31); p < end; p += 32)
        flag[p] = near_test(near_cell_of(L, __ldg(L.idx + p)), xo, yo, zo) ? 1 : 0;
}

// Then the rows of the pairs kept (observation obs[p], flat cell cell[p]):
// val[p] = near_row's (nmc, ndc), each cell's own 8 corners in double,
// differenced and rounded to float; a thread a pair.
template <int FAM, int NMC, int NDC>
__global__ void __launch_bounds__(THREADS) lattice_near_rows_kernel(Near L, const int* __restrict__ obs,
                                                                    const int* __restrict__ cell, int nnz,
                                                                    float* __restrict__ val, Field f) {
    const int p = blockIdx.x * THREADS + threadIdx.x;
    if (p >= nnz) return;
    const int b = __ldg(obs + p);
    float row[NMC][NDC];
    if (!near_row<FAM, NMC, NDC>(near_cell_of(L, __ldg(cell + p)), __ldg(L.xd + b), __ldg(L.yd + b),
                                 __ldg(L.zd + b), f, row)) {
#pragma unroll
        for (int k = 0; k < NMC; ++k)
#pragma unroll
            for (int j = 0; j < NDC; ++j) row[k][j] = 0.0f;  // never: the pair was marked near by the same test
    }
#pragma unroll
    for (int k = 0; k < NMC; ++k)
#pragma unroll
        for (int j = 0; j < NDC; ++j) val[static_cast<size_t>(p) * (NMC * NDC) + k * NDC + j] = row[k][j];
}

// The near passes over the stored rows (prism_common.cuh near_stream): the
// matvec's by observation, into the last slot of the matvec's buffer; the
// rmatvec's by cell, into the last split of the rmatvec's buffer.
template <int NMC, int NDC, int G>
__global__ void __launch_bounds__(STREAM_THREADS) lattice_near_matvec_kernel(NearRows r, const float* __restrict__ xw,
                                                                             double* __restrict__ out, size_t N) {
    near_stream<NMC, NDC, G, true>(r, xw, out, N);
}

template <int NMC, int NDC, int G>
__global__ void __launch_bounds__(STREAM_THREADS) lattice_near_rmatvec_kernel(NearRows r,
                                                                              const float* __restrict__ u,
                                                                              double* __restrict__ out, size_t N) {
    near_stream<NMC, NDC, G, false>(r, u, out, N);
}

template <bool MATVEC, int NMC, int NDC, int G>
struct LatticeNearLaunch {
    static void run(const NearRows& r, const float* vin, double* out, size_t N, cudaStream_t stream) {
        if (MATVEC)
            lattice_near_matvec_kernel<NMC, NDC, G>
                <<<near_stream_blocks<G>(r.segments), STREAM_THREADS, 0, stream>>>(r, vin, out, N);
        else
            lattice_near_rmatvec_kernel<NMC, NDC, G>
                <<<near_stream_blocks<G>(r.segments), STREAM_THREADS, 0, stream>>>(r, vin, out, N);
    }
};

// out[i] = the sum of partial[p, i] over p, in order.
template <typename T>
__device__ __forceinline__ void reduce_in_order(const double* __restrict__ partial, T* __restrict__ out, size_t nout,
                                                int parts) {
    const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= nout) return;
    double s = 0.0;
    for (int p = 0; p < parts; ++p) s += partial[static_cast<size_t>(p) * nout + i];
    out[i] = static_cast<T>(s);
}

// The matvec's tiles in order.
template <typename T>
__global__ void __launch_bounds__(THREADS) lattice_matvec_reduce(const double* __restrict__ partial,
                                                                 T* __restrict__ out, size_t nout, int tiles) {
    reduce_in_order(partial, out, nout, tiles);
}

// The rmatvec's observation splits in order.
template <typename T>
__global__ void __launch_bounds__(THREADS) lattice_rmatvec_reduce(const double* __restrict__ partial,
                                                                  T* __restrict__ out, size_t nout, int splits) {
    reduce_in_order(partial, out, nout, splits);
}

// ---------------------------------------------------------------- dispatch

struct Launch {
    Lattice L;
    int tz, ty, tx;   // the caller's tile (checked against tile_z)
    int splits;
    const void* vin;  // xw (nmc, N) or u (nrows, ndc)
    double* partial;  // (tiles, nrows, ndc) or (splits, nmc, N)
    void* out;        // (nrows, ndc) or (nmc, N)
    Field f;
    cudaStream_t stream;
};

template <bool MATVEC, typename T, int FAM, int NMC, int NDC, int MODE>
int launch_products(const Launch& a) {
    constexpr int TZ = tile_z(NMC * NDC);
    if (a.tz != TZ || a.ty != TY || a.tx != TX) return static_cast<int>(cudaErrorInvalidValue);
    const Lattice& L = a.L;
    const int tiles = ((L.nz + TZ - 1) / TZ) * ((L.ny + TY - 1) / TY) * ((L.nx + TX - 1) / TX);
    const dim3 grid(tiles, a.splits);
    const int near = MODE == BLEND;  // the near pass's slot, written before this launch
    if (MATVEC) {
        lattice_matvec_partials<T, FAM, NMC, NDC, MODE><<<grid, THREADS, 0, a.stream>>>(
            L, static_cast<const T*>(a.vin), a.partial, a.f);
        const size_t nout = static_cast<size_t>(L.nrows) * NDC;
        lattice_matvec_reduce<T><<<static_cast<unsigned>((nout + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
            a.partial, static_cast<T*>(a.out), nout, tiles + near);
    } else {
        lattice_rmatvec_partials<T, FAM, NMC, NDC, MODE><<<grid, THREADS, 0, a.stream>>>(
            L, static_cast<const T*>(a.vin), a.partial, a.f);
        const size_t nout = static_cast<size_t>(NMC) * L.nx * L.ny * L.nz;
        lattice_rmatvec_reduce<T><<<static_cast<unsigned>((nout + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
            a.partial, static_cast<T*>(a.out), nout, a.splits + near);
    }
    return static_cast<int>(cudaGetLastError());
}

template <bool MATVEC, typename T, int MODE>
int launch_family(int family, int nmc, int ndc, const Launch& a) {
#define LATTICE_CASE(FAM, NMC, NDC) \
    if (family == FAM && nmc == NMC && ndc == NDC) return launch_products<MATVEC, T, FAM, NMC, NDC, MODE>(a);
    FOR_EACH_FAMILY(LATTICE_CASE)
#undef LATTICE_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool MATVEC>
int launch(int is_double, int family, int nmc, int ndc, int mode, const Launch& a) {
    if (a.L.nx <= 0 || a.L.ny <= 0 || a.L.nz <= 0 || a.L.nrows <= 0 || a.splits <= 0 || a.L.per <= 0 ||
        static_cast<long long>(a.splits) * a.L.per < a.L.nrows)
        return static_cast<int>(cudaErrorInvalidValue);
    if (mode == BLEND && (a.L.wi0 == nullptr || a.L.wz <= 0 || a.L.wy <= 0 || a.L.wx <= 0))
        return static_cast<int>(cudaErrorInvalidValue);
    if (is_double) {
        if (mode != CLOSED) return static_cast<int>(cudaErrorInvalidValue);  // the blend is float's
        return launch_family<MATVEC, double, CLOSED>(family, nmc, ndc, a);
    }
    if (mode == BLEND) return launch_family<MATVEC, float, BLEND>(family, nmc, ndc, a);
    return launch_family<MATVEC, float, CLOSED>(family, nmc, ndc, a);
}

// The build's rows kernel of one family.
int near_rows_family(int family, int nmc, int ndc, const Near& L, const int* obs, const int* cell, int nnz,
                     float* val, const Field& f, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((nnz + THREADS - 1) / THREADS);
#define ROWS_CASE(FAM, NMC, NDC)                                                                                 \
    if (family == FAM && nmc == NMC && ndc == NDC) {                                                             \
        lattice_near_rows_kernel<FAM, NMC, NDC><<<blocks, THREADS, 0, stream>>>(L, obs, cell, nnz, val, f);      \
        return static_cast<int>(cudaGetLastError());                                                             \
    }
    FOR_EACH_FAMILY(ROWS_CASE)
#undef ROWS_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One signature for both entry points. is_double: the operator's type;
// family: Family; mode: Mode; (tz, ty, tx): the tile ops/lattice_matvec.py
// planned; splits of per observations each.
#define LATTICE_ARGS                                                                                          \
    int is_double, int family, int nmc, int ndc, int mode, int tz, int ty, int tx, const void *xe,           \
        const void *ye, const void *ze, const void *xd, const void *yd, const void *zd, const void *wi0,     \
        const void *vin, void *partial, void *out, int nx, int ny, int nz, int nrows, int wz, int wy, int wx, \
        int splits, int per, double m0, double m1, double m2, double s4pi, void *stream
#define LATTICE_LAUNCH                                                                                         \
    Launch {                                                                                                   \
        Lattice{xe, ye, ze, xd, yd, zd, static_cast<const int*>(wi0), nx, ny, nz, nrows, wz, wy, wx, per}, tz, \
            ty, tx, splits, vin, static_cast<double*>(partial), out, Field{m0, m1, m2, s4pi, 0},               \
            static_cast<cudaStream_t>(stream)                                                                  \
    }

extern "C" int lattice_matvec(LATTICE_ARGS) {
    return launch<true>(is_double, family, nmc, ndc, mode, LATTICE_LAUNCH);
}

extern "C" int lattice_rmatvec(LATTICE_ARGS) {
    return launch<false>(is_double, family, nmc, ndc, mode, LATTICE_LAUNCH);
}

// The build of the blend's near rows, float only, run once with the operator
// (ops/lattice_matvec.py lattice_near_build). lattice_near_mark: flag
// (ptr[nrows],) bytes over the candidates ptr, idx by observation.
// lattice_near_rows: val (nnz, nmc, ndc) of the pairs kept, observation
// obs[p] and flat cell cell[p] (int32).
#define NEAR_GEOMETRY                                                                                          \
    const void *xe, const void *ye, const void *ze, const void *xd, const void *yd, const void *zd
#define NEAR_LISTS(PTR, IDX)                                                                                   \
    Near {                                                                                                     \
        static_cast<const float*>(xe), static_cast<const float*>(ye), static_cast<const float*>(ze),          \
            static_cast<const float*>(xd), static_cast<const float*>(yd), static_cast<const float*>(zd),      \
            static_cast<const int*>(PTR), static_cast<const int*>(IDX), nx, ny, nz, nrows                      \
    }

extern "C" int lattice_near_mark(NEAR_GEOMETRY, const void *ptr, const void *idx, int nx, int ny, int nz, int nrows,
                                 void *flag, void *stream) {
    if (nx <= 0 || ny <= 0 || nz <= 0 || nrows <= 0 || ptr == nullptr || idx == nullptr || flag == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((static_cast<size_t>(nrows) * 32 + THREADS - 1) / THREADS);
    lattice_near_mark_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        NEAR_LISTS(ptr, idx), static_cast<unsigned char*>(flag));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int lattice_near_rows(int family, int nmc, int ndc, NEAR_GEOMETRY, const void *obs, const void *cell,
                                 int nnz, int nx, int ny, int nz, int nrows, void *val, double m0, double m1,
                                 double m2, double s4pi, void *stream) {
    if (nx <= 0 || ny <= 0 || nz <= 0 || nrows <= 0 || nnz < 0 ||
        (nnz > 0 && (obs == nullptr || cell == nullptr || val == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (nnz == 0) return static_cast<int>(cudaGetLastError());
    return near_rows_family(family, nmc, ndc, NEAR_LISTS(nullptr, nullptr), static_cast<const int*>(obs),
                            static_cast<const int*>(cell), nnz, static_cast<float*>(val), Field{m0, m1, m2, s4pi, 0},
                            static_cast<cudaStream_t>(stream));
}

// The blend's near passes over the stored rows, float only, each run before
// the product's lattice_matvec or lattice_rmatvec on its stream. Matvec: ptr,
// idx, val the rows by observation (segments = the padded rows), vin = xw
// (nmc, N), out the (nrows, ndc) last slot of the matvec's buffer. Rmatvec:
// ptr, idx, val, seg the rows by cell (segments = the cells that have a near
// pair), vin = u (nrows, ndc), out the (nmc, N) last split of the rmatvec's
// buffer (cleared here first). lanes: a segment's group (ops/matrixfree.py
// stream_lanes).
#define NEAR_ARGS                                                                                              \
    int nmc, int ndc, int lanes, const void *ptr, const void *idx, const void *val, const void *seg,           \
        int segments, const void *vin, void *out, int N, void *stream
#define NEAR_ROWS                                                                                              \
    NearRows {                                                                                                \
        static_cast<const int*>(ptr), static_cast<const int*>(idx), static_cast<const float*>(val),           \
            static_cast<const int*>(seg), segments                                                            \
    }

extern "C" int lattice_near_matvec(NEAR_ARGS) {
    return near_stream_pass<LatticeNearLaunch, true>(nmc, ndc, lanes, NEAR_ROWS, vin, out, N,
                                                     static_cast<cudaStream_t>(stream));
}

extern "C" int lattice_near_rmatvec(NEAR_ARGS) {
    return near_stream_pass<LatticeNearLaunch, false>(nmc, ndc, lanes, NEAR_ROWS, vin, out, N,
                                                      static_cast<cudaStream_t>(stream));
}
