// Matrix-vector products on a bfloat16-stored dense matrix, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the bfloat16 to
// float32 conversion into its GEMV on the bfloat16 kernel that
// tpu.kernelStoreDtype = bfloat16 stores (tomofastx_tpu/ops/sparse_kernel.py,
// DenseKernel.matvec and rmatvec on the S that tomofastx_tpu/inversion/
// workflow.py:474-488 casts). PyTorch has no call that computes this function,
// so it is written here.
//
//   matvec:  y[r] = sum_c float(S[r, c]) * x[c]
//   rmatvec: g[c] = sum_r float(S[r, c]) * u[r]
//
//   S  (nrows, ncols) bfloat16, row-major; both products read this one S
//   x, u, y, g        float32 (sums in float32) or float64 (sums in float64)
//
// What bounds them: bytes. Each value of S is read once a product and used for
// one multiply-add, so the least time is the size of S over the memory rate;
// the vectors are small beside it (x: a megabyte at the smoke shape, which the
// L2 cache holds).
//
// What the design does about it.
// matvec: one warp owns one row. A lane reads 16 bytes (8 values) of the row
// at a time, so a warp reads 512 contiguous bytes in one instruction, and each
// lane keeps 4 such loads in flight before it uses the first. The loads of S
// bypass the cache's keep policy (__ldcs): nothing reads them twice. The
// conversion of bfloat16 to float is exact and takes a shift or a mask of the
// 32-bit word that holds two values; the float32 matrix never exists. The x
// values come through the read-only path (__ldg). A shuffle reduction over the
// lanes gives the row's output.
// rmatvec: threads run across the columns, 8 a thread (one 16-byte load a
// row), 2048 a thread block, so a warp reads 512 contiguous bytes of every
// row and the reads stay coalesced without a transpose. The rows are cut into
// slabs (a function of the shape, chosen by the wrapper so that there are
// enough thread blocks to fill the card); a block sums its slab's rows for its
// columns in registers, 4 rows' loads in flight, and writes the slab's partial
// sums to a buffer. A second kernel adds the partials of each column in slab
// order. No float atomics anywhere: every sum has a fixed order, so two runs,
// and a product on a one-slot mesh, agree to the last bit.
//
// A row length that is not a multiple of 8 values (so rows start off 16-byte
// alignment) takes a plain path with 2-byte loads.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // rows of a matvec thread block
constexpr int THREADS = WARPS * 32;   // threads of every thread block here
constexpr int DEPTH = 4;              // 16-byte loads in flight per lane
constexpr int COLS = THREADS * 8;     // columns of an rmatvec thread block
constexpr unsigned FULL = 0xffffffffu;

// The two bfloat16 values of a 32-bit word, exactly, as floats.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
    return lo_bf16(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Eight x values, in the accumulation type.
template <typename T>
struct X8 {
    T v[8];
};

__device__ __forceinline__ X8<float> load_x8(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ X8<double> load_x8(const double* p) {
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
    return {{a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y}};
}

// acc + sum of the 8 products of one 16-byte load of S with 8 x values, in order.
template <typename T>
__device__ __forceinline__ T dot8(const uint4 s, const X8<T>& x, T acc) {
    acc += T(lo_bf16(s.x)) * x.v[0];
    acc += T(hi_bf16(s.x)) * x.v[1];
    acc += T(lo_bf16(s.y)) * x.v[2];
    acc += T(hi_bf16(s.y)) * x.v[3];
    acc += T(lo_bf16(s.z)) * x.v[4];
    acc += T(hi_bf16(s.z)) * x.v[5];
    acc += T(lo_bf16(s.w)) * x.v[6];
    acc += T(hi_bf16(s.w)) * x.v[7];
    return acc;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bf16_matvec_kernel(const __nv_bfloat16* __restrict__ S, const T* __restrict__ x, T* __restrict__ y,
                   int nrows, int ncols) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + warp;
    if (row >= nrows) return;  // whole warps leave; nothing below waits on a block
    const __nv_bfloat16* srow = S + static_cast<size_t>(row) * ncols;

    T acc = T(0);
    if (VEC) {
        const uint4* s16 = reinterpret_cast<const uint4*>(srow);
        const int nvec = ncols >> 3;
        for (int base = 0; base < nvec; base += 32 * DEPTH) {
            uint4 s[DEPTH];
#pragma unroll
            for (int u = 0; u < DEPTH; ++u) {
                const int k = base + u * 32 + lane;
                s[u] = k < nvec ? __ldcs(s16 + k) : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < DEPTH; ++u) {
                const int k = base + u * 32 + lane;
                if (k < nvec) acc = dot8(s[u], load_x8(x + static_cast<size_t>(k) * 8), acc);
            }
        }
    } else {
        for (int c = lane; c < ncols; c += 32) acc += T(bf16_at(srow + c)) * __ldg(x + c);
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
    if (lane == 0) y[row] = acc;
}

// partial[slab, c] = sum over the slab's rows r of S[r, c] * u[r], for this
// thread's 8 columns c0 .. c0 + 7.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
bf16_rmatvec_partial(const __nv_bfloat16* __restrict__ S, const T* __restrict__ u, T* __restrict__ partial,
                     int nrows, int ncols, int rows_per_slab) {
    const int slab = blockIdx.y;
    const int c0 = (blockIdx.x * THREADS + threadIdx.x) * 8;
    if (c0 >= ncols) return;
    const int r0 = slab * rows_per_slab;
    const int r1 = min(nrows, r0 + rows_per_slab);

    T acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = T(0);

    if (VEC) {
        int r = r0;
        for (; r + DEPTH <= r1; r += DEPTH) {
            uint4 s[DEPTH];
            T ur[DEPTH];
#pragma unroll
            for (int q = 0; q < DEPTH; ++q) {
                s[q] = __ldcs(reinterpret_cast<const uint4*>(S + static_cast<size_t>(r + q) * ncols + c0));
                ur[q] = __ldg(u + r + q);
            }
#pragma unroll
            for (int q = 0; q < DEPTH; ++q) {
                acc[0] += T(lo_bf16(s[q].x)) * ur[q];
                acc[1] += T(hi_bf16(s[q].x)) * ur[q];
                acc[2] += T(lo_bf16(s[q].y)) * ur[q];
                acc[3] += T(hi_bf16(s[q].y)) * ur[q];
                acc[4] += T(lo_bf16(s[q].z)) * ur[q];
                acc[5] += T(hi_bf16(s[q].z)) * ur[q];
                acc[6] += T(lo_bf16(s[q].w)) * ur[q];
                acc[7] += T(hi_bf16(s[q].w)) * ur[q];
            }
        }
        for (; r < r1; ++r) {
            const uint4 s = __ldcs(reinterpret_cast<const uint4*>(S + static_cast<size_t>(r) * ncols + c0));
            const T ur = __ldg(u + r);
            acc[0] += T(lo_bf16(s.x)) * ur;
            acc[1] += T(hi_bf16(s.x)) * ur;
            acc[2] += T(lo_bf16(s.y)) * ur;
            acc[3] += T(hi_bf16(s.y)) * ur;
            acc[4] += T(lo_bf16(s.z)) * ur;
            acc[5] += T(hi_bf16(s.z)) * ur;
            acc[6] += T(lo_bf16(s.w)) * ur;
            acc[7] += T(hi_bf16(s.w)) * ur;
        }
    } else {
        for (int r = r0; r < r1; ++r) {
            const T ur = __ldg(u + r);
            const __nv_bfloat16* srow = S + static_cast<size_t>(r) * ncols;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (c0 + j < ncols) acc[j] += T(bf16_at(srow + c0 + j)) * ur;
        }
    }

    T* out = partial + static_cast<size_t>(slab) * ncols + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        if (VEC || c0 + j < ncols) out[j] = acc[j];
}

// g[c] = sum over the slabs, in slab order, of partial[slab, c].
template <typename T>
__global__ void __launch_bounds__(THREADS)
bf16_rmatvec_reduce(const T* __restrict__ partial, T* __restrict__ g, int ncols, int nslabs) {
    const int c = blockIdx.x * THREADS + threadIdx.x;
    if (c >= ncols) return;
    T acc = partial[c];
    for (int s = 1; s < nslabs; ++s) acc += partial[static_cast<size_t>(s) * ncols + c];
    g[c] = acc;
}

template <typename T>
int launch_matvec(const void* S, const void* x, void* y, int nrows, int ncols, void* stream) {
    if (nrows > 0) {
        const int blocks = (nrows + WARPS - 1) / WARPS;
        const auto s = static_cast<cudaStream_t>(stream);
        const auto* Sb = static_cast<const __nv_bfloat16*>(S);
        if (ncols % 8 == 0)
            bf16_matvec_kernel<T, true><<<blocks, THREADS, 0, s>>>(Sb, static_cast<const T*>(x),
                                                                   static_cast<T*>(y), nrows, ncols);
        else
            bf16_matvec_kernel<T, false><<<blocks, THREADS, 0, s>>>(Sb, static_cast<const T*>(x),
                                                                    static_cast<T*>(y), nrows, ncols);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rmatvec(const void* S, const void* u, void* partial, void* g, int nrows, int ncols, int nslabs,
                   void* stream) {
    if (ncols > 0 && nslabs > 0) {
        const auto s = static_cast<cudaStream_t>(stream);
        const auto* Sb = static_cast<const __nv_bfloat16*>(S);
        const int rows_per_slab = nrows > 0 ? (nrows + nslabs - 1) / nslabs : 0;
        const dim3 grid((ncols + COLS - 1) / COLS, nslabs);
        if (ncols % 8 == 0)
            bf16_rmatvec_partial<T, true><<<grid, THREADS, 0, s>>>(
                Sb, static_cast<const T*>(u), static_cast<T*>(partial), nrows, ncols, rows_per_slab);
        else
            bf16_rmatvec_partial<T, false><<<grid, THREADS, 0, s>>>(
                Sb, static_cast<const T*>(u), static_cast<T*>(partial), nrows, ncols, rows_per_slab);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        bf16_rmatvec_reduce<T><<<(ncols + THREADS - 1) / THREADS, THREADS, 0, s>>>(
            static_cast<const T*>(partial), static_cast<T*>(g), ncols, nslabs);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One signature for the four: S, the vector, the slab partials (matvec: unused),
// the output, nrows, ncols, slabs (matvec: unused), stream.
extern "C" int bf16_matvec_f32(const void* S, const void* x, void*, void* y, int nrows, int ncols, int,
                               void* stream) {
    return launch_matvec<float>(S, x, y, nrows, ncols, stream);
}

extern "C" int bf16_matvec_f64(const void* S, const void* x, void*, void* y, int nrows, int ncols, int,
                               void* stream) {
    return launch_matvec<double>(S, x, y, nrows, ncols, stream);
}

extern "C" int bf16_rmatvec_f32(const void* S, const void* u, void* partial, void* g, int nrows, int ncols,
                                int nslabs, void* stream) {
    return launch_rmatvec<float>(S, u, partial, g, nrows, ncols, nslabs, stream);
}

extern "C" int bf16_rmatvec_f64(const void* S, const void* u, void* partial, void* g, int nrows, int ncols,
                                int nslabs, void* stream) {
    return launch_rmatvec<double>(S, u, partial, g, nrows, ncols, nslabs, stream);
}
