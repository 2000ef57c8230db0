// Row-block sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the TPU kernel blocked_matvec / _blocked_matvec_kernel of
// tomofastx_tpu/ops/pallas_kernels.py. It computes the same function and is
// laid out for this card, not carried over step by step.
//
//   y[r] = sum_b sum_k bvals[r, b, k] * x[128 * bidx[r, b] + k]
//
//   bvals (nrows, B, 128) float32   row r's values in its slot b
//   bidx  (nrows, B)      int32     128-column block that slot b of row r reads
//   x     (NB * 128,)     float32 or float64
//   y     (nrows,)        the type of x
//
// Pad slots point at any valid block and hold zeros, so every slot is computed
// alike. Any number of rows and of slots is taken.
//
// What bounds it: bytes. Every value of bvals is read once and used for one
// multiply-add, so the least time is the size of bvals over the memory rate;
// x is small and stays in the L2 cache, and the arithmetic is a few percent of
// what the card could do in that time.
//
// What the design does about it: one warp owns one row, whose slots are one
// contiguous run of B * 512 bytes, and a thread block holds 8 such warps. A
// lane reads 16 bytes (float4) of a slot, so a warp reads the slot's 512 bytes
// in one instruction, and it keeps 8 slots in flight before it uses the first.
// The loads of bvals bypass the cache's keep policy (__ldcs) because nothing
// reads them twice; the loads of x go through the read-only path (__ldg). The
// block ids of 32 slots are read with one coalesced load, one per lane, and
// handed round by shuffle, so no lane waits on a scalar load per slot (the
// scalar-indexed loads are what made the TPU kernel slow on its machine). The
// accumulator stays in a register in the type of x (float64 when x is float64,
// which is what a double-precision solve needs). A shuffle reduction over the
// lanes gives the row's output. No atomics and no shared memory: the sum order
// is fixed, so two runs agree bit for bit.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;     // columns of a block
constexpr int WARPS = 8;       // warps (rows) of a thread block
constexpr int THREADS = WARPS * 32;
constexpr int DEPTH = 8;       // slots in flight per warp
constexpr unsigned FULL = 0xffffffffu;

// The four x values a lane multiplies with, in the accumulation type.
template <typename T>
struct X4 {
    T a, b, c, d;
};

__device__ __forceinline__ X4<float> load_x4(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    return {t.x, t.y, t.z, t.w};
}

__device__ __forceinline__ X4<double> load_x4(const double* p) {
    const double2 lo = __ldg(reinterpret_cast<const double2*>(p));
    const double2 hi = __ldg(reinterpret_cast<const double2*>(p) + 1);
    return {lo.x, lo.y, hi.x, hi.y};
}

template <typename T>
__device__ __forceinline__ T dot4(const float4 v, const X4<T> xv, T acc) {
    acc += T(v.x) * xv.a;
    acc += T(v.y) * xv.b;
    acc += T(v.z) * xv.c;
    acc += T(v.w) * xv.d;
    return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_matvec_kernel(const float* __restrict__ bvals, const int* __restrict__ bidx,
                      const T* __restrict__ x, T* __restrict__ y, int nrows, int nslots) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + warp;
    if (row >= nrows) return;  // whole warps leave; nothing below waits on a block

    // Lane's float4 of slot b is row_vals[b * 32].
    const float4* row_vals =
        reinterpret_cast<const float4*>(bvals + static_cast<size_t>(row) * nslots * BLOCK) + lane;
    const int* row_idx = bidx + static_cast<size_t>(row) * nslots;
    const T* x_lane = x + lane * 4;

    T acc = T(0);
    for (int b0 = 0; b0 < nslots; b0 += 32) {
        const int nb = min(32, nslots - b0);
        const int mine = lane < nb ? __ldg(row_idx + b0 + lane) : 0;
        int j = 0;
        for (; j + DEPTH <= nb; j += DEPTH) {
            float4 v[DEPTH];
            X4<T> xv[DEPTH];
#pragma unroll
            for (int u = 0; u < DEPTH; ++u) {
                const int block = __shfl_sync(FULL, mine, j + u);
                v[u] = __ldcs(row_vals + static_cast<size_t>(b0 + j + u) * (BLOCK / 4));
                xv[u] = load_x4(x_lane + static_cast<size_t>(block) * BLOCK);
            }
#pragma unroll
            for (int u = 0; u < DEPTH; ++u) acc = dot4(v[u], xv[u], acc);
        }
        for (; j < nb; ++j) {
            const int block = __shfl_sync(FULL, mine, j);
            const float4 v = __ldcs(row_vals + static_cast<size_t>(b0 + j) * (BLOCK / 4));
            acc = dot4(v, load_x4(x_lane + static_cast<size_t>(block) * BLOCK), acc);
        }
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
    if (lane == 0) y[row] = acc;
}

template <typename T>
int launch(const void* bvals, const void* bidx, const void* x, void* y,
           int nrows, int nslots, void* stream) {
    if (nrows > 0) {
        const int blocks = (nrows + WARPS - 1) / WARPS;
        blocked_matvec_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(bvals), static_cast<const int*>(bidx),
            static_cast<const T*>(x), static_cast<T*>(y), nrows, nslots);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int blocked_matvec_f32(const void* bvals, const void* bidx, const void* x, void* y,
                                  int nrows, int nslots, void* stream) {
    return launch<float>(bvals, bidx, x, y, nrows, nslots, stream);
}

extern "C" int blocked_matvec_f64(const void* bvals, const void* bidx, const void* x, void* y,
                                  int nrows, int nslots, void* stream) {
    return launch<double>(bvals, bidx, x, y, nrows, nslots, stream);
}
