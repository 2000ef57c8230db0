// Tile-union block-sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the TPU kernel tile_matvec / _tile_matvec_kernel of
// tomofastx_tpu/ops/pallas_kernels.py. It computes the same function and is
// laid out for this card, not carried over step by step.
//
//   y[8*i + m] = sum_b sum_k uvals[i, b, m, k] * x[128 * ubidx[i, b] + k]
//
//   uvals (ntiles, BU, 8, 128) float32   values of tile i, union slot b
//   ubidx (ntiles, BU)         int32     128-column block that slot b reads
//   x     (NB * 128,)          float32 or float64
//   y     (ntiles * 8,)        the type of x
//
// Pad slots point at block 0 and hold zeros, so every slot is computed alike.
//
// What bounds it: bytes. Every value of uvals is read once and used for one
// multiply-add, so the least time is the size of uvals over the memory rate;
// x is small and stays in the L2 cache, and the arithmetic is a few percent
// of what the card could do in that time.
//
// What the design does about it: one thread block owns one tile, whose slots
// are one contiguous run of BU * 4 KB. Each of the 8 warps walks every 8th
// slot. A lane reads 16 bytes (float4) of each of the slot's 8 rows, so a warp
// reads a whole 512-byte row per instruction and keeps 8 such loads in flight;
// the loads of uvals bypass the cache's keep policy (__ldcs) because nothing
// reads them twice, the loads of x go through the read-only path (__ldg).
// Eight accumulators per lane stay in registers in the type of x (float64
// when x is float64, which is what a double-precision solve needs). A shuffle
// reduction over the lanes and a small shared-memory sum over the warps give
// the tile's 8 outputs. No atomics: the sum order is fixed, so two runs agree
// bit for bit.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TM = 8;          // rows of a tile
constexpr int BLOCK = 128;     // columns of a block
constexpr int SLOT = TM * BLOCK;
constexpr int WARPS = 8;       // warps of a thread block
constexpr int THREADS = WARPS * 32;

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
__global__ void __launch_bounds__(THREADS)
tile_matvec_kernel(const float* __restrict__ uvals, const int* __restrict__ ubidx,
                   const T* __restrict__ x, T* __restrict__ y, int bu) {
    const int tile = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    const float* tile_vals = uvals + static_cast<size_t>(tile) * bu * SLOT;
    const int* tile_idx = ubidx + static_cast<size_t>(tile) * bu;

    T acc[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) acc[m] = T(0);

#pragma unroll 2
    for (int b = warp; b < bu; b += WARPS) {
        const int block = __ldg(tile_idx + b);
        const X4<T> xv = load_x4(x + static_cast<size_t>(block) * BLOCK + lane * 4);
        const float4* rows =
            reinterpret_cast<const float4*>(tile_vals + static_cast<size_t>(b) * SLOT) + lane;
        float4 u[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) u[m] = __ldcs(rows + m * (BLOCK / 4));
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            acc[m] += T(u[m].x) * xv.a;
            acc[m] += T(u[m].y) * xv.b;
            acc[m] += T(u[m].z) * xv.c;
            acc[m] += T(u[m].w) * xv.d;
        }
    }

#pragma unroll
    for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc[m] += __shfl_down_sync(0xffffffffu, acc[m], off);
    }

    __shared__ T part[WARPS][TM];
    if (lane == 0) {
#pragma unroll
        for (int m = 0; m < TM; ++m) part[warp][m] = acc[m];
    }
    __syncthreads();
    if (threadIdx.x < TM) {
        T s = T(0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
        y[static_cast<size_t>(tile) * TM + threadIdx.x] = s;
    }
}

template <typename T>
int launch(const void* uvals, const void* ubidx, const void* x, void* y,
           int ntiles, int bu, void* stream) {
    if (ntiles > 0) {
        tile_matvec_kernel<T><<<ntiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(uvals), static_cast<const int*>(ubidx),
            static_cast<const T*>(x), static_cast<T*>(y), bu);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tile_matvec_f32(const void* uvals, const void* ubidx, const void* x, void* y,
                               int ntiles, int bu, void* stream) {
    return launch<float>(uvals, ubidx, x, y, ntiles, bu, stream);
}

extern "C" int tile_matvec_f64(const void* uvals, const void* ubidx, const void* x, void* y,
                               int ntiles, int bu, void* stream) {
    return launch<double>(uvals, ubidx, x, y, ntiles, bu, stream);
}
