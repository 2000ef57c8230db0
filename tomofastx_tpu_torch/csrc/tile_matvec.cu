// Tile-union block-sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package: tile_matvec /
// _tile_matvec_kernel of tomofastx_tpu/ops/pallas_kernels.py (kernel 1), and
// TileKernel._shard_map_pallas of tomofastx_tpu/ops/tile_kernel.py (kernel 2,
// kernel 1 on each device's part of the tile axis). It computes the same
// function and is laid out for this card, not carried over step by step.
//
//   y[8*i + m] = sum_b sum_k uvals[i, b, m, k] * x[128 * ubidx[i, b] + k]
//
//   uvals (ntiles, BU, 8, 128) float32   values of tile i, union slot b
//   ubidx (ntiles, BU)         int32     128-column block that slot b reads
//   x     (NB * 128,)          float32 or float64
//   y     (ntiles * 8,)        the type of x
//
// Pad slots point at block 0 and hold zeros, so every slot is computed alike.
// One launch takes a table of parts (kernel 2): packs of one BU on this
// device, each with its own uvals, ubidx and first output tile in y.
//
// What bounds it: bytes. Every value of uvals is read once and used for one
// multiply-add, so the least time is the size of uvals over the memory rate;
// x is small and stays in the L2 cache, and the arithmetic is a few percent
// of what the card could do in that time.
//
// The sum order it keeps. A tile's row sums are 8 chains, chain c adding
// the tile's slots c, c+8, c+16, ... in turn (a lane its 4 columns, each
// product one multiply-add into the row's accumulator), each chain then
// reduced over its 32 lanes by shuffles, and the 8 chain sums added in chain
// order: the order of the one-block-a-tile kernel it replaces, so its
// outputs are that kernel's to the last bit. (A first design summed other
// runs of slots; more exact against float64 sums, it moved the float32
// solves of the smoke's joint and coupled problems past the formats'
// tolerance from the dense runs: PERF.md.) The order depends on BU alone,
// so a pack cut into parts gives the whole pack's outputs to the last bit.
//
// What the design does about the bytes (scripts/probe_torch_tile_matvec.py
// and chip_smoke.py time it against that kernel and torch.mv; PERF.md):
//
// - Short tiles (BU <= 32 slots, the adjoint's): a thread block sums WARPS
//   whole tiles side by side, one consumer warp a tile, its 8 chains one
//   after another, each reduced by shuffles alone: no __syncthreads between
//   tiles, ~1 MB of values a block.
// - Long tiles (the forward's, BU ~ 1950): a tile is cut into its 8 chains,
//   one thread block each (one consumer warp, ~1 MB of values), the 8
//   launched as one thread block cluster; block rank 0 adds
//   the 8 chain sums in rank order through distributed shared memory: one
//   launch, no float atomics, no scratch. 4096 such blocks at the smoke's
//   shape, several resident on each SM, so the card fills evenly.
// - Values stream through a ring of stages in dynamic shared memory, a stage
//   holding one 4 KB slot for each consumer warp. One producer thread keeps
//   the stages in flight with 1-D bulk copies (cp.async.bulk, the TMA engine;
//   one 4 KB copy a slot) under an evict-first L2 policy, completing an
//   mbarrier a stage; the consumer warps wait on it, read their slots and
//   free the stage through a second mbarrier. x comes through the read-only
//   path one slot ahead of its use; eight accumulators per lane stay in
//   registers in the type of x (float64 when x is float64).
// - The ring's depth (3 stages of 8 slots for short tiles, 96 KB, two blocks
//   an SM; 8 stages of one slot for a chain, 32 KB) is the fastest of the
//   shapes the probe timed; 2 to 16 stages, 2 or 4 tiles a block, and a
//   short tile's chain reduced beside the next chain's products all read
//   within 1 % of it.
//
// Plain C entry points, loaded with ctypes; the launch returns the launch's
// error or cudaGetLastError(). The library allocates nothing and reads
// nothing back from the device: the wrapper sets the shared-memory attribute
// (tile_matvec_prepare) and checks that a cluster shape can be scheduled
// (tile_matvec_max_active_clusters) before it launches, and picks the
// launch's block size and ring from the plan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

#ifndef TILE_MATVEC_WARPS
#define TILE_MATVEC_WARPS 8
#endif
#ifndef TILE_MATVEC_STAGES
#define TILE_MATVEC_STAGES 3
#endif
#ifndef TILE_MATVEC_CHAIN_STAGES
#define TILE_MATVEC_CHAIN_STAGES 8
#endif

namespace {

constexpr int TM = 8;          // rows of a tile
constexpr int BLOCK = 128;     // columns of a block
constexpr int SLOT = TM * BLOCK;
constexpr uint32_t SLOT_BYTES = SLOT * sizeof(float);
constexpr int CHAINS = 8;                              // chains of a tile's sum order
constexpr int WARPS = TILE_MATVEC_WARPS;               // short tiles: consumer warps (tiles) a block
constexpr int STAGES = TILE_MATVEC_STAGES;             // short tiles: stages of the ring
constexpr int CHAIN_STAGES = TILE_MATVEC_CHAIN_STAGES;  // long tiles: stages of a chain's ring
constexpr int MAX_PARTS = 64;

// A launch's shape: long tiles (CHAIN) take one consumer warp a block, short
// tiles WARPS; one producer warp each.
template <bool CHAIN>
struct Shape {
    static constexpr int consumers = CHAIN ? 1 : WARPS;
    static constexpr int stages = CHAIN ? CHAIN_STAGES : STAGES;
    static constexpr int threads = (consumers + 1) * 32;
    static constexpr int ring_bytes = stages * consumers * SLOT_BYTES;
};

// One part of a launch; the wrapper's ctypes structure has this layout.
struct Part {
    const float* uvals;
    const int* ubidx;
    long long tile0;   // first output tile of the part in y
    long long block0;  // first thread block of the part in the grid
    int ntiles;
    int pad;
};

struct Table {
    Part part[MAX_PARTS];
    int nparts;
};

// ---- mbarriers and bulk copies (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    return policy;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
}

// ---- the x values a lane multiplies with, in the accumulation type ----

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

// The k-th slot of a short tile's chain order (chain 0's slots, then chain
// 1's, ...), for k < BU.
__device__ __forceinline__ int chain_order_slot(int k, int bu) {
    for (int c = 0; c < CHAINS; ++c) {
        const int len = (bu - c + CHAINS - 1) / CHAINS;
        if (k < len) return c + CHAINS * k;
        k -= len;
    }
    return 0;
}

// One chain, or a short tile's 8 chains in turn, through the ring:
// acc[m] += <row m of each slot, its x block>, lane by lane, in the order
// of the one-block-a-tile kernel. Calls done(acc) after each chain, with
// acc reduced over the lanes (lane 0 holds the sum) and reset after.
template <typename T, bool CHAIN, typename Done>
__device__ __forceinline__ void consume(const unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        const int* ids_at, int n, int bu, int warp, int lane,
                                        const T* __restrict__ x, Done done) {
    using S = Shape<CHAIN>;
    T acc[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) acc[m] = T(0);
    // The block id of the warp's k-th slot, 32 at a time (one to a lane);
    // its slot index in the tile, for a short tile's chain ends.
    const int seq = CHAIN ? 0 : chain_order_slot(lane, bu);
    int id = lane < n ? __ldg(ids_at + (CHAIN ? CHAINS * lane : seq)) : 0;
    X4<T> xn{};
    if (n > 0) xn = load_x4(x + static_cast<size_t>(__shfl_sync(0xffffffffu, id, 0)) * BLOCK + lane * 4);
    for (int k = 0; k < n; ++k) {
        const int s = k % S::stages;
        mbar_wait(&full[s], (k / S::stages) & 1);
        const X4<T> xv = xn;
        if (k + 1 < n) {
            if (CHAIN && ((k + 1) & 31) == 0) id = k + 1 + lane < n ? __ldg(ids_at + CHAINS * (k + 1 + lane)) : 0;
            xn = load_x4(x + static_cast<size_t>(__shfl_sync(0xffffffffu, id, (k + 1) & 31)) * BLOCK + lane * 4);
        }
        const float4* rows =
            reinterpret_cast<const float4*>(ring + (static_cast<size_t>(s) * S::consumers + warp) * SLOT_BYTES) +
            lane;
        float4 u[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) u[m] = rows[m * (BLOCK / 4)];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            acc[m] += T(u[m].x) * xv.a;
            acc[m] += T(u[m].y) * xv.b;
            acc[m] += T(u[m].z) * xv.c;
            acc[m] += T(u[m].w) * xv.d;
        }
        // A chain ends at the warp's last slot, or (a short tile) where the
        // next slot of its chain would pass BU.
        if (k + 1 == n || (!CHAIN && __shfl_sync(0xffffffffu, seq, k) + CHAINS >= bu)) {
#pragma unroll
            for (int m = 0; m < TM; ++m) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) acc[m] += __shfl_down_sync(0xffffffffu, acc[m], off);
            }
            done(acc);
#pragma unroll
            for (int m = 0; m < TM; ++m) acc[m] = T(0);
        }
    }
}

template <typename T, bool CHAIN>
__global__ void __launch_bounds__(Shape<CHAIN>::threads)
tile_matvec_kernel(const __grid_constant__ Table table, const T* __restrict__ x, T* __restrict__ y, int bu) {
    using S = Shape<CHAIN>;
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t full[S::stages];
    __shared__ __align__(8) uint64_t empty[S::stages];
    __shared__ T chain_sum[TM];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    // The part this block belongs to (the table is short; a linear walk).
    const int b = blockIdx.x;
    int k = 0;
    while (k + 1 < table.nparts && b >= table.part[k + 1].block0) ++k;
    const Part& part = table.part[k];
    const int lb = b - static_cast<int>(part.block0);
    // Long tiles: this block is chain r of tile lb / CHAINS, slots r, r+8, ...
    // Short tiles: warp w sums tile lb*WARPS + w, all its slots.
    const int tile0 = CHAIN ? lb / CHAINS : lb * WARPS;
    const int r = CHAIN ? lb % CHAINS : 0;
    const int n = CHAIN ? (r < bu ? (bu - r + CHAINS - 1) / CHAINS : 0) : bu;
    // The consumer warps that have a tile (short tiles: fewer past the
    // part's last tile).
    const int tiles = CHAIN ? 1 : min(WARPS, part.ntiles - tile0);

    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < S::stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], tiles);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == S::consumers) {
        // The producer: one thread keeps the ring's stages in flight, a slot
        // a consumer warp a stage.
        if (lane == 0) {
            const uint64_t policy = evict_first_policy();
            const float* vals = part.uvals + static_cast<size_t>(tile0) * bu * SLOT;
            for (int j = 0; j < n; ++j) {
                const int s = j % S::stages;
                if (j >= S::stages) mbar_wait(&empty[s], ((j / S::stages) - 1) & 1);
                const int slot = CHAIN ? r + CHAINS * j : chain_order_slot(j, bu);
                mbar_arrive_expect_tx(&full[s], tiles * SLOT_BYTES);
                for (int w = 0; w < tiles; ++w)
                    bulk_load(ring + (static_cast<size_t>(s) * S::consumers + w) * SLOT_BYTES,
                              vals + (static_cast<size_t>(w) * bu + slot) * SLOT, SLOT_BYTES, &full[s], policy);
            }
        }
        __syncwarp();
    } else {
        const int tile = tile0 + warp;
        const bool valid = tile < part.ntiles;
        const int* ids = part.ubidx + static_cast<size_t>(tile) * bu + r;
        if (CHAIN) {
            if (lane == 0 && n == 0) {
#pragma unroll
                for (int m = 0; m < TM; ++m) chain_sum[m] = T(0);
            }
            consume<T, CHAIN>(ring, full, empty, ids, n, bu, warp, lane, x, [&](const T* acc) {
                if (lane == 0) {
#pragma unroll
                    for (int m = 0; m < TM; ++m) chain_sum[m] = acc[m];
                }
            });
        } else {
            T total[TM];
#pragma unroll
            for (int m = 0; m < TM; ++m) total[m] = T(0);
            if (valid) {
                consume<T, CHAIN>(ring, full, empty, ids, n, bu, warp, lane, x, [&](const T* acc) {
#pragma unroll
                    for (int m = 0; m < TM; ++m) total[m] += acc[m];
                });
                if (lane == 0) {
                    T* out = y + (static_cast<size_t>(part.tile0) + tile) * TM;
#pragma unroll
                    for (int m = 0; m < TM; ++m) out[m] = total[m];
                }
            }
        }
        __syncwarp();
    }

    if (CHAIN) {
        // The tile's 8 chain sums, in chain order, from the cluster's blocks.
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        if (cl.block_rank() == 0 && threadIdx.x < TM) {
            T s = T(0);
#pragma unroll
            for (int c = 0; c < CHAINS; ++c) s += cl.map_shared_rank(chain_sum, c)[threadIdx.x];
            y[(static_cast<size_t>(part.tile0) + tile0) * TM + threadIdx.x] = s;
        }
        cl.sync();  // no block leaves while rank 0 reads its shared memory
    }
}

template <typename T, bool CHAIN>
int launch(const Part* parts, int nparts, const void* x, void* y, int bu, int nblocks, void* stream) {
    using S = Shape<CHAIN>;
    // A short tile's warp holds its block ids one to a lane.
    if (nparts < 1 || nparts > MAX_PARTS || (!CHAIN && bu > 32)) return static_cast<int>(cudaErrorInvalidValue);
    if (nblocks <= 0) return static_cast<int>(cudaGetLastError());
    Table table{};
    for (int k = 0; k < nparts; ++k) table.part[k] = parts[k];
    table.nparts = nparts;

    cudaLaunchConfig_t config{};
    config.gridDim = dim3(static_cast<unsigned>(nblocks));
    config.blockDim = dim3(S::threads);
    config.dynamicSmemBytes = S::ring_bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CHAINS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = CHAIN ? 1 : 0;
    const cudaError_t err =
        cudaLaunchKernelEx(&config, tile_matvec_kernel<T, CHAIN>, table, static_cast<const T*>(x), static_cast<T*>(y), bu);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CHAIN>
cudaError_t set_ring_size() {
    return cudaFuncSetAttribute(tile_matvec_kernel<T, CHAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Shape<CHAIN>::ring_bytes);
}

template <typename T>
int max_active_clusters(int* out) {
    using S = Shape<true>;
    cudaLaunchConfig_t config{};
    config.gridDim = dim3(CHAINS);
    config.blockDim = dim3(S::threads);
    config.dynamicSmemBytes = S::ring_bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CHAINS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        out, reinterpret_cast<const void*>(tile_matvec_kernel<T, true>), &config));
}

}  // namespace

// The kernel's shape, for the wrapper's work plan: consumer warps (tiles) a
// block on short tiles, chains of a tile, parts a launch. Sets the dynamic
// shared-memory size of the four kernels on the current device.
extern "C" int tile_matvec_prepare(int* warps, int* chains, int* max_parts) {
    *warps = WARPS;
    *chains = CHAINS;
    *max_parts = MAX_PARTS;
    cudaError_t err = set_ring_size<float, false>();
    if (err == cudaSuccess) err = set_ring_size<float, true>();
    if (err == cudaSuccess) err = set_ring_size<double, false>();
    if (err == cudaSuccess) err = set_ring_size<double, true>();
    return static_cast<int>(err);
}

// How many clusters of a long tile's 8 chain blocks the current device can
// hold at once (0: that cluster shape cannot be scheduled).
extern "C" int tile_matvec_max_active_clusters(int f64, int* out) {
    return f64 ? max_active_clusters<double>(out) : max_active_clusters<float>(out);
}

// One launch over `nparts` parts of one BU: chain = 1 for long tiles (8
// blocks a tile, one cluster), 0 for short ones (WARPS tiles a block).
extern "C" int tile_matvec_f32(const void* parts, int nparts, const void* x, void* y, int bu, int chain,
                               int nblocks, void* stream) {
    const Part* p = static_cast<const Part*>(parts);
    return chain ? launch<float, true>(p, nparts, x, y, bu, nblocks, stream)
                 : launch<float, false>(p, nparts, x, y, bu, nblocks, stream);
}

extern "C" int tile_matvec_f64(const void* parts, int nparts, const void* x, void* y, int bu, int chain,
                               int nblocks, void* stream) {
    const Part* p = static_cast<const Part*>(parts);
    return chain ? launch<double, true>(p, nparts, x, y, bu, nblocks, stream)
                 : launch<double, false>(p, nparts, x, y, bu, nblocks, stream);
}
