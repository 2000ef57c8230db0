// Kernel B2 for the float operators (prism_matvec.cuh says what it computes
// and how): the blend's main loops, the build of its stored near rows and its
// near passes over them, and the float closed forms. Plain C entry points,
// loaded with ctypes by ops/prism_matvec.py; each returns cudaGetLastError().

#include "prism_matvec.cuh"

namespace {

// ---------------------------------------------------------------- the near rows (the blend's)

// The near rows' build, once with the operator (ops/prism_matvec.py
// prism_near_build). First the candidates: flag[b * K + i] = 1 where
// near_idx[b, i] (the whole grid's numbering) is one of this operator's
// cells, from cell_lo, and is_far, the main loop's own test, calls the pair
// near; a thread a candidate.
__global__ void __launch_bounds__(THREADS) prism_near_mark_kernel(Geometry g, const int* __restrict__ near_idx,
                                                                  size_t total, int K, int cell_lo, int N,
                                                                  unsigned char* __restrict__ flag) {
    const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= total) return;
    const int b = static_cast<int>(i / K);
    const int n = __ldg(near_idx + i) - cell_lo;
    bool near = false;
    if (n >= 0 && n < N) {
        const Cell<float> c = make_cell<float>(at<float>(g.X1, n), at<float>(g.X2, n), at<float>(g.Y1, n),
                                               at<float>(g.Y2, n), at<float>(g.Z1, n), at<float>(g.Z2, n));
        near = !is_far(c, at<float>(g.xd, b), at<float>(g.yd, b), at<float>(g.zd, b));
    }
    flag[i] = near ? 1 : 0;
}

// Then the rows of the pairs kept (observation obs[p], cell cell[p]):
// val[p] = near_row's (nmc, ndc), the closed forms in double rounded to
// float; a thread a pair.
template <int FAM, int NMC, int NDC>
__global__ void __launch_bounds__(THREADS) prism_near_rows_kernel(Geometry g, const int* __restrict__ obs,
                                                                  const int* __restrict__ cell, int nnz,
                                                                  float* __restrict__ val, Field f) {
    const int p = blockIdx.x * THREADS + threadIdx.x;
    if (p >= nnz) return;
    const int b = __ldg(obs + p), n = __ldg(cell + p);
    const Cell<float> c = make_cell<float>(at<float>(g.X1, n), at<float>(g.X2, n), at<float>(g.Y1, n),
                                           at<float>(g.Y2, n), at<float>(g.Z1, n), at<float>(g.Z2, n));
    float row[NMC][NDC];
    if (!near_row<FAM, NMC, NDC>(c, at<float>(g.xd, b), at<float>(g.yd, b), at<float>(g.zd, b), f, row)) {
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
// matvec's by observation, into the last split of the matvec's buffer; the
// rmatvec's by cell, into the near sums the main rmatvec starts from.
template <int NMC, int NDC, int G>
__global__ void __launch_bounds__(STREAM_THREADS) prism_near_matvec_kernel(NearRows r, const float* __restrict__ xw,
                                                                           double* __restrict__ out, size_t N) {
    near_stream<NMC, NDC, G, true>(r, xw, out, N);
}

template <int NMC, int NDC, int G>
__global__ void __launch_bounds__(STREAM_THREADS) prism_near_rmatvec_kernel(NearRows r, const float* __restrict__ u,
                                                                            double* __restrict__ out, size_t N) {
    near_stream<NMC, NDC, G, false>(r, u, out, N);
}

template <bool MATVEC, int NMC, int NDC, int G>
struct PrismNearLaunch {
    static void run(const NearRows& r, const float* vin, double* out, size_t N, cudaStream_t stream) {
        if (MATVEC)
            prism_near_matvec_kernel<NMC, NDC, G><<<near_stream_blocks<G>(r.segments), STREAM_THREADS, 0, stream>>>(
                r, vin, out, N);
        else
            prism_near_rmatvec_kernel<NMC, NDC, G><<<near_stream_blocks<G>(r.segments), STREAM_THREADS, 0, stream>>>(
                r, vin, out, N);
    }
};

// The build's rows kernel of one family, float only.
int near_rows_family(int family, int nmc, int ndc, const Geometry& g, const int* obs, const int* cell, int nnz,
                     float* val, const Field& f, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((nnz + THREADS - 1) / THREADS);
#define ROWS_CASE(FAM, NMC, NDC)                                                                                   \
    if (family == FAM && nmc == NMC && ndc == NDC) {                                                               \
        prism_near_rows_kernel<FAM, NMC, NDC><<<blocks, THREADS, 0, stream>>>(g, obs, cell, nnz, val, f);          \
        return static_cast<int>(cudaGetLastError());                                                               \
    }
    FOR_EACH_FAMILY(ROWS_CASE)
#undef ROWS_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool MATVEC>
int launch_float(int is_double, int family, int nmc, int ndc, int mode, const Launch& a) {
    if (is_double) return static_cast<int>(cudaErrorInvalidValue);  // prism_matvec_f64.cu's
    if (mode == BLEND) {
        if (a.partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);  // the near pass's sums
        return launch_family<MATVEC, float, BLEND>(family, nmc, ndc, a);
    }
    return launch_family<MATVEC, float, CLOSED>(family, nmc, ndc, a);
}

}  // namespace

extern "C" int prism_matvec(PRISM_ARGS) {
    PRISM_CHECK_MATVEC;
    return launch_float<true>(is_double, family, nmc, ndc, mode, PRISM_LAUNCH);
}

extern "C" int prism_rmatvec(PRISM_ARGS) {
    PRISM_CHECK_RMATVEC;
    return launch_float<false>(is_double, family, nmc, ndc, mode, PRISM_LAUNCH);
}

// The build of the blend's near rows, run once with the operator
// (ops/prism_matvec.py prism_near_build). prism_near_mark: flag (nrows, K)
// bytes over near_idx (nrows, K), the whole grid's numbering, of the
// operator's N cells from cell_lo. prism_near_rows: val (nnz, nmc, ndc) of
// the pairs kept, observation obs[p] and cell cell[p] (int32).
extern "C" int prism_near_mark(const void *X1, const void *X2, const void *Y1, const void *Y2, const void *Z1,
                               const void *Z2, const void *xd, const void *yd, const void *zd, const void *near_idx,
                               int nrows, int K, int cell_lo, int N, void *flag, void *stream) {
    if (N <= 0 || nrows <= 0 || K <= 0 || near_idx == nullptr || flag == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t total = static_cast<size_t>(nrows) * K;
    prism_near_mark_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        Geometry{X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd}, static_cast<const int*>(near_idx), total, K, cell_lo, N,
        static_cast<unsigned char*>(flag));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int prism_near_rows(int family, int nmc, int ndc, int handle_inside, const void *X1, const void *X2,
                               const void *Y1, const void *Y2, const void *Z1, const void *Z2, const void *xd,
                               const void *yd, const void *zd, const void *obs, const void *cell, int nnz, void *val,
                               double m0, double m1, double m2, double s4pi, void *stream) {
    if (nnz < 0 || (nnz > 0 && (obs == nullptr || cell == nullptr || val == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (nnz == 0) return static_cast<int>(cudaGetLastError());
    return near_rows_family(family, nmc, ndc, Geometry{X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd},
                            static_cast<const int*>(obs), static_cast<const int*>(cell), nnz,
                            static_cast<float*>(val), Field{m0, m1, m2, s4pi, handle_inside},
                            static_cast<cudaStream_t>(stream));
}

// The blend's near passes over the stored rows, run before the product's
// prism_matvec or prism_rmatvec on its stream. Matvec: ptr, idx, val the rows
// by observation (segments = the padded rows), vin = xw (nmc, N), out the
// (nrows, ndc) last split of the matvec's buffer. Rmatvec: ptr, idx, val,
// seg the rows by cell (segments = the cells that have a near pair), vin = u
// (nrows, ndc), out the (nmc, N) near sums the rmatvec starts from (cleared
// here first). lanes: a segment's group (ops/matrixfree.py stream_lanes).
#define PRISM_NEAR_ARGS                                                                                      \
    int nmc, int ndc, int lanes, const void *ptr, const void *idx, const void *val, const void *seg,         \
        int segments, const void *vin, void *out, int N, void *stream
#define PRISM_NEAR_ROWS                                                                                      \
    NearRows {                                                                                              \
        static_cast<const int*>(ptr), static_cast<const int*>(idx), static_cast<const float*>(val),         \
            static_cast<const int*>(seg), segments                                                          \
    }

extern "C" int prism_near_matvec(PRISM_NEAR_ARGS) {
    return near_stream_pass<PrismNearLaunch, true>(nmc, ndc, lanes, PRISM_NEAR_ROWS, vin, out, N,
                                                   static_cast<cudaStream_t>(stream));
}

extern "C" int prism_near_rmatvec(PRISM_NEAR_ARGS) {
    return near_stream_pass<PrismNearLaunch, false>(nmc, ndc, lanes, PRISM_NEAR_ROWS, vin, out, N,
                                                    static_cast<cudaStream_t>(stream));
}
