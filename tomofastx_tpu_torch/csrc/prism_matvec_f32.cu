// Kernel B2 for the float operators (prism_matvec.cuh says what it computes
// and how): the blend's main loops and its near passes, and the float closed
// forms. Plain C entry points, loaded with ctypes by ops/prism_matvec.py; each
// returns cudaGetLastError().

#include "prism_matvec.cuh"

namespace {

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

// The blend's near passes, run before the product's prism_matvec or
// prism_rmatvec on its stream. Matvec: idx = near_idx (nrows, K) in the whole
// grid's numbering, cell_lo the operator's first cell, vin = xw (nmc, N), out
// the (nrows, ndc) last split of the matvec's buffer. Rmatvec: idx = the
// transposed offsets (N + 1,), obs their observations, vin = u (nrows, ndc),
// out the (nmc, N) near sums the rmatvec starts from.
#define PRISM_NEAR_ARGS                                                                                         \
    int family, int nmc, int ndc, int handle_inside, const void *X1, const void *X2, const void *Y1,            \
        const void *Y2, const void *Z1, const void *Z2, const void *xd, const void *yd, const void *zd,         \
        const void *idx, const void *obs, const void *vin, void *out, int N, int nrows, int K, int cell_lo,     \
        double m0, double m1, double m2, double s4pi, void *stream
#define PRISM_NEAR_LAUNCH                                                                                        \
    make_launch(X1, X2, Y1, Y2, Z1, Z2, xd, yd, zd, vin, nullptr, out, N, nrows, 0, 0, m0, m1, m2, s4pi,         \
                handle_inside, stream)

extern "C" int prism_near_matvec(PRISM_NEAR_ARGS) {
    if (N <= 0 || nrows <= 0 || K <= 0 || idx == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return near_family<true>(family, nmc, ndc, PRISM_NEAR_LAUNCH, static_cast<const int*>(idx), nullptr, K, cell_lo);
}

extern "C" int prism_near_rmatvec(PRISM_NEAR_ARGS) {
    if (N <= 0 || nrows <= 0 || idx == nullptr || obs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return near_family<false>(family, nmc, ndc, PRISM_NEAR_LAUNCH, static_cast<const int*>(idx),
                              static_cast<const int*>(obs), 0, 0);
}
