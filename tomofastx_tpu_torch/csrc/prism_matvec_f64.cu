// Kernel B2 for the double operators (prism_matvec.cuh says what it computes
// and how): the double closed forms. Plain C entry points, loaded with ctypes
// by ops/prism_matvec.py; each returns cudaGetLastError().

#include "prism_matvec.cuh"

namespace {

template <bool MATVEC>
int launch_double(int is_double, int family, int nmc, int ndc, int mode, const Launch& a) {
    // The blend and the float closed forms are prism_matvec_f32.cu's.
    if (!is_double || mode != CLOSED) return static_cast<int>(cudaErrorInvalidValue);
    return launch_family<MATVEC, double, CLOSED>(family, nmc, ndc, a);
}

}  // namespace

extern "C" int prism_matvec(PRISM_ARGS) {
    PRISM_CHECK_MATVEC;
    return launch_double<true>(is_double, family, nmc, ndc, mode, PRISM_LAUNCH);
}

extern "C" int prism_rmatvec(PRISM_ARGS) {
    PRISM_CHECK_RMATVEC;
    return launch_double<false>(is_double, family, nmc, ndc, mode, PRISM_LAUNCH);
}
