// Fused host kernels for the SA-AMG hierarchy build (amg/sa.py) — the
// single-core numpy path makes ~8 separate 84M-element passes per level
// (repeat/compare/bincount/cumsum/fancy-index) where one C++ scan does the
// whole job.  Outputs are bit-identical to the Python oracles:
//  - lssp_filter_lumped  == _filter_lumped + _subset_csr_lumped
//    (drop |a_ij| < tol·(√a_ii·√a_jj), lump dropped mass onto the kept
//    structural diagonal; per-row left-to-right accumulation order matches
//    np.bincount)
//  - lssp_lump_pattern   == _lump_to_pattern + _subset_csr_lumped
//    (keep the (2ry+1)×(2rx+1) grid stencil; dy = rint(d/gx) uses
//    round-half-to-even, matching np.rint)
// A copy of lssp_tpu/native/src/amgfilter.cpp without its dia_offsets /
// dia_fill (the port's csr_to_dia builds the same arrays in numpy); only
// this header and that omission differ.
// Index types: _i32/_i64 variants so scipy's native int32 arrays need no
// widening copy (84M-entry matrices: each avoided copy is ~0.3 s).
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfenv>
#include <vector>

namespace {

template <typename I>
int64_t filter_lumped(const I* ip, const I* ix, const double* ax, int64_t n,
                      double tol, I* oip, I* oix, double* oax) {
    // pass 1: |diag| per row (0 → 1.0), matching np.abs(Ac.diagonal())
    std::vector<double> sq(n);
    for (int64_t i = 0; i < n; ++i) {
        double d = 0.0;
        for (I k = ip[i]; k < ip[i + 1]; ++k)
            if (ix[k] == i) { d = ax[k]; break; }
        d = std::fabs(d);
        sq[i] = std::sqrt(d == 0.0 ? 1.0 : d);
    }
    // pass 2: keep/drop per row, lump dropped onto the kept diagonal
    int64_t nnz = 0;
    oip[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        double lump = 0.0;
        int64_t diag_pos = -1;
        for (I k = ip[i]; k < ip[i + 1]; ++k) {
            I j = ix[k];
            bool isdiag = (j == (I)i);
            if (isdiag || std::fabs(ax[k]) >= tol * (sq[i] * sq[j])) {
                if (isdiag) diag_pos = nnz;
                oix[nnz] = j;
                oax[nnz] = ax[k];
                ++nnz;
            } else {
                lump += ax[k];
            }
        }
        if (lump != 0.0) {
            if (diag_pos < 0) return -1;   // Python allocating fallback
            oax[diag_pos] += lump;
        }
        oip[i + 1] = (I)nnz;
    }
    return nnz;
}

template <typename I>
int64_t lump_pattern(const I* ip, const I* ix, const double* ax, int64_t n,
                     int64_t gx, int64_t ry, int64_t rx,
                     I* oip, I* oix, double* oax) {
    int64_t nnz = 0;
    oip[0] = 0;
    const double gxd = (double)gx;
    for (int64_t i = 0; i < n; ++i) {
        double lump = 0.0;
        int64_t diag_pos = -1;
        for (I k = ip[i]; k < ip[i + 1]; ++k) {
            int64_t d = (int64_t)ix[k] - i;
            // np.rint == round-half-to-even == std::nearbyint in the
            // default FE_TONEAREST mode
            int64_t dy = (int64_t)std::nearbyint((double)d / gxd);
            int64_t dx = d - dy * gx;
            if ((dy < 0 ? -dy : dy) <= ry && (dx < 0 ? -dx : dx) <= rx) {
                if (d == 0) diag_pos = nnz;
                oix[nnz] = ix[k];
                oax[nnz] = ax[k];
                ++nnz;
            } else {
                lump += ax[k];
            }
        }
        if (lump != 0.0) {
            if (diag_pos < 0) return -1;
            oax[diag_pos] += lump;
        }
        oip[i + 1] = (I)nnz;
    }
    return nnz;
}

}  // namespace

extern "C" {

int64_t lssp_filter_lumped_i32(const int32_t* ip, const int32_t* ix,
                               const double* ax, int64_t n, double tol,
                               int32_t* oip, int32_t* oix, double* oax) {
    return filter_lumped<int32_t>(ip, ix, ax, n, tol, oip, oix, oax);
}
int64_t lssp_filter_lumped_i64(const int64_t* ip, const int64_t* ix,
                               const double* ax, int64_t n, double tol,
                               int64_t* oip, int64_t* oix, double* oax) {
    return filter_lumped<int64_t>(ip, ix, ax, n, tol, oip, oix, oax);
}
int64_t lssp_lump_pattern_i32(const int32_t* ip, const int32_t* ix,
                              const double* ax, int64_t n, int64_t gx,
                              int64_t ry, int64_t rx,
                              int32_t* oip, int32_t* oix, double* oax) {
    return lump_pattern<int32_t>(ip, ix, ax, n, gx, ry, rx, oip, oix, oax);
}
int64_t lssp_lump_pattern_i64(const int64_t* ip, const int64_t* ix,
                              const double* ax, int64_t n, int64_t gx,
                              int64_t ry, int64_t rx,
                              int64_t* oip, int64_t* oix, double* oax) {
    return lump_pattern<int64_t>(ip, ix, ax, n, gx, ry, rx, oip, oix, oax);
}

}  // extern "C"
