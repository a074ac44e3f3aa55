// Sparse QR factorization — George–Heath Givens row merging.
//
// C++ fast path for lssp_tpu_torch/pc/qr_host.py, a verbatim copy of
// lssp_tpu/native/src/spqr.cpp apart from its comments (the reference's QR_MUMPS
// capability, solver-qrmumps.cxx:10-84).  The caller
// (Python) applies the fill-bounding column permutation and sorts rows by
// leading column; this kernel only runs the merge loop: each input row is
// rotated against the stored sparse R rows until its leading entry either
// lands in an empty R slot or the row annihilates (its rotated rhs is then
// pure least-squares residual).  Sorted-vector merges keep the rotation
// cost linear in the union support — the same algorithm as the Python
// oracle, ~100× faster (per-merge interpreter overhead dominates there).
//
// Built with -ffp-contract=off like the other host kernels so outputs stay
// reproducible across compilers.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

using i64 = long long;

struct SpQRHandle {
    i64 n = 0;
    std::vector<std::vector<i64>> rc;      // per R-row sorted column ids
    std::vector<std::vector<double>> rv;   // matching values (rc[j][0]==j)
    std::vector<double> crhs;              // Q^T b accumulated
    double res2 = 0.0;                     // sum of annihilated rhs^2
    i64 rnnz = 0;
};

}  // namespace

extern "C" {

void* lssp_spqr(const i64* Ap, const i64* Aj, const double* Ax,
                i64 m, i64 n, const double* b, i64 has_b,
                double* res2_out, i64* rnnz_out) {
    auto* h = new SpQRHandle;
    h->n = n;
    h->rc.resize(n);
    h->rv.resize(n);
    h->crhs.assign(n, 0.0);

    std::vector<i64> wc, nc, uc;
    std::vector<double> wv, nv, uv;

    for (i64 i = 0; i < m; ++i) {
        i64 s = Ap[i], e = Ap[i + 1];
        double beta = has_b ? b[i] : 0.0;
        if (s == e) {
            if (has_b) h->res2 += beta * beta;
            continue;
        }
        wc.assign(Aj + s, Aj + e);
        wv.assign(Ax + s, Ax + e);
        bool stored = false;
        while (!wc.empty()) {
            i64 j = wc[0];
            if (h->rc[j].empty()) {
                h->rc[j] = wc;
                h->rv[j] = wv;
                h->crhs[j] = beta;
                beta = 0.0;
                stored = true;
                break;
            }
            const std::vector<i64>& rcj = h->rc[j];
            const std::vector<double>& rvj = h->rv[j];
            double a = rvj[0], bb = wv[0];
            double hy = std::hypot(a, bb);
            // both leading values exactly zero (explicit stored zeros):
            // identity rotation instead of 0/0 = NaN
            double c = hy == 0.0 ? 1.0 : a / hy;
            double sn = hy == 0.0 ? 0.0 : bb / hy;
            uc.clear(); uv.clear();      // new R row (union support)
            nc.clear(); nv.clear();      // new working row
            size_t p = 0, q = 0;
            while (p < rcj.size() || q < wc.size()) {
                i64 col;
                double rvv = 0.0, wvv = 0.0;
                if (q >= wc.size() ||
                    (p < rcj.size() && rcj[p] < wc[q])) {
                    col = rcj[p]; rvv = rvj[p]; ++p;
                } else if (p >= rcj.size() || wc[q] < rcj[p]) {
                    col = wc[q]; wvv = wv[q]; ++q;
                } else {
                    col = rcj[p]; rvv = rvj[p]; wvv = wv[q]; ++p; ++q;
                }
                double nr = c * rvv + sn * wvv;
                double nw = -sn * rvv + c * wvv;
                if (col == j) nw = 0.0;            // exact cancellation
                if (nr != 0.0 || col == j) {       // diagonal kept even if 0
                    uc.push_back(col); uv.push_back(nr);
                }
                if (nw != 0.0) {
                    nc.push_back(col); nv.push_back(nw);
                }
            }
            h->rc[j] = uc;
            h->rv[j] = uv;
            wc = nc;
            wv = nv;
            double ncr = c * h->crhs[j] + sn * beta;
            beta = -sn * h->crhs[j] + c * beta;
            h->crhs[j] = ncr;
        }
        if (!stored && has_b) h->res2 += beta * beta;
    }

    // empty columns (structurally rank-deficient): unit diagonal so the
    // back-substitution stays defined (pivot-clamp convention)
    for (i64 j = 0; j < n; ++j) {
        if (h->rc[j].empty()) {
            h->rc[j].push_back(j);
            h->rv[j].push_back(1.0);
            h->crhs[j] = 0.0;
        }
        h->rnnz += (i64)h->rc[j].size();
    }
    *res2_out = h->res2;
    *rnnz_out = h->rnnz;
    return h;
}

void lssp_spqr_fetch(void* handle, i64* Rp, i64* Rj, double* Rx,
                     double* crhs) {
    auto* h = static_cast<SpQRHandle*>(handle);
    i64 pos = 0;
    Rp[0] = 0;
    for (i64 j = 0; j < h->n; ++j) {
        for (size_t k = 0; k < h->rc[j].size(); ++k) {
            Rj[pos] = h->rc[j][k];
            Rx[pos] = h->rv[j][k];
            ++pos;
        }
        Rp[j + 1] = pos;
        crhs[j] = h->crhs[j];
    }
}

void lssp_spqr_free(void* handle) {
    delete static_cast<SpQRHandle*>(handle);
}

}  // extern "C"
