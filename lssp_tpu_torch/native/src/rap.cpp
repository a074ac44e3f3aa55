// Fused Galerkin triple product Ac = P^T * A * P for the AMG setup,
// where P = B * P0 is the smoothed aggregation prolongator: B a sparse
// smoother (or identity when absent) and P0 the aggregation map given as
// a per-row coarse column (p0c).  P is never materialized: its row k is
// B.row(k) with columns remapped through p0c (duplicates merge inside the
// Gustavson accumulator).
//
// A copy of lssp_tpu/native/src/rap.cpp (only this header differs), so the
// PyTorch port's Galerkin operators are bit-identical to the JAX
// package's.  Replaces the scipy chain  (B @ P0) -> tocsc -> csr_matmat x2
// (oracle: the scipy expressions in lssp_tpu_torch/amg/sa.py
// sa_host_levels).
//
// Output rows are sorted and duplicate-free (canonical CSR).  Returns the
// output nnz, or -(needed_estimate) when `cap` is too small (caller
// reallocates and retries).

#include <cstdint>
#include <malloc.h>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

// glibc munmaps >128KB allocations eagerly, so every call re-faults the
// multi-GB T/Pt buffers (~5 s at the 16.8M level).  Raising the mmap
// threshold once keeps them on the brk heap, which stays mapped across
// calls — later levels (and repeated setups) reuse hot pages.
static const int _heap_cfg = [] {
    mallopt(M_MMAP_THRESHOLD, 1 << 30);
    return 0;
}();

template <typename I>
long rap_impl(const I* Ap, const I* Aj, const double* Ax, long n,
              const I* Bp, const I* Bj, const double* Bx,  // may be null
              const I* p0c, long nc,
              I* Cp, I* Cj, double* Cx, long cap) {
    std::vector<double> w((size_t)nc, 0.0);
    std::vector<long> mark((size_t)nc, -1);   // last row id that touched c
    std::vector<I> touched;
    touched.reserve(64);

    // ---- materialize P = B * P0 row-wise, duplicates merged: both
    // Gustavson passes then walk ~30% fewer entries than re-expanding
    // B's columns through the aggregation map every time ----
    std::vector<I> Pp(n + 1);
    std::vector<I> Pj;
    std::vector<double> Px;
    if (Bp) {
        Pj.reserve((size_t)Bp[n]);
        Px.reserve((size_t)Bp[n]);
        for (long k = 0; k < n; ++k) {
            touched.clear();
            for (I kb = Bp[k]; kb < Bp[k + 1]; ++kb) {
                const I c = p0c[Bj[kb]];
                if (mark[(size_t)c] != k) {
                    mark[(size_t)c] = k;
                    touched.push_back(c);
                }
                w[(size_t)c] += Bx[kb];
            }
            for (I c : touched) {           // unsorted: accumulation
                Pj.push_back(c);            // passes don't need order
                Px.push_back(w[(size_t)c]);
                w[(size_t)c] = 0.0;
            }
            Pp[k + 1] = (I)Pj.size();
        }
    }
    const I* PPp = Bp ? Pp.data() : nullptr;
    const I* PPj = Bp ? Pj.data() : nullptr;
    const double* PPx = Bp ? Px.data() : nullptr;

    // ---- T = A * P, rows stored contiguously (std::vector growth) ----
    std::vector<I> Tp(n + 1);
    std::vector<I> Tj;
    std::vector<double> Tx;
    Tj.reserve((size_t)(Ap[n] + n));
    Tx.reserve((size_t)(Ap[n] + n));
    for (long i = 0; i < n; ++i) {
        touched.clear();
        const long rid = n + i;        // fresh marker namespace after P
        for (I ka = Ap[i]; ka < Ap[i + 1]; ++ka) {
            const long k = (long)Aj[ka];
            const double a = Ax[ka];
            if (PPp) {
                for (I kb = PPp[k]; kb < PPp[k + 1]; ++kb) {
                    const I c = PPj[kb];
                    if (mark[(size_t)c] != rid) {
                        mark[(size_t)c] = rid;
                        touched.push_back(c);
                    }
                    w[(size_t)c] += a * PPx[kb];
                }
            } else {
                const I c = p0c[k];
                if (mark[(size_t)c] != rid) {
                    mark[(size_t)c] = rid;
                    touched.push_back(c);
                }
                w[(size_t)c] += a;
            }
        }
        for (I c : touched) {               // unsorted (see P pass)
            Tj.push_back(c);
            Tx.push_back(w[(size_t)c]);
            w[(size_t)c] = 0.0;
        }
        Tp[i + 1] = (I)Tj.size();
    }

    // ---- Pt: implicit P transposed (counting sort over coarse cols) ----
    // P.row(k) entries: (p0c[Bj[kb]], Bx[kb]) or ((p0c[k], 1.0)) when B
    // is identity.  Pt stores (fine row, value) grouped by coarse row.
    const long nnzP = PPp ? (long)PPp[n] : n;
    std::vector<I> Ptp((size_t)nc + 1, 0);
    std::vector<I> Pti((size_t)nnzP);
    std::vector<double> Ptx((size_t)nnzP);
    if (PPp) {
        for (long kk = 0; kk < nnzP; ++kk) ++Ptp[(size_t)PPj[kk] + 1];
    } else {
        for (long k = 0; k < n; ++k) ++Ptp[(size_t)p0c[k] + 1];
    }
    for (long c = 0; c < nc; ++c) Ptp[c + 1] += Ptp[c];
    {
        std::vector<I> pos(Ptp.begin(), Ptp.end() - 1);
        if (PPp) {
            for (long k = 0; k < n; ++k)
                for (I kb = PPp[k]; kb < PPp[k + 1]; ++kb) {
                    const I c = PPj[kb];
                    const I at = pos[(size_t)c]++;
                    Pti[(size_t)at] = (I)k;
                    Ptx[(size_t)at] = PPx[kb];
                }
        } else {
            for (long k = 0; k < n; ++k) {
                const I c = p0c[k];
                const I at = pos[(size_t)c]++;
                Pti[(size_t)at] = (I)k;
                Ptx[(size_t)at] = 1.0;
            }
        }
    }

    // ---- Ac = Pt * T (Gustavson over coarse rows) ----
    long nnz = 0;
    Cp[0] = 0;
    for (long c = 0; c < nc; ++c) {
        touched.clear();
        const long rowid = 2 * n + c;  // distinct marker namespace
        for (I kp = Ptp[c]; kp < Ptp[c + 1]; ++kp) {
            const long i = (long)Pti[(size_t)kp];
            const double v1 = Ptx[(size_t)kp];
            for (I kt = Tp[i]; kt < Tp[i + 1]; ++kt) {
                const I c2 = Tj[(size_t)kt];
                if (mark[(size_t)c2] != rowid) {
                    mark[(size_t)c2] = rowid;
                    touched.push_back(c2);
                }
                w[(size_t)c2] += v1 * Tx[(size_t)kt];
            }
        }
        std::sort(touched.begin(), touched.end());
        if (nnz + (long)touched.size() > cap) {
            // report a generous estimate so one retry suffices
            long est = nnz + (long)touched.size();
            double frac = (double)(c + 1) / (double)nc;
            long need = (long)((double)est / frac * 1.25) + 16;
            // reset workspace before bailing
            for (I cc : touched) w[(size_t)cc] = 0.0;
            return -need;
        }
        for (I c2 : touched) {
            Cj[nnz] = c2;
            Cx[nnz] = w[(size_t)c2];
            w[(size_t)c2] = 0.0;
            ++nnz;
        }
        Cp[c + 1] = (I)nnz;
    }
    return nnz;
}

}  // namespace

extern "C" {

// max_i dinv[i] * sum_j |A[i,j]| — the Gershgorin bound on lambda_max of
// D^-1 A (oracle: amg/setup.py lambda_gershgorin; np.add.reduceat over
// 16.8M segments measured ~0.45 s/call, this pass is memory-bound)
double lssp_gersh_i32(const int32_t* Ap, const double* Ax,
                      const double* dinv, long n) {
    double best = 0.0;
    for (long i = 0; i < n; ++i) {
        double s = 0.0;
        for (int32_t k = Ap[i]; k < Ap[i + 1]; ++k)
            s += Ax[k] < 0 ? -Ax[k] : Ax[k];
        const double v = s * (dinv[i] < 0 ? -dinv[i] : dinv[i]);
        if (v > best) best = v;
    }
    return best;
}

double lssp_gersh_i64(const int64_t* Ap, const double* Ax,
                      const double* dinv, long n) {
    double best = 0.0;
    for (long i = 0; i < n; ++i) {
        double s = 0.0;
        for (int64_t k = Ap[i]; k < Ap[i + 1]; ++k)
            s += Ax[k] < 0 ? -Ax[k] : Ax[k];
        const double v = s * (dinv[i] < 0 ? -dinv[i] : dinv[i]);
        if (v > best) best = v;
    }
    return best;
}

long lssp_rap_i32(const int32_t* Ap, const int32_t* Aj, const double* Ax,
                  long n, const int32_t* Bp, const int32_t* Bj,
                  const double* Bx, const int32_t* p0c, long nc,
                  int32_t* Cp, int32_t* Cj, double* Cx, long cap) {
    return rap_impl<int32_t>(Ap, Aj, Ax, n, Bp, Bj, Bx, p0c, nc, Cp, Cj,
                             Cx, cap);
}

long lssp_rap_i64(const int64_t* Ap, const int64_t* Aj, const double* Ax,
                  long n, const int64_t* Bp, const int64_t* Bj,
                  const double* Bx, const int64_t* p0c, long nc,
                  int64_t* Cp, int64_t* Cj, double* Cx, long cap) {
    return rap_impl<int64_t>(Ap, Aj, Ax, n, Bp, Bj, Bx, p0c, nc, Cp, Cj,
                             Cx, cap);
}

}  // extern "C"
