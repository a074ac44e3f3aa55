// Supernodal multifrontal LU — native symbolic + numeric engines.
// Oracle: lssp_tpu_torch/pc/multifrontal.py (same algorithm, numpy/scipy);
// a verbatim copy of lssp_tpu/native/src/mf.cpp apart from its comments.
// Capability anchor: the reference's UMFPACK/MUMPS/SuperLU adapters
// (solver-umfpack.cxx:107-153,
//  solver-mumps.cxx:162-210) — BLAS-3 factorization throughput.
//
// BLAS/LAPACK are NOT linked: the caller passes raw function pointers
// extracted from scipy's cython_blas/cython_lapack capsules (Fortran
// calling convention, column-major).  Fronts are stored column-major.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

typedef void (*dgemm_t)(const char*, const char*, const int*, const int*,
                        const int*, const double*, const double*,
                        const int*, const double*, const int*,
                        const double*, double*, const int*);
typedef void (*dtrsm_t)(const char*, const char*, const char*, const char*,
                        const int*, const int*, const double*,
                        const double*, const int*, double*, const int*);
typedef void (*dgetrf_t)(const int*, const int*, double*, const int*,
                         int*, int*);

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// symbolic: etree + postorder + per-column L-pattern rowsets +
// fundamental supernodes + graduated relaxed amalgamation.
//
// Inputs: symmetric pattern M (CSR, both triangles, sorted) of the
// AMD-permuted matrix.  Outputs (caller-allocated, n-sized unless said):
//   post     (n)       postorder: new k holds old column post[k]
//   sn_start (n+1)     supernode column starts (count returned)
//   sn_parent(n)       parent supernode per supernode
//   rs_ptr   (n+1)     rowset offsets per supernode
//   rs_idx   (cap_rs)  concatenated rowsets (postordered labels)
// Returns the supernode count, or -1 when cap_rs is too small.
long lssp_mf_symbolic(const int64_t* Mp, const int64_t* Mi, long n,
                      int64_t* post, int64_t* sn_start, int64_t* sn_parent,
                      int64_t* rs_ptr, int64_t* rs_idx, long cap_rs) {
    // ---- etree (Liu) ----
    std::vector<int64_t> parent((size_t)n, -1), anc((size_t)n, -1);
    for (long j = 0; j < n; ++j)
        for (int64_t p = Mp[j]; p < Mp[j + 1]; ++p) {
            long i = (long)Mi[p];
            if (i >= j) continue;
            while (true) {
                long a = (long)anc[i];
                if (a == -1) {
                    anc[i] = j;
                    if (parent[i] == -1) parent[i] = j;
                    break;
                }
                if (a == j) break;
                anc[i] = j;
                i = a;
            }
        }
    // ---- postorder (iterative DFS, children ascending) ----
    std::vector<int64_t> head((size_t)n, -1), next((size_t)n, -1);
    for (long j = n - 1; j >= 0; --j)          // build ascending child lists
        if (parent[j] >= 0) {
            next[j] = head[(size_t)parent[j]];
            head[(size_t)parent[j]] = j;
        }
    std::vector<int64_t> stack;
    std::vector<int64_t> rank((size_t)n);
    long k = 0;
    for (long r = 0; r < n; ++r) {
        if (parent[r] >= 0) continue;
        stack.push_back(r);
        while (!stack.empty()) {
            long v = (long)stack.back();
            long c = (long)head[(size_t)v];
            if (c != -1) {
                head[(size_t)v] = next[(size_t)c];
                stack.push_back(c);
            } else {
                stack.pop_back();
                post[k] = v;
                rank[(size_t)v] = k;
                ++k;
            }
        }
    }
    // relabeled parent
    std::vector<int64_t> par2((size_t)n);
    for (long j2 = 0; j2 < n; ++j2) {
        long oldj = (long)post[j2];
        par2[(size_t)j2] = parent[oldj] >= 0 ? rank[(size_t)parent[oldj]]
                                             : -1;
    }
    // ---- per-column rowset counts + storage (markers, children unions)
    // process new labels ascending (children < parent under postorder)
    std::vector<std::vector<int64_t>> rowset((size_t)n);
    std::vector<int64_t> mark((size_t)n, -1);
    std::vector<std::vector<int64_t>> kids((size_t)n);
    for (long j = 0; j < n; ++j)
        if (par2[j] >= 0) kids[(size_t)par2[j]].push_back(j);
    for (long j = 0; j < n; ++j) {
        auto& rs = rowset[(size_t)j];
        mark[(size_t)j] = j;
        rs.push_back(j);
        long oldj = (long)post[j];
        for (int64_t p = Mp[oldj]; p < Mp[oldj + 1]; ++p) {
            long i2 = (long)rank[(size_t)Mi[p]];
            if (i2 > j && mark[(size_t)i2] != j) {
                mark[(size_t)i2] = j;
                rs.push_back(i2);
            }
        }
        for (long c : kids[(size_t)j]) {
            for (long r : rowset[(size_t)c])
                if (r > j && mark[(size_t)r] != j) {
                    mark[(size_t)r] = j;
                    rs.push_back(r);
                }
        }
        std::sort(rs.begin(), rs.end());
        // rowsets are KEPT for every column: the supernode pass below
        // reads rowset(last col) per supernode (total memory = nnz(L))
    }
    // ---- fundamental supernodes on counts ----
    std::vector<long> starts;
    starts.push_back(0);
    for (long j = 1; j < n; ++j)
        if (!(par2[j - 1] == j &&
              rowset[(size_t)(j - 1)].size() ==
                  rowset[(size_t)j].size() + 1))
            starts.push_back(j);
    starts.push_back(n);
    long nsn = (long)starts.size() - 1;
    // snode rowset size = width + |rowset(last col)| - 1
    // graduated amalgamation into the ADJACENT next supernode when it
    // holds the parent column
    std::vector<long> out_starts;
    out_starts.push_back(0);
    long cur_first = 0;
    long cur_w = starts[1] - starts[0];
    auto snsize = [&](long s) {
        long w = starts[s + 1] - starts[s];
        return w - 1 + (long)rowset[(size_t)(starts[s + 1] - 1)].size();
    };
    long cur_rows = snsize(0);
    for (long t = 1; t < nsn; ++t) {
        long w_t = starts[t + 1] - starts[t];
        long pcol = par2[(size_t)(starts[t] - 1)];  // parent of cur's last
        bool can = pcol >= starts[t] && pcol < starts[t + 1];
        if (can) {
            long rows_t = snsize(t);
            // merged rowset = cols(cur) ∪ rowset(t)  (nesting theorem)
            long merged = cur_w + rows_t;
            long real = cur_rows * cur_w + rows_t * w_t;
            long cost = merged * (cur_w + w_t);
            long z = cost - real;
            long wm = cur_w + w_t;
            can = (wm <= 4 || (wm <= 16 && z * 100 <= 30 * cost) ||
                   (wm <= 48 && z * 100 <= 15 * cost) ||
                   z * 100 <= 5 * cost);
            if (can) {
                cur_w = wm;
                cur_rows = merged;
            }
        }
        if (!can) {
            out_starts.push_back(starts[t]);
            cur_first = starts[t];
            cur_w = w_t;
            cur_rows = snsize(t);
        }
    }
    (void)cur_first;
    out_starts.push_back(n);
    long nsn2 = (long)out_starts.size() - 1;
    // ---- emit: snode rowsets = cols ∪ rowset(last col); parents ----
    long at = 0;
    rs_ptr[0] = 0;
    for (long s = 0; s < nsn2; ++s) {
        long c0 = out_starts[s], c1 = out_starts[s + 1];
        auto& last = rowset[(size_t)(c1 - 1)];
        long need = (c1 - c0 - 1) + (long)last.size();
        if (at + need > cap_rs) return -1;
        for (long j = c0; j < c1 - 1; ++j) rs_idx[at++] = j;
        for (long r : last) rs_idx[at++] = r;
        std::sort(rs_idx + rs_ptr[s], rs_idx + at);
        rs_ptr[s + 1] = at;
        sn_start[s] = c0;
    }
    sn_start[nsn2] = n;
    // snode-of map + parents
    std::vector<int64_t> sn_of((size_t)n);
    for (long s = 0; s < nsn2; ++s)
        for (long j = out_starts[s]; j < out_starts[s + 1]; ++j)
            sn_of[(size_t)j] = s;
    for (long s = 0; s < nsn2; ++s) {
        long lastc = out_starts[s + 1] - 1;
        sn_parent[s] = par2[(size_t)lastc] >= 0
                           ? sn_of[(size_t)par2[(size_t)lastc]] : -1;
    }
    return nsn2;
}

// ---------------------------------------------------------------------
// numeric: multifrontal traversal with update stacks, dense kernels via
// caller-supplied BLAS/LAPACK pointers.  B given as CSR AND CSC of the
// (postorder-)permuted matrix.  Outputs COO triplets (pivot-space rows
// for U; matrix-space rows for L — caller remaps via rowof) plus rowof.
// Returns nclamped, or -1 on allocation failure, -2 if an output cap is
// exceeded (caps are exact from the symbolic, so -2 indicates a bug).
long lssp_mf_numeric(
    const int64_t* Bp, const int64_t* Bj, const double* Bx,      // CSR
    const int64_t* Cp, const int64_t* Ci, const double* Cx,      // CSC
    long n, const int64_t* sn_start, const int64_t* sn_parent,
    const int64_t* rs_ptr, const int64_t* rs_idx, long nsn,
    double ztol, double zval,
    void* dgemm_p, void* dtrsm_p, void* dgetrf_p,
    int64_t* Lr, int64_t* Lc, double* Lv, long capL,
    int64_t* Ur, int64_t* Uc, double* Uv, long capU,
    int64_t* rowof) {
    dgemm_t dgemm = (dgemm_t)dgemm_p;
    dtrsm_t dtrsm = (dtrsm_t)dtrsm_p;
    dgetrf_t dgetrf = (dgetrf_t)dgetrf_p;
    struct Update {
        const int64_t* rows;
        long nr;
        double* data;               // colmajor nr×nr
    };
    std::vector<std::vector<Update>> pending((size_t)nsn);
    std::vector<long> pos((size_t)n, -1);
    std::vector<int> ipiv;
    long nclamped = 0, nL = 0, nU = 0;
    for (long j = 0; j < n; ++j) rowof[j] = j;

    for (long s = 0; s < nsn; ++s) {
        const long c0 = (long)sn_start[s], c1 = (long)sn_start[s + 1];
        const long w = c1 - c0;
        const int64_t* R = rs_idx + rs_ptr[s];
        const long nR = (long)(rs_ptr[s + 1] - rs_ptr[s]);
        double* F = (double*)calloc((size_t)nR * nR, sizeof(double));
        if (!F) return -1;
        for (long k = 0; k < nR; ++k) pos[(size_t)R[k]] = k;
        // assemble A columns c0..c1 (rows >= c0) and rows c0..c1 (cols >= c1)
        for (long j = c0; j < c1; ++j)
            for (int64_t p = Cp[j]; p < Cp[j + 1]; ++p) {
                long r = (long)Ci[p];
                if (r >= c0) F[pos[(size_t)r] + (size_t)(j - c0) * nR]
                    += Cx[p];
            }
        for (long i = c0; i < c1; ++i)
            for (int64_t p = Bp[i]; p < Bp[i + 1]; ++p) {
                long c = (long)Bj[p];
                if (c >= c1) F[(i - c0) + (size_t)pos[(size_t)c] * nR]
                    += Bx[p];
            }
        // extend-add children
        for (auto& u : pending[(size_t)s]) {
            for (long b = 0; b < u.nr; ++b) {
                const long cb = pos[(size_t)u.rows[b]];
                double* dst = F + (size_t)cb * nR;
                const double* src = u.data + (size_t)b * u.nr;
                for (long a = 0; a < u.nr; ++a)
                    dst[pos[(size_t)u.rows[a]]] += src[a];
            }
            free(u.data);
        }
        pending[(size_t)s].clear();
        pending[(size_t)s].shrink_to_fit();
        // dense partial factorization, pivoting restricted to block rows
        int m_i = (int)w, n_i = (int)w, lda = (int)nR, info = 0;
        ipiv.resize((size_t)w);
        dgetrf(&m_i, &n_i, F, &lda, ipiv.data(), &info);
        // clamp near-zero pivots (library-wide rule)
        for (long k = 0; k < w; ++k) {
            double d = F[k + (size_t)k * nR];
            if (d <= ztol && d >= -ztol) {
                F[k + (size_t)k * nR] = d >= 0 ? zval : -zval;
                ++nclamped;
            }
        }
        // block row permutation: pr[k] = original block row at pivot k;
        // apply the same swaps to the A12 columns (w..nR)
        std::vector<long> pr((size_t)w);
        for (long k = 0; k < w; ++k) pr[(size_t)k] = k;
        for (long k = 0; k < w; ++k) {
            long pk = (long)ipiv[(size_t)k] - 1;   // LAPACK is 1-based
            if (pk != k) {
                std::swap(pr[(size_t)k], pr[(size_t)pk]);
                for (long c = w; c < nR; ++c)
                    std::swap(F[k + (size_t)c * nR],
                              F[pk + (size_t)c * nR]);
            }
        }
        for (long k = 0; k < w; ++k)
            rowof[c0 + k] = R[pr[(size_t)k]];
        const long nS = nR - w;
        if (nS > 0) {
            // L21 = A21 U11^-1  (right-solve, upper, non-unit)
            const char Rgt = 'R', Up = 'U', NoT = 'N', NonU = 'N',
                       Lft = 'L', Lo = 'L', Unit = 'U';
            const double one = 1.0, mone = -1.0;
            int mm = (int)nS, nn = (int)w;
            dtrsm(&Rgt, &Up, &NoT, &NonU, &mm, &nn, &one, F, &lda,
                  F + w, &lda);
            // U12 = L11^-1 A12  (left-solve, lower, unit)
            mm = (int)w; nn = (int)nS;
            dtrsm(&Lft, &Lo, &NoT, &Unit, &mm, &nn, &one, F, &lda,
                  F + (size_t)w * nR, &lda);
            // Schur: F22 -= L21 U12
            int kk = (int)w;
            mm = (int)nS; nn = (int)nS;
            dgemm(&NoT, &NoT, &mm, &nn, &kk, &mone, F + w, &lda,
                  F + (size_t)w * nR, &lda, &one,
                  F + w + (size_t)w * nR, &lda);
            long p = (long)sn_parent[s];
            if (p >= 0) {
                double* ud = (double*)malloc((size_t)nS * nS
                                             * sizeof(double));
                if (!ud) { free(F); return -1; }
                for (long c = 0; c < nS; ++c)
                    memcpy(ud + (size_t)c * nS,
                           F + w + (size_t)(w + c) * nR,
                           (size_t)nS * sizeof(double));
                pending[(size_t)p].push_back(Update{R + w, nS, ud});
            }
        }
        // emit factors in STRUCTURED order — L grouped by COLUMN
        // (ascending globally: a CSC layout the caller turns into CSR
        // with one counting transpose), U grouped by pivot ROW
        // (ascending globally: a direct CSR).  No sorting downstream.
        for (long c = 0; c < w; ++c) {
            if (nL + (nR - c - 1) > capL) { free(F); return -2; }
            for (long r = c + 1; r < w; ++r) {
                Lr[nL] = R[pr[(size_t)r]];
                Lc[nL] = c0 + c;
                Lv[nL] = F[r + (size_t)c * nR];
                ++nL;
            }
            for (long r = w; r < nR; ++r) {
                Lr[nL] = R[r];
                Lc[nL] = c0 + c;
                Lv[nL] = F[r + (size_t)c * nR];
                ++nL;
            }
        }
        for (long r = 0; r < w; ++r) {
            if (nU + (w - r) + (nR - w) > capU) { free(F); return -2; }
            for (long c = r; c < w; ++c) {
                Ur[nU] = c0 + r;
                Uc[nU] = c0 + c;
                Uv[nU] = F[r + (size_t)c * nR];
                ++nU;
            }
            for (long c = w; c < nR; ++c) {
                Ur[nU] = c0 + r;
                Uc[nU] = R[c];
                Uv[nU] = F[r + (size_t)c * nR];
                ++nU;
            }
        }
        for (long k = 0; k < nR; ++k) pos[(size_t)R[k]] = -1;
        free(F);
    }
    // encode counts in the first two rowof-adjacent slots?  Use return
    // convention: caller passed exact caps; report nclamped.
    return nclamped;
}

}  // extern "C"
