// Native sparse direct LU: left-looking (Gilbert–Peierls) factorization
// with threshold partial pivoting, C ABI via ctypes.
//
// This supplies the capability the reference only gets from external direct
// solvers (UMFPACK solver-umfpack.cxx, KLU
// solver-klu.cxx, SuperLU solver-superlu.cxx, MUMPS solver-mumps.cxx,
// PARDISO solver-pardiso.cxx) as a from-scratch native implementation:
// factor once on the host, triangular solves run on the device via the
// level-scheduled sweeps of lssp_tpu_torch/ops/trisolve.py.  A verbatim
// copy of lssp_tpu/native/src/splu.cpp apart from its comments, so the
// port's factors are bit-identical to the JAX package's.
//
// Input is CSC (= CSR of Aᵀ, which the Python wrapper provides).  For each
// column j: (1) depth-first search from the column's pattern through the
// already-computed L columns yields the nonzero reach in topological order;
// (2) a sparse triangular solve scatters/updates a dense workspace along
// that reach; (3) the pivot is the largest remaining entry, with the
// diagonal preferred whenever it is within pivot_tol of the maximum
// (threshold pivoting keeps the fill of pre-ordered matrices low).
// Zero pivots are clamped to ±zval like the reference's ILU guard
// (pc-iluk.cxx:367-374) and reported via info.

#include <cmath>
#include <cstdint>
#include <vector>

using std::int64_t;

namespace {

struct LUResult {
    std::vector<int64_t> Lp, Li, Up, Ui;
    std::vector<double> Lx, Ux;
    std::vector<int64_t> pinv;   // row -> pivot position
    int64_t nclamped = 0;
};

// Iterative DFS from root through the column graph of L; appends the reach
// to xi (filled from the end, xi[top..n-1] ends up in topological order).
int64_t reach_from(int64_t root, const std::vector<int64_t>& Lp,
                   const std::vector<int64_t>& Li,
                   const std::vector<int64_t>& pinv,
                   std::vector<char>& mark, std::vector<int64_t>& xi,
                   std::vector<int64_t>& rstack, std::vector<int64_t>& pstack,
                   int64_t top) {
    if (mark[root]) return top;
    int64_t head = 0;
    rstack[0] = root;
    while (head >= 0) {
        int64_t i = rstack[head];
        if (!mark[i]) {
            mark[i] = 1;
            pstack[head] = (pinv[i] >= 0) ? Lp[pinv[i]] : 0;
        }
        bool done = true;
        if (pinv[i] >= 0) {
            int64_t jcol = pinv[i];
            for (int64_t p = pstack[head]; p < Lp[jcol + 1]; ++p) {
                int64_t ii = Li[p];
                if (!mark[ii]) {
                    pstack[head] = p + 1;
                    rstack[++head] = ii;
                    done = false;
                    break;
                }
            }
        }
        if (done) {
            xi[--top] = i;
            --head;
        }
    }
    return top;
}

}  // namespace

extern "C" {

// Factor the n×n CSC matrix (Ap, Ai, Ax).  Returns an opaque handle; fetch
// sizes with lssp_splu_sizes, arrays with lssp_splu_fetch, release with
// lssp_splu_free.  info_out receives the number of clamped (near-zero)
// pivots — 0 means the factorization is exact.
void* lssp_splu(const int64_t* Ap, const int64_t* Ai, const double* Ax,
                int64_t n, double pivot_tol, double ztol, double zval,
                int64_t* info_out) {
    auto* res = new LUResult();
    res->Lp.assign(1, 0);
    res->Up.assign(1, 0);
    res->pinv.assign(n, -1);

    std::vector<double> x(n, 0.0);
    std::vector<char> mark(n, 0);
    std::vector<int64_t> xi(n), rstack(n), pstack(n);
    // rough fill guess to cut reallocation churn
    res->Li.reserve(4 * (size_t)Ap[n]);
    res->Lx.reserve(4 * (size_t)Ap[n]);
    res->Ui.reserve(4 * (size_t)Ap[n]);
    res->Ux.reserve(4 * (size_t)Ap[n]);

    for (int64_t j = 0; j < n; ++j) {
        // ---- symbolic: reach of column j through existing L columns
        int64_t top = n;
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p)
            top = reach_from(Ai[p], res->Lp, res->Li, res->pinv, mark, xi,
                             rstack, pstack, top);
        // ---- numeric: scatter column, then eliminate in topological order
        for (int64_t p = top; p < n; ++p) x[xi[p]] = 0.0;
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) x[Ai[p]] = Ax[p];
        for (int64_t p = top; p < n; ++p) {
            int64_t i = xi[p];
            int64_t jf = res->pinv[i];
            if (jf < 0) continue;
            double xv = x[i];
            if (xv == 0.0) continue;
            for (int64_t q = res->Lp[jf]; q < res->Lp[jf + 1]; ++q)
                x[res->Li[q]] -= res->Lx[q] * xv;
        }
        // ---- pivot: largest unpivoted entry, diagonal preferred
        int64_t ipiv = -1;
        double amax = 0.0;
        for (int64_t p = top; p < n; ++p) {
            int64_t i = xi[p];
            if (res->pinv[i] >= 0) continue;
            double a = std::fabs(x[i]);
            if (a > amax) { amax = a; ipiv = i; }
        }
        double pivot;
        if (ipiv < 0) {
            // structurally empty column: take any unpivoted row, zero pivot
            for (int64_t r = 0; r < n; ++r)
                if (res->pinv[r] < 0) { ipiv = r; break; }
            pivot = 0.0;
        } else {
            // prefer the diagonal when it is within pivot_tol of the max
            // (mark[j] ⇔ j is in this column's reach, so x[j] is live)
            if (mark[j] && res->pinv[j] < 0 &&
                std::fabs(x[j]) >= pivot_tol * amax && std::fabs(x[j]) > 0.0)
                ipiv = j;
            pivot = x[ipiv];
        }
        if (std::fabs(pivot) <= ztol) {
            pivot = (pivot >= 0.0) ? zval : -zval;   // reference-style clamp
            ++res->nclamped;
        }
        res->pinv[ipiv] = j;
        // ---- emit U column j (rows already pivoted) + the pivot itself
        for (int64_t p = top; p < n; ++p) {
            int64_t i = xi[p];
            mark[i] = 0;                              // reset for next column
            if (res->pinv[i] >= 0 && i != ipiv) {
                if (x[i] != 0.0) {
                    res->Ui.push_back(res->pinv[i]);
                    res->Ux.push_back(x[i]);
                }
            }
        }
        res->Ui.push_back(j);
        res->Ux.push_back(pivot);
        res->Up.push_back((int64_t)res->Ui.size());
        // ---- emit L column j (rows not yet pivoted), scaled by the pivot
        for (int64_t p = top; p < n; ++p) {
            int64_t i = xi[p];
            if (res->pinv[i] < 0 && x[i] != 0.0) {
                res->Li.push_back(i);                 // renumbered at the end
                res->Lx.push_back(x[i] / pivot);
            }
        }
        res->Lp.push_back((int64_t)res->Li.size());
    }
    // final row renumbering of L into pivot order
    for (auto& li : res->Li) li = res->pinv[li];
    if (info_out) *info_out = res->nclamped;
    return res;
}

void lssp_splu_sizes(void* handle, int64_t* lnnz, int64_t* unnz) {
    auto* res = static_cast<LUResult*>(handle);
    *lnnz = (int64_t)res->Li.size();
    *unnz = (int64_t)res->Ui.size();
}

void lssp_splu_fetch(void* handle, int64_t* Lp, int64_t* Li, double* Lx,
                     int64_t* Up, int64_t* Ui, double* Ux, int64_t* pinv) {
    auto* res = static_cast<LUResult*>(handle);
    int64_t n = (int64_t)res->Lp.size() - 1;
    for (int64_t i = 0; i <= n; ++i) { Lp[i] = res->Lp[i]; Up[i] = res->Up[i]; }
    for (size_t p = 0; p < res->Li.size(); ++p) { Li[p] = res->Li[p]; Lx[p] = res->Lx[p]; }
    for (size_t p = 0; p < res->Ui.size(); ++p) { Ui[p] = res->Ui[p]; Ux[p] = res->Ux[p]; }
    for (int64_t i = 0; i < n; ++i) pinv[i] = res->pinv[i];
}

void lssp_splu_free(void* handle) {
    delete static_cast<LUResult*>(handle);
}

}  // extern "C"
