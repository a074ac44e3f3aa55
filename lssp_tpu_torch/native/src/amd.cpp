// Minimum-degree fill-reducing ordering on the pattern of A+A^T.
//
// Quotient-graph minimum degree with APPROXIMATE external degrees
// (Amestoy-Davis-Duff bound, aggressive absorption) and element
// absorption — the C++ fast path for the Python oracle
// lssp_tpu_torch/sparse/reorder.py: amd_permutation, and a verbatim copy of
// lssp_tpu/native/src/amd.cpp apart from its comments (identical output: integer
// arithmetic only, ties broken by smallest node index).  Capability analog
// of the COLAMD/AMD orderings the reference reaches through SuperLU
// (solver-superlu.cxx:60-64) and MUMPS ICNTL(7)
// (solver-mumps.cxx:108-137).
#include <cstdint>
#include <vector>
#include <queue>
#include <algorithm>

namespace {

struct QNode {
    int64_t deg;
    int64_t id;
    bool operator>(const QNode& o) const {
        return deg != o.deg ? deg > o.deg : id > o.id;
    }
};

}  // namespace

extern "C" void lssp_amd_order(const int64_t* ip, const int64_t* ix,
                               int64_t n, int64_t* perm) {
    if (n <= 0) return;
    if (n == 1) { perm[0] = 0; return; }

    // symmetrized adjacency (A + A^T pattern, no diagonal), sorted unique
    std::vector<std::vector<int64_t>> adj_var(n);
    {
        std::vector<int64_t> cnt(n, 0);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t q = ip[i]; q < ip[i + 1]; ++q)
                if (ix[q] != i) { ++cnt[i]; ++cnt[ix[q]]; }
        for (int64_t i = 0; i < n; ++i) adj_var[i].reserve(cnt[i]);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t q = ip[i]; q < ip[i + 1]; ++q) {
                int64_t j = ix[q];
                if (j == i) continue;
                adj_var[i].push_back(j);
                adj_var[j].push_back(i);
            }
        for (int64_t i = 0; i < n; ++i) {
            auto& a = adj_var[i];
            std::sort(a.begin(), a.end());
            a.erase(std::unique(a.begin(), a.end()), a.end());
        }
    }

    std::vector<std::vector<int64_t>> adj_el(n);    // elements of variable
    std::vector<std::vector<int64_t>> elem_vars(n); // live vars of element
    std::vector<int64_t> degree(n), mark(n, -1);
    std::vector<char> alive(n, 1), in_lp(n, 0);
    std::priority_queue<QNode, std::vector<QNode>, std::greater<QNode>> heap;
    for (int64_t i = 0; i < n; ++i) {
        degree[i] = (int64_t)adj_var[i].size();
        heap.push({degree[i], i});
    }

    std::vector<int64_t> Lp;
    std::vector<int64_t> w(n, 0), emark(n, -1);
    int64_t stamp = 0, estamp = 0;

    for (int64_t k = 0; k < n; ++k) {
        int64_t p;
        for (;;) {
            QNode t = heap.top();
            heap.pop();
            if (alive[t.id] && t.deg == degree[t.id]) { p = t.id; break; }
        }
        alive[p] = 0;
        perm[k] = p;

        // Lp = adj_var[p] ∪ (∪_{e∈adj_el[p]} elem_vars[e]) \ {p}
        Lp.clear();
        ++stamp;
        mark[p] = stamp;
        for (int64_t v : adj_var[p])
            if (mark[v] != stamp) { mark[v] = stamp; Lp.push_back(v); }
        for (int64_t e : adj_el[p]) {
            for (int64_t v : elem_vars[e])
                if (mark[v] != stamp) { mark[v] = stamp; Lp.push_back(v); }
            elem_vars[e].clear();
            elem_vars[e].shrink_to_fit();   // absorbed into element p
        }
        std::sort(Lp.begin(), Lp.end());
        for (int64_t v : Lp) in_lp[v] = 1;
        in_lp[p] = 1;

        // absorbed-element membership test: adj_el lists are short —
        // binary search over the sorted adj_el[p]
        std::vector<int64_t>& absorbed = adj_el[p];
        std::sort(absorbed.begin(), absorbed.end());
        elem_vars[p] = Lp;

        // AMD approximate degrees (Amestoy–Davis–Duff): one pass gives
        // w[e] = |L_e \ Lp| for every element touching Lp (the exact
        // union walk per variable was O(fill²) — measured 6 s on the
        // 15.6k-row coupled3d matrix alone)
        ++estamp;
        for (int64_t i : Lp)
            for (int64_t e : adj_el[i]) {
                if (elem_vars[e].empty()) continue;       // dead
                if (emark[e] != estamp) {
                    emark[e] = estamp;
                    w[e] = (int64_t)elem_vars[e].size();
                }
                --w[e];
            }
        for (int64_t i : Lp)
            for (int64_t e : adj_el[i])
                if (emark[e] == estamp && w[e] == 0 &&
                    !elem_vars[e].empty()) {
                    elem_vars[e].clear();                 // L_e ⊆ Lp
                    elem_vars[e].shrink_to_fit();         // aggressive
                }

        for (int64_t i : Lp) {
            // adj_var[i] \= (Lp ∪ {p}); lists stay sorted
            auto& av = adj_var[i];
            av.erase(std::remove_if(av.begin(), av.end(),
                                    [&](int64_t v) { return in_lp[v]; }),
                     av.end());
            // adj_el[i] = (adj_el[i] \ absorbed \ dead) ∪ {p}
            auto& ae = adj_el[i];
            ae.erase(std::remove_if(ae.begin(), ae.end(), [&](int64_t e) {
                         return elem_vars[e].empty() ||
                                std::binary_search(absorbed.begin(),
                                                   absorbed.end(), e);
                     }),
                     ae.end());
            int64_t d = (int64_t)av.size() + (int64_t)Lp.size() - 1;
            for (int64_t e : ae) d += w[e];
            ae.push_back(p);
            int64_t cap = n - k - 1;
            if (d > cap) d = cap;
            if (d != degree[i]) {
                degree[i] = d;
                heap.push({d, i});
            }
        }
        for (int64_t v : Lp) in_lp[v] = 0;
        in_lp[p] = 0;
        adj_var[p].clear();
        adj_var[p].shrink_to_fit();
        absorbed.clear();
        absorbed.shrink_to_fit();
    }
}
