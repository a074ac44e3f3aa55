// Greedy strength-graph aggregation (setup-phase hot loop of the
// hierarchical aggregation ordering, lssp_tpu_torch/amg/aggregate.py).
// A copy of lssp_tpu/native/src/aggregate.cpp; only this header differs.
//
// Semantics are EXACTLY the Python oracle's (greedy_aggregate_exact over
// _sym_strength): the strength graph keeps edge {u,w}, u != w, when
//   |a_uw| >= theta * sqrt(|a_uu| * |a_ww|)   in EITHER direction,
// and the greedy BFS visits strong neighbours in ascending column order —
// reproduced here by merge-walking the (sorted) rows of A and A^T instead
// of materialising the symmetrised graph (the scipy build of which was the
// measured bottleneck: 16 s of a 23 s hierarchy at 1M rows).  Only the raw
// aggregate ids are produced; the exactness fix-up stays in (vectorised)
// Python, shared by both paths.  Compiled with -ffp-contract=off so the
// strength predicate is bit-identical to numpy's.
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" void lssp_greedy_aggregate(
    const int64_t* Ap, const int64_t* Aj, const double* Ax,
    const int64_t* Tp, const int64_t* Tj, const double* Tx,
    int64_t n, int64_t g, double theta,
    const uint8_t* virt, int64_t* ids) {
  // |diagonal|, zero -> 1.0 (same guard as _sym_strength)
  std::vector<double> d(n, 1.0);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t k = Ap[u]; k < Ap[u + 1]; ++k)
      if (Aj[k] == u) {
        double v = std::fabs(Ax[k]);
        d[u] = (v == 0.0) ? 1.0 : v;
        break;
      }

  for (int64_t i = 0; i < n; ++i) ids[i] = -1;

  std::vector<int64_t> frontier, next, members;
  frontier.reserve(64); next.reserve(64); members.reserve(g);
  int64_t nxt = 0;
  for (int64_t v = 0; v < n; ++v) {
    if (ids[v] >= 0 || virt[v]) continue;
    members.clear(); frontier.clear();
    members.push_back(v);
    ids[v] = nxt;
    frontier.push_back(v);
    while ((int64_t)members.size() < g && !frontier.empty()) {
      next.clear();
      bool full = false;
      for (size_t fi = 0; fi < frontier.size() && !full; ++fi) {
        int64_t u = frontier[fi];
        // merge-walk row u of A and row u of A^T in ascending column order
        int64_t ka = Ap[u], ea = Ap[u + 1];
        int64_t kt = Tp[u], et = Tp[u + 1];
        while (ka < ea || kt < et) {
          int64_t w; double au = 0.0, aw = 0.0;  // a_uw, a_wu
          bool ha = false, ht = false;
          int64_t ca = ka < ea ? Aj[ka] : INT64_MAX;
          int64_t ct = kt < et ? Tj[kt] : INT64_MAX;
          if (ca <= ct) { w = ca; au = Ax[ka]; ha = true; ++ka; }
          else          { w = ct; }
          if (ct == w && kt < et) { aw = Tx[kt]; ht = true; ++kt; }
          if (w == u || ids[w] >= 0 || virt[w]) continue;
          // strong in either direction: |a| >= theta*sqrt(d_u*d_w).
          // Evaluate EXACTLY as numpy does (sqrt form, no contraction)
          // so the native and Python orderings are identical.
          double s = theta * std::sqrt(d[u] * d[w]);
          bool strong = (ha && std::fabs(au) >= s) ||
                        (ht && std::fabs(aw) >= s);
          if (!strong) continue;
          ids[w] = nxt;
          members.push_back(w);
          next.push_back(w);
          if ((int64_t)members.size() >= g) { full = true; break; }
        }
      }
      frontier.swap(next);
    }
    ++nxt;
  }
}
