// K2 / K2k: the whole truncated-Neumann ILU apply as one wavefront launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lssp_tpu/ops/pallas_neumann.py: _build_call
// (entries fused_neumann_apply and _apply_impl, plan plan_fused_neumann),
// which runs the whole apply z ~= U^-1 L^-1 r as one program, and its k-rhs
// rule (_vmap_safe_apply, _batched_band_apply, pallas_neumann.py:280-326):
//   k sweeps  y <- r - Ls y,   z0 = D^-1 y,   k sweeps  z <- z0 - (D^-1 Us) z.
// That program keeps both factors and the iterate resident in 11 MB of
// VMEM; a Hopper block has 227 KB of shared memory and the 128^3 factors
// alone are 50 MB, so the apply cannot sit in one block.  Per row a sweep is
//
//   out[i] = (base[i] - (sum_d band[d, i] * y[i + off_d]
//                        + sum_{j in strays(i)} val_j * y[col_j]))  (* invd[i])
//
// with the band in d order, then the row-sorted CSR strays; the invd scale
// is fused into the last forward sweep, which yields z0.  The band is the
// factor's dominant diagonals (the _split_band rule of the TPU plan).
//
// Bound: device-memory bandwidth.  Run as 2k launches of one Jacobi sweep
// each (this kernel's earlier form), the apply streamed the factor band, the iterate, the base
// and the output through HBM 2k times, about 8x the bytes of the bound
// (each input read once, the output written once).  Here it is ONE launch,
// a wavefront over row tiles:
//
// - Work item (phase, u, column tile): one row tile (kThreads * rpt rows,
//   rpt <= RPT) through all k sweep levels of a phase; phase 1 walks the
//   tiles downward, t = tiles - 1 - u.  Ls is strictly lower, so level s of
//   tile u needs level s - 1 only on tiles [u - dep, u] (dep: the factors'
//   reach in tiles); D^-1 Us is strictly upper, the same with the order
//   reversed.  Tile u's level s waits for level s - 1 of the tiles before
//   it, which run beside it one level ahead or more: the wavefront.
// - The tile's band rows are copied into shared memory once an item, so
//   the factors move through HBM once an apply; the tile's previous level
//   sits in a shared window with a halo of the neighbouring tile's (the
//   near diagonals, |offset| <= halo; two windows, alternating by level),
//   its base (r, or z0) in registers.
//   Only the far diagonals, the halo and the strays go through the L2,
//   from the level rings: at k = 1 about 8 bytes a row and level (one
//   read, one write) where a sweep launch moved the whole row through HBM.
// - What bounds it instead: each level of an item is a chain of L2 round
//   trips (poll the neighbours' progress, load the far diagonal and the
//   halo, store, release), and the tiles that fit on the card at once
//   (shared memory for the band, registers for the base and sums) cover
//   only part of n, so a phase runs as a few waves of that chain.
// - What an item waits for is the host's (ops/neumann.py: Wavefront, whose
//   sets the CPU tests check and replay): per phase a WaitSet of item
//   distances for the tiles a level reads (without strays only those its
//   band diagonals read, at most two a diagonal; with strays every tile of
//   the reach), one for the ring slots it overwrites, and one for phase 1's
//   wait on z0.  The kernel only walks them.
// - Blocks take items by atomicAdd on a ticket, phase 0's tiles in order,
//   then phase 1's; each block fetches its next ticket while an item runs.
//   An item waits only on items of smaller tickets, which running blocks
//   hold, so the grid (occupancy x SMs, persistent) cannot deadlock.
// - Each (phase, column tile, tile) has a progress word, its levels done,
//   published with st.release.gpu after __syncthreads and polled with
//   ld.acquire.gpu (__nanosleep backoff to 256 ns).  The words and the
//   ticket are zeroed by a memset on the launch's stream, so a CUDA graph
//   replays the pair as it is; nothing per call is in the launch arguments.
// - Levels 1..k-1 of a phase live in rings of ring_tiles tiles, one ring a
//   level (row i at slot i & mask; full length when the ring would not be
//   smaller, as for strays that reach far back).  Before it overwrites a
//   slot, an item waits until the readers of the value there (level s + 1
//   of the tiles that read tile u - ring_tiles) are done; a ring longer
//   than the reach keeps that wait on smaller tickets.
// - Data written in the launch (the rings, z0) is read with ld.global.cg,
//   through the L2, never through the SM's non-coherent L1 (no __ldg, no
//   const __restrict__ on those pointers), and r, which level 1 reads
//   alike, too; the band is copied into shared memory with cp.async, the
//   strays and invd go through __ldg.
// - K2k, the (n, k) form: element (i, c) at i * k + c, one thread per row
//   and register tile of KT columns (csrc/krhs.cuh); each column sums in
//   K2's order.  A thread owns up to RPT rows (8 / KT, 4 at KT = 8, half
//   in fp64; lssp_neumann_rows_per_thread), so a tile is 2,048 rows at
//   k = 1 and 1,024 at k = 8 in fp32, halved while its band rows would pass
//   48 KB (ops/neumann.py: tile_rows); 4 blocks an SM fit at KT < 8, 2 at
//   KT = 8 (registers).

#include <cstdint>
#include <new>

#include <cuda_runtime.h>

#include "krhs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiags = 64;
constexpr uint64_t kMaxWaitNs = 10000000000ull;

// Rows a thread owns in a tile of KT columns: 8 / KT, 4 at KT = 8, in
// fp32, half as many (at least one) in fp64; and the blocks an SM must fit
// (the register budget): 4 at KT < 8, 2 at KT = 8.
template <typename T, int KT>
struct RowsPerThread {
  static constexpr int fp32 = KT == 8 ? 4 : 8 / KT;
  static constexpr int value = fp32 * 4 / static_cast<int>(sizeof(T)) > 0
                                   ? fp32 * 4 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int min_blocks = KT == 8 ? 2 : 4;
};

// A set of items to wait for, as item u sees it: u - d for d in [lo[i],
// hi[i]] of each range i, in the order of u's phase (d >= 1, or >= 0 for
// phase 1's wait on phase 0, whose items all come first); ``total`` counts
// the d.  The host (ops/neumann.py: Wavefront) builds every set.
constexpr int kMaxRanges = 16;
struct WaitSet {
  int count, total;
  int lo[kMaxRanges], hi[kMaxRanges];

  // the e-th d, e < total
  __device__ __forceinline__ int delta(int e) const {
    for (int i = 0;; ++i) {
      const int len = hi[i] - lo[i] + 1;
      if (e < len) return lo[i] + e;
      e -= len;
    }
  }
};

template <typename T>
struct Factor {
  const T* band;             // (ndiag, n)
  const int32_t* offsets;    // (ndiag,)
  int ndiag;
  const int32_t* sptr;       // (n + 1,) or null
  const int32_t* scol;
  const T* sval;
};

template <typename T>
struct Apply {
  Factor<T> f[2];            // phase 0: Ls; phase 1: D^-1 Us
  const T* invd;             // (n,)
  const T* r;                // (n, k), read-only
  T* z0;                     // (n, k)
  T* out;                    // (n, k)
  T* levels;                 // [2][sweeps - 1] rings of (ring_rows, k): levels 1..k-1
  int* progress;             // [2][nct][tiles]: levels done
  unsigned int* ticket;
  int64_t n, k, mask, ring_rows;  // ring slot of row i: i & mask
  int sweeps, rows, tiles, nct;
  int halo[2];               // per phase: rows beside the tile in shared memory
  int hmax;                  // the window's halo rows: max(halo[0], halo[1])
  // per phase: the items whose level s - 1 level s > 1 reads, and those
  // whose level s + 1 must be done before level s < sweeps overwrites their
  // ring slots (empty when the rings do not wrap); phase 1's level 1 waits
  // for phase 0's last level (z0) on ``base``
  WaitSet reads[2], reuse[2], base;
};

// Dynamic shared memory of a block: two windows of (rows + hmax) rows of
// KT values, then the tile's band rows, (ndmax, rows).
template <typename T>
int64_t smem_bytes(int kt, int rows, int hmax, int ndmax) {
  return (2 * static_cast<int64_t>(rows + hmax) * kt + static_cast<int64_t>(ndmax) * rows) *
         static_cast<int64_t>(sizeof(T));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block-wide: wait until every entry e in [0, total) is met: entry(e, t,
// need) names a progress word (a tile t) and the levels it must reach, or
// returns false for nothing to wait for.  Thread x polls entries x,
// x + kThreads, ..., all in one round.  Every thread of the block calls it.
template <typename Entry>
__device__ void wait_for(const int* prog, int total, Entry entry) {
  if (total <= 0) return;
  int e = threadIdx.x;
  unsigned sleep = 32;
  uint64_t since = 0;
  for (;;) {
    for (; e < total; e += kThreads) {
      int t, need;
      if (entry(e, t, need) && ld_acquire(prog + t) < need) break;
    }
    if (__syncthreads_and(e >= total)) break;
    // a schedule that cannot finish (a broken plan) fails the launch after
    // 10 s instead of holding the card
    const uint64_t now = globaltimer();
    if (since == 0) since = now;
    if (now - since > kMaxWaitNs) __trap();
    __nanosleep(sleep);
    if (sleep < 256) sleep *= 2;
  }
}

// Copy one T from device memory into shared memory asynchronously
// (cp.async); a copy that is not ``valid`` fills 0 and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// A diagonal's values of a level for the thread's RPT rows of a tile, from
// the L2: rows j0 + li (li = threadIdx.x + q * kThreads), 0 outside [0, n).
template <typename T, int KT, int RPT>
__device__ __forceinline__ void far_loads(lssp::Tile<T, KT> (&yv)[RPT], const T* yg,
                                          int64_t ymask, int64_t j0, int64_t n, int rows,
                                          int rpt, int64_t k, int64_t c0) {
  const bool inside = j0 >= 0 && j0 + rows <= n;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int64_t j = j0 + threadIdx.x + q * kThreads;
    yv[q].zero();
    if (q < rpt && (inside || (j >= 0 && j < n))) yv[q].load_cg(yg + (j & ymask) * k + c0);
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads, (RowsPerThread<T, KT>::min_blocks))
neumann_wavefront_kernel(const __grid_constant__ Apply<T> a) {
  constexpr int RPT = RowsPerThread<T, KT>::value;
  using Tile = lssp::Tile<T, KT>;
  // dynamic shared memory (smem_bytes): two windows, each a level of the
  // tile and a halo of the neighbouring tile's (before it in phase 0,
  // after it in phase 1) for the near diagonals; level s reads window
  // (s - 1) & 1 and writes window s & 1, so no barrier separates its
  // reads from its writes.  Then the tile's band rows.
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* s_y = reinterpret_cast<T*>(s_dyn);
  const int wsize = (a.rows + a.hmax) * KT;      // a window's values
  T* s_band = s_y + 2 * wsize;
  __shared__ int s_off[2][kMaxDiags];
  __shared__ unsigned s_ticket;
  for (int ph = 0; ph < 2; ++ph)
    for (int d = threadIdx.x; d < a.f[ph].ndiag; d += kThreads)
      s_off[ph][d] = a.f[ph].offsets[d];
  const int S = a.sweeps, NT = a.tiles, nct = a.nct, rows = a.rows;
  const int rpt = rows / kThreads;
  const unsigned total = 2u * static_cast<unsigned>(NT) * static_cast<unsigned>(nct);
  const int64_t n = a.n, k = a.k;
  // thread 0 fetches the block's next ticket while an item runs (a block
  // that holds an unstarted ticket still runs an item of a smaller one, so
  // the smallest unfinished item always runs)
  unsigned next = 0;
  if (threadIdx.x == 0) s_ticket = atomicAdd(a.ticket, 1u);
  for (;;) {
    __syncthreads();
    const unsigned x = s_ticket;
    if (x >= total) return;
    if (threadIdx.x == 0) next = atomicAdd(a.ticket, 1u);
    const int ct = static_cast<int>(x % nct), ph = static_cast<int>(x / nct) / NT;
    const int u = static_cast<int>(x / nct) % NT, t = ph ? NT - 1 - u : u;
    int* prog = a.progress + static_cast<int64_t>(ph * nct + ct) * NT;
    const Factor<T>& f = a.f[ph];
    const int* off = s_off[ph];
    const int halo = a.halo[ph];
    const int woff = ph ? 0 : halo;                // window slot of the tile's row 0
    const int64_t t0 = static_cast<int64_t>(t) * rows, c0 = static_cast<int64_t>(ct) * KT;
    const int nrow = static_cast<int>(min(static_cast<int64_t>(rows), n - t0));

    // the tile's band rows, copied from device memory once an apply with
    // cp.async (every diagonal's copies in flight together, beside the base
    // loads below; rows past n filled with 0)
    for (int d = 0; d < f.ndiag; ++d) {
      const T* band = f.band + d * n;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int li = threadIdx.x + q * kThreads;
        if (q < rpt)
          copy_async(s_band + d * rows + li, band + (li < nrow ? t0 + li : 0), li < nrow);
      }
    }

    // level 0, the base of every level: r, or z0 once phase 0 is done on
    // the tiles this one reads; in registers, and in the window (rows past
    // n hold 0 there, so the near diagonals read 0 past the matrix's end)
    if (ph == 1) {
      // z0 of the tiles this one reads (phase 0's progress words)
      const int* prog0 = a.progress + static_cast<int64_t>(ct) * NT;
      wait_for(prog0, a.base.total, [&](int e, int& tt, int& need) {
        const int v = u - a.base.delta(e);
        tt = NT - 1 - v;
        need = S;
        return v >= 0;
      });
    }
    const T* base_g = ph ? a.z0 : a.r;
    Tile base[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int li = threadIdx.x + q * kThreads;
      base[q].zero();
      if (q < rpt) {
        if (li < nrow) base[q].load_cg(base_g + (t0 + li) * k + c0);
        base[q].store(s_y + (li + woff) * KT);
        if (li >= nrow) base[q].store(s_y + wsize + (li + woff) * KT);
      }
    }

    asm volatile("cp.async.wait_all;" ::: "memory");   // the band: read after a barrier

    for (int s = 1; s <= S; ++s) {
      // the other tiles' level s - 1 (level 0 needs no wait), and the
      // readers of the ring slots this level overwrites, in one round
      const WaitSet& rd = a.reads[ph];
      const WaitSet& ru = a.reuse[ph];
      const int nread = s == 1 ? 0 : rd.total, nreuse = s < S ? ru.total : 0;
      wait_for(prog, nread + nreuse, [&](int e, int& tt, int& need) {
        const bool read = e < nread;
        const int v = u - (read ? rd.delta(e) : ru.delta(e - nread));
        tt = ph ? NT - 1 - v : v;
        need = read ? s - 1 : s + 1;
        return v >= 0;
      });
      const bool last = s == S;
      const T* yg = s == 1 ? base_g : a.levels + (ph * (S - 1) + s - 2) * a.ring_rows * k;
      const int64_t ymask = s == 1 ? int64_t(-1) : a.mask;
      T* wy = s_y + ((s - 1) & 1) * wsize;   // the window of level s - 1
      // the halo of level s - 1: rows of the neighbouring tile, from the L2
      // (0 past either end of the matrix)
      for (int h = threadIdx.x; h < halo; h += kThreads) {
        const int64_t j = ph ? t0 + rows + h : t0 - halo + h;
        Tile v;
        v.zero();
        if (j >= 0 && j < n) v.load_cg(yg + (j & ymask) * k + c0);
        v.store(wy + (ph ? rows + h : h) * KT);
      }
      __syncthreads();
      // every row's sums, a diagonal at a time, in d order: the band from
      // shared memory, the iterate from the window (a near diagonal) or
      // from the L2 (the loads of all RPT rows in flight together); a row
      // the diagonal misses adds 0 * 0.
      Tile acc[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) acc[q].zero();
      for (int d = 0; d < f.ndiag; ++d) {
        const int o = off[d];
        const T* sb = s_band + d * rows;
        if ((ph ? o : -o) <= halo) {
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            const int li = threadIdx.x + q * kThreads;
            if (q < rpt) acc[q].axpy(sb[li], wy + (li + woff + o) * KT);
          }
        } else {
          Tile yv[RPT];
          far_loads<T, KT, RPT>(yv, yg, ymask, t0 + o, n, rows, rpt, k, c0);
#pragma unroll
          for (int q = 0; q < RPT; ++q)
            if (q < rpt) acc[q].axpy(sb[threadIdx.x + q * kThreads], yv[q]);
        }
      }
      if (f.sptr != nullptr) {
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int li = threadIdx.x + q * kThreads;
          if (q >= rpt || li >= nrow) continue;
          const int64_t i = t0 + li;
          const int32_t e = __ldg(f.sptr + i + 1);
          for (int32_t p = __ldg(f.sptr + i); p < e; ++p) {
            Tile yv;
            yv.load_cg(yg + (static_cast<int64_t>(__ldg(f.scol + p)) & ymask) * k + c0);
            acc[q].axpy(__ldg(f.sval + p), yv);
          }
        }
      }
      T* dst = last ? (ph ? a.out : a.z0) : a.levels + (ph * (S - 1) + s - 1) * a.ring_rows * k;
      const int64_t dmask = last ? int64_t(-1) : a.mask;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int li = threadIdx.x + q * kThreads;
        if (q >= rpt || li >= nrow) continue;
        const int64_t i = t0 + li;
        const T scale = ph == 0 && last ? __ldg(a.invd + i) : T(1);
        Tile v;
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          v.v[c] = base[q].v[c] - acc[q].v[c];
          if (ph == 0 && last) v.v[c] *= scale;
        }
        if (!last) v.store(s_y + (s & 1) * wsize + (li + woff) * KT);
        v.store(dst + (i & dmask) * k + c0);
      }
      __syncthreads();
      // release: the block's stores, ordered by the barrier, before the word
      if (threadIdx.x == 0) st_release(prog + t, s);
    }
    if (threadIdx.x == 0) s_ticket = next;
  }
}

// The shared memory a block may have on the current device (once), and
// the kernel allowed all of it past the default 48 KB (once).
inline int smem_optin() {
  static const int bytes = [] {
    int dev = 0, b = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    return b;
  }();
  return bytes;
}

template <typename T, int KT>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      neumann_wavefront_kernel<T, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_optin() - static_cast<int>(2 * kMaxDiags * sizeof(int) + 64));
  return e;
}

template <typename T, int KT>
int blocks_in_flight(int64_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = allow_smem<T, KT>();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, neumann_wavefront_kernel<T, KT>,
                                                      kThreads, static_cast<size_t>(smem));
  if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidConfiguration;
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

template <typename T>
int rows_per_thread(int kt) {
  switch (kt) {
    case 8: return RowsPerThread<T, 8>::value;
    case 4: return RowsPerThread<T, 4>::value;
    case 2: return RowsPerThread<T, 2>::value;
    default: return RowsPerThread<T, 1>::value;
  }
}

template <typename T>
int blocks_for(int kt, int rows, int hmax, int ndmax) {
  if (rows < kThreads || rows > kThreads * rows_per_thread<T>(kt) || hmax < 0 || hmax > rows ||
      ndmax < 1 || ndmax > kMaxDiags)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = smem_bytes<T>(kt, rows, hmax, ndmax);
  switch (kt) {
    case 8: return blocks_in_flight<T, 8>(smem);
    case 4: return blocks_in_flight<T, 4>(smem);
    case 2: return blocks_in_flight<T, 2>(smem);
    case 1: return blocks_in_flight<T, 1>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// A WaitSet from the host's list (its count, then count (lo, hi) pairs),
// advancing p; false for a malformed set or a d below min_delta (an item
// must wait only on smaller tickets, or the grid could deadlock).
bool read_set(const int*& p, WaitSet& w, int min_delta, int tiles) {
  w.count = *p++;
  w.total = 0;
  if (w.count < 0 || w.count > kMaxRanges) return false;
  for (int i = 0; i < w.count; ++i) {
    w.lo[i] = *p++;
    w.hi[i] = *p++;
    if (w.lo[i] < min_delta || w.hi[i] < w.lo[i] || w.hi[i] > tiles) return false;
    w.total += w.hi[i] - w.lo[i] + 1;
  }
  return true;
}

// A launch prepared once a plan (ops/neumann.py: _Launch): the kernel's
// arguments but the per-apply buffers, validated, with the launch's
// shape.  Prepared<T> holds no device memory.
template <typename T>
struct Prepared {
  Apply<T> a;                // r, z0, out, levels, progress, ticket: per apply
  int kt, grid;
  int64_t smem, flag_bytes;
  bool empty;                // n == 0 or k == 0: nothing to launch
};

template <typename T>
int prepare(const void* bandL, const void* offL, int ndL, const void* sptrL, const void* scolL,
            const void* svalL, const void* bandU, const void* offU, int ndU, const void* sptrU,
            const void* scolU, const void* svalU, const void* invd, int64_t n, int64_t k,
            int64_t ring_rows, int64_t mask, int sweeps, int rows, int tiles, const int* waits,
            int haloL, int haloU, int kt, int grid, void** handle) {
  if (handle == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *handle = nullptr;
  Prepared<T> p{};
  p.empty = n == 0 || k == 0;
  const int64_t nct = kt > 0 ? k / kt : 0;
  if (!p.empty) {
    if ((kt != 1 && kt != 2 && kt != 4 && kt != 8) || k % kt != 0 || rows % kThreads != 0 ||
        rows < kThreads || rows > kThreads * rows_per_thread<T>(kt) || sweeps < 1 ||
        tiles < 1 || haloL < 0 || haloL > rows || haloU < 0 || haloU > rows ||
        waits == nullptr || ndL < 1 || ndL > kMaxDiags || ndU < 1 || ndU > kMaxDiags ||
        grid < 1 || static_cast<int64_t>(tiles) * rows < n ||
        2 * static_cast<int64_t>(tiles) * nct >= (int64_t(1) << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    // a ring that wraps: a power of two of rows (the slot is a mask) less
    // than n; full length otherwise
    if (mask != -1 ? (ring_rows < rows || ring_rows >= n ||
                      (ring_rows & (ring_rows - 1)) != 0 || mask != ring_rows - 1)
                   : ring_rows < n)
      return static_cast<int>(cudaErrorInvalidValue);
    Apply<T>& a = p.a;
    const int* w = waits;
    if (!read_set(w, a.reads[0], 1, tiles) || !read_set(w, a.reads[1], 1, tiles) ||
        !read_set(w, a.base, 0, tiles) || !read_set(w, a.reuse[0], 1, tiles) ||
        !read_set(w, a.reuse[1], 1, tiles) ||
        (mask != -1 && sweeps > 1 && (a.reuse[0].count == 0 || a.reuse[1].count == 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int hmax = haloL > haloU ? haloL : haloU;
    p.smem = smem_bytes<T>(kt, rows, hmax, ndL > ndU ? ndL : ndU);
    if (p.smem > smem_optin() - static_cast<int>(2 * kMaxDiags * sizeof(int) + 64))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e;
    switch (kt) {
      case 8: e = allow_smem<T, 8>(); break;
      case 4: e = allow_smem<T, 4>(); break;
      case 2: e = allow_smem<T, 2>(); break;
      default: e = allow_smem<T, 1>(); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    a.f[0] = {static_cast<const T*>(bandL), static_cast<const int32_t*>(offL), ndL,
              static_cast<const int32_t*>(sptrL), static_cast<const int32_t*>(scolL),
              static_cast<const T*>(svalL)};
    a.f[1] = {static_cast<const T*>(bandU), static_cast<const int32_t*>(offU), ndU,
              static_cast<const int32_t*>(sptrU), static_cast<const int32_t*>(scolU),
              static_cast<const T*>(svalU)};
    a.invd = static_cast<const T*>(invd);
    a.n = n;
    a.k = k;
    a.mask = mask;
    a.ring_rows = ring_rows;
    a.sweeps = sweeps;
    a.rows = rows;
    a.tiles = tiles;
    a.nct = static_cast<int>(nct);
    a.halo[0] = haloL;
    a.halo[1] = haloU;
    a.hmax = hmax;
    p.kt = kt;
    p.grid = grid;
    p.flag_bytes = (2 * nct * tiles + 1) * static_cast<int64_t>(sizeof(int));
  }
  Prepared<T>* h = new (std::nothrow) Prepared<T>(p);
  if (h == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  *handle = h;
  return static_cast<int>(cudaSuccess);
}

// One apply of a prepared launch: the memset of flags, then the kernel.
template <typename T>
int run(const void* handle, const void* r, void* z0, void* out, void* levels, void* flags,
        void* stream) {
  const Prepared<T>& p = *static_cast<const Prepared<T>*>(handle);
  if (p.empty) return static_cast<int>(cudaSuccess);
  if (flags == nullptr || (p.a.sweeps > 1 && levels == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = p.kt * sizeof(T) >= 16 ? 16 : p.kt * static_cast<int64_t>(sizeof(T));
  if (!lssp::aligned(r, bytes) || !lssp::aligned(z0, bytes) || !lssp::aligned(out, bytes) ||
      !lssp::aligned(levels, bytes))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Apply<T> a = p.a;
  a.r = static_cast<const T*>(r);
  a.z0 = static_cast<T*>(z0);
  a.out = static_cast<T*>(out);
  a.levels = static_cast<T*>(levels);
  a.progress = static_cast<int*>(flags);
  a.ticket =
      reinterpret_cast<unsigned int*>(a.progress + 2 * static_cast<int64_t>(a.nct) * a.tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags, 0, static_cast<size_t>(p.flag_bytes), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = static_cast<size_t>(p.smem);
  switch (p.kt) {
    case 8: neumann_wavefront_kernel<T, 8><<<p.grid, kThreads, smem, st>>>(a); break;
    case 4: neumann_wavefront_kernel<T, 4><<<p.grid, kThreads, smem, st>>>(a); break;
    case 2: neumann_wavefront_kernel<T, 2><<<p.grid, kThreads, smem, st>>>(a); break;
    default: neumann_wavefront_kernel<T, 1><<<p.grid, kThreads, smem, st>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the kernel for tile width kt, tiles of rows rows, a window
// halo of hmax rows and ndmax band rows (the larger factor's) that fit on
// the current device at once (occupancy x SMs), or minus a CUDA error.
int lssp_neumann_blocks_f32(int kt, int rows, int hmax, int ndmax) {
  return blocks_for<float>(kt, rows, hmax, ndmax);
}
int lssp_neumann_blocks_f64(int kt, int rows, int hmax, int ndmax) {
  return blocks_for<double>(kt, rows, hmax, ndmax);
}

// Rows a thread owns in a tile for tile width kt (a tile holds at most
// 256 times as many rows).
int lssp_neumann_rows_per_thread_f32(int kt) { return rows_per_thread<float>(kt); }
int lssp_neumann_rows_per_thread_f64(int kt) { return rows_per_thread<double>(kt); }

// The launch of one plan and block width, prepared once: per factor (L,
// then D^-1 U) band (ndiag, n) row-major, offsets (ndiag,) int32, and
// sptr (n+1,) / scol / sval (row-sorted CSR strays), all three null without
// strays; invd (n,); n, k.  The schedule (ring_rows, mask, sweeps, rows,
// tiles, the wait sets) is ops/neumann.py: wavefront_schedule's; waits:
// host memory, read here and not kept, the five WaitSets reads[0],
// reads[1], base, reuse[0], reuse[1], each its count of ranges, then a
// (lo, hi) pair a range; haloL, haloU; kt, the tile width; grid: the blocks
// to launch (at most lssp_neumann_blocks).  Sets *handle (host memory,
// freed by lssp_neumann_release_*) and returns 0, or a CUDA error
// (cudaErrorInvalidValue for arguments the kernel cannot take) with
// *handle null.  The device pointers are kept, not read.
//
// lssp_neumann_run_*: the whole apply, one launch after a memset of flags,
// on stream.  r, z0, out: (n, k) row-major (k = 1: K2), z0 and out
// written; levels: 2 * (sweeps - 1) * ring_rows * k scratch (null when
// sweeps == 1); flags: 2 * (k / kt) * tiles + 1 int32 scratch.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue / cudaErrorMisalignedAddress
// without launching.
#define LSSP_NEUMANN_ENTRIES(SUF, T)                                                          \
  int lssp_neumann_prepare_##SUF(const void* bandL, const void* offL, int ndL,               \
                                 const void* sptrL, const void* scolL, const void* svalL,   \
                                 const void* bandU, const void* offU, int ndU,              \
                                 const void* sptrU, const void* scolU, const void* svalU,   \
                                 const void* invd, int64_t n, int64_t k, int64_t ring_rows, \
                                 int64_t mask, int sweeps, int rows, int tiles,             \
                                 const int* waits, int haloL, int haloU, int kt, int grid,  \
                                 void** handle) {                                           \
    return prepare<T>(bandL, offL, ndL, sptrL, scolL, svalL, bandU, offU, ndU, sptrU, scolU, \
                      svalU, invd, n, k, ring_rows, mask, sweeps, rows, tiles, waits, haloL, \
                      haloU, kt, grid, handle);                                              \
  }                                                                                          \
  int lssp_neumann_run_##SUF(const void* handle, const void* r, void* z0, void* out,         \
                             void* levels, void* flags, void* stream) {                     \
    return run<T>(handle, r, z0, out, levels, flags, stream);                               \
  }                                                                                          \
  void lssp_neumann_release_##SUF(void* handle) { delete static_cast<Prepared<T>*>(handle); }
LSSP_NEUMANN_ENTRIES(f32, float)
LSSP_NEUMANN_ENTRIES(f64, double)
#undef LSSP_NEUMANN_ENTRIES

}  // extern "C"
