// The band ring: the bf16 forms of K1 (csrc/dia_spmv.cu) and K3
// (csrc/hyb_spmv.cu) for Hopper (sm_90a), one kernel template for both.
//
//   y[i] = alpha * (sum_d data[d, i] * x[i + off_d]
//                   [+ sum_{e : rem_rows[e] == i} rem_vals[e] * x[rem_cols[e]]])
//          (+ beta * z[i] when z)
//
// Why: the one-row-a-thread kernel moves 2 bytes a load in bf16, so a
// warp's request is 64 bytes and each thread's chain of dependent loads is
// as long as in fp32; it reached 48 % (K1) and 36 % (K3) of the bf16 bound.
// Here the bytes reach shared memory through 1-D bulk copies
// (cp.async.bulk ... mbarrier::complete_tx) that a producer warp keeps
// S - 1 tiles ahead of the consumer threads, so the copies run whatever the
// consumers are doing.
//
// A tile is T = 8 * kThreads rows.  A consumer thread owns 8 consecutive
// rows: one 16-byte vector of bf16.  A stage of the ring holds, for each
// diagonal d, the band slice data[d, base : base + T] and an x window
// x[base + f_d : base + f_d + T + 8] with f_d = off_d - s_d and
// s_d = off_d mod 8 (in [0, 8)), so the copy's source is 16-byte aligned;
// and z[base : base + T] when z is given.  Row base + 8q + e needs x at
// window position 8q + e + s_d: a thread reads one or two aligned 16-byte
// vectors and takes its 8 values at the shift s_d (a switch on s_d, so each
// value is one shift or mask of a word).  One window a diagonal, T + 8
// elements whatever the offset, where a shared window with a +-max|off|
// halo would be 32K elements for a 128^3 stencil.  Copies are clamped to
// [0, ncols).  A tile whose rows reach outside [0, ncols) through some
// diagonal (an edge tile: t < t_lo or t >= t_hi, from the host plan)
// guards each term as the rowwise kernel does (0 <= i + off_d < ncols,
// else the term is skipped); an interior tile takes no guard.  Every
// position an interior tile uses was copied.
//
// Arithmetic: the rowwise kernel's, term for term.  Each term is one fused
// multiply-add into a float sum, diagonals in order, then (K3) the row's
// remainder entries in CSR order; the epilogue is alpha * acc then
// fma(beta, z, .); y is rounded once (__float2bfloat16_rn).  So y equals
// the rowwise kernel's bit for bit.
//
// K3's remainder: a tile is T / 256 of the host index's 256-row blocks
// (HYB_BLOCK_ROWS), so its entries are [ptr[b0], ptr[min(b0 + T/256,
// nblocks)]) with b0 = t * T / 256, and the host layout is unchanged.  The
// consumers load a tile's first chunk (2 * kThreads entries: rows, columns,
// values) in registers a tile ahead and gather x[col] before the band
// sums; after them they write the chunk to shared memory, and each thread
// adds its rows' entries from there (a binary search for its first row,
// then CSR order).  A heavier tile loops over further chunks, loaded in
// place.
//
// Persistent grid: the host launches min(ntiles, SMs * blocks an SM)
// blocks of kThreads consumers and one producer warp; block b takes tiles
// b, b + grid, ...  Each stage has a full barrier (the producer's expected
// bytes) and an empty one (every consumer arrives when done with it).  The
// host plan (ops/dia_spmv.py: band_tile_plan) picks T and S from what was
// fastest of T in {512, 1024, 2048} x S in {2, 3, 4} on the H100 at the 2-D
// Laplacian 2048^2 and the 128^3 stencil (chip_smoke.py phase 32 times
// them): T = 1024, S = 4 for K1 where two blocks still fit an SM, else
// S = 2; S = 2 for K3, whose remainder gathers want four blocks an SM.

#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lssp {
namespace ring {

constexpr int kRows = 8;           // rows a thread: one 16-byte bf16 vector
constexpr int kMaxStages = 4;
constexpr int kMaxDiag = 64;
constexpr int kChunk = 2;          // remainder entries a thread stages
constexpr int kHybBlockRows = 256; // _kernels.HYB_BLOCK_ROWS

struct Params {
  const __nv_bfloat16* data;
  const int32_t* offsets;
  int ndiag;
  int64_t n, ncols;
  const __nv_bfloat16* x;
  float alpha, beta;
  const __nv_bfloat16* z;
  __nv_bfloat16* y;
  int stages;
  int64_t t_lo, t_hi;              // interior tiles [t_lo, t_hi)
  // the remainder (K3); unused by K1
  const int32_t* rem_rows;
  const int32_t* rem_cols;
  const __nv_bfloat16* rem_vals;
  const int32_t* rem_block_ptr;
  int64_t nblocks;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the consumer threads' barrier (named barrier 1), without the producer warp
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float lo_bf(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf_bits(uint32_t b) { return __uint_as_float(b << 16); }

// 8 floats from a 16-byte bf16 vector
__device__ __forceinline__ void unpack(const uint4& v, float f[kRows]) {
  f[0] = lo_bf(v.x); f[1] = hi_bf(v.x); f[2] = lo_bf(v.y); f[3] = hi_bf(v.y);
  f[4] = lo_bf(v.z); f[5] = hi_bf(v.z); f[6] = lo_bf(v.w); f[7] = hi_bf(v.w);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

// the bytes of one stage: band and window per diagonal, then z
__device__ __forceinline__ int64_t stage_bytes(int tile, int ndiag, bool has_z) {
  return static_cast<int64_t>(ndiag) * (2 * tile + 8) * 2 + (has_z ? tile * 2 : 0);
}

// The producer thread fills a stage with tile t: the band slices, the
// clamped x windows and the z slice, all counted on the stage's full
// barrier.
template <int T>
__device__ void issue_tile(const Params& p, const int* off, int64_t t, unsigned char* stage,
                           uint64_t* bar) {
  const int nd = p.ndiag;
  const int64_t base = t * T;
  const int64_t rows = imin(T, p.n - base);
  __nv_bfloat16* band = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* win = band + static_cast<int64_t>(nd) * T;
  uint32_t bytes = static_cast<uint32_t>(nd * rows * 2 + (p.z != nullptr ? rows * 2 : 0));
  for (int d = 0; d < nd; ++d) {
    const int64_t start = base + (off[d] - (off[d] & 7));
    const int64_t lo = imax(start, 0), hi = imin(start + rows + 8, p.ncols);
    if (hi > lo) bytes += static_cast<uint32_t>((hi - lo) * 2);
  }
  // order the consumers' reads of this stage's last tile (seen through its
  // empty barrier) before the async proxy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, bytes);
  for (int d = 0; d < nd; ++d) {
    bulk_copy(band + static_cast<int64_t>(d) * T, p.data + static_cast<int64_t>(d) * p.n + base,
              static_cast<uint32_t>(rows * 2), bar);
    const int64_t start = base + (off[d] - (off[d] & 7));
    const int64_t lo = imax(start, 0), hi = imin(start + rows + 8, p.ncols);
    if (hi > lo)
      bulk_copy(win + static_cast<int64_t>(d) * (T + 8) + (lo - start), p.x + lo,
                static_cast<uint32_t>((hi - lo) * 2), bar);
  }
  if (p.z != nullptr)
    bulk_copy(win + static_cast<int64_t>(nd) * (T + 8), p.z + base,
              static_cast<uint32_t>(rows * 2), bar);
}

// The 8 x values of a thread's rows for one diagonal: window positions
// r0 + S .. r0 + S + 7, read as one or two aligned 16-byte vectors.  With
// S a constant each value is one shift or mask of a word.
template <int S>
__device__ __forceinline__ void window8(const __nv_bfloat16* w, float xv[kRows]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(w);
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, 0u, 0u, 0u, 0u};
  if (S > 0) {
    const uint4 hi = *reinterpret_cast<const uint4*>(w + 8);
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
#pragma unroll
  for (int e = 0; e < kRows; ++e)
    xv[e] = ((S + e) & 1) ? hi_bf(v[(S + e) >> 1]) : lo_bf(v[(S + e) >> 1]);
}

__device__ __forceinline__ void window_at(const __nv_bfloat16* w, int s, float xv[kRows]) {
  switch (s) {
    case 0: window8<0>(w, xv); break;
    case 1: window8<1>(w, xv); break;
    case 2: window8<2>(w, xv); break;
    case 3: window8<3>(w, xv); break;
    case 4: window8<4>(w, xv); break;
    case 5: window8<5>(w, xv); break;
    case 6: window8<6>(w, xv); break;
    default: window8<7>(w, xv); break;
  }
}

template <int T>
__device__ __forceinline__ void band_term(const Params& p, int d, int o,
                                          const __nv_bfloat16* band, const __nv_bfloat16* win,
                                          int64_t base, int r0, bool edge, float acc[kRows]) {
  float a[kRows], xv[kRows];
  unpack(*reinterpret_cast<const uint4*>(band + static_cast<int64_t>(d) * T + r0), a);
  const __nv_bfloat16* w = win + static_cast<int64_t>(d) * (T + 8) + r0;
  window_at(w, o & 7, xv);
  if (!edge) {
#pragma unroll
    for (int e = 0; e < kRows; ++e) acc[e] = __fmaf_rn(a[e], xv[e], acc[e]);
  } else {
    const int64_t j0 = base + r0 + o;
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      if (j0 + e >= 0 && j0 + e < p.ncols) acc[e] = __fmaf_rn(a[e], xv[e], acc[e]);
  }
}

// acc[e] += band[d][r0 + e] * x[base + r0 + e + off_d] over the diagonals,
// in order, one fused multiply-add a term; an edge tile skips the terms
// whose x index leaves [0, ncols).  ND > 0 fixes the diagonal count.
template <int T, int ND>
__device__ __forceinline__ void band_sums(const Params& p, const int* off,
                                          const __nv_bfloat16* band, const __nv_bfloat16* win,
                                          int64_t base, int r0, bool edge, float acc[kRows]) {
  if constexpr (ND > 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) band_term<T>(p, d, off[d], band, win, base, r0, edge, acc);
  } else {
    for (int d = 0; d < p.ndiag; ++d)
      band_term<T>(p, d, off[d], band, win, base, r0, edge, acc);
  }
}

// A tile's remainder chunk as one thread holds it: entries lo + tid + q *
// kThreads for q < kChunk, valid below end (col < 0 marks the others).
// rv packs the row relative to the tile (low 16 bits) with the value's
// bf16 bits (high 16).
struct Chunk {
  uint32_t rv[kChunk];
  int32_t col[kChunk];
};

template <int kThreads>
__device__ __forceinline__ void load_chunk(const Params& p, int32_t lo, int32_t end, int64_t base,
                                           Chunk& c) {
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int32_t e = lo + static_cast<int32_t>(threadIdx.x) + q * kThreads;
    c.rv[q] = 0;
    c.col[q] = -1;
    if (e < end) {
      const uint32_t r = static_cast<uint32_t>(__ldg(p.rem_rows + e) - base);
      const uint32_t v = __ldg(reinterpret_cast<const unsigned short*>(p.rem_vals) + e);
      c.rv[q] = r | (v << 16);
      c.col[q] = __ldg(p.rem_cols + e);
    }
  }
}

template <int kThreads>
__device__ __forceinline__ void gather_x(const Params& p, const Chunk& c, uint32_t xg[kChunk]) {
#pragma unroll
  for (int q = 0; q < kChunk; ++q)
    xg[q] = c.col[q] >= 0 ? __ldg(reinterpret_cast<const unsigned short*>(p.x) + c.col[q]) : 0u;
}

// Write a chunk to shared memory, then, after the consumers' barrier, add
// each thread's rows' entries in CSR order.
template <int kThreads>
__device__ __forceinline__ void add_chunk(const Chunk& c, const uint32_t xg[kChunk], int32_t cnt,
                                          int r0, bool mine, int32_t* srow, float* sval,
                                          float* sx, float acc[kRows]) {
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int slot = static_cast<int>(threadIdx.x) + q * kThreads;
    if (c.col[q] >= 0) {
      srow[slot] = static_cast<int32_t>(c.rv[q] & 0xffffu);
      sval[slot] = hi_bf(c.rv[q]);
      sx[slot] = bf_bits(xg[q]);
    }
  }
  consumers_sync<kThreads>();
  if (mine) {
    int a = 0, b = cnt;                    // first entry of row r0 or later
    while (a < b) {
      const int m = (a + b) >> 1;
      if (srow[m] < r0) a = m + 1; else b = m;
    }
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      for (; a < cnt && srow[a] == r0 + e; ++a) acc[e] = __fmaf_rn(sval[a], sx[a], acc[e]);
  }
  consumers_sync<kThreads>();
}

// kThreads consumer threads (8 rows each) and one producer warp.  kRem:
// the band and the remainder (K3), else the band alone (K1).  ND > 0 fixes
// the diagonal count (the 5- and 7-point stencils), 0 reads it.
template <int kThreads, bool kRem, int ND>
__global__ void __launch_bounds__(kThreads + 32, 512 / kThreads) band_ring_kernel(const Params p) {
  constexpr int T = kThreads * kRows;
  constexpr int kBlocksPerTile = T / kHybBlockRows;
  constexpr int C = kChunk * kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ int off[kMaxDiag];

  const int tid = static_cast<int>(threadIdx.x);
  const int nd = p.ndiag, S = p.stages;
  const bool has_z = p.z != nullptr;
  const int64_t sbytes = stage_bytes(T, nd, has_z);
  for (int d = tid; d < nd; d += kThreads + 32) off[d] = p.offsets[d];
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t ntiles = (p.n + T - 1) / T;
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t nlocal = first < ntiles ? (ntiles - 1 - first) / step + 1 : 0;
  if (tid >= kThreads) {                   // the producer warp: one thread issues
    if (tid == kThreads)
      for (int64_t k = 0; k < nlocal; ++k) {
        const int st = static_cast<int>(k % S);
        if (k >= S) mbar_wait(&empty[st], static_cast<uint32_t>((k / S - 1) & 1));
        issue_tile<T>(p, off, first + k * step, smem + st * sbytes, &full[st]);
      }
    return;
  }

  int32_t* srow = reinterpret_cast<int32_t*>(smem + S * sbytes);
  float* sval = reinterpret_cast<float*>(srow + C);
  float* sx = sval + C;
  // K3 looks ahead: the next two tiles' slices of the host index and the
  // next tile's chunk load while this tile's band is summed
  auto slice = [&](int64_t k, int32_t& lo, int32_t& hi) {
    lo = hi = 0;
    if (k < nlocal) {
      const int64_t b0 = (first + k * step) * kBlocksPerTile;
      lo = __ldg(p.rem_block_ptr + b0);
      hi = __ldg(p.rem_block_ptr + imin(b0 + kBlocksPerTile, p.nblocks));
    }
  };
  int32_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  Chunk c0, c1;
  if (kRem) {
    slice(0, lo0, hi0);
    slice(1, lo1, hi1);
    load_chunk<kThreads>(p, lo0, min(hi0, lo0 + C), first * T, c0);
  }

  const int r0 = tid * kRows;
  for (int64_t k = 0; k < nlocal; ++k) {
    const int64_t t = first + k * step, base = t * T;
    uint32_t xg[kChunk];
    int32_t lo2 = 0, hi2 = 0;
    if (kRem) {                            // x for this tile's chunk, the next tile's chunk
      gather_x<kThreads>(p, c0, xg);
      slice(k + 2, lo2, hi2);
      load_chunk<kThreads>(p, lo1, min(hi1, lo1 + C), base + step * T, c1);
    }
    const int st = static_cast<int>(k % S);
    mbar_wait(&full[st], static_cast<uint32_t>((k / S) & 1));

    const bool mine = r0 < p.n - base;
    const __nv_bfloat16* band = reinterpret_cast<const __nv_bfloat16*>(smem + st * sbytes);
    const __nv_bfloat16* win = band + static_cast<int64_t>(nd) * T;
    float acc[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) acc[e] = 0.0f;
    if (mine) band_sums<T, ND>(p, off, band, win, base, r0, t < p.t_lo || t >= p.t_hi, acc);
    if (kRem && hi0 > lo0) {
      add_chunk<kThreads>(c0, xg, min(hi0 - lo0, C), r0, mine, srow, sval, sx, acc);
      for (int32_t e0 = lo0 + C; e0 < hi0; e0 += C) {      // a heavy tile
        Chunk more;
        uint32_t xm[kChunk];
        load_chunk<kThreads>(p, e0, min(hi0, e0 + C), base, more);
        gather_x<kThreads>(p, more, xm);
        add_chunk<kThreads>(more, xm, min(hi0 - e0, C), r0, mine, srow, sval, sx, acc);
      }
    }
    if (mine) {
      float out[kRows];
#pragma unroll
      for (int e = 0; e < kRows; ++e) out[e] = p.alpha * acc[e];
      if (has_z) {
        float zf[kRows];
        unpack(*reinterpret_cast<const uint4*>(win + static_cast<int64_t>(nd) * (T + 8) + r0), zf);
#pragma unroll
        for (int e = 0; e < kRows; ++e) out[e] = __fmaf_rn(p.beta, zf[e], out[e]);
      }
      __stcs(reinterpret_cast<uint4*>(p.y + base + r0),
             make_uint4(pack2(out[0], out[1]), pack2(out[2], out[3]), pack2(out[4], out[5]),
                        pack2(out[6], out[7])));
    }
    mbar_arrive(&empty[st]);               // this thread is done with the stage
    if (kRem) {
      c0 = c1;
      lo0 = lo1; hi0 = hi1;
      lo1 = lo2; hi1 = hi2;
    }
  }
}

// Launch on stream.  Sets the kernel's dynamic shared memory ceiling once a
// device, and clamps the grid to the blocks the SMs hold at once (the
// occupancy at this shared size, asked once a size), so no block of the
// persistent grid waits for another to finish.  Returns cudaGetLastError().
template <int kThreads, bool kRem, int ND>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  constexpr int kMaxDevices = 64, kSizes = 8;
  static bool ready[kMaxDevices] = {};
  static int occ_smem[kMaxDevices][kSizes], occ_grid[kMaxDevices][kSizes];
  const auto kernel = band_ring_kernel<kThreads, kRem, ND>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    cudaFuncGetAttributes(&attr, kernel);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         optin - static_cast<int>(attr.sharedSizeBytes));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int i = 0; i < kSizes; ++i) occ_smem[dev][i] = -1;
    ready[dev] = true;
  }
  int slot = 0;
  while (slot < kSizes - 1 && occ_smem[dev][slot] != smem && occ_smem[dev][slot] != -1) ++slot;
  if (occ_smem[dev][slot] != smem) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads + 32, smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem[dev][slot] = smem;
    occ_grid[dev][slot] = per_sm * sms;
  }
  const int fit = occ_grid[dev][slot];
  kernel<<<grid < fit ? grid : fit, kThreads + 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads, bool kRem>
int launch_nd(const Params& p, int grid, int smem, cudaStream_t stream) {
  switch (p.ndiag) {
    case 5: return launch<kThreads, kRem, 5>(p, grid, smem, stream);
    case 7: return launch<kThreads, kRem, 7>(p, grid, smem, stream);
    default: return launch<kThreads, kRem, 0>(p, grid, smem, stream);
  }
}

// The entry both .cu files call: checks what the host plan promised, then
// picks the tile height.
template <bool kRem>
int launch_plan(const Params& p, int threads, int grid, int smem, void* stream) {
  if (p.n == 0) return static_cast<int>(cudaSuccess);
  if (p.ndiag < 1 || p.ndiag > kMaxDiag || p.stages < 2 || p.stages > kMaxStages ||
      p.n % kRows != 0 || p.ncols % kRows != 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* q : {static_cast<const void*>(p.data), static_cast<const void*>(p.x),
                        static_cast<const void*>(p.z), static_cast<const void*>(p.y)})
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 256: return launch_nd<256, kRem>(p, grid, smem, s);
    case 128: return launch_nd<128, kRem>(p, grid, smem, s);
    case 64: return launch_nd<64, kRem>(p, grid, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace ring
}  // namespace lssp
