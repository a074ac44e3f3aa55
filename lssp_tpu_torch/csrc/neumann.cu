// K2: one Jacobi-style sweep of the truncated-Neumann ILU apply, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lssp_tpu/ops/pallas_neumann.py: _build_call
// (entries fused_neumann_apply and _apply_impl, plan plan_fused_neumann),
// which runs the whole apply z ~= U^-1 L^-1 r as one program:
//   k sweeps  y <- r - Ls y,   z0 = D^-1 y,   k sweeps  z <- z0 - (D^-1 Us) z.
// That program keeps both factors and the iterate resident in 11 MB of
// VMEM; a Hopper block has 227 KB of shared memory and 64^3 needs ~10 MB,
// so it cannot carry over.  Here one launch is one sweep, and the wrapper
// (ops/neumann.py: fused_neumann_apply) runs the 2k launches:
//
//   out[i] = (base[i] - (sum_d band[d, i] * y[i + off_d]
//                        + sum_{j in strays(i)} val_j * y[col_j]))  (* invd[i])
//
// The band is the factor's dominant diagonals (the _split_band rule of the
// TPU plan); the few off-band "strays" are row-sorted CSR.  The optional
// invd scale is fused into the last forward sweep, which yields z0.
//
// Every sweep is Jacobi-style: it reads all of y before any of it is
// written.  Blocks run in no order, so out must never alias y; the wrapper
// ping-pongs between two buffers.
//
// Bound: device-memory bandwidth, like K1.  Per row and sweep it moves
// ndiag band values, one y value, base, the output and, where present, the
// row's strays: (ndiag + 3) * sizeof(T) bytes plus 12-16 bytes per stray.
// One thread owns one row and band[d * n + i] / y[i + off_d] are read
// consecutively across a warp, so band and iterate loads coalesce; the
// stray gathers are scattered but few (2% occupancy floor per diagonal).
//
// K2k, the k-rhs form (pallas_neumann.py: _vmap_safe_apply's vmap rule,
// which runs _batched_band_apply for pure-band factors and a per-column
// lax.map of the kernel when the factors have strays): the same sweep on
// (n, k) row-major blocks y, base and out, element (i, c) at i * k + c,
// with the wrapper's same ping-pong of 2 * sweeps launches.  One thread per
// row and register tile of KT columns (csrc/krhs.cuh): each band value and
// each stray (value, column) pair is read once for the tile, so the factors
// stream once per sweep for all k columns, strays included (no per-column
// fallback).  Each column sums in K2's order.
//
// Later work: one persistent kernel with a grid-wide sync between sweeps,
// so the factors stream once per apply from L2 (the 64^3 fp32 factors fit
// the 50 MB L2).

#include <cstdint>

#include <cuda_runtime.h>

#include "krhs.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void neumann_sweep_kernel(const T* __restrict__ band,
                                     const int32_t* __restrict__ offsets,
                                     int ndiag, int64_t n,
                                     const int32_t* __restrict__ sptr,
                                     const int32_t* __restrict__ scol,
                                     const T* __restrict__ sval,
                                     const T* y, const T* base,
                                     const T* __restrict__ invd,
                                     T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) acc += band[static_cast<int64_t>(d) * n + i] * y[j];
  }
  if (sptr != nullptr) {
    const int32_t e = sptr[i + 1];
    for (int32_t k = sptr[i]; k < e; ++k) acc += sval[k] * y[scol[k]];
  }
  T v = base[i] - acc;
  if (invd != nullptr) v *= invd[i];
  out[i] = v;
}

template <typename T, int KT>
__global__ void neumann_sweep_block_kernel(const T* __restrict__ band,
                                           const int32_t* __restrict__ offsets,
                                           int ndiag, int64_t n, int64_t k,
                                           const int32_t* __restrict__ sptr,
                                           const int32_t* __restrict__ scol,
                                           const T* __restrict__ sval,
                                           const T* y, const T* base,
                                           const T* __restrict__ invd,
                                           T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * KT;
  lssp::Tile<T, KT> acc, v;
  acc.zero();
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) acc.axpy(band[static_cast<int64_t>(d) * n + i], y + j * k + c0);
  }
  if (sptr != nullptr) {
    const int32_t e = sptr[i + 1];
    for (int32_t s = sptr[i]; s < e; ++s)
      acc.axpy(sval[s], y + static_cast<int64_t>(scol[s]) * k + c0);
  }
  v.load(base + i * k + c0);
  const T scale = invd != nullptr ? invd[i] : T(1);
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    v.v[c] -= acc.v[c];
    if (invd != nullptr) v.v[c] *= scale;
  }
  v.store(out + i * k + c0);
}

template <typename T>
int launch(const void* band, const void* offsets, int ndiag, int64_t n,
           const void* sptr, const void* scol, const void* sval, const void* y,
           const void* base, const void* invd, void* out, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  neumann_sweep_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(band), static_cast<const int32_t*>(offsets), ndiag, n,
      static_cast<const int32_t*>(sptr), static_cast<const int32_t*>(scol),
      static_cast<const T*>(sval), static_cast<const T*>(y),
      static_cast<const T*>(base), static_cast<const T*>(invd),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KT>
int launch_tile(const void* band, const void* offsets, int ndiag, int64_t n,
                int64_t k, const void* sptr, const void* scol, const void* sval,
                const void* y, const void* base, const void* invd, void* out,
                void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(k / KT));
  neumann_sweep_block_kernel<T, KT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(band), static_cast<const int32_t*>(offsets), ndiag, n, k,
      static_cast<const int32_t*>(sptr), static_cast<const int32_t*>(scol),
      static_cast<const T*>(sval), static_cast<const T*>(y),
      static_cast<const T*>(base), static_cast<const T*>(invd),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_block(const void* band, const void* offsets, int ndiag, int64_t n,
                 int64_t k, const void* sptr, const void* scol, const void* sval,
                 const void* y, const void* base, const void* invd, void* out,
                 void* stream) {
  if (n == 0 || k == 0) return static_cast<int>(cudaSuccess);
  int kt = lssp::tile_width<T>(k, y, base, out);
  if (k / kt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
#define LSSP_SWEEP_TILE(KT)                                                        \
  return launch_tile<T, KT>(band, offsets, ndiag, n, k, sptr, scol, sval, y, base, \
                            invd, out, stream)
  switch (kt) {
    case 8: LSSP_SWEEP_TILE(8);
    case 4: LSSP_SWEEP_TILE(4);
    case 2: LSSP_SWEEP_TILE(2);
    default: LSSP_SWEEP_TILE(1);
  }
#undef LSSP_SWEEP_TILE
}

}  // namespace

extern "C" {

// band: (ndiag, n) row-major; offsets: (ndiag,) int32; sptr: (n+1,) int32,
// scol: (nstray,) int32, sval: (nstray,) — all three null when the factor
// has no strays; y, base, out: (n,); invd: (n,) or null.  out must not
// alias y.  Returns cudaGetLastError().
int lssp_neumann_sweep_f32(const void* band, const void* offsets, int ndiag,
                           int64_t n, const void* sptr, const void* scol,
                           const void* sval, const void* y, const void* base,
                           const void* invd, void* out, void* stream) {
  return launch<float>(band, offsets, ndiag, n, sptr, scol, sval, y, base, invd,
                       out, stream);
}

int lssp_neumann_sweep_f64(const void* band, const void* offsets, int ndiag,
                           int64_t n, const void* sptr, const void* scol,
                           const void* sval, const void* y, const void* base,
                           const void* invd, void* out, void* stream) {
  return launch<double>(band, offsets, ndiag, n, sptr, scol, sval, y, base, invd,
                        out, stream);
}

// K2k.  As above, with y, base, out: (n, k) row-major; invd stays (n,).
// out must not alias y.  Returns cudaGetLastError().
int lssp_neumann_sweep_block_f32(const void* band, const void* offsets, int ndiag,
                                 int64_t n, int64_t k, const void* sptr,
                                 const void* scol, const void* sval, const void* y,
                                 const void* base, const void* invd, void* out,
                                 void* stream) {
  return launch_block<float>(band, offsets, ndiag, n, k, sptr, scol, sval, y, base,
                             invd, out, stream);
}

int lssp_neumann_sweep_block_f64(const void* band, const void* offsets, int ndiag,
                                 int64_t n, int64_t k, const void* sptr,
                                 const void* scol, const void* sval, const void* y,
                                 const void* base, const void* invd, void* out,
                                 void* stream) {
  return launch_block<double>(band, offsets, ndiag, n, k, sptr, scol, sval, y, base,
                              invd, out, stream);
}

}  // extern "C"
