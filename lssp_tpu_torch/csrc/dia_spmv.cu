// K1: DIA (stencil) SpMV with a fused axpby epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel lssp_tpu/ops/pallas_spmv.py: _dia_spmv_pallas
// (prepadded=False; entries dia_spmv_pallas and _vmap_safe_kernel), which
// computes y = scale * sum_d data[d, i] * x[i + off_d].
//
//   y[i] = alpha * sum_d data[d, i] * x[i + off_d]  (+ beta * z[i] when z)
//
// alpha = 1, no z: spmv.  alpha = a, no z: mv_amxy (the scale folded into
// the epilogue, as the Pallas kernel does).  z = y: mv_amxpby.
//
// Bound: device-memory bandwidth.  Per row it moves ndiag data values, one
// x value (the neighbouring diagonals hit the same x lines in L1/L2), one y
// write, and one z read when z is given: (ndiag + 2) * sizeof(T) bytes, an
// arithmetic intensity of about 2 flops per 8-16 bytes.  The design does
// the one thing that matters at that intensity: every load is coalesced.
// One thread owns one row; diagonal d is read as data[d * n + i], so the 32
// threads of a warp read 32 consecutive values of each diagonal, and x is
// read at i + off_d, again consecutive across the warp.  The offsets (a
// few int32) stay in the read-only cache.
//
// The Pallas kernel never bounds-checks, because it reads x from a
// zero-margined VMEM window.  Here x is read in place, so every read is
// guarded by 0 <= i + off_d < ncols: the stored data slot is 0 there, but
// x[i + off_d] would be an illegal address.
//
// K1k, the k-rhs form (lssp_tpu/ops/pallas_spmv.py: _vmap_safe_kernel's
// vmap rule, an XLA shifted-stream SpMM), on an (n, k) block stored
// row-major, element (i, c) at i * k + c (the layout ops/spmv.py states):
//
//   Y[i, c] = alpha * sum_d data[d, i] * X[i + off_d, c]  (+ beta * Z[i, c])
//
// One thread per row and register tile of KT columns (csrc/krhs.cuh): the
// band value data[d, i] is read once and multiplies the tile's KT values of
// row i + off_d, read as 16-byte vectors, so the band streams once per
// product for all k columns: (ndiag + 2k) * sizeof(T) bytes per row against
// k * (ndiag + 2) for k single launches.  Each column sums its diagonals in
// K1's order, so column c equals K1 on column c up to the compiler's
// contraction choices.
//
// bf16 (the inner precision of solve_ir(inner_dtype=torch.bfloat16); the
// Pallas kernel takes bf16 too): data, x, z and y are __nv_bfloat16, the
// products and the sum are float (lssp::Acc), the alpha / beta epilogue is
// applied in float, and y is rounded once, at the store.  The Pallas kernel
// sums in the tile's dtype, rounding every step, so this is the more
// accurate of the two (ROADMAP C property 16).
//
// Later work: a shared-memory x window with its halo, 16-byte vector
// loads in K1.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "krhs.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const int32_t* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t ncols,
                                const T* __restrict__ x, typename lssp::Acc<T>::type alpha,
                                typename lssp::Acc<T>::type beta,
                                const T* __restrict__ z, T* __restrict__ y) {
  using A = typename lssp::Acc<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  A acc = A(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < ncols)
      acc += lssp::to_acc(data[static_cast<int64_t>(d) * n + i]) * lssp::to_acc(x[j]);
  }
  A out = alpha * acc;
  if (z != nullptr) out += beta * lssp::to_acc(z[i]);
  y[i] = lssp::from_acc<T>(out);
}

template <typename T, int KT>
__global__ void dia_spmm_kernel(const T* __restrict__ data,
                                const int32_t* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t ncols, int64_t k,
                                const T* __restrict__ X, typename lssp::Acc<T>::type alpha,
                                typename lssp::Acc<T>::type beta,
                                const T* __restrict__ Z, T* __restrict__ Y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * KT;
  lssp::Tile<T, KT> acc;
  acc.zero();
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < ncols)
      acc.axpy(lssp::to_acc(data[static_cast<int64_t>(d) * n + i]), X + j * k + c0);
  }
  acc.axpby_store(alpha, beta, Z == nullptr ? nullptr : Z + i * k + c0, Y + i * k + c0);
}

template <typename T>
int launch(const void* data, const void* offsets, int ndiag, int64_t n,
           int64_t ncols, const void* x, double alpha, double beta,
           const void* z, void* y, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      n, ncols, static_cast<const T*>(x), static_cast<typename lssp::Acc<T>::type>(alpha),
      static_cast<typename lssp::Acc<T>::type>(beta), static_cast<const T*>(z), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KT>
int launch_tile(const void* data, const void* offsets, int ndiag, int64_t n,
                int64_t ncols, int64_t k, const void* X, double alpha, double beta,
                const void* Z, void* Y, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(k / KT));
  dia_spmm_kernel<T, KT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      n, ncols, k, static_cast<const T*>(X), static_cast<typename lssp::Acc<T>::type>(alpha),
      static_cast<typename lssp::Acc<T>::type>(beta), static_cast<const T*>(Z), static_cast<T*>(Y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmm(const void* data, const void* offsets, int ndiag, int64_t n,
                int64_t ncols, int64_t k, const void* X, double alpha,
                double beta, const void* Z, void* Y, void* stream) {
  if (n == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int kt = lssp::tile_width<T>(k, X, Z, Y);
  if (k / kt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (kt) {
    case 8: return launch_tile<T, 8>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y, stream);
    case 4: return launch_tile<T, 4>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y, stream);
    case 2: return launch_tile<T, 2>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y, stream);
    default: return launch_tile<T, 1>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y, stream);
  }
}

}  // namespace

extern "C" {

// data: (ndiag, n) row-major; offsets: (ndiag,) int32; x: (ncols,);
// z: (n,) or null; y: (n,).  All on the device.  Returns cudaGetLastError().
int lssp_dia_spmv_f32(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, const void* x, double alpha,
                      double beta, const void* z, void* y, void* stream) {
  return launch<float>(data, offsets, ndiag, n, ncols, x, alpha, beta, z, y, stream);
}

int lssp_dia_spmv_f64(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, const void* x, double alpha,
                      double beta, const void* z, void* y, void* stream) {
  return launch<double>(data, offsets, ndiag, n, ncols, x, alpha, beta, z, y, stream);
}

int lssp_dia_spmv_bf16(const void* data, const void* offsets, int ndiag,
                       int64_t n, int64_t ncols, const void* x, double alpha,
                       double beta, const void* z, void* y, void* stream) {
  return launch<__nv_bfloat16>(data, offsets, ndiag, n, ncols, x, alpha, beta, z, y,
                               stream);
}

// K1k.  data: (ndiag, n) row-major; offsets: (ndiag,) int32; X: (ncols, k),
// Z: (n, k) or null, Y: (n, k), all three row-major.  All on the device.
// Returns cudaGetLastError().
int lssp_dia_spmm_f32(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, int64_t k, const void* X,
                      double alpha, double beta, const void* Z, void* Y,
                      void* stream) {
  return launch_spmm<float>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y,
                            stream);
}

int lssp_dia_spmm_f64(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, int64_t k, const void* X,
                      double alpha, double beta, const void* Z, void* Y,
                      void* stream) {
  return launch_spmm<double>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z, Y,
                             stream);
}

int lssp_dia_spmm_bf16(const void* data, const void* offsets, int ndiag,
                       int64_t n, int64_t ncols, int64_t k, const void* X,
                       double alpha, double beta, const void* Z, void* Y,
                       void* stream) {
  return launch_spmm<__nv_bfloat16>(data, offsets, ndiag, n, ncols, k, X, alpha, beta, Z,
                                    Y, stream);
}

}  // extern "C"
