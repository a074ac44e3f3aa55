// K4: the per-shard DIA SpMV of the distributed solve, every shard in one
// launch, with a fused axpby epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel lssp_tpu/ops/pallas_spmv.py: _dia_spmv_pallas
// (prepadded=True; entries dia_spmv_pallas_ext and _vmap_safe_ext_kernel),
// which shard_map runs once per shard on x_ext = [halo_lo | x | halo_hi].
// Here the P shards are the leading axis of one tensor and one launch
// covers them all:
//
//   y[p, i] = alpha * sum_d data[p, d, i] * x_ext[p, lo + i + off_d]
//             (+ beta * z[p, i] when z)
//
// data: (P, ndiag, R); x_ext: (P, ldx) with ldx >= R + lo + hi; z, y:
// (P, R).  alpha = 1, no z: the distributed product.  alpha = -1, beta = 1,
// z = r: one Neumann sweep y <- r - L*y of the block-Jacobi ILU apply.
//
// Bound: device-memory bandwidth, as K1 (csrc/dia_spmv.cu): per row ndiag
// data values, one x_ext value (neighbouring diagonals hit the same lines
// in L1/L2), one y write and one z read when z is given.  One thread owns
// one row; diagonal d of shard p is read at data[(p * ndiag + d) * R + i],
// so a warp reads 32 consecutive values of each diagonal, and x_ext at
// consecutive addresses too.  blockIdx.y is the shard, blockIdx.x the row
// block within it, so no thread divides to find its shard.
//
// No bounds check on x_ext: it carries each shard's halos (from the
// neighbours for a product, zeros for a sweep), so lo + i + off_d always
// lies in [0, R + lo + hi).  That is the Pallas prepadded branch's
// contract.  Shard 0's left halo and shard P-1's right halo hold the ring
// wrap-around, which only ever meets stored zeros.
//
// K4k, the k-rhs form (pallas_spmv.py: _vmap_safe_ext_kernel's vmap rule):
// every shard's product on a (P, R + lo + hi, k) block, one launch,
//
//   y[p, i, c] = alpha * sum_d data[p, d, i] * x_ext[p, lo + i + off_d, c]
//                (+ beta * z[p, i, c] when z)
//
// with every block row-major (the layout ops/spmv.py states).  One thread
// per row and register tile of KT columns (csrc/krhs.cuh), as K1k
// (csrc/dia_spmv.cu): each data value is read once for the tile, so each
// shard's band streams once per product for all k columns.  grid (row
// blocks, shards, column tiles).  No bounds check, as K4: the halos carry
// the margin.  The sweep epilogue (-1, 1, z = r) serves the block-Jacobi
// Neumann sweeps on blocks.
//
// Later work: read the neighbour's rows in place instead of the halo copy
// the wrapper's caller makes, and a shared-memory x window.

#include <cstdint>

#include <cuda_runtime.h>

#include "krhs.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dia_spmv_ext_kernel(const T* __restrict__ data,
                                    const int32_t* __restrict__ offsets,
                                    int ndiag, int64_t R, int64_t ldx,
                                    int64_t lo, const T* __restrict__ x_ext,
                                    T alpha, T beta, const T* __restrict__ z,
                                    T* __restrict__ y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int64_t p = blockIdx.y;
  const T* d_p = data + p * ndiag * R + i;
  const T* x_p = x_ext + p * ldx + lo + i;
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    acc += d_p[static_cast<int64_t>(d) * R] * x_p[__ldg(offsets + d)];
  }
  T out = alpha * acc;
  if (z != nullptr) out += beta * z[p * R + i];
  y[p * R + i] = out;
}

template <typename T, int KT>
__global__ void dia_spmm_ext_kernel(const T* __restrict__ data,
                                    const int32_t* __restrict__ offsets,
                                    int ndiag, int64_t R, int64_t ldx,
                                    int64_t lo, int64_t k,
                                    const T* __restrict__ x_ext, T alpha, T beta,
                                    const T* __restrict__ z, T* __restrict__ y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int64_t p = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.z) * KT;
  const T* d_p = data + p * ndiag * R + i;
  const T* x_p = x_ext + (p * ldx + lo + i) * k + c0;
  lssp::Tile<T, KT> acc;
  acc.zero();
  for (int d = 0; d < ndiag; ++d)
    acc.axpy(d_p[static_cast<int64_t>(d) * R], x_p + static_cast<int64_t>(__ldg(offsets + d)) * k);
  const int64_t row = (p * R + i) * k + c0;
  acc.axpby_store(alpha, beta, z == nullptr ? nullptr : z + row, y + row);
}

template <typename T>
int launch(const void* data, const void* offsets, int ndiag, int64_t P,
           int64_t R, int64_t ldx, int64_t lo, const void* x_ext, double alpha,
           double beta, const void* z, void* y, void* stream) {
  if (P == 0 || R == 0) return static_cast<int>(cudaSuccess);
  if (P > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(P));
  dia_spmv_ext_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      R, ldx, lo, static_cast<const T*>(x_ext), static_cast<T>(alpha),
      static_cast<T>(beta), static_cast<const T*>(z), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KT>
int launch_tile(const void* data, const void* offsets, int ndiag, int64_t P,
                int64_t R, int64_t ldx, int64_t lo, int64_t k, const void* x_ext,
                double alpha, double beta, const void* z, void* y, void* stream) {
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(P), static_cast<unsigned>(k / KT));
  dia_spmm_ext_kernel<T, KT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      R, ldx, lo, k, static_cast<const T*>(x_ext), static_cast<T>(alpha),
      static_cast<T>(beta), static_cast<const T*>(z), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmm(const void* data, const void* offsets, int ndiag, int64_t P,
                int64_t R, int64_t ldx, int64_t lo, int64_t k, const void* x_ext,
                double alpha, double beta, const void* z, void* y, void* stream) {
  if (P == 0 || R == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int kt = lssp::tile_width<T>(k, x_ext, z, y);
  if (P > 65535 || k / kt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
#define LSSP_EXT_TILE(KT)                                                          \
  return launch_tile<T, KT>(data, offsets, ndiag, P, R, ldx, lo, k, x_ext, alpha, \
                            beta, z, y, stream)
  switch (kt) {
    case 8: LSSP_EXT_TILE(8);
    case 4: LSSP_EXT_TILE(4);
    case 2: LSSP_EXT_TILE(2);
    default: LSSP_EXT_TILE(1);
  }
#undef LSSP_EXT_TILE
}

}  // namespace

extern "C" {

// data: (P, ndiag, R) row-major; offsets: (ndiag,) int32; x_ext: (P, ldx);
// z: (P, R) or null; y: (P, R).  All on the device.  Returns
// cudaGetLastError().
int lssp_dia_spmv_ext_f32(const void* data, const void* offsets, int ndiag,
                          int64_t P, int64_t R, int64_t ldx, int64_t lo,
                          const void* x_ext, double alpha, double beta,
                          const void* z, void* y, void* stream) {
  return launch<float>(data, offsets, ndiag, P, R, ldx, lo, x_ext, alpha, beta,
                       z, y, stream);
}

int lssp_dia_spmv_ext_f64(const void* data, const void* offsets, int ndiag,
                          int64_t P, int64_t R, int64_t ldx, int64_t lo,
                          const void* x_ext, double alpha, double beta,
                          const void* z, void* y, void* stream) {
  return launch<double>(data, offsets, ndiag, P, R, ldx, lo, x_ext, alpha, beta,
                        z, y, stream);
}

// K4k.  data: (P, ndiag, R) row-major; offsets: (ndiag,) int32; x_ext:
// (P, ldx, k); z: (P, R, k) or null; y: (P, R, k).  Returns
// cudaGetLastError().
int lssp_dia_spmm_ext_f32(const void* data, const void* offsets, int ndiag,
                          int64_t P, int64_t R, int64_t ldx, int64_t lo, int64_t k,
                          const void* x_ext, double alpha, double beta,
                          const void* z, void* y, void* stream) {
  return launch_spmm<float>(data, offsets, ndiag, P, R, ldx, lo, k, x_ext, alpha,
                            beta, z, y, stream);
}

int lssp_dia_spmm_ext_f64(const void* data, const void* offsets, int ndiag,
                          int64_t P, int64_t R, int64_t ldx, int64_t lo, int64_t k,
                          const void* x_ext, double alpha, double beta,
                          const void* z, void* y, void* stream) {
  return launch_spmm<double>(data, offsets, ndiag, P, R, ldx, lo, k, x_ext, alpha,
                             beta, z, y, stream);
}

}  // extern "C"
