// K3: HYB (band plus remainder) SpMV with a fused axpby epilogue, for
// Hopper (sm_90a).
//
// Replaces both TPU kernels of the HYB product in
// lssp_tpu/ops/pallas_spmv.py: _dia_spmv_hyb_tc_pallas (tile-compact
// remainder, scattered by a one-hot MXU matmul; entry dia_spmv_hyb_tc_pallas)
// and _dia_spmv_hyb_pallas (window-slot remainder plus a scalar overflow
// scatter; entry dia_spmv_hyb_pallas).  The two compute the same function
// and differ only in the remainder layout the TPU needs, so one kernel
// serves both:
//
//   y[i] = alpha * (sum_d band[d, i] * x[i + off_d]
//                   + sum_{e : rem_rows[e] == i} rem_vals[e] * x[rem_cols[e]])
//          (+ beta * z[i] when z)
//
// in one launch, writing y once.
//
// Bound: device-memory bandwidth, as K1.  Per row the band moves ndiag
// values, one x value, one y write (and one z read); per remainder entry
// one value, one column index, one row index and one gathered x value.
// The band part is K1's loop: one thread per row, diagonal d read as
// data[d * n + i], coalesced across the warp, every x read guarded by
// 0 <= i + off_d < ncols (x is read in place, not from a zero-margined
// window as on the TPU).
//
// Remainder layout: row-sorted COO triplets (CSR order) plus a per-block
// pointer rem_block_ptr[nblocks + 1], a block being the kThreads rows one
// thread block owns.  The block's entries are [ptr[b], ptr[b + 1]); each
// thread finds its row's first entry by a binary search inside that slice
// (a few reads of rem_rows, all in L1 for one block) and sums its row's
// entries serially, in CSR order.  Chosen over a per-row pointer (n + 1
// int32) because that would add 4 B per row to every row's traffic, 28 ->
// 32 B/row for a 5-diagonal fp32 band (+14 %), while the remainders this
// format exists for hold well under one entry per row; the block pointer
// costs 4 B per 256 rows.  Each row is summed by one thread, with no
// atomics, so two runs give bitwise-equal y.  A row with many entries is
// simply a long loop for its thread; columns are not bounded.
//
// K3k, the k-rhs form (the vmap rules of both HYB kernels,
// pallas_spmv.py: _vmap_safe_hyb_tc_kernel and _vmap_safe_hyb_kernel), on
// (n, k) row-major blocks, element (i, c) at i * k + c: K1k's band loop
// (csrc/dia_spmv.cu; one thread per row and register tile of KT columns,
// csrc/krhs.cuh) plus the row's remainder entries, each value read once
// for the tile and each column summed in K3's order.  The remainder index
// stays the one for kThreads-row blocks, and a thread block still holds
// kThreads rows (grid.y walks the column tiles).
//
// bf16: as K1 (csrc/dia_spmv.cu): bf16 loads, float products, sum and
// epilogue (lssp::Acc), one rounding at the store.
//
// Later work: a shared-memory x window with its halo, 16-byte vector
// loads, warp-cooperative sums for heavy remainder rows.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "krhs.cuh"

namespace {

constexpr int kThreads = 256;   // rows per block: _kernels.HYB_BLOCK_ROWS

template <typename T>
__global__ void hyb_spmv_kernel(const T* __restrict__ data,
                                const int32_t* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t ncols,
                                const int32_t* __restrict__ rem_rows,
                                const int32_t* __restrict__ rem_cols,
                                const T* __restrict__ rem_vals,
                                const int32_t* __restrict__ rem_block_ptr,
                                const T* __restrict__ x, typename lssp::Acc<T>::type alpha,
                                typename lssp::Acc<T>::type beta,
                                const T* __restrict__ z, T* __restrict__ y) {
  using A = typename lssp::Acc<T>::type;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  A acc = A(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < ncols)
      acc += lssp::to_acc(data[static_cast<int64_t>(d) * n + i]) * lssp::to_acc(x[j]);
  }
  const int32_t end = __ldg(rem_block_ptr + blockIdx.x + 1);
  int32_t lo = __ldg(rem_block_ptr + blockIdx.x);
  if (lo < end) {
    const int32_t row = static_cast<int32_t>(i);
    int32_t hi = end;
    while (lo < hi) {                    // first entry with rem_rows >= row
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(rem_rows + mid) < row) lo = mid + 1; else hi = mid;
    }
    for (int32_t e = lo; e < end && __ldg(rem_rows + e) == row; ++e)
      acc += lssp::to_acc(__ldg(rem_vals + e)) * lssp::to_acc(x[__ldg(rem_cols + e)]);
  }
  A out = alpha * acc;
  if (z != nullptr) out += beta * lssp::to_acc(z[i]);
  y[i] = lssp::from_acc<T>(out);
}

template <typename T, int KT>
__global__ void hyb_spmm_kernel(const T* __restrict__ data,
                                const int32_t* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t ncols, int64_t k,
                                const int32_t* __restrict__ rem_rows,
                                const int32_t* __restrict__ rem_cols,
                                const T* __restrict__ rem_vals,
                                const int32_t* __restrict__ rem_block_ptr,
                                const T* __restrict__ X, typename lssp::Acc<T>::type alpha,
                                typename lssp::Acc<T>::type beta,
                                const T* __restrict__ Z, T* __restrict__ Y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * KT;
  lssp::Tile<T, KT> acc;
  acc.zero();
  for (int d = 0; d < ndiag; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j >= 0 && j < ncols)
      acc.axpy(lssp::to_acc(data[static_cast<int64_t>(d) * n + i]), X + j * k + c0);
  }
  const int32_t end = __ldg(rem_block_ptr + blockIdx.x + 1);
  int32_t lo = __ldg(rem_block_ptr + blockIdx.x);
  if (lo < end) {
    const int32_t row = static_cast<int32_t>(i);
    int32_t hi = end;
    while (lo < hi) {                    // first entry with rem_rows >= row
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(rem_rows + mid) < row) lo = mid + 1; else hi = mid;
    }
    for (int32_t e = lo; e < end && __ldg(rem_rows + e) == row; ++e)
      acc.axpy(lssp::to_acc(__ldg(rem_vals + e)),
               X + static_cast<int64_t>(__ldg(rem_cols + e)) * k + c0);
  }
  acc.axpby_store(alpha, beta, Z == nullptr ? nullptr : Z + i * k + c0, Y + i * k + c0);
}

template <typename T>
int launch(const void* data, const void* offsets, int ndiag, int64_t n,
           int64_t ncols, const void* rem_rows, const void* rem_cols,
           const void* rem_vals, const void* rem_block_ptr, const void* x,
           double alpha, double beta, const void* z, void* y, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  hyb_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      n, ncols, static_cast<const int32_t*>(rem_rows),
      static_cast<const int32_t*>(rem_cols), static_cast<const T*>(rem_vals),
      static_cast<const int32_t*>(rem_block_ptr), static_cast<const T*>(x),
      static_cast<typename lssp::Acc<T>::type>(alpha),
      static_cast<typename lssp::Acc<T>::type>(beta), static_cast<const T*>(z),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KT>
int launch_tile(const void* data, const void* offsets, int ndiag, int64_t n,
                int64_t ncols, int64_t k, const void* rem_rows,
                const void* rem_cols, const void* rem_vals,
                const void* rem_block_ptr, const void* X, double alpha,
                double beta, const void* Z, void* Y, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(k / KT));
  hyb_spmm_kernel<T, KT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(offsets), ndiag,
      n, ncols, k, static_cast<const int32_t*>(rem_rows),
      static_cast<const int32_t*>(rem_cols), static_cast<const T*>(rem_vals),
      static_cast<const int32_t*>(rem_block_ptr), static_cast<const T*>(X),
      static_cast<typename lssp::Acc<T>::type>(alpha),
      static_cast<typename lssp::Acc<T>::type>(beta), static_cast<const T*>(Z),
      static_cast<T*>(Y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spmm(const void* data, const void* offsets, int ndiag, int64_t n,
                int64_t ncols, int64_t k, const void* rem_rows,
                const void* rem_cols, const void* rem_vals,
                const void* rem_block_ptr, const void* X, double alpha,
                double beta, const void* Z, void* Y, void* stream) {
  if (n == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int kt = lssp::tile_width<T>(k, X, Z, Y);
  if (k / kt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
#define LSSP_HYB_TILE(KT)                                                         \
  return launch_tile<T, KT>(data, offsets, ndiag, n, ncols, k, rem_rows, rem_cols, \
                            rem_vals, rem_block_ptr, X, alpha, beta, Z, Y, stream)
  switch (kt) {
    case 8: LSSP_HYB_TILE(8);
    case 4: LSSP_HYB_TILE(4);
    case 2: LSSP_HYB_TILE(2);
    default: LSSP_HYB_TILE(1);
  }
#undef LSSP_HYB_TILE
}

}  // namespace

extern "C" {

// data: (ndiag, n) row-major; offsets: (ndiag,) int32; rem_rows/rem_cols:
// (nnz_rem,) int32, rows ascending; rem_vals: (nnz_rem,); rem_block_ptr:
// (ceil(n / kThreads) + 1,) int32, built for kThreads-row blocks; x:
// (ncols,); z: (n,) or null; y: (n,).  All on the device.
// Returns cudaGetLastError().
int lssp_hyb_spmv_f32(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, const void* rem_rows,
                      const void* rem_cols, const void* rem_vals,
                      const void* rem_block_ptr, const void* x,
                      double alpha, double beta, const void* z, void* y,
                      void* stream) {
  return launch<float>(data, offsets, ndiag, n, ncols, rem_rows, rem_cols,
                       rem_vals, rem_block_ptr, x, alpha, beta, z,
                       y, stream);
}

int lssp_hyb_spmv_f64(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, const void* rem_rows,
                      const void* rem_cols, const void* rem_vals,
                      const void* rem_block_ptr, const void* x,
                      double alpha, double beta, const void* z, void* y,
                      void* stream) {
  return launch<double>(data, offsets, ndiag, n, ncols, rem_rows, rem_cols,
                        rem_vals, rem_block_ptr, x, alpha, beta, z,
                        y, stream);
}

int lssp_hyb_spmv_bf16(const void* data, const void* offsets, int ndiag,
                       int64_t n, int64_t ncols, const void* rem_rows,
                       const void* rem_cols, const void* rem_vals,
                       const void* rem_block_ptr, const void* x,
                       double alpha, double beta, const void* z, void* y,
                       void* stream) {
  return launch<__nv_bfloat16>(data, offsets, ndiag, n, ncols, rem_rows, rem_cols,
                               rem_vals, rem_block_ptr, x, alpha, beta, z, y, stream);
}

// K3k.  As above, with X: (ncols, k), Z: (n, k) or null and Y: (n, k),
// all three row-major.  Returns cudaGetLastError().
int lssp_hyb_spmm_f32(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, int64_t k, const void* rem_rows,
                      const void* rem_cols, const void* rem_vals,
                      const void* rem_block_ptr, const void* X, double alpha,
                      double beta, const void* Z, void* Y, void* stream) {
  return launch_spmm<float>(data, offsets, ndiag, n, ncols, k, rem_rows, rem_cols,
                            rem_vals, rem_block_ptr, X, alpha, beta, Z, Y, stream);
}

int lssp_hyb_spmm_f64(const void* data, const void* offsets, int ndiag,
                      int64_t n, int64_t ncols, int64_t k, const void* rem_rows,
                      const void* rem_cols, const void* rem_vals,
                      const void* rem_block_ptr, const void* X, double alpha,
                      double beta, const void* Z, void* Y, void* stream) {
  return launch_spmm<double>(data, offsets, ndiag, n, ncols, k, rem_rows, rem_cols,
                             rem_vals, rem_block_ptr, X, alpha, beta, Z, Y, stream);
}

int lssp_hyb_spmm_bf16(const void* data, const void* offsets, int ndiag,
                       int64_t n, int64_t ncols, int64_t k, const void* rem_rows,
                       const void* rem_cols, const void* rem_vals,
                       const void* rem_block_ptr, const void* X, double alpha,
                       double beta, const void* Z, void* Y, void* stream) {
  return launch_spmm<__nv_bfloat16>(data, offsets, ndiag, n, ncols, k, rem_rows,
                                    rem_cols, rem_vals, rem_block_ptr, X, alpha, beta, Z,
                                    Y, stream);
}

}  // extern "C"
