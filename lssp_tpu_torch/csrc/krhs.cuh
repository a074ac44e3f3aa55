// The register tile of the k-rhs kernels K1k-K4k (dia_spmv.cu, hyb_spmv.cu,
// neumann.cu, dia_spmv_ext.cu).
//
// A block of k right-hand sides is (rows, k) row-major, element (i, c) at
// i * k + c (the layout ops/spmv.py states).  Each thread owns one row and
// a tile of KT consecutive columns (KT = 8, 4, 2 or 1; grid.y or grid.z
// walks the k / KT tiles), keeps the KT sums in registers and reads the KT
// values of a row of the block with 16-byte vector loads (8-byte ones for a
// tile of two fp32 values).  So a matrix value is read once per tile and
// multiplies KT columns, and one thread does KT columns' work: a thread per
// (row, column) pair measured 0.7 TB/s on the 128^3 DIA band at k = 8 in
// fp32, this tile 2.6 TB/s (NVIDIA H100 80GB HBM3, 700 W; the launch cost
// per thread, not the bytes, bounded the first).
//
// tile_width() picks KT: the largest of 8, 4, 2, 1 that divides k and keeps
// every block pointer aligned for the vector loads; a misaligned or odd-k
// block runs with KT = 1, scalar loads, never a copy.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lssp {

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

// The CUDA vector type of a Pack, for the __ldcg loads (cached in the L2
// only, never in the SM's L1: the data a kernel writes itself and reads
// back from other blocks, K2's wavefront).
template <typename T, int W> struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T, int KT>
struct Tile {
  // elements per vector load: 16 bytes, or the whole tile when smaller
  static constexpr int W = KT * sizeof(T) >= 16 ? 16 / static_cast<int>(sizeof(T)) : KT;
  T v[KT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < KT; ++c) v[c] = T(0);
  }
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int q = 0; q < KT / W; ++q) {
      const Pack<T, W> pk = reinterpret_cast<const Pack<T, W>*>(p)[q];
#pragma unroll
      for (int w = 0; w < W; ++w) v[q * W + w] = pk.v[w];
    }
  }
  // load() through the L2 only (ld.global.cg)
  __device__ __forceinline__ void load_cg(const T* p) {
    using V = typename VecOf<T, W>::type;
#pragma unroll
    for (int q = 0; q < KT / W; ++q) {
      Pack<T, W> pk;
      *reinterpret_cast<V*>(&pk) = __ldcg(reinterpret_cast<const V*>(p) + q);
#pragma unroll
      for (int w = 0; w < W; ++w) v[q * W + w] = pk.v[w];
    }
  }
  // v += a * p[0:KT]
  __device__ __forceinline__ void axpy(T a, const T* p) {
    Tile t;
    t.load(p);
#pragma unroll
    for (int c = 0; c < KT; ++c) v[c] += a * t.v[c];
  }
  // v += a * t, a tile loaded earlier
  __device__ __forceinline__ void axpy(T a, const Tile& t) {
#pragma unroll
    for (int c = 0; c < KT; ++c) v[c] += a * t.v[c];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int q = 0; q < KT / W; ++q) {
      Pack<T, W> pk;
#pragma unroll
      for (int w = 0; w < W; ++w) pk.v[w] = v[q * W + w];
      reinterpret_cast<Pack<T, W>*>(p)[q] = pk;
    }
  }
  // the K1/K3/K4 epilogue per column: y = alpha * acc (+ beta * z)
  __device__ __forceinline__ void axpby_store(T alpha, T beta, const T* z, T* y) const {
    Tile out;
    if (z != nullptr) out.load(z);
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      T o = alpha * v[c];
      if (z != nullptr) o += beta * out.v[c];
      out.v[c] = o;
    }
    out.store(y);
  }
};

inline bool aligned(const void* p, int64_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The tile width for k columns of T with the given block pointers.
template <typename T>
int tile_width(int64_t k, const void* a, const void* b, const void* c) {
  for (int kt = 8; kt > 1; kt /= 2) {
    const int64_t bytes = kt * sizeof(T) >= 16 ? 16 : kt * static_cast<int64_t>(sizeof(T));
    if (k % kt == 0 && aligned(a, bytes) && aligned(b, bytes) && aligned(c, bytes)) return kt;
  }
  return 1;
}

}  // namespace lssp
