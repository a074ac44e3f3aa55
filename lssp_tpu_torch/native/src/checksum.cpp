// CRC-32 of a byte buffer, the value of zlib's crc32 (reflected
// polynomial 0xEDB88320, initial and final value all ones), for the memo's
// content fingerprint (lssp_tpu_torch/utils/memo.py).  The port's own
// source: it has no counterpart in the JAX package.
//
// The body is folded with carry-less multiplies (PCLMULQDQ): four 128-bit
// lanes advance 64 bytes a step, are folded into one, that one takes the
// remaining 16-byte blocks, and a Barrett reduction gives the 32-bit
// remainder.  The constants are those of Gopal et al., "Fast CRC
// Computation for Generic Polynomials Using PCLMULQDQ Instruction" (Intel,
// 2009), for the bit-reflected polynomial; Linux's crc32-pclmul uses the
// same.  A byte table takes what the fold does not cover (a buffer under
// 64 bytes, the last n mod 16 bytes), so lssp_crc32 alone returns zlib's
// value.  Loads are unaligned: a numpy view need not start on 16 bytes.
//
// lssp_crc32_split takes contiguous chunks on threads and joins their CRCs
// by the CRC-32 combine (the chunk's CRC times x^(8·len) mod P, zlib's
// crc32_combine).  lssp_crc32_folds says whether this CPU has the
// instructions; where it does not, the Python side keeps zlib.

#include <algorithm>
#include <cstdint>
#include <immintrin.h>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t POLY = 0xEDB88320u;

struct ByteTable {
  uint32_t t[256];
  constexpr ByteTable() : t() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ POLY : c >> 1;
      t[i] = c;
    }
  }
};
constexpr ByteTable TABLE;

// `crc` is the running state (the complement of a CRC value)
uint32_t bytewise(uint32_t crc, const uint8_t* p, int64_t n) {
  for (int64_t i = 0; i < n; ++i) crc = TABLE.t[(crc ^ p[i]) & 0xff] ^ (crc >> 8);
  return crc;
}

#define FOLD_TARGET __attribute__((target("pclmul,sse4.1")))

FOLD_TARGET inline __m128i load(const uint8_t* p) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
}

// x·k folded 128 bits ahead onto y: x.lo·k.lo ^ x.hi·k.hi ^ y
FOLD_TARGET inline __m128i step(__m128i x, __m128i k, __m128i y) {
  __m128i lo = _mm_clmulepi64_si128(x, k, 0x00);
  __m128i hi = _mm_clmulepi64_si128(x, k, 0x11);
  return _mm_xor_si128(_mm_xor_si128(lo, hi), y);
}

// the state after n bytes, n >= 64 and a multiple of 16
FOLD_TARGET uint32_t fold(uint32_t crc, const uint8_t* p, int64_t n) {
  const __m128i k1k2 = _mm_set_epi64x(0x1c6e41596, 0x154442bd4);   // fold by 4 (512 bits)
  const __m128i k3k4 = _mm_set_epi64x(0x0ccaa009e, 0x1751997d0);   // fold by 1 (128 bits)
  const __m128i k5 = _mm_set_epi64x(0, 0x163cd6124);               // 64 → 32 bits
  const __m128i pu = _mm_set_epi64x(0x1f7011641, 0x1db710641);     // P' and Barrett's u'
  const __m128i low32 = _mm_setr_epi32(~0, 0, ~0, 0);

  __m128i x1 = _mm_xor_si128(load(p), _mm_cvtsi32_si128(static_cast<int>(crc)));
  __m128i x2 = load(p + 16), x3 = load(p + 32), x4 = load(p + 48);
  p += 64;
  n -= 64;
  for (; n >= 64; p += 64, n -= 64) {
    x1 = step(x1, k1k2, load(p));
    x2 = step(x2, k1k2, load(p + 16));
    x3 = step(x3, k1k2, load(p + 32));
    x4 = step(x4, k1k2, load(p + 48));
  }
  x1 = step(x1, k3k4, x2);
  x1 = step(x1, k3k4, x3);
  x1 = step(x1, k3k4, x4);
  for (; n >= 16; p += 16, n -= 16) x1 = step(x1, k3k4, load(p));

  // 128 → 64 bits, then 64 → 32
  __m128i t = _mm_clmulepi64_si128(x1, k3k4, 0x10);
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), t);
  t = _mm_srli_si128(x1, 4);
  x1 = _mm_xor_si128(_mm_clmulepi64_si128(_mm_and_si128(x1, low32), k5, 0x00), t);

  // Barrett reduction to the 32-bit remainder
  t = _mm_clmulepi64_si128(_mm_and_si128(x1, low32), pu, 0x10);
  t = _mm_clmulepi64_si128(_mm_and_si128(t, low32), pu, 0x00);
  x1 = _mm_xor_si128(x1, t);
  return static_cast<uint32_t>(_mm_extract_epi32(x1, 1));
}

bool folds() {
  return __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
}

uint32_t crc32(const uint8_t* p, int64_t n) {
  static const bool FOLDS = folds();
  uint32_t crc = ~0u;
  if (FOLDS && n >= 64) {
    int64_t body = n & ~int64_t(15);
    crc = fold(crc, p, body);
    p += body;
    n -= body;
  }
  return ~bytewise(crc, p, n);
}

// a·b mod P, polynomials in the reflected order (bit 31 is x^0)
uint32_t mulmod(uint32_t a, uint32_t b) {
  uint32_t prod = 0;
  for (uint32_t m = 1u << 31; m != 0; m >>= 1) {
    if (a & m) prod ^= b;
    b = (b & 1) ? (b >> 1) ^ POLY : b >> 1;
  }
  return prod;
}

// the CRC of A then B from crc(A), crc(B) and B's length
uint32_t combine(uint32_t crc_a, uint32_t crc_b, int64_t len_b) {
  uint32_t shift = 1u << 31;        // x^0
  uint32_t sq = 1u << 23;           // x^8: one byte
  for (uint64_t k = static_cast<uint64_t>(len_b); k != 0; k >>= 1) {
    if (k & 1) shift = mulmod(shift, sq);
    sq = mulmod(sq, sq);
  }
  return mulmod(shift, crc_a) ^ crc_b;
}

}  // namespace

extern "C" {

uint32_t lssp_crc32(const uint8_t* p, int64_t n) {
  return crc32(p, n);
}

int lssp_crc32_folds(void) {
  return folds() ? 1 : 0;
}

// the same value, `threads` contiguous chunks at once
uint32_t lssp_crc32_split(const uint8_t* p, int64_t n, int threads) {
  if (threads < 2 || n < 2 * 64) return crc32(p, n);
  int64_t chunk = ((n + threads - 1) / threads + 63) & ~int64_t(63);
  int parts = static_cast<int>((n + chunk - 1) / chunk);
  std::vector<uint32_t> crcs(parts);
  std::vector<std::thread> pool;
  int started = 0;
  try {
    for (; started < parts - 1; ++started) {
      int64_t at = started * chunk;
      pool.emplace_back([&crcs, p, at, chunk, started] { crcs[started] = crc32(p + at, chunk); });
    }
  } catch (const std::system_error&) {
    // no thread to be had: this one takes the chunks not started
  }
  for (int i = started; i < parts; ++i) {
    int64_t at = i * chunk;
    crcs[i] = crc32(p + at, std::min(chunk, n - at));
  }
  for (auto& th : pool) th.join();
  uint32_t crc = crcs[0];
  for (int i = 1; i < parts; ++i) {
    int64_t at = i * chunk;
    crc = combine(crc, crcs[i], std::min(chunk, n - at));
  }
  return crc;
}

}  // extern "C"
