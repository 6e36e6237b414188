// Field arithmetic on one state per thread, and the planar state layout,
// shared by the CUDA kernels (every .cu file of this directory).
//
// A field element is 8 little-endian limbs of 32 bits. The Montgomery
// radix is R = 2^256, the same as the JAX package's 16 digits of 16 bits,
// so Montgomery-domain values agree bit for bit with it. Every value a
// function returns is reduced to [0, p): p is about 0.453 * 2^256, so
// 4p > 2^256 and the usual "inputs < 2p give outputs < 2p" lazy bound
// does not hold for these limbs.
//
// The header compiles for the host as well, so the same code can be
// checked against a reference with a host compiler. It declares no
// __constant__ table: each .cu file is its own CUDA module, and a table
// declared in a shared header would be a separate, uninitialised copy in
// every file that includes it (perm.cuh holds perm.cu's tables).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HADES_FN __device__ __forceinline__
#define HADES_HD __host__ __device__ __forceinline__
#else
#define HADES_FN static inline
#define HADES_HD static inline
#endif

namespace hades {

constexpr int kLimbs = 8;
constexpr int kWidth = 5;
constexpr int kFullRounds = 8;
constexpr int kPartialRounds = 59;
constexpr int kRounds = kFullRounds + kPartialRounds;
constexpr int kHalf = kFullRounds / 2;

// -p^{-1} mod 2^32: p = 1 (mod 2^32), so it is 2^32 - 1 and m = -t0.
constexpr uint32_t kPPrimeWord = 0xFFFFFFFFu;

// The modulus p = 0x73eda753...00000001 as 32-bit limbs, low limb first.
// Immediates, not a table: every use sits in a fully unrolled loop.
HADES_HD uint32_t p_limb(int i) {
  switch (i) {
    case 0: return 0x00000001u;
    case 1: return 0xFFFFFFFFu;
    case 2: return 0xFFFE5BFEu;
    case 3: return 0x53BDA402u;
    case 4: return 0x09A1D805u;
    case 5: return 0x3339D808u;
    case 6: return 0x299D7D48u;
    default: return 0x73EDA753u;
  }
}

// r = t - p if t >= p, else t. Needs t < 2p. r may alias t.
HADES_FN void cond_sub_p(uint32_t r[kLimbs], const uint32_t t[kLimbs]) {
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    uint64_t x = (uint64_t)t[j] - p_limb(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = borrow ? t[j] : d[j];
}

// r = (a + b) mod p for a, b < p. a + b < 2p < 2^256: no carry out.
HADES_FN void add_mod(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                      const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p(r, s);
}

// r = a b R^{-1} mod p for a, b < p: coarsely integrated operand scanning
// (CIOS). Each 32x32 -> 64-bit product is one wide multiply-add; the carry
// rides in the high word of a 64-bit accumulator, c + a b + t < 2^64.
// Invariant: t < 2p after every outer step, since
// (t + a b_i + m p) / 2^32 < (2p + 2 (2^32 - 1) p) / 2^32 < 2p; t never
// needs more than 9 words, and the 9th is zero at the end (2p < 2^256).
HADES_FN void mont_mul(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                       const uint32_t b[kLimbs]) {
  uint32_t t[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) t[j] = 0;
  uint32_t t8 = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t bi = b[i];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      c += (uint64_t)a[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    uint64_t s = (uint64_t)t8 + c;
    t8 = (uint32_t)s;
    const uint32_t t9 = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kPPrimeWord;
    c = ((uint64_t)m * p_limb(0) + t[0]) >> 32;  // low word is zero
#pragma unroll
    for (int j = 1; j < kLimbs; ++j) {
      c += (uint64_t)m * p_limb(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    s = (uint64_t)t8 + c;
    t[kLimbs - 1] = (uint32_t)s;
    t8 = t9 + (uint32_t)(s >> 32);
  }
  cond_sub_p(r, t);
}

HADES_FN void copy(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = a[j];
}

// x^5 = (x^2)^2 x, three Montgomery products. r may alias x.
HADES_FN void sbox(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {
  uint32_t x2[kLimbs], x4[kLimbs];
  mont_mul(x2, x, x);
  mont_mul(x4, x2, x2);
  mont_mul(r, x4, x);
}

// Status codes of the C entry points, besides CUDA's own
// (hades_error_string, perm.cu).
constexpr int kErrTableSize = -1;
constexpr int kErrModulus = -2;
constexpr int kErrBatch = -3;
constexpr int kErrShape = -4;

// The planar layout of the kernels' inputs and outputs: x[w, d, b] is
// 16-bit digit d of word w of state b, for a batch of n states. Thread b
// touches x[w, d, b], so neighbouring threads read neighbouring addresses.
constexpr int kDigits = 16;

HADES_FN void load_state(uint32_t s[kWidth][kLimbs], const int32_t* __restrict__ x,
                         long long b, long long n) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const uint32_t lo = (uint32_t)x[(long long)(w * kDigits + 2 * k) * n + b];
      const uint32_t hi = (uint32_t)x[(long long)(w * kDigits + 2 * k + 1) * n + b];
      s[w][k] = lo | (hi << 16);
    }
  }
}

HADES_FN void store_state(int32_t* __restrict__ out, const uint32_t s[kWidth][kLimbs],
                          long long b, long long n) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      out[(long long)(w * kDigits + 2 * k) * n + b] = (int32_t)(s[w][k] & 0xFFFFu);
      out[(long long)(w * kDigits + 2 * k + 1) * n + b] = (int32_t)(s[w][k] >> 16);
    }
  }
}

// Blocks of `threads` for a batch of n states, or 0 when n is out of range.
static inline unsigned grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (n <= 0 || blocks > 0x7FFFFFFFLL) ? 0u : (unsigned)blocks;
}

}  // namespace hades
