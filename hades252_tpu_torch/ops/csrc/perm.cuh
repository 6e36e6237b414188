// Field arithmetic and the per-state Hades252 permutation, one thread per
// state, for the CUDA kernels in perm.cu.
//
// A field element is 8 little-endian limbs of 32 bits. The Montgomery
// radix is R = 2^256, the same as the JAX package's 16 digits of 16 bits,
// so Montgomery-domain values agree bit for bit with it. Every value a
// function returns is reduced to [0, p): p is about 0.453 * 2^256, so
// 4p > 2^256 and the usual "inputs < 2p give outputs < 2p" lazy bound
// does not hold for these limbs.
//
// The header compiles for the host as well (without __CUDACC__ the
// constant tables are ordinary arrays), so the same code can be checked
// against a reference with a host compiler.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HADES_FN __device__ __forceinline__
#define HADES_HD __host__ __device__ __forceinline__
#define HADES_CONST __constant__
#else
#define HADES_FN static inline
#define HADES_HD static inline
#define HADES_CONST static
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

// Constant tables, Montgomery form, uploaded once per device by
// hades_init (perm.cu). Dense schedule: 11,520 B; sparse schedule
// 27,328 B with the MDS; both fit the 64 KB constant bank. Every thread of
// a warp reads the same entry in the same round: constant memory's
// broadcast case.
HADES_CONST uint32_t c_r2[kLimbs];                                 // R^2 mod p
HADES_CONST uint32_t c_ark[kRounds][kWidth][kLimbs];               // dense ARK
HADES_CONST uint32_t c_mds[kWidth][kWidth][kLimbs];                // MDS
HADES_CONST uint32_t c_ark_fr[kFullRounds][kWidth][kLimbs];        // full-round ARK
HADES_CONST uint32_t c_c0[kWidth][kLimbs];                         // chain entry shift
HADES_CONST uint32_t c_u[kPartialRounds][4][kLimbs];               // sparse column
HADES_CONST uint32_t c_w[kPartialRounds][4][kLimbs];               // sparse row
HADES_CONST uint32_t c_m[kLimbs];                                  // M[4][4]
HADES_CONST uint32_t c_d[kPartialRounds][kWidth][kLimbs];          // folded ARK
HADES_CONST uint32_t c_final[4][4][kLimbs];                        // A^59

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

HADES_FN void to_mont(uint32_t s[kWidth][kLimbs]) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) mont_mul(s[w], s[w], c_r2);
}

HADES_FN void from_mont(uint32_t s[kWidth][kLimbs]) {
  uint32_t one[kLimbs] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < kWidth; ++w) mont_mul(s[w], s[w], one);
}

// s <- MDS s: 25 Montgomery products, each row folded j-ascending.
HADES_FN void mds_layer(uint32_t s[kWidth][kLimbs]) {
  uint32_t out[kWidth][kLimbs];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    mont_mul(out[k], s[0], c_mds[k][0]);
#pragma unroll
    for (int j = 1; j < kWidth; ++j) {
      uint32_t t[kLimbs];
      mont_mul(t, s[j], c_mds[k][j]);
      add_mod(out[k], out[k], t);
    }
  }
#pragma unroll
  for (int k = 0; k < kWidth; ++k) copy(s[k], out[k]);
}

// ARK on all words -> x^5 on all words -> MDS.
HADES_FN void full_round(uint32_t s[kWidth][kLimbs],
                         const uint32_t ark[kWidth][kLimbs]) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
    add_mod(s[w], s[w], ark[w]);
    sbox(s[w], s[w]);
  }
  mds_layer(s);
}

// The dense schedule (the JAX package's _perm_kernel): 67 rounds of ARK,
// x^5 (all words in a full round, word 4 in a partial one) and the MDS.
HADES_FN void perm_naive(uint32_t s[kWidth][kLimbs], bool convert) {
  if (convert) to_mont(s);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    if (r < kHalf || r >= kHalf + kPartialRounds) {
      full_round(s, c_ark[r]);
    } else {
#pragma unroll
      for (int w = 0; w < kWidth; ++w) add_mod(s[w], s[w], c_ark[r][w]);
      sbox(s[kWidth - 1], s[kWidth - 1]);
      mds_layer(s);
    }
  }
  if (convert) from_mont(s);
}

// The sparse-factored schedule (the JAX package's _perm_kernel_opt):
// full rounds 0..3, the entry shift x = s + c0, 59 sparse rounds of 12
// products each (x^5 on word 4, then S_r with 9 non-identity entries),
// words 0..3 <- A^59 x[0:4], full rounds 4..7.
HADES_FN void perm_opt(uint32_t s[kWidth][kLimbs], bool convert) {
  if (convert) to_mont(s);
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round(s, c_ark_fr[r]);
#pragma unroll
  for (int w = 0; w < kWidth; ++w) add_mod(s[w], s[w], c_c0[w]);
#pragma unroll 1
  for (int r = 0; r < kPartialRounds; ++r) {
    uint32_t x4[kLimbs], n4[kLimbs], t[kLimbs];
    sbox(x4, s[4]);
    // n4 = w_r . x[0:4] + m x4, from the words before this round's update
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mont_mul(t, s[j], c_w[r][j]);
      if (j == 0) copy(n4, t); else add_mod(n4, n4, t);
    }
    mont_mul(t, x4, c_m);
    add_mod(n4, n4, t);
    // x[i] += u_r[i] x4, then the folded constants d_r
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mont_mul(t, x4, c_u[r][i]);
      add_mod(s[i], s[i], t);
      add_mod(s[i], s[i], c_d[r][i]);
    }
    add_mod(s[4], n4, c_d[r][4]);
  }
  {
    uint32_t fin[4][kLimbs], t[kLimbs];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mont_mul(fin[i], s[0], c_final[i][0]);
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        mont_mul(t, s[j], c_final[i][j]);
        add_mod(fin[i], fin[i], t);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) copy(s[i], fin[i]);
  }
#pragma unroll 1
  for (int r = kHalf; r < kFullRounds; ++r) full_round(s, c_ark_fr[r]);
  if (convert) from_mont(s);
}

}  // namespace hades
