// The sizes and helpers that the dot kernels' per-state code shares
// (perm_dense.cuh for `mxu8` and `mxu`, perm_hybp.cuh for `hyb`, `hybp`,
// `hyb13` and `hybp13`): the byte weights' shapes, the recombination of a
// dot's base-256 column sums into limbs, the ladder of conditional
// subtracts after a wide reduction, and the state's way into the Montgomery
// domain and out. Counterparts in hades252_tpu/ops/perm_pallas.py:
// _MxuOps (:653), _redc_wide_big (:818).
//
// A dot multiplies constant byte weights by the byte rows of values, one
// column per state. The byte rows of a word are its bytes in natural order:
// row k of a 256-bit value is its byte k, so its 32 rows are its 8 limbs as
// stored. The JAX package orders them low bytes of 16-bit digits, then high
// bytes; params._kernel_weights permutes the weights' K axis to match.

#pragma once

#include "field.cuh"

namespace hades {
namespace mxu8 {

constexpr int kBlockRows = 64;                     // 63 columns, padded to 64
constexpr int kLinK = kWidth * 4 * kLimbs;         // 160 byte rows of a state
constexpr int kLinBytes = kWidth * kBlockRows * kLinK;  // w_lin: 51,200 B
constexpr int kPpBytes = 32 * 32;                       // w_pp:   1,024 B
constexpr int kPBytes = kBlockRows * 32;                // w_p:    2,048 B
constexpr int kWeightBytes = kLinBytes + kPpBytes + kPBytes;
// the kernel's uint32 table: the dense ARK, then R^2
constexpr int kConstWords = kRounds * kWidth * kLimbs + kLimbs;

// t <- t - m where t >= m, for 9-limb values.
HADES_FN void cond_sub9(uint32_t t[kLimbs + 1], const uint32_t m[kLimbs + 1]) {
  uint32_t d[kLimbs + 1];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j <= kLimbs; ++j) {
    const uint64_t x = (uint64_t)t[j] - m[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
#pragma unroll
  for (int j = 0; j <= kLimbs; ++j) t[j] = borrow ? t[j] : d[j];
}

// The dot's first M base-256 column sums (column i at bit 8i, d.col(i)) ->
// L normalised 32-bit limbs of their value, mod 2^(32L): JAX's
// _recombine16 and _carry in one pass. A column is below 160 * 255^2 <
// 2^24 for an MDS dot and below 65 * 32 * 255^2 < 2^28 for a dot over the
// chain's basis, so a limb's four shifted columns plus the carry stay
// below 2^53.
template <int M, int L, class Dot>
HADES_FN void recombine(const Dot& d, uint32_t out[L]) {
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (4 * j + b < M) acc += (uint64_t)d.col(4 * j + b) << (8 * b);
    }
    out[j] = (uint32_t)acc;
    acc >>= 32;
  }
}

// t <- t mod p for a 9-limb t < 2^RUNGS p: conditional subtracts of
// 2^(RUNGS-1) p, .., 2p, p. 16p < 2^260 fits 9 limbs, so RUNGS <= 5.
template <int RUNGS>
HADES_FN void ladder9(uint32_t t[kLimbs + 1]) {
  static_assert(RUNGS >= 0 && RUNGS <= 5, "2^(RUNGS-1) p must fit 9 limbs");
#pragma unroll
  for (int sh = RUNGS - 1; sh >= 0; --sh) {
    uint32_t m[kLimbs + 1];
#pragma unroll
    for (int j = 0; j <= kLimbs; ++j) {
      const uint32_t lo = j < kLimbs ? p_limb(j) : 0u;
      const uint32_t below = j ? p_limb(j - 1) : 0u;
      m[j] = sh == 0 ? lo : (lo << sh) | (below >> ((32 - sh) & 31));
    }
    cond_sub9(t, m);
  }
}

// The state into the Montgomery domain (times R^2, which follows the ARK in
// consts) and back out (times 1): CIOS products, as the TPU kernel's are
// VPU products.
HADES_FN void state_to_mont(uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts) {
  uint32_t r2[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r2[j] = consts[kRounds * kWidth * kLimbs + j];
#pragma unroll
  for (int w = 0; w < kWidth; ++w) mont_mul(s[w], s[w], r2);
}

HADES_FN void state_from_mont(uint32_t s[kWidth][kLimbs]) {
  const uint32_t one[kLimbs] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < kWidth; ++w) mont_mul(s[w], s[w], one);
}

}  // namespace mxu8
}  // namespace hades
