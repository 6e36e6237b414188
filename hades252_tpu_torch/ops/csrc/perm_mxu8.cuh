// The `mxu8` schedule's per-state code in the first port's shape: the dense
// round with every constant product as a byte dot, the MDS layer and each
// Montgomery REDC alike, as the TPU kernel runs it. The chained kernels in
// that shape run their full rounds on it (perm_hyb.cuh: hyb13,
// hybp13); the dense kernels themselves now reduce on the CUDA cores
// (perm_dense.cuh). Counterparts in hades252_tpu/ops/perm_pallas.py:
// _perm_kernel_mxu_impl (:731), _MxuOps (:653), _redc_words_mxu (:580).
//
// The code is written against a "dot" object that multiplies constant byte
// weights by the byte rows of values, one column per state:
//   d.put<N>(words)   this state's N 32-bit words become its 4N byte rows;
//   d.run<M, K>(W)    M x K weights (row-major bytes) times the byte rows;
//   d.col(i)          this state's column sum i of the last run (< 2^24);
//   d.done()          the sums have been read and may be overwritten.
// On the card the dot is a block-wide tensor-core MMA through shared
// memory (mma_tile.cuh). For the host, below, it is a plain loop over the
// same weights, so the whole schedule compiles with a host C++ compiler
// and can be checked against the int oracle without a card.
//
// The byte rows of a word are its bytes in natural order: row k of a
// 256-bit value is its byte k, so its 32 rows are its 8 limbs as stored.
// The JAX package orders them low bytes of 16-bit digits, then high bytes;
// params._kernel_weights permutes the weights' K axis to match.

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

// t = a b exactly, 16 limbs: the S-box's variable x variable product, on
// the CUDA cores. a, b < 2^256 (they may be un-normalised below 2p).
HADES_FN void mul_wide(uint32_t t[2 * kLimbs], const uint32_t a[kLimbs],
                       const uint32_t b[kLimbs]) {
#pragma unroll
  for (int j = 0; j < 2 * kLimbs; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      c += (uint64_t)a[j] * b[i] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + kLimbs] = (uint32_t)c;
  }
}

// The last run's first M base-256 column sums (column i at bit 8i) ->
// L normalised 32-bit limbs of their value, mod 2^(32L): JAX's
// _recombine16 and _carry in one pass. A column is < 160 * 255^2 < 2^24,
// so a limb's four shifted columns plus the carry stay below 2^50.
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

// Montgomery REDC, out = T R^-1 mod p, with both constant products as dots
// (_redc_words_mxu, _redc_wide_big). T comes as NT normalised limbs, so
// JAX's _carry_lo (T mod R exact before the m step) is already done: NT = 16
// for an S-box product (T < 2.2p^2 < 2^512), 17 for a lazy sum of products.
//   m = T_lo p' mod R  (w_pp, the Toeplitz of p' truncated to 32 columns)
//   s = T + m p        (w_p, the Toeplitz of p), exactly divisible by R
// NT = 17: s / R < T / R + p < 2^RUNGS p is normalised by a ladder of RUNGS
// conditional subtracts: 2 for the MDS layer (T < 5p^2, s / R < 3.3p), 5
// for the hyb chain (T < 65p^2, s / R < 31p).
// NT = 16: s / R < 2p and `normalize` subtracts p; the S-box skips that
// for x^2 and x^4 (perm_pallas.py:594-599): x < p gives x^2 < 1.46p, so
// (x^2)^2 < 2.11p^2 < Rp keeps the next REDC exact and x^4 < 1.96p, and
// x^4 x < 1.96p^2 < Rp; every un-normalised value is < 2p < 2^256.
template <int NT, int RUNGS = (NT > 2 * kLimbs ? 2 : 0), class Dot>
HADES_FN void redc(Dot& d, uint32_t out[kLimbs], const uint32_t t[NT], bool normalize) {
  uint32_t m[kLimbs], mp[2 * kLimbs], s[kLimbs + 1];
  d.template put<kLimbs>(t);
  d.template run<32, 32>(d.w_pp);
  recombine<32, kLimbs>(d, m);
  d.done();
  d.template put<kLimbs>(m);
  d.template run<kBlockRows, 32>(d.w_p);
  recombine<2 * 32 - 1, 2 * kLimbs>(d, mp);  // m p < R p < 2^512
  d.done();
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 2 * kLimbs; ++j) {
    c += (uint64_t)mp[j] + t[j];
    if (j >= kLimbs) s[j - kLimbs] = (uint32_t)c;
    c >>= 32;
  }
  s[kLimbs] = (uint32_t)c + (NT > 2 * kLimbs ? t[NT - 1] : 0u);
  if (NT > 2 * kLimbs) ladder9<RUNGS>(s);
  copy(out, s);
  if (NT <= 2 * kLimbs && normalize) cond_sub_p(out, out);
}

// The S-box's raw products in base-2^13 digits, for the hyb13 and hybp13
// kernels (perm_pallas.py: _to13 :181, _mul13_cols :195, _sqr13_cols :208,
// _cols13_to16 :225). A value below 2^256 is 20 digits of 13 bits; a raw
// product of two digits is below 2^26, so a column of the schoolbook sums
// up to 20 of them in 32 bits with no lo/hi split: below 20 * 2^26 < 2^31
// for a product, and for a square (the off-diagonal sum doubled, plus the
// diagonal) below 21 * 2^26 < 2^31.
constexpr int kD13 = 20;
constexpr uint32_t kMask13 = (1u << 13) - 1;

// d <- the 20 thirteen-bit digits of a (8 limbs): bit windows, each over
// at most two limbs. a may be un-normalised (< 2p < 2^256).
HADES_FN void to13(uint32_t d[kD13], const uint32_t a[kLimbs]) {
#pragma unroll
  for (int k = 0; k < kD13; ++k) {
    const int j = (13 * k) / 32, r = (13 * k) % 32;
    uint32_t v = a[j] >> r;
    if (r + 13 > 32 && j + 1 < kLimbs) v |= a[j + 1] << (32 - r);
    d[k] = v & kMask13;
  }
}

// t = a b exactly, 16 limbs, from 13-bit digits: 400 raw products (210 for
// kSquare, whose caller passes a for b), a column at a time. Column k sits at bit
// 13 k and goes straight into the limbs through a 64-bit accumulator, so
// the 39 columns are never live together and there is no 16-bit column
// stage. The accumulator holds the columns so far, shifted down by the
// limbs already written: below 2^(31 + 13k mod 32 + 1) <= 2^63.
template <bool kSquare>
HADES_FN void mul13(uint32_t t[2 * kLimbs], const uint32_t a[kD13], const uint32_t b[kD13]) {
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * kD13 - 1; ++k) {
    uint32_t col = 0;
#pragma unroll
    for (int i = 0; i < kD13; ++i) {
      const int j = k - i;
      if (kSquare ? (i < j && j < kD13) : (j >= 0 && j < kD13)) col += a[i] * b[j];
    }
    if (kSquare) {
      col += col;
      if (k % 2 == 0) col += a[k / 2] * a[k / 2];
    }
    const int limb = (13 * k) / 32, prev = k ? (13 * (k - 1)) / 32 : 0;
    if (limb != prev) {
      t[prev] = (uint32_t)acc;
      acc >>= 32;
    }
    acc += (uint64_t)col << ((13 * k) % 32);
  }
  t[2 * kLimbs - 1] = (uint32_t)acc;  // column 38 opens limb 15; a b < 2^512
}

// x <- x^5 = (x^2)^2 x: raw products on the CUDA cores, reductions on the
// dot (_MxuOps.sbox_words). x < p in and out. kSbox13 takes the raw
// products in base-2^13 digits (sbox13=True, :687-700): the products'
// values, and so every REDC bound, are the same. The digits of x are
// worked out again for the last product, not kept across two REDCs.
template <bool kSbox13 = false, class Dot>
HADES_FN void sbox(Dot& d, uint32_t x[kLimbs]) {
  uint32_t t[2 * kLimbs], x2[kLimbs], x4[kLimbs];
  if (kSbox13) {
    uint32_t a[kD13], b[kD13];
    to13(a, x);
    mul13<true>(t, a, a);
    redc<2 * kLimbs>(d, x2, t, false);
    to13(a, x2);
    mul13<true>(t, a, a);
    redc<2 * kLimbs>(d, x4, t, false);
    to13(a, x4);
    to13(b, x);
    mul13<false>(t, a, b);
  } else {
    mul_wide(t, x, x);
    redc<2 * kLimbs>(d, x2, t, false);
    mul_wide(t, x2, x2);
    redc<2 * kLimbs>(d, x4, t, false);
    mul_wide(t, x4, x);
  }
  redc<2 * kLimbs>(d, x, t, true);
}

// s <- MDS s: the 160 byte rows of the state times w_lin, one 63-column
// block per output word (_MxuOps.mds_mxu), then one wide REDC per word.
// The REDCs run in a loop that is not unrolled, to keep one copy of the
// code: each turn reduces t[0], shifts t down and parks the result in
// t[4], so after five turns t[k] holds output word k.
template <class Dot>
HADES_FN void mds(Dot& d, uint32_t s[kWidth][kLimbs]) {
  constexpr int kT = 2 * kLimbs + 1;
  uint32_t t[kWidth][kT];
  d.template put<kWidth * kLimbs>(&s[0][0]);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    d.template run<kBlockRows, kLinK>(d.w_lin + k * kBlockRows * kLinK);
    recombine<63, kT>(d, t[k]);  // T_k < 5p^2 < 2^513
    d.done();
  }
#pragma unroll 1
  for (int k = 0; k < kWidth; ++k) {
    uint32_t r[kLimbs];
    redc<kT>(d, r, t[0], true);
#pragma unroll
    for (int i = 0; i + 1 < kWidth; ++i) {
#pragma unroll
      for (int j = 0; j < kT; ++j) t[i][j] = t[i + 1][j];
    }
    copy(t[kWidth - 1], r);
  }
#pragma unroll
  for (int k = 0; k < kWidth; ++k) copy(s[k], t[k]);
}

// One dense round (_MxuOps.round_fn): ARK by add_mod, x^5 on every word of
// a full round and on word 4 of a partial one, then the MDS dot. consts
// opens with the Montgomery ARK (kRounds x kWidth x kLimbs).
template <bool kSbox13 = false, class Dot>
HADES_FN void dense_round(Dot& d, uint32_t s[kWidth][kLimbs],
                          const uint32_t* __restrict__ consts, int r, bool full) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
    uint32_t a[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) a[j] = consts[(r * kWidth + w) * kLimbs + j];
    add_mod(s[w], s[w], a);
  }
  // One copy of the S-box code: word 4 is S-boxed, and in a full round
  // the state is rotated by a word after each, five times over.
#pragma unroll 1
  for (int i = 0; i < (full ? kWidth : 1); ++i) {
    sbox<kSbox13>(d, s[kWidth - 1]);
    if (full) {
      uint32_t last[kLimbs];
      copy(last, s[kWidth - 1]);
#pragma unroll
      for (int w = kWidth - 1; w > 0; --w) copy(s[w], s[w - 1]);
      copy(s[0], last);
    }
  }
  mds(d, s);
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

#ifndef __CUDACC__
// The host's dot: a plain loop over the same byte weights.
struct HostDot {
  const uint8_t* w_lin;
  const uint8_t* w_pp;
  const uint8_t* w_p;
  uint8_t x[kLinK];
  int32_t c[kBlockRows];

  template <int N>
  void put(const uint32_t* words) {
    for (int i = 0; i < N; ++i) {
      for (int b = 0; b < 4; ++b) x[4 * i + b] = (uint8_t)(words[i] >> (8 * b));
    }
  }
  template <int M, int K>
  void run(const uint8_t* w) {
    for (int m = 0; m < M; ++m) {
      int32_t sum = 0;
      for (int k = 0; k < K; ++k) sum += (int32_t)w[m * K + k] * x[k];
      c[m] = sum;
    }
  }
  uint32_t col(int i) const { return (uint32_t)c[i]; }
  void done() {}
};
#endif

}  // namespace mxu8
}  // namespace hades
