// Field arithmetic in a thread's registers, and the planar state layout,
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

// ---------------------------------------------------------------------------
// Carry chains
// ---------------------------------------------------------------------------
// The products below are written for the card's 32-bit multiply-add pipe:
// chains of mad.lo.cc / madc.hi.cc that keep the carry in the flag, with no
// 64-bit accumulator and no carry moves. Each step of a chain is one of the
// primitives here, a single PTX instruction on the card. The host's bodies
// do the same arithmetic in plain C with the flag in a Carry object, so the
// chains themselves (one text for both) run under a host compiler. On the
// card the flag is the hardware's: a chain's steps are consecutive
// `asm volatile` statements with nothing that writes the flag between them,
// and the Carry object is empty.

struct Carry {
#ifndef __CUDACC__
  uint32_t f = 0;
#endif
};

#ifdef __CUDACC__
#define HADES_CHAIN3(name, ptx)                                                   \
  HADES_FN uint32_t name(Carry&, uint32_t a, uint32_t b, uint32_t c) {            \
    uint32_t r;                                                                   \
    asm volatile(ptx " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));      \
    return r;                                                                     \
  }
#define HADES_CHAIN2(name, ptx)                                                   \
  HADES_FN uint32_t name(Carry&, uint32_t a, uint32_t b) {                        \
    uint32_t r;                                                                   \
    asm volatile(ptx " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                  \
    return r;                                                                     \
  }
HADES_CHAIN2(add_cc, "add.cc.u32")     // a + b, writes the flag
HADES_CHAIN2(addc_cc, "addc.cc.u32")   // a + b + flag, writes the flag
HADES_CHAIN2(addc, "addc.u32")         // a + b + flag
HADES_CHAIN2(sub_cc, "sub.cc.u32")     // a - b, writes the borrow
HADES_CHAIN2(subc_cc, "subc.cc.u32")   // a - b - borrow, writes the borrow
HADES_CHAIN2(subc, "subc.u32")         // a - b - borrow
HADES_CHAIN3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a b) + c, writes the flag
HADES_CHAIN3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a b) + c + flag, writes the flag
HADES_CHAIN3(mad_hi_cc, "mad.hi.cc.u32")    // hi(a b) + c, writes the flag
HADES_CHAIN3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a b) + c + flag, writes the flag
HADES_CHAIN3(madc_hi, "madc.hi.u32")        // hi(a b) + c + flag
#undef HADES_CHAIN2
#undef HADES_CHAIN3
HADES_FN uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#else
HADES_FN uint32_t chain_sum(Carry& k, uint64_t s, bool write) {
  if (write) k.f = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
HADES_FN uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
HADES_FN uint32_t add_cc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a + b, true); }
HADES_FN uint32_t addc_cc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a + b + k.f, true); }
HADES_FN uint32_t addc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a + b + k.f, false); }
HADES_FN uint32_t sub_cc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a - b, true); }
HADES_FN uint32_t subc_cc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a - b - k.f, true); }
HADES_FN uint32_t subc(Carry& k, uint32_t a, uint32_t b) { return chain_sum(k, (uint64_t)a - b - k.f, false); }
HADES_FN uint32_t mad_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) { return chain_sum(k, (uint64_t)(uint32_t)(a * b) + c, true); }
HADES_FN uint32_t madc_lo_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) { return chain_sum(k, (uint64_t)(uint32_t)(a * b) + c + k.f, true); }
HADES_FN uint32_t mad_hi_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) { return chain_sum(k, (uint64_t)mul_hi(a, b) + c, true); }
HADES_FN uint32_t madc_hi_cc(Carry& k, uint32_t a, uint32_t b, uint32_t c) { return chain_sum(k, (uint64_t)mul_hi(a, b) + c + k.f, true); }
HADES_FN uint32_t madc_hi(Carry& k, uint32_t a, uint32_t b, uint32_t c) { return chain_sum(k, (uint64_t)mul_hi(a, b) + c + k.f, false); }
#endif

// r = t - p if t >= p, else t. Needs t < 2p. r may alias t.
HADES_FN void cond_sub_p(uint32_t r[kLimbs], const uint32_t t[kLimbs]) {
  uint32_t d[kLimbs];
  Carry k;
  d[0] = sub_cc(k, t[0], p_limb(0));
#pragma unroll
  for (int j = 1; j < kLimbs; ++j) d[j] = subc_cc(k, t[j], p_limb(j));
  const uint32_t borrow = subc(k, 0u, 0u);  // all ones when t < p
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = borrow ? t[j] : d[j];
}

// r = (a + b) mod p for a, b < p. a + b < 2p < 2^256: no carry out.
HADES_FN void add_mod(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                      const uint32_t b[kLimbs]) {
  uint32_t s[kLimbs];
  Carry k;
  s[0] = add_cc(k, a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kLimbs - 1; ++j) s[j] = addc_cc(k, a[j], b[j]);
  s[kLimbs - 1] = addc(k, a[kLimbs - 1], b[kLimbs - 1]);
  cond_sub_p(r, s);
}

// A 32 x 32 -> 64-bit product is a mad.lo and a mad.hi with the same
// operands; written one after the other onto neighbouring limbs, with the
// carry running through, the assembler makes one wide multiply-add with
// carry of the pair. A chain of such pairs covers consecutive limbs two at
// a time, so the products of one row that start at even limbs and those
// that start at odd limbs are two chains, and each keeps an accumulator of
// its own, `e` and `o`: pairs of one accumulator never straddle each other.
// The value is e + o, added up once at the end.
//
// chain_row adds a[j0] x, a[j0 + 2] x, .. (j < JN) at limbs pos, pos + 2, ..
// of acc, and the chain's last carry at the limb after the last pair when
// kCarry says that limb exists and can take it.
template <int J0, int JN, bool kCarry>
HADES_FN void chain_row(uint32_t* acc, int pos, const uint32_t* a, uint32_t x) {
  Carry k;
  acc[pos] = mad_lo_cc(k, a[J0], x, acc[pos]);
  acc[pos + 1] = madc_hi_cc(k, a[J0], x, acc[pos + 1]);
#pragma unroll
  for (int j = J0 + 2; j < JN; j += 2) {
    acc[pos + j - J0] = madc_lo_cc(k, a[j], x, acc[pos + j - J0]);
    acc[pos + j - J0 + 1] = madc_hi_cc(k, a[j], x, acc[pos + j - J0 + 1]);
  }
  constexpr int kPairs = (JN - J0 + 1) / 2;
  if (kCarry) acc[pos + 2 * kPairs] = addc(k, acc[pos + 2 * kPairs], 0u);
}

// t = e + o for 16-limb accumulators whose sum is below 2^512; o[0] is 0.
HADES_FN void merge_even_odd(uint32_t t[2 * kLimbs], const uint32_t e[2 * kLimbs],
                             const uint32_t o[2 * kLimbs]) {
  Carry k;
  t[0] = e[0];
  t[1] = add_cc(k, e[1], o[1]);
#pragma unroll
  for (int j = 2; j < 2 * kLimbs - 1; ++j) t[j] = addc_cc(k, e[j], o[j]);
  t[2 * kLimbs - 1] = addc(k, e[2 * kLimbs - 1], o[2 * kLimbs - 1]);
}

// t = a b exactly, 16 limbs, for any a, b < 2^256: operand scanning, 64
// wide products. Row i adds a_j b_i at limb i + j: the even j as one chain
// over limbs i .. i + 7, the odd j as another over limbs i + 1 .. i + 8.
// Each accumulator is a sum of some of the products, so it stays below the
// sum of the rows so far, 2^(32 (i + 9)): the first chain's carry lands in
// limb i + 8, which nothing has written yet in that accumulator, and the
// second chain has no carry out of limb i + 8.
HADES_FN void mul_wide8(uint32_t t[2 * kLimbs], const uint32_t a[kLimbs],
                        const uint32_t b[kLimbs]) {
  uint32_t e[2 * kLimbs], o[2 * kLimbs];
#pragma unroll
  for (int j = 0; j < 2 * kLimbs; ++j) e[j] = o[j] = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    chain_row<0, kLimbs, true>(i % 2 ? o : e, i, a, b[i]);
    chain_row<1, kLimbs, false>(i % 2 ? e : o, i + 1, a, b[i]);
  }
  merge_even_odd(t, e, o);
}

// The products a_j a_i above the diagonal (j > i), once: row i as two chains,
// j = i + 1, i + 3, .. and j = i + 2, i + 4, .. A chain's last carry lands in
// a limb that so far holds at most other chains' carries.
template <int I>
HADES_FN void sqr_rows(uint32_t* e, uint32_t* o, const uint32_t a[kLimbs]) {
  if constexpr (I < kLimbs - 1) {
    // first chain: limbs 2 I + 1 .., odd; second: limbs 2 I + 2 .., even
    chain_row<I + 1, kLimbs, true>(o, 2 * I + 1, a, a[I]);
    if constexpr (I + 2 < kLimbs) {
      constexpr int kEnd = 2 * I + 2 + 2 * ((kLimbs - I - 1) / 2);  // its carry's limb
      chain_row<I + 2, kLimbs, (kEnd < 2 * kLimbs)>(e, 2 * I + 2, a, a[I]);
    }
    sqr_rows<I + 1>(e, o, a);
  }
}

// t = a^2 exactly, 16 limbs: the 28 products above the diagonal once,
// doubled, plus the 8 squares of the diagonal (one chain of pairs over all
// 16 limbs): 36 wide products in place of 64.
HADES_FN void sqr_wide8(uint32_t t[2 * kLimbs], const uint32_t a[kLimbs]) {
  uint32_t e[2 * kLimbs], o[2 * kLimbs];
#pragma unroll
  for (int j = 0; j < 2 * kLimbs; ++j) e[j] = o[j] = 0u;
  sqr_rows<0>(e, o, a);
  merge_even_odd(t, e, o);  // below 2^511: the doubling fits
  Carry k;
  t[1] = add_cc(k, t[1], t[1]);
#pragma unroll
  for (int j = 2; j < 2 * kLimbs - 1; ++j) t[j] = addc_cc(k, t[j], t[j]);
  t[2 * kLimbs - 1] = addc(k, t[2 * kLimbs - 1], t[2 * kLimbs - 1]);
  t[0] = mad_lo_cc(k, a[0], a[0], 0u);
  t[1] = madc_hi_cc(k, a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) {
    t[2 * i] = madc_lo_cc(k, a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(k, a[i], a[i], t[2 * i + 1]);
  }
}

// Montgomery reduction in place: t (NT = 16 or 17 limbs) <- t + M p with
// M = sum m_i 2^(32 i) chosen so that the low 8 limbs vanish; the quotient
// (t + M p) / R is then t[8 .. NT-1]. The caller's t + R p is below
// 2^(32 NT), so no carry leaves the top.
//
// The running value is e + o + c: e starts as t, o and c as 0. Step i reads
// limb i of the sum (with the carry `low` out of the limbs below), takes
// m_i = -limb (p = 1 mod 2^32, so that limb becomes 0 and carries when it
// was not 0), and adds m_i times the other limbs of p. Limb 1 of p is 2^32 -
// 1: m_i p_1 is the pair (m_i - (m_i != 0), -m_i), a negate and a subtract,
// no multiply. With it the odd limbs of p are one chain of pairs over limbs
// i + 1 .. i + 8 and the even limbs 2, 4, 6 another over i + 2 .. i + 7; the
// two go to the accumulator whose pairs they match, and each chain's last
// carry to c, whose limbs only count carries. The next m needs limb i + 1
// only: the multiply-adds are off the path from one step to the next.
template <int NT>
HADES_FN void redc_steps(uint32_t t[NT]) {
  static_assert(NT == 2 * kLimbs || NT == 2 * kLimbs + 1, "16 or 17 limbs");
  uint32_t o[2 * kLimbs + 1], c[2 * kLimbs + 2];
#pragma unroll
  for (int j = 0; j <= 2 * kLimbs; ++j) o[j] = 0u;
#pragma unroll
  for (int j = 0; j <= 2 * kLimbs + 1; ++j) c[j] = 0u;
  uint32_t low = 0u;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    uint32_t* x = i % 2 ? o : t;  // pairs that start at limbs of i's parity
    uint32_t* y = i % 2 ? t : o;
    Carry k;
    uint32_t v = add_cc(k, t[i], o[i]);
    uint32_t h = addc(k, 0u, 0u);
    v = add_cc(k, v, low);
    h = addc(k, h, 0u);
    const uint32_t m = 0u - v;
    low = h + (v != 0u ? 1u : 0u);
    y[i + 1] = add_cc(k, y[i + 1], v);                              // lo(m p_1) = -m
    y[i + 2] = addc_cc(k, y[i + 2], m - (m != 0u ? 1u : 0u));       // hi(m p_1)
#pragma unroll
    for (int j = 3; j < kLimbs; j += 2) {
      y[i + j] = madc_lo_cc(k, m, p_limb(j), y[i + j]);
      y[i + j + 1] = madc_hi_cc(k, m, p_limb(j), y[i + j + 1]);
    }
    c[i + kLimbs + 1] += addc(k, 0u, 0u);
    x[i + 2] = mad_lo_cc(k, m, p_limb(2), x[i + 2]);
    x[i + 3] = madc_hi_cc(k, m, p_limb(2), x[i + 3]);
#pragma unroll
    for (int j = 4; j < kLimbs; j += 2) {
      x[i + j] = madc_lo_cc(k, m, p_limb(j), x[i + j]);
      x[i + j + 1] = madc_hi_cc(k, m, p_limb(j), x[i + j + 1]);
    }
    c[i + kLimbs] += addc(k, 0u, 0u);
  }
  // the quotient: limbs 8 .. NT-1 of e + o + c, and the carry out of limb 7
  c[kLimbs] += low;
  Carry k;
  t[kLimbs] = add_cc(k, t[kLimbs], o[kLimbs]);
#pragma unroll
  for (int j = kLimbs + 1; j < NT; ++j) t[j] = addc_cc(k, t[j], o[j]);
  t[kLimbs] = add_cc(k, t[kLimbs], c[kLimbs]);
#pragma unroll
  for (int j = kLimbs + 1; j < NT; ++j) t[j] = addc_cc(k, t[j], c[j]);
}

// r = T R^-1 mod p for a 16-limb T < R p whose quotient stays below 2p
// (T < p^2 gives (T + M p) / R < p^2 / R + p < 2p).
HADES_FN void redc(uint32_t r[kLimbs], uint32_t t[2 * kLimbs]) {
  redc_steps<2 * kLimbs>(t);
  cond_sub_p(r, t + kLimbs);
}

// r = a b R^{-1} mod p for a, b < p. r may alias a or b.
HADES_FN void mont_mul(uint32_t r[kLimbs], const uint32_t a[kLimbs],
                       const uint32_t b[kLimbs]) {
  uint32_t t[2 * kLimbs];
  mul_wide8(t, a, b);
  redc(r, t);
}

// r = a^2 R^{-1} mod p for a < p. r may alias a.
HADES_FN void mont_sqr(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
  uint32_t t[2 * kLimbs];
  sqr_wide8(t, a);
  redc(r, t);
}

HADES_FN void copy(uint32_t r[kLimbs], const uint32_t a[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) r[j] = a[j];
}

// x^5 = (x^2)^2 x: two squarings and a product. r may alias x.
HADES_FN void sbox(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {
  uint32_t x2[kLimbs], x4[kLimbs];
  mont_sqr(x2, x);
  mont_sqr(x4, x2);
  mont_mul(r, x4, x);
}

// ---------------------------------------------------------------------------
// The S-box's raw products in base-2^13 digits, for the hyb13 and hybp13
// kernels (hades252_tpu/ops/perm_pallas.py: _to13 :181, _mul13_cols :195,
// _sqr13_cols :208, _cols13_to16 :225). A value below 2^256 is 20 digits of
// 13 bits; a raw product of two digits is below 2^26, so a column of the
// schoolbook sums up to 20 of them in 32 bits with no lo/hi split and no
// carry: below 20 * 2^26 < 2^31 for a product, and for a square (the
// off-diagonal sum doubled, plus the diagonal) below 21 * 2^26 < 2^31.
// ---------------------------------------------------------------------------
constexpr int kD13 = 20;
constexpr uint32_t kMask13 = (1u << 13) - 1;

// d <- the 20 thirteen-bit digits of a (8 limbs): bit windows, each over
// at most two limbs. a may be any value below 2^256.
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
// kSquare, whose caller passes a for b), a column at a time. Column k sits
// at bit 13 k and goes straight into the limbs through a 64-bit
// accumulator, so the 39 columns are never live together and there is no
// 16-bit column stage. The accumulator holds the columns so far, shifted
// down by the limbs already written: below 2^(31 + 13k mod 32 + 1) <= 2^63.
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

// x^5 = (x^2)^2 x as sbox computes it, with the three raw products in
// base-2^13 digits (sbox13=True, perm_pallas.py:687-700). A product's value
// is the same whichever base computes it, and each is reduced at once by
// the same redc as mont_sqr's and mont_mul's, so x^2, x^4 and x^5 are
// bit-identical to sbox's. x < p; r may alias x. The digits of x are
// worked out again for the last product, not kept across two reductions.
HADES_FN void sbox13(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {
  uint32_t a[kD13], b[kD13], t[2 * kLimbs], x4[kLimbs];
  to13(a, x);
  mul13<true>(t, a, a);
  redc(x4, t);  // x^2
  to13(a, x4);
  mul13<true>(t, a, a);
  redc(x4, t);
  to13(a, x4);
  to13(b, x);
  mul13<false>(t, a, b);
  redc(r, t);
}

// The S-box of a kernel: sbox, or sbox13 for hyb13 and hybp13.
template <bool kSbox13>
HADES_FN void sbox_of(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {
  if constexpr (kSbox13) {
    sbox13(r, x);
  } else {
    sbox(r, x);
  }
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

// One word of state b: 16 digits in, 8 limbs out, and back.
HADES_FN void load_word(uint32_t s[kLimbs], const int32_t* __restrict__ x, int w, long long b,
                        long long n) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const uint32_t lo = (uint32_t)x[(long long)(w * kDigits + 2 * k) * n + b];
    const uint32_t hi = (uint32_t)x[(long long)(w * kDigits + 2 * k + 1) * n + b];
    s[k] = lo | (hi << 16);
  }
}

HADES_FN void store_word(int32_t* __restrict__ out, const uint32_t s[kLimbs], int w, long long b,
                         long long n) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    out[(long long)(w * kDigits + 2 * k) * n + b] = (int32_t)(s[k] & 0xFFFFu);
    out[(long long)(w * kDigits + 2 * k + 1) * n + b] = (int32_t)(s[k] >> 16);
  }
}

HADES_FN void load_state(uint32_t s[kWidth][kLimbs], const int32_t* __restrict__ x,
                         long long b, long long n) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) load_word(s[w], x, w, b, n);
}

HADES_FN void store_state(int32_t* __restrict__ out, const uint32_t s[kWidth][kLimbs],
                          long long b, long long n) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) store_word(out, s[w], w, b, n);
}

// Blocks of `threads` for a batch of n states, or 0 when n is out of range.
static inline unsigned grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (n <= 0 || blocks > 0x7FFFFFFFLL) ? 0u : (unsigned)blocks;
}

}  // namespace hades
