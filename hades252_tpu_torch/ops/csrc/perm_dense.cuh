// The dense schedules' per-state code on this card, for the `mxu8` and `mxu`
// kernels (perm_dense_block.cuh, perm_mxu8.cu, perm_mxu.cu), and the MDS
// layer and full round that the chained kernels' consumer shares
// (perm_hybp.cuh: `hyb`, `hybp`, and `hyb13`, `hybp13` with the base-2^13
// S-box). Counterparts in hades252_tpu/ops/perm_pallas.py:
// _perm_kernel_mxu_impl (:731), _MxuOps (:653).
//
// The TPU kernel runs every constant product as a byte dot: the MDS layer
// with w_lin, and both halves of each of the 632 Montgomery reductions with
// w_pp and w_p, because the TPU's vector unit has no widening multiply. This
// card's CUDA cores have one, so here a reduction is field.cuh's carry
// chains in a thread's registers (redc_steps, 8 steps of 6 multiply-add
// pairs) and the S-box is field.cuh's (two squares and a product, each
// reduced at once). The one product left on the tensor cores is the MDS
// layer's: the state's 160 bytes times the five 64-row blocks of w_lin.
//
// The code is written against a dot object for that product:
//   d.mds_put(words)   this state's 40 words, its 160 byte rows (natural byte
//                      order: byte k of the state is row k);
//   d.mds_run(k)       block k of w_lin (64 x 160) times them;
//   d.col(i)           this state's column sum i of the last run (< 2^24);
//   d.mds_done()       the sums have been read and may be overwritten.
// On the card it is a tensor-core product through shared memory; for the
// host, below, a plain loop over the same weights, so that the whole
// schedule compiles with a host C++ compiler and runs against the int
// oracle without a card.

#pragma once

#include "perm_mxu8.cuh"

namespace hades {
namespace dense {

using mxu8::kBlockRows;
using mxu8::kLinK;
constexpr int kT = 2 * kLimbs + 1;  // limbs of a dot's value

// out <- T R^-1 mod p for a 17-limb T whose (T + M p) / R is below 2^RUNGS p
// (2 rungs after an MDS dot, T < 5p^2: (T + M p) / R < 3.3p; 5 after a
// chain dot, T < 65p^2: < 31p): the reduction on the CUDA cores, then the
// ladder of RUNGS conditional subtracts.
template <int RUNGS>
HADES_FN void redc_big(uint32_t out[kLimbs], uint32_t t[kT]) {
  redc_steps<kT>(t);
  mxu8::ladder9<RUNGS>(t + kLimbs);
  copy(out, t + kLimbs);
}

// s <- MDS s: one dot of the state's 160 bytes per output word (63 base-256
// columns), then the five values T < 5p^2 reduced together, five
// independent chains side by side (two rungs each: (T + M p) / R < 3.3p).
// Word k of s is overwritten only after all its bytes were put.
template <class Dot>
HADES_FN void mds(Dot& d, uint32_t s[kWidth][kLimbs]) {
  uint32_t t[kWidth][kT];
  d.mds_put(&s[0][0]);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    d.mds_run(k);
    mxu8::recombine<63, kT>(d, t[k]);
    d.mds_done();
  }
#pragma unroll
  for (int k = 0; k < kWidth; ++k) redc_big<2>(s[k], t[k]);
}

// One round (_MxuOps.round_fn): ARK, x^5 on every word of a full round (one copy of the S-box:
// word 4 is S-boxed and the state rotated by a word, five times over) and on
// word 4 of a partial one, then the MDS dot. consts opens with the
// Montgomery ARK (kRounds x kWidth x kLimbs). kSbox13 takes field.cuh's
// sbox13 (hyb13, hybp13) in place of sbox.
template <bool kSbox13 = false, class Dot>
HADES_FN void round_fn(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts,
                    int r, bool full) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {
    uint32_t a[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) a[j] = consts[(r * kWidth + w) * kLimbs + j];
    add_mod(s[w], s[w], a);
  }
#pragma unroll 1
  for (int i = 0; i < (full ? kWidth : 1); ++i) {
    uint32_t x[kLimbs];
    sbox_of<kSbox13>(x, s[kWidth - 1]);
    if (full) {
#pragma unroll
      for (int w = kWidth - 1; w > 0; --w) copy(s[w], s[w - 1]);
      copy(s[0], x);
    } else {
      copy(s[kWidth - 1], x);
    }
  }
  mds(d, s);
}

template <bool kSbox13 = false, class Dot>
HADES_FN void full_round(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts,
                         int r) {
  round_fn<kSbox13>(d, s, consts, r, true);
}

// The 67 dense rounds (_perm_kernel_mxu_impl). consts: the Montgomery ARK,
// then R^2 (mxu8::kConstWords).
template <class Dot>
HADES_FN void perm(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts,
                   bool convert) {
  if (convert) mxu8::state_to_mont(s, consts);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    round_fn(d, s, consts, r, r < kHalf || r >= kHalf + kPartialRounds);
  }
  if (convert) mxu8::state_from_mont(s);
}

#ifndef __CUDACC__
// The host's dot: w_lin row-major, (320, 160), as bytes (W = uint8_t, mxu8)
// or as the bits of bf16 values with float sums (W = uint16_t, mxu), as the
// two kernels read them.
template <class W = uint8_t>
struct HostDot {
  const W* w_lin;
  uint8_t x[kLinK];
  int32_t c[kBlockRows];

  void mds_put(const uint32_t* words) {
    for (int i = 0; i < kWidth * kLimbs; ++i) {
      for (int b = 0; b < 4; ++b) x[4 * i + b] = (uint8_t)(words[i] >> (8 * b));
    }
  }
  static float widen(uint16_t bits) {
    const uint32_t u = (uint32_t)bits << 16;
    float f;
    __builtin_memcpy(&f, &u, 4);
    return f;
  }
  void mds_run(int k) {
    const W* w = w_lin + k * kBlockRows * kLinK;
    for (int m = 0; m < kBlockRows; ++m) {
      int32_t sum = 0;
      float fsum = 0.0f;
      for (int i = 0; i < kLinK; ++i) {
        if (sizeof(W) == 1) sum += (int32_t)w[m * kLinK + i] * x[i];
        else fsum += widen((uint16_t)w[m * kLinK + i]) * (float)x[i];
      }
      c[m] = sizeof(W) == 1 ? sum : (int32_t)fsum;
    }
  }
  void mds_done() {}
  uint32_t col(int i) const { return (uint32_t)c[i]; }
};
#endif

}  // namespace dense
}  // namespace hades
