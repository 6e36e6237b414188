// The `hyb` and `hybp` schedules' per-state code in the first port's shape:
// mxu8's full rounds around the full-expansion partial chain, for the block
// code of perm_hyb_block.cuh, which perm_hyb13.cu runs with the base-2^13
// S-box. perm_hybp.cuh takes its basis layout, tables and constants.
// Counterparts in hades252_tpu/ops/perm_pallas.py: _perm_kernel_hyb (:845),
// _perm_kernel_hybp (:945), _redc_wide_big (:818); the schedule itself is
// params.dot_schedule_int.
//
// The 59 partial rounds apply the S-box to word 4 only, so over the basis
//   e = [1, x_0..x_4, s_0..s_58]   (65 elements of 32 bytes)
// every S-box input t_r is a fixed linear map of e[:6+r] and so is the
// chain's output. A partial round is then one byte dot of the basis with
// that round's 63 x 32(6+r) Toeplitz weights (zero-padded to 32 or 64
// elements), one big REDC and one S-box, in place of the dense round's MDS
// dot and five REDCs.
//
// The code is written against perm_mxu8.cuh's dot object, which gains the
// basis buffer:
//   d.basis_put(j, words)   this state's basis element j <- 8 limbs;
//   d.run_basis(W, k)       64 x k weights (row-major bytes, k a multiple
//                           of 64) times the first k bytes of the basis;
//                           the sums are read with d.col(i), then d.done();
//   d.stage_new(W)          a 64 x 32 block of weights, where d.run reads it
//                           fastest (hybp's newest-element dot);
//   d.end_chain()           the last run_basis is over: w_lin, whose place
//                           the card's run_basis borrows, is needed again.
// A basis element's 32 bytes are its 8 limbs as stored (natural byte order;
// params._chain_tables permutes the weights' K axis to match). Elements not
// yet written meet zero weights, so their bytes never count and the buffer
// needs no clearing. A state's buffer is padded from 65 to 66 elements, so
// that every k is a multiple of the wide dot's 64-byte step; the 66th is
// never written and w_out's columns for it are zero.
//
// Bounds (perm_pallas.py:818-842): a dot sums up to 65 Montgomery products,
// T < 65p^2 < 2^517, 17 limbs; a column sum is < 65 * 32 * 255^2 < 2^28, so
// recombine's 64-bit accumulator (four columns shifted by up to 24 bits,
// plus a carry) stays below 2^53. (T + m p) / R < 0.453 * 65p + p < 31p <
// 2^260 takes 9 limbs and the five-rung ladder 16p .. p.

#pragma once

#include "perm_mxu8.cuh"

namespace hades {
namespace hyb {

using mxu8::kBlockRows;

constexpr int kBasis = 1 + kWidth + kPartialRounds;  // 65 elements
constexpr int kBasisBytes = 32 * (kBasis + 1);       // 2,112 B a state, the last 32 padding
constexpr int kSeg1Rounds = 27;                      // rounds 0..26: <= 32 elements
constexpr int kSeg1K = 32 * 32;
constexpr int kSeg2K = 32 * 64;                      // rounds 27..58: <= 64 elements
constexpr int kT = 2 * kLimbs + 1;                   // limbs of a dot's value

// The chain's weights, one flat byte array: the rounds of segment 1, those
// of segment 2, for hybp the 59 newest-element blocks, then the exit map.
constexpr int kSeg1Bytes = kSeg1Rounds * kBlockRows * kSeg1K;
constexpr int kSeg2Bytes = (kPartialRounds - kSeg1Rounds) * kBlockRows * kSeg2K;
constexpr int kNewBytes = kPartialRounds * kBlockRows * 32;
constexpr int kOutBytes = kWidth * kBlockRows * kBasisBytes;
constexpr int chain_bytes(bool pipelined) {
  return kSeg1Bytes + kSeg2Bytes + (pipelined ? kNewBytes : 0) + kOutBytes;
}
// the kernels' uint32 table: mxu8's (the dense ARK, R^2), then R mod p
constexpr int kConstWords = mxu8::kConstWords + kLimbs;

// t <- the value of the dot of the first k basis bytes with w, 17 limbs.
template <class Dot>
HADES_FN void basis_dot(Dot& d, uint32_t t[kT], const uint8_t* w, int k) {
  d.run_basis(w, k);
  mxu8::recombine<63, kT>(d, t);
  d.done();
}

// t <- the value of round r's dot over the basis (for hybp: without the
// newest element, whose block of the weights is zero).
template <class Dot>
HADES_FN void round_dot(Dot& d, uint32_t t[kT], const uint8_t* chain, int r) {
  if (r < kSeg1Rounds) {
    basis_dot(d, t, chain + r * (kBlockRows * kSeg1K), kSeg1K);
  } else {
    basis_dot(d, t, chain + kSeg1Bytes + (r - kSeg1Rounds) * (kBlockRows * kSeg2K), kSeg2K);
  }
}

// The 59 partial rounds and the chain's exit. In: the state after full
// round 3. Out: the state entering full round 63.
//
// kPipelined (hybp) runs the split of _perm_kernel_hybp in its order: round
// r's dot is the big one over the older elements, started before round
// r-1's S-box, plus a 64 x 32 dot of the newest element s_{r-1}, summed
// before the REDC. The big dot's value waits across the S-box as its 17
// limbs (recombining is linear, so the sum of the two values is the value
// of the summed columns), not as 63 column sums.
template <bool kPipelined, bool kSbox13 = false, class Dot>
HADES_FN void chain(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ one_mont,
                    const uint8_t* chain_w) {
  const uint8_t* w_new = chain_w + kSeg1Bytes + kSeg2Bytes;
  const uint8_t* w_out = w_new + (kPipelined ? kNewBytes : 0);
  uint32_t x[kLimbs], t[kT], older[kT];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) x[j] = one_mont[j];
  d.basis_put(0, x);
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    d.basis_put(1 + i, s[i]);
    // dead until the exit, which shifts it: no register of it stays live
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) s[i][j] = 0;
  }

#pragma unroll 1
  for (int r = 0; r < kPartialRounds; ++r) {
    if (!kPipelined || r == 0) {
      round_dot(d, t, chain_w, r);
    } else {
      const uint8_t* w = d.stage_new(w_new + r * (kBlockRows * 32));
      d.template put<kLimbs>(x);  // x = s_{r-1}
      d.template run<kBlockRows, 32>(w);
      mxu8::recombine<63, kT>(d, t);
      d.done();
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        c += (uint64_t)t[j] + older[j];
        t[j] = (uint32_t)c;
        c >>= 32;
      }
    }
    uint32_t u[kLimbs];
    mxu8::redc<kT, 5>(d, u, t, true);  // the S-box's input t_r
    if (kPipelined) {
      if (r > 0) d.basis_put(kWidth + r, x);  // s_{r-1} enters the basis
      if (r + 1 < kPartialRounds) round_dot(d, older, chain_w, r + 1);
    }
    mxu8::sbox<kSbox13>(d, u);  // s_r
    if (kPipelined) {
      copy(x, u);
    } else {
      d.basis_put(1 + kWidth + r, u);
    }
  }
  if (kPipelined) d.basis_put(kBasis - 1, x);  // s_58

  // The exit: one 64-row block of w_out and one big REDC per word. Each
  // turn shifts the (dead) state down a word and parks the result in word
  // 4, so after five turns word k holds output k.
#pragma unroll 1
  for (int k = 0; k < kWidth; ++k) {
    basis_dot(d, t, w_out + k * (kBlockRows * kBasisBytes), kBasisBytes);
    mxu8::redc<kT, 5>(d, x, t, true);
#pragma unroll
    for (int i = 0; i + 1 < kWidth; ++i) copy(s[i], s[i + 1]);
    copy(s[kWidth - 1], x);
  }
  d.end_chain();
}

// The permutation: full rounds 0..3 as mxu8's, the chain, full rounds
// 63..66. consts: kConstWords; chain_w: chain_bytes(kPipelined). kSbox13
// (hyb13, hybp13) takes every S-box's raw products, in the full rounds and
// the chain alike, in base-2^13 digits (mxu8::sbox).
template <bool kPipelined, bool kSbox13 = false, class Dot>
HADES_FN void perm(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts,
                   const uint8_t* chain_w, bool convert) {
  if (convert) mxu8::state_to_mont(s, consts);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    if (r == kHalf) {
      chain<kPipelined, kSbox13>(d, s, consts + mxu8::kConstWords, chain_w);
      r += kPartialRounds;
    }
    mxu8::dense_round<kSbox13>(d, s, consts, r, true);
  }
  if (convert) mxu8::state_from_mont(s);
}

#ifndef __CUDACC__
// The host's dot: mxu8's plain loops, and the basis as a byte array.
struct HostDot : mxu8::HostDot {
  uint8_t y[kBasisBytes];

  void basis_put(int j, const uint32_t* words) {
    for (int i = 0; i < kLimbs; ++i) {
      for (int b = 0; b < 4; ++b) y[32 * j + 4 * i + b] = (uint8_t)(words[i] >> (8 * b));
    }
  }
  void run_basis(const uint8_t* w, int k) {
    for (int m = 0; m < kBlockRows; ++m) {
      int32_t sum = 0;
      for (int i = 0; i < k; ++i) sum += (int32_t)w[m * k + i] * y[i];
      c[m] = sum;
    }
  }
  const uint8_t* stage_new(const uint8_t* w) { return w; }
  void end_chain() {}
};
#endif

}  // namespace hyb
}  // namespace hades
