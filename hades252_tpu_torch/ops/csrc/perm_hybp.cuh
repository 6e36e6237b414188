// The chained schedules' per-state code for the kernels in perm_hybp.cu
// (`hybp`, `hyb`, and `hybp13`, `hyb13` with the base-2^13 S-box): the
// consumer's side of a block that is split into a consumer, which walks
// the states through the rounds, and a producer, which runs the chain's
// dots (perm_hybp.cu). Counterparts in hades252_tpu/ops/perm_pallas.py:
// _perm_kernel_hybp (:945), _perm_kernel_hyb (:845), both with sbox13
// False or True, _redc_wide_big (:818); the schedule is
// params.dot_schedule_int and the weights are params.hybp_tables and
// params.hyb_tables. The consumer's code is the same for all four but for
// the S-box: only the producer's job table (below) and the dot object
// differ between the split and the whole dot.
//
// The 59 partial rounds apply the S-box to word 4 only, so over the basis
//   e = [1, x_0..x_4, s_0..s_58]   (65 elements of 32 bytes)
// every S-box input t_r is a fixed linear map of e[:6+r] and so is the
// chain's output. A partial round is then one byte dot of the basis with
// that round's 63 x 32(6+r) Toeplitz weights (zero-padded to 32 or 64
// elements), one big reduction and one S-box, in place of the dense
// round's MDS dot and five reductions. A basis element's 32 bytes are its
// 8 limbs as stored (natural byte order; params._chain_tables permutes the
// weights' K axis to match). A state's basis is padded from 65 to 66
// elements, so that every K is a multiple of 64 bytes; the 66th is never
// written and w_out's columns for it are zero.
//
// Bounds (perm_pallas.py:818-842): a dot sums up to 65 Montgomery
// products, T < 65p^2 < 2^517, 17 limbs; (T + m p) / R < 0.453 * 65p + p <
// 31p < 2^260 takes 9 limbs and the five-rung ladder 16p .. p.
//
// What the TPU kernel did and this one does otherwise. There every
// Montgomery reduction is two more byte dots (with p' and with p), because
// the TPU's vector unit has no widening multiply and its matrix unit is the
// only fast multiplier. This card's CUDA cores have a 32-bit multiply-add
// with carry, so a reduction is 8 steps of 6 multiply-add pairs in a
// thread's registers (field.cuh: redc_steps), with no shared memory and no
// barrier, where the dots took six block barriers each. The dots that
// remain are the ones with constant weights and a long K: the MDS layer of
// the 8 full rounds, the chain's big dot over the older basis elements, its
// small dot of the newest element, and the exit map. They all run on the
// tensor cores.
//
// The code is written against a dot object:
//   d.lin_wait()          the MDS weights are in place (start, and after the chain);
//   d.mds_put(words)      this state's 160 state bytes, for the MDS dots;
//   d.mds_run(k)          block k of the MDS weights (64 x 160) times them;
//   d.mds_done()          the sums have been read;
//   d.chain_begin()       no state of the block reads the MDS weights any more;
//   d.basis_put(j, w)     this state's basis element j <- 8 limbs;
//   d.basis_signal()      the elements put so far may be read by the producer;
//   d.job_cols(q)         the sums of job q are ready to be read: for q < 59 round
//                         q's dot (hyb: the producer's whole dot; hybp: the
//                         producer's over the older elements plus, for q > 0,
//                         the newest element's, which the consumer's own warp
//                         runs), for q >= 59 word q - 59 of the exit;
//   d.job_done(q)         they have been read;
//   d.col(i)              column sum i of the last mds_run or job_cols.
// On the card these wait on and signal the block's barriers; for the host,
// below, the producer's jobs run in sequence at the signal that allows them.

#pragma once

#include "perm_dense.cuh"

namespace hades {
namespace hybp {

using dense::kT;
using mxu8::kBlockRows;
using mxu8::kLinK;

constexpr int kBasis = 1 + kWidth + kPartialRounds;  // 65 elements
constexpr int kBasisBytes = 32 * (kBasis + 1);       // 2,112 B a state, the last 32 padding
constexpr int kSeg1Rounds = 27;                      // rounds 0..26: <= 32 elements
constexpr int kSeg1K = 32 * 32;
constexpr int kSeg2K = 32 * 64;                      // rounds 27..58: <= 64 elements

// The chain's weights, one flat byte array: the rounds of segment 1, those
// of segment 2, for hybp the 59 newest-element blocks, then the exit map.
constexpr int kSeg1Bytes = kSeg1Rounds * kBlockRows * kSeg1K;
constexpr int kSeg2Bytes = (kPartialRounds - kSeg1Rounds) * kBlockRows * kSeg2K;
constexpr int kNewTableBytes = kPartialRounds * kBlockRows * 32;
constexpr int kOutBytes = kWidth * kBlockRows * kBasisBytes;
constexpr int chain_bytes(bool split) {
  return kSeg1Bytes + kSeg2Bytes + (split ? kNewTableBytes : 0) + kOutBytes;
}
// the kernels' uint32 table: mxu8's (the dense ARK, R^2), then R mod p
constexpr int kConstWords = mxu8::kConstWords + kLimbs;

// The producer's jobs: one a partial round, then the 5 blocks of the exit
// map. With the split (`hybp`), round q's job is its big dot over the older
// elements, and the consumer adds the newest element's small dot; without it
// (`hyb`), round q's job is the round's whole dot. Job q multiplies the
// first job_k(q, split) bytes of the basis, reads its weights at
// job_w(chain_w, q, split) with rows job_stride(q) apart, and may start
// after the consumer's signal number job_signal(q, split).
constexpr int kJobs = kPartialRounds + kWidth;

// Round q's elements: hybp's older ones (all 6 in round 0, the 5 + q before
// the newest in round q > 0; the newest one's weights are zero in its
// table), or hyb's 6 + q. Rounded up to the dot's step of 64 bytes: the
// element after the last, if any, meets zero weights.
HADES_HD int job_k(int q, bool split) {
  if (q >= kPartialRounds) return kBasisBytes;
  const int elems = !split ? 1 + kWidth + q : q == 0 ? 1 + kWidth : kWidth + q;
  return (32 * elems + 63) & ~63;
}

HADES_HD int job_stride(int q) {
  return q < kSeg1Rounds ? kSeg1K : q < kPartialRounds ? kSeg2K : kBasisBytes;
}

// The tables of params.hybp_tables (split) and params.hyb_tables share
// their layout but for hybp's w_new before the exit map.
HADES_HD const uint8_t* job_w(const uint8_t* chain_w, int q, bool split) {
  if (q < kSeg1Rounds) return chain_w + q * (kBlockRows * kSeg1K);
  if (q < kPartialRounds) {
    return chain_w + kSeg1Bytes + (q - kSeg1Rounds) * (kBlockRows * kSeg2K);
  }
  return chain_w + kSeg1Bytes + kSeg2Bytes + (split ? kNewTableBytes : 0) +
         (q - kPartialRounds) * (kBlockRows * kBasisBytes);
}

// Signal 0: elements 0..5 are in; signal r > 0: s_{r-1} is in. Round q's
// older elements end with s_{q-2}, its newest is s_{q-1}; the exit needs
// s_58.
HADES_HD int job_signal(int q, bool split) {
  if (q >= kPartialRounds) return kPartialRounds;
  return !split ? q : q > 1 ? q - 1 : 0;
}

HADES_HD const uint8_t* new_w(const uint8_t* chain_w, int r) {
  return chain_w + kSeg1Bytes + kSeg2Bytes + r * (kBlockRows * 32);
}

using dense::full_round;
using dense::redc_big;

// The 59 partial rounds and the chain's exit. In: the state after full
// round 3. Out: the state entering full round 63. Round r: s_{r-1} enters
// the basis and is signalled, which lets the producer start round r + 1's
// big dot while this thread reduces round r's sums and runs its S-box
// (hybp), or round r's whole dot, which this thread then waits for (hyb).
// kSbox13 takes field.cuh's sbox13 (hyb13, hybp13).
template <bool kSbox13, class Dot>
HADES_FN void chain(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ one_mont) {
  uint32_t x[kLimbs], t[kT];
  d.chain_begin();
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
  d.basis_signal();
#pragma unroll 1
  for (int r = 0; r < kPartialRounds; ++r) {
    if (r > 0) {
      d.basis_put(kWidth + r, x);  // s_{r-1}
      d.basis_signal();
    }
    d.job_cols(r);
    mxu8::recombine<63, kT>(d, t);
    d.job_done(r);
    redc_big<5>(x, t);  // the S-box's input t_r
    sbox_of<kSbox13>(x, x);  // s_r
  }
  d.basis_put(kBasis - 1, x);  // s_58
  d.basis_signal();
#pragma unroll 1
  for (int k = 0; k < kWidth; ++k) {
    d.job_cols(kPartialRounds + k);
    mxu8::recombine<63, kT>(d, t);
    d.job_done(kPartialRounds + k);
    redc_big<5>(x, t);
#pragma unroll
    for (int i = 0; i + 1 < kWidth; ++i) copy(s[i], s[i + 1]);
    copy(s[kWidth - 1], x);
  }
}

// The permutation. consts: kConstWords (the dense ARK, R^2, R mod p).
// kSbox13 (hyb13, hybp13) takes every S-box's raw products, in the full
// rounds and the chain alike, in base-2^13 digits.
template <bool kSbox13, class Dot>
HADES_FN void perm(Dot& d, uint32_t s[kWidth][kLimbs], const uint32_t* __restrict__ consts,
                   bool convert) {
  if (convert) mxu8::state_to_mont(s, consts);
  d.lin_wait();
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round<kSbox13>(d, s, consts, r);
  chain<kSbox13>(d, s, consts + mxu8::kConstWords);
  d.lin_wait();
#pragma unroll 1
  for (int r = kHalf + kPartialRounds; r < kRounds; ++r) full_round<kSbox13>(d, s, consts, r);
  if (convert) mxu8::state_from_mont(s);
}

#ifndef __CUDACC__
// The host's dot: plain loops over the kernel's byte weights, and the
// producer's jobs run in sequence, each at the signal that allows it, so
// that a job sees the basis as the card's producer may see it at the
// earliest: everything it needs and nothing later. kSplit follows the
// kernel's: hybp's table with the consumer's small dot, or hyb's.
template <bool kSplit = true>
struct HostDot : dense::HostDot<> {
  const uint8_t* chain_w;
  uint8_t y[kBasisBytes];
  int32_t job[kJobs][kBlockRows];
  int signals = 0, next_job = 0;

  void lin_wait() {}
  void chain_begin() {
    signals = next_job = 0;
    for (int i = 0; i < kBasisBytes; ++i) y[i] = 0xA5;  // unwritten elements meet zero weights
  }
  void basis_put(int j, const uint32_t* words) {
    for (int i = 0; i < kLimbs; ++i) {
      for (int b = 0; b < 4; ++b) y[32 * j + 4 * i + b] = (uint8_t)(words[i] >> (8 * b));
    }
  }
  void basis_signal() {
    for (; next_job < kJobs && job_signal(next_job, kSplit) <= signals; ++next_job) {
      const uint8_t* w = job_w(chain_w, next_job, kSplit);
      const int k = job_k(next_job, kSplit), stride = job_stride(next_job);
      for (int m = 0; m < kBlockRows; ++m) {
        int32_t sum = 0;
        for (int i = 0; i < k; ++i) sum += (int32_t)w[m * stride + i] * y[i];
        job[next_job][m] = sum;
      }
    }
    ++signals;
  }
  bool job_cols(int q) {
    if (q >= next_job) return false;  // the producer could not have run it yet
    const uint8_t* w = new_w(chain_w, q);
    for (int m = 0; m < kBlockRows; ++m) {
      int32_t sum = job[q][m];
      if (kSplit && q > 0 && q < kPartialRounds) {
        for (int i = 0; i < 32; ++i) sum += (int32_t)w[m * 32 + i] * y[32 * (kWidth + q) + i];
      }
      c[m] = sum;
    }
    return true;
  }
  void job_done(int) {}
  uint32_t col(int i) const { return (uint32_t)c[i]; }
};
#endif

}  // namespace hybp
}  // namespace hades
