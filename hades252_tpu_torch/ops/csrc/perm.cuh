// The per-state Hades252 permutation of the `naive` and `opt` schedules and
// their constant tables, for the CUDA kernels in perm.cu. Both run a group
// of G lanes of one warp a state (perm_naive_lanes, perm_opt_lanes; G = 1
// is one thread a state).
//
// The header compiles for the host as well (without __CUDACC__ the tables
// are ordinary arrays, and a group's lanes are the slots of an array, run
// one after the other between exchanges, with the shuffles as array
// reads), so the same code can be checked against a reference with a host
// compiler.

#pragma once

#include "field.cuh"

#ifdef __CUDACC__
#define HADES_GLOBAL __device__
#else
#define HADES_GLOBAL static
#endif

namespace hades {

// Tables, Montgomery form, uploaded once per device by hades_init
// (perm.cu), 38,080 B in global memory, where they stay in L1: a lane reads
// the entries of the words it owns, so the lanes of a warp read four
// different entries at once, which constant memory would serve one after
// the other. The dense schedule's (R^2, the ARK of every round, the MDS),
// then the sparse schedule's.
HADES_GLOBAL uint32_t g_r2[kLimbs];                                 // R^2 mod p
HADES_GLOBAL uint32_t g_ark[kRounds][kWidth][kLimbs];               // dense ARK
HADES_GLOBAL uint32_t g_mds[kWidth][kWidth][kLimbs];                // MDS
HADES_GLOBAL uint32_t g_ark_fr[kFullRounds][kWidth][kLimbs];       // full-round ARK
HADES_GLOBAL uint32_t g_c0[kWidth][kLimbs];                        // chain entry shift
HADES_GLOBAL uint32_t g_u[kPartialRounds][4][kLimbs];              // sparse column
HADES_GLOBAL uint32_t g_w[kPartialRounds][4][kLimbs];              // sparse row
HADES_GLOBAL uint32_t g_m[kLimbs];                                 // M[4][4]
HADES_GLOBAL uint32_t g_d[kPartialRounds][kWidth][kLimbs];         // folded ARK
HADES_GLOBAL uint32_t g_final[4][4][kLimbs];                       // A^59

// ---------------------------------------------------------------------------
// A state on a group of G lanes. Lane i of the group owns words i, i + G, ..
// below 4; word 4, whose S-box is every partial round's chain, is kept by
// all lanes, so x^5 of word 4 is never waited for from another lane. Sums
// mod p are taken in another order than by one thread; each is reduced to
// [0, p), so the results are the same.
//
// The dense schedule (the JAX package's _perm_kernel, perm_naive_lanes): 67
// rounds of ARK, x^5 (on all words in a full round, on word 4 in a partial
// one) and the MDS. A round is, a lane: its own S-boxes, an all-gather of
// the five words, the MDS rows of its own words and its share of row 4,
// summed over the group. At G = 4 that is 13 products in a row a full round
// and 10 a partial one, where one thread ran 40 and 28.
//
// The sparse-factored schedule (the JAX package's _perm_kernel_opt,
// perm_opt_lanes): full rounds 0..3, the entry shift x = s + c0, 59 sparse
// rounds of 12 products each (x^5 on word 4, then S_r with 9 non-identity
// entries), words 0..3 <- A^59 x[0:4], full rounds 4..7. A sparse round is,
// a lane: the S-box (three products in a row), the lane's own w_r and u_r
// products and m x^5, which hang on nothing but the lane's registers, and
// one sum over the group (G = 4: two exchanges of 8 limbs and two modular
// adds) for the new word 4: 6 products in a row where one thread ran 12.
// ---------------------------------------------------------------------------

template <int G>
struct Group {
  static_assert(G == 1 || G == 2 || G == 4, "lanes a state");
  static constexpr int kOwn = 4 / G;  // words below 4 a lane owns
#ifdef __CUDACC__
  static constexpr int kSlots = 1;    // a thread is one lane
  static __device__ __forceinline__ int lane(int) { return (int)threadIdx.x & (G - 1); }
#else
  static constexpr int kSlots = G;    // the host runs the lanes in turn
  static int lane(int l) { return l; }
#endif
  uint32_t own[kSlots][kOwn][kLimbs];  // own[l][k]: word lane(l) + G k
  uint32_t s4[kSlots][kLimbs];         // word 4, the same in every lane
};

#define HADES_EACH_LANE(l) _Pragma("unroll") for (int l = 0; l < Group<G>::kSlots; ++l)

// dst <- lane j's src, in every lane. dst and src point at lane 0's value;
// the next lane's (host only) is dstride or sstride words on.
template <int G>
HADES_FN void lanes_from(uint32_t* dst, int dstride, const uint32_t* src, int sstride, int j) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) dst[i] = __shfl_sync(0xFFFFFFFFu, src[i], j, G);
#else
  for (int l = 0; l < G; ++l) {
    for (int i = 0; i < kLimbs; ++i) dst[l * dstride + i] = src[j * sstride + i];
  }
#endif
}

// dst <- the src of the lane whose index differs in the bits of mask.
template <int G>
HADES_FN void lanes_xor(uint32_t dst[][kLimbs], const uint32_t src[][kLimbs], int mask) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) dst[0][i] = __shfl_xor_sync(0xFFFFFFFFu, src[0][i], mask);
#else
  for (int l = 0; l < G; ++l) {
    for (int i = 0; i < kLimbs; ++i) dst[l][i] = src[l ^ mask][i];
  }
#endif
}

// out <- sum over j < N of m[j] s[j] mod p, folded j-ascending.
template <int N>
HADES_FN void row_dot(uint32_t out[kLimbs], const uint32_t m[][kLimbs],
                      const uint32_t s[][kLimbs]) {
  uint32_t acc[kLimbs], t[kLimbs];
  mont_mul(acc, s[0], m[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) {
    mont_mul(t, s[j], m[j]);
    add_mod(acc, acc, t);
  }
  copy(out, acc);
}

// all[l][0..3] <- the group's words 0..3, in every lane.
template <int G>
HADES_FN void gather_words(uint32_t all[][kWidth][kLimbs], const Group<G>& g) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lanes_from<G>(&all[0][j][0], kWidth * kLimbs, &g.own[0][j / G][0], Group<G>::kOwn * kLimbs,
                  j % G);
  }
}

template <int G>
HADES_FN void full_round_lanes(Group<G>& g, int r) {
  constexpr int kOwn = Group<G>::kOwn;
  uint32_t all[Group<G>::kSlots][kWidth][kLimbs];
  HADES_EACH_LANE(l) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      add_mod(g.own[l][k], g.own[l][k], g_ark_fr[r][g.lane(l) + G * k]);
      sbox(g.own[l][k], g.own[l][k]);
    }
    add_mod(g.s4[l], g.s4[l], g_ark_fr[r][4]);
    sbox(g.s4[l], g.s4[l]);
  }
  gather_words<G>(all, g);
  HADES_EACH_LANE(l) {
    copy(all[l][4], g.s4[l]);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) row_dot<kWidth>(g.own[l][k], g_mds[g.lane(l) + G * k], all[l]);
    row_dot<kWidth>(g.s4[l], g_mds[4], all[l]);
  }
}

// One round of the dense schedule: ARK with the round's five words, x^5 on
// word 4 and, in a full round, on the lane's own words; then the MDS over
// the gathered state: the rows of the lane's own words, and row 4 as the
// lane's share (the products of its own words) summed over the group, plus
// m[4][4] x4, which is 2 products a lane at 4 lanes where the whole row is 5.
// The loops over the words stay rolled, and one body serves full and partial
// rounds: unrolled, a full round of one thread a state was some 16 k
// instructions, and rolling its S-boxes and MDS rows took that kernel from
// 2.42 to 1.16 ms at B = 2^14 (tools/probe_chains.py, part 7; PERF.md).
template <int G>
HADES_FN void naive_round_lanes(Group<G>& g, const uint32_t ark[kWidth][kLimbs], bool full) {
  constexpr int kOwn = Group<G>::kOwn, kSlots = Group<G>::kSlots;
  uint32_t all[kSlots][kWidth][kLimbs], part[kSlots][kLimbs], other[kSlots][kLimbs];
  HADES_EACH_LANE(l) {
#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) {
      add_mod(g.own[l][k], g.own[l][k], ark[g.lane(l) + G * k]);
      if (full) sbox(g.own[l][k], g.own[l][k]);
    }
    add_mod(g.s4[l], g.s4[l], ark[4]);
    sbox(g.s4[l], g.s4[l]);
  }
  gather_words<G>(all, g);
  HADES_EACH_LANE(l) {
    copy(all[l][4], g.s4[l]);
#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) {
      uint32_t t[kLimbs];
      mont_mul(t, g.own[l][k], g_mds[4][g.lane(l) + G * k]);
      if (k == 0) copy(part[l], t); else add_mod(part[l], part[l], t);
    }
#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) row_dot<kWidth>(g.own[l][k], g_mds[g.lane(l) + G * k], all[l]);
  }
#pragma unroll
  for (int mask = 1; mask < G; mask <<= 1) {
    lanes_xor<G>(other, part, mask);
    HADES_EACH_LANE(l) add_mod(part[l], part[l], other[l]);
  }
  HADES_EACH_LANE(l) {
    uint32_t t[kLimbs];
    mont_mul(t, all[l][4], g_mds[4][4]);
    add_mod(g.s4[l], part[l], t);
  }
}

template <int G>
HADES_FN void sparse_round_lanes(Group<G>& g, int r) {
  constexpr int kOwn = Group<G>::kOwn, kSlots = Group<G>::kSlots;
  uint32_t part[kSlots][kLimbs], mx[kSlots][kLimbs], other[kSlots][kLimbs];
  HADES_EACH_LANE(l) {
    uint32_t x4[kLimbs], t[kLimbs];
    sbox(x4, g.s4[l]);
    // the lane's share of w_r . x[0:4], from the words before their update
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      mont_mul(t, g.own[l][k], g_w[r][g.lane(l) + G * k]);
      if (k == 0) copy(part[l], t); else add_mod(part[l], part[l], t);
    }
    // x[i] += u_r[i] x4, then the folded constants d_r
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      mont_mul(t, x4, g_u[r][g.lane(l) + G * k]);
      add_mod(g.own[l][k], g.own[l][k], t);
      add_mod(g.own[l][k], g.own[l][k], g_d[r][g.lane(l) + G * k]);
    }
    mont_mul(mx[l], x4, g_m);
  }
#pragma unroll
  for (int mask = 1; mask < G; mask <<= 1) {
    lanes_xor<G>(other, part, mask);
    HADES_EACH_LANE(l) add_mod(part[l], part[l], other[l]);
  }
  HADES_EACH_LANE(l) {
    add_mod(g.s4[l], part[l], mx[l]);
    add_mod(g.s4[l], g.s4[l], g_d[r][4]);
  }
}

// Into and out of the Montgomery domain: a product with R^2, and with 1.
template <int G>
HADES_FN void to_mont_lanes(Group<G>& g) {
  HADES_EACH_LANE(l) {
#pragma unroll
    for (int k = 0; k < Group<G>::kOwn; ++k) mont_mul(g.own[l][k], g.own[l][k], g_r2);
    mont_mul(g.s4[l], g.s4[l], g_r2);
  }
}

template <int G>
HADES_FN void from_mont_lanes(Group<G>& g) {
  const uint32_t one[kLimbs] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  HADES_EACH_LANE(l) {
#pragma unroll
    for (int k = 0; k < Group<G>::kOwn; ++k) mont_mul(g.own[l][k], g.own[l][k], one);
    mont_mul(g.s4[l], g.s4[l], one);
  }
}

template <int G>
HADES_FN void perm_naive_lanes(Group<G>& g, bool convert) {
  if (convert) to_mont_lanes<G>(g);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    naive_round_lanes<G>(g, g_ark[r], r < kHalf || r >= kHalf + kPartialRounds);
  }
  if (convert) from_mont_lanes<G>(g);
}

template <int G>
HADES_FN void perm_opt_lanes(Group<G>& g, bool convert) {
  constexpr int kOwn = Group<G>::kOwn;
  if (convert) to_mont_lanes<G>(g);
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round_lanes<G>(g, r);
  HADES_EACH_LANE(l) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) add_mod(g.own[l][k], g.own[l][k], g_c0[g.lane(l) + G * k]);
    add_mod(g.s4[l], g.s4[l], g_c0[4]);
  }
#pragma unroll 1
  for (int r = 0; r < kPartialRounds; ++r) sparse_round_lanes<G>(g, r);
  {
    uint32_t all[Group<G>::kSlots][kWidth][kLimbs];
    gather_words<G>(all, g);
    HADES_EACH_LANE(l) {
#pragma unroll
      for (int k = 0; k < kOwn; ++k) row_dot<4>(g.own[l][k], g_final[g.lane(l) + G * k], all[l]);
    }
  }
#pragma unroll 1
  for (int r = kHalf; r < kFullRounds; ++r) full_round_lanes<G>(g, r);
  if (convert) from_mont_lanes<G>(g);
}

#ifndef __CUDACC__
// The host's run of one state through a group of G lanes, under the dense
// (kDense, naive) or the sparse schedule (opt): every lane gets its words
// and word 4, and the lanes' copies of word 4 must agree at the end.
template <int G, bool kDense>
static bool perm_lanes_host(uint32_t s[kWidth][kLimbs], bool convert) {
  Group<G> g;
  for (int l = 0; l < G; ++l) {
    for (int k = 0; k < Group<G>::kOwn; ++k) copy(g.own[l][k], s[l + G * k]);
    copy(g.s4[l], s[4]);
  }
  if (kDense) perm_naive_lanes<G>(g, convert);
  else perm_opt_lanes<G>(g, convert);
  bool same = true;
  for (int l = 0; l < G; ++l) {
    for (int k = 0; k < Group<G>::kOwn; ++k) copy(s[l + G * k], g.own[l][k]);
    for (int i = 0; i < kLimbs; ++i) same = same && g.s4[l][i] == g.s4[0][i];
  }
  copy(s[4], g.s4[0]);
  return same;
}
#endif

}  // namespace hades
