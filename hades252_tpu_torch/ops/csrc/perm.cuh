// The per-state Hades252 permutation of the `naive` and `opt` schedules,
// one thread per state, and their constant tables, for the CUDA kernels in
// perm.cu.
//
// The header compiles for the host as well (without __CUDACC__ the
// constant tables are ordinary arrays), so the same code can be checked
// against a reference with a host compiler.

#pragma once

#include "field.cuh"

#ifdef __CUDACC__
#define HADES_CONST __constant__
#else
#define HADES_CONST static
#endif

namespace hades {

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
