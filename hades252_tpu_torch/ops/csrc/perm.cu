// The fused 67-round Hades252 permutation for Hopper (sm_90a).
//
// Replaces the two TPU kernels of hades252_tpu/ops/perm_pallas.py that
// the dense and sparse schedules run:
//   hades_perm_naive  <- _perm_kernel      (perm_pallas.py:330, "naive")
//   hades_perm_opt    <- _perm_kernel_opt  (perm_pallas.py:390, "opt")
// Both keep the Pallas kernels' interface: a planar (5, 16, B) int32
// array of 16-bit little-endian digits in, the same out, canonical
// (convert=1) or Montgomery-domain (convert=0).
//
// What bounds them: not memory (a state is 320 B in and 320 B out against
// about 2,000 (naive) or 1,050 (opt) Montgomery products) and, at the
// batches the models launch, not the multiply-add rate either, but the
// length of one thread's chain of dependent multiply-adds: a permutation is
// 67 rounds in a row, and the first port's one thread a state left one
// warp on each of the card's 528 schedulers at B = 2^14, with nothing to
// hide a latency behind (its time did not move when the reduction's
// multiplies were taken out; tools/probe_chains.py).
//
// What the design does about it. The Pallas kernels' 16-bit digits exist
// because the TPU's vector unit has no widening multiply; this card has a
// 32-bit multiply-add with carry, so both kernels work on 8 limbs of 32
// bits with the carry-chain products of field.cuh (a product, a squaring of
// 36 products for the S-box's x^2 and x^4, and a reduction that uses the
// shape of p).
// - hades_perm_naive keeps one thread a state, every intermediate in
//   registers, no shared memory and no synchronisation: it is the kernel
//   the others are checked against, and stays simple.
// - hades_perm_opt spreads a state over a group of lanes of one warp
//   (perm.cuh: perm_opt_lanes). With 4 lanes a lane holds one of the words
//   0..3 and a copy of word 4, so a sparse round is 6 products in a row a
//   lane, not 12, a full round 16, not 40, and a batch has four times the
//   warps. The lanes exchange 8-limb values by warp shuffles: one sum over
//   the group a sparse round, one all-gather a full round. A lane's
//   registers hold 2 words and a gathered state, not 5 words and the MDS
//   layer's 5 more, so 4 lanes fit 128 registers and 4 blocks of 128
//   threads sit on an SM. Lanes that compute word 4's S-box four times
//   over are the price, 1.9 times the products of one thread a state, and
//   a full card is bound by the multiplier: so the group follows the batch
//   (4, 2 or 1 lanes; see kGroup4Max below).
// The sparse schedule's tables are in global memory (27 KB, in L1): the
// lanes of a warp read the entries of four different words at once. The
// dense schedule's are in __constant__ memory, read as broadcasts. Loads
// and stores are coalesced over the states of a warp.
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a, 128 threads per block), none with
// a spill: hades_perm_naive 150 registers; hades_perm_opt 126 at 4 lanes,
// 148 at 2, 154 at 1 (the first port's one thread a state: 255 and 44 B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm.cuh"

namespace hades {

constexpr int kThreads = 128;

// hades_perm_opt's lanes a state follow the batch, since what bounds the
// kernel does. A batch that leaves most schedulers one warp or none is
// bound by the length of a lane's chain, which 4 lanes a state cut to 0.4
// of one thread's; a batch that fills the card is bound by the multiplier,
// and there the lanes' repeated S-box of word 4 (1.9 times the products at
// 4 lanes, 1.3 at 2) only costs. Up to kGroup4Max states 4 lanes, up to
// kGroup2Max 2, above that one thread a state (a group of one: the same
// code, its exchanges copies).
// The thresholds are where the measured times cross on an H100
// (tools/probe_chains.py, part 3; PERF.md).
constexpr long long kGroup4Max = 1 << 13;
constexpr long long kGroup2Max = 1 << 14;
// Blocks an SM a group size is compiled for, which caps its registers: 128 a
// thread at 4 lanes (4 blocks), 168 at 2 (3 blocks); one thread a state
// takes the 154 it wants, and 3 blocks of it still fit an SM.
constexpr int opt_blocks(int group) { return group == 4 ? 4 : group == 2 ? 3 : 2; }

}  // namespace hades

using namespace hades;

__global__ void __launch_bounds__(kThreads)
hades_perm_naive(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 long long n, int convert) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;  // the ragged tail: no padding needed
  uint32_t s[kWidth][kLimbs];
  load_state(s, x, b, n);
  perm_naive(s, convert != 0);
  store_state(out, s, b, n);
}

// A group of G lanes a state; a block's 128 threads take 128 / G states.
// Every thread runs to the end, since the exchanges are warp-wide: a group
// past the batch runs a zero state and only its store is masked.
template <int G>
__global__ void __launch_bounds__(kThreads, opt_blocks(G))
hades_perm_opt(const int32_t* __restrict__ x, int32_t* __restrict__ out,
               long long n, int convert) {
  using Lanes = Group<G>;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = tid / G;
  const int lane = (int)threadIdx.x & (G - 1);
  const bool live = b < n;
  Lanes g;
#pragma unroll
  for (int k = 0; k < Lanes::kOwn; ++k) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) g.own[0][k][j] = 0;
    if (live) load_word(g.own[0][k], x, lane + G * k, b, n);
  }
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) g.s4[0][j] = 0;
  if (live) load_word(g.s4[0], x, kWidth - 1, b, n);
  perm_opt_lanes<G>(g, convert != 0);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < Lanes::kOwn; ++k) store_word(out, g.own[0][k], lane + G * k, b, n);
  if (lane == 0) store_word(out, g.s4[0], kWidth - 1, b, n);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

namespace {

// Copy the next sizeof(symbol) bytes of src to a __constant__ table.
template <typename T>
cudaError_t upload(const T& symbol, const uint32_t*& src) {
  const cudaError_t err = cudaMemcpyToSymbol(symbol, src, sizeof(T));
  src += sizeof(T) / sizeof(uint32_t);
  return err;
}

}  // namespace

extern "C" {

// Upload the tables to the current device. `tables` holds, back to back as
// 32-bit limbs: p, R^2, the dense ARK and MDS, then the sparse schedule's
// ark_fr, c0, u, w, m, d and final (the order of perm.cuh's declarations);
// `words` is their total. p is checked against the modulus this file is
// built for and not stored.
int hades_init(const uint32_t* tables, long long words) {
  const long long total =
      kLimbs + (long long)(sizeof(c_r2) + sizeof(c_ark) + sizeof(c_mds) +
                           sizeof(g_ark_fr) + sizeof(g_c0) + sizeof(g_u) +
                           sizeof(g_w) + sizeof(g_m) + sizeof(g_d) +
                           sizeof(g_final)) / (long long)sizeof(uint32_t);
  if (words != total) return kErrTableSize;
  for (int j = 0; j < kLimbs; ++j) {
    if (tables[j] != p_limb(j)) return kErrModulus;
  }
  const uint32_t* src = tables + kLimbs;
  const uint32_t* r2 = src;                                 // both schedules take
  const uint32_t* mds = src + (sizeof(c_r2) + sizeof(c_ark)) / sizeof(uint32_t);  // these two
  const cudaError_t errs[] = {
      upload(c_r2, src),     upload(c_ark, src), upload(c_mds, src),
      upload(g_ark_fr, src), upload(g_c0, src),  upload(g_u, src),
      upload(g_w, src),      upload(g_m, src),   upload(g_d, src),
      upload(g_final, src),  upload(g_r2, r2),   upload(g_mds, mds)};
  for (cudaError_t err : errs) {
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int hades_perm_naive_launch(const void* x, void* out, long long n, int convert,
                            void* stream) {
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return kErrBatch;
  hades_perm_naive<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert);
  return (int)cudaGetLastError();
}

int hades_perm_opt_launch(const void* x, void* out, long long n, int convert,
                          void* stream) {
  const int group = n <= kGroup4Max ? 4 : n <= kGroup2Max ? 2 : 1;
  const unsigned grid = grid_for(n, kThreads / group);
  if (grid == 0) return kErrBatch;
  const int32_t* in = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 4) {
    hades_perm_opt<4><<<grid, kThreads, 0, s>>>(in, o, n, convert);
  } else if (group == 2) {
    hades_perm_opt<2><<<grid, kThreads, 0, s>>>(in, o, n, convert);
  } else {
    hades_perm_opt<1><<<grid, kThreads, 0, s>>>(in, o, n, convert);
  }
  return (int)cudaGetLastError();
}

const char* hades_error_string(int code) {
  switch (code) {
    case kErrTableSize: return "constant tables have the wrong size";
    case kErrModulus: return "constant tables were built for another modulus";
    case kErrBatch: return "batch size out of range for one launch";
    case kErrShape: return "matrix shape not supported by the kernel";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
