// The fused 67-round Hades252 permutation for Hopper (sm_90a), on the CUDA
// cores.
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
// 67 rounds in a row, and one thread a state leaves one warp on each of the
// card's 528 schedulers at B = 2^14, with nothing to hide a latency behind
// (the first port's time did not move when the reduction's multiplies were
// taken out; tools/probe_chains.py). A Merkle tree's upper levels (2^12
// states and fewer) are a fraction of one wave, and each costs the whole
// length of that chain.
//
// What the design does about it. The Pallas kernels' 16-bit digits exist
// because the TPU's vector unit has no widening multiply; this card has a
// 32-bit multiply-add with carry, so both kernels work on 8 limbs of 32
// bits with the carry-chain products of field.cuh (a product, a squaring of
// 36 products for the S-box's x^2 and x^4, and a reduction that uses the
// shape of p). Both spread a state over a group of lanes of one warp
// (perm.cuh: perm_naive_lanes, perm_opt_lanes). With 4 lanes a lane holds
// one of the words 0..3 and a copy of word 4, so a round is, a lane, the
// S-boxes of its own words and of word 4, an all-gather of the state by
// warp shuffles, and the MDS row of its word (and, for naive, its share of
// row 4, summed over the group): a dense full round 13 products in a row,
// not 40, a dense partial round 10, not 28, a sparse round 6, not 12; and a
// batch has four times the warps. A lane's registers hold 2 words and a
// gathered state, not 5 words and the MDS layer's 5 more, so 4 lanes fit
// 128 registers and 4 blocks of 128 threads sit on an SM. Lanes that
// compute word 4's S-box four times over are the price (1.9 times the
// products of one thread a state for opt, 1.4 for naive), and a full card
// is bound by the multiplier: so the group follows the batch (4, 2 or 1
// lanes; each kernel has its own thresholds, below). naive's round is one
// body with its loops over the words rolled: one thread's fully unrolled
// full round was some 16 k instructions, and instruction fetch, not the
// multiplier, held it back (tools/probe_chains.py, part 7). The tables are
// in global memory (38 KB, in L1): the lanes of a warp read the entries of
// four different words at once. Loads and stores are coalesced over the
// states of a warp.
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a, 128 threads per block), none with
// a spill: hades_perm_opt 126 registers at 4 lanes, 148 at 2, 154 at 1;
// hades_perm_naive 113 at 4 lanes, 128 and a 96 B stack frame at 2, 124 and
// 160 B at 1 (the rolled loops index the lane's own words), and 7,032 /
// 7,680 / 9,632 SASS instructions against the 31,704 of the first port's
// one thread a state.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm.cuh"

namespace hades {

constexpr int kThreads = 128;

// The lanes a state follow the batch, since what bounds the kernels does. A
// batch that leaves most schedulers one warp or none is bound by the length
// of a lane's chain, which 4 lanes a state cut to 0.4 of one thread's; a
// batch that fills the card is bound by the multiplier, and there the
// lanes' repeated work on word 4 only costs. Up to kGroup4Max states 4
// lanes, up to kGroup2Max 2, above that one thread a state (a group of one:
// the same code, its exchanges copies). The thresholds are where the
// measured times cross on an H100 (tools/probe_chains.py, part 3; PERF.md).
// naive at 4 / 2 / 1 lanes: 0.447 / 0.664 / 1.263 ms at B = 2^12, 0.826 /
// 0.652 / 1.280 at 2^13, 1.270 / 0.907 / 1.268 at 2^14, 2.517 / 1.907 /
// 1.715 at 2^15.
constexpr long long kGroup4Max = 1 << 13;
constexpr long long kGroup2Max = 1 << 14;
constexpr long long kNaiveGroup4Max = 1 << 12;
constexpr long long kNaiveGroup2Max = 1 << 14;
// Blocks an SM a group size is compiled for, which caps its registers: 128 a
// thread at 4 lanes (4 blocks), 168 at 2 (3 blocks); one thread a state
// takes the 154 it wants, and 3 blocks of it still fit an SM.
constexpr int group_blocks(int group) { return group == 4 ? 4 : group == 2 ? 3 : 2; }

// A group of G lanes a state; a block's 128 threads take 128 / G states.
// Every thread runs to the end, since the exchanges are warp-wide: a group
// past the batch runs a zero state and only its store is masked.
template <int G, bool kDense>
__device__ __forceinline__ void perm_block(const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out, long long n, int convert) {
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
  if (kDense) {
    perm_naive_lanes<G>(g, convert != 0);
  } else {
    perm_opt_lanes<G>(g, convert != 0);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < Lanes::kOwn; ++k) store_word(out, g.own[0][k], lane + G * k, b, n);
  if (lane == 0) store_word(out, g.s4[0], kWidth - 1, b, n);
}

}  // namespace hades

using namespace hades;

template <int G>
__global__ void __launch_bounds__(kThreads, group_blocks(G))
hades_perm_naive(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                 int convert) {
  perm_block<G, true>(x, out, n, convert);
}

template <int G>
__global__ void __launch_bounds__(kThreads, group_blocks(G))
hades_perm_opt(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert) {
  perm_block<G, false>(x, out, n, convert);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

namespace {

// Copy the next sizeof(symbol) bytes of src to a table in device memory.
template <typename T>
cudaError_t upload(const T& symbol, const uint32_t*& src) {
  const cudaError_t err = cudaMemcpyToSymbol(symbol, src, sizeof(T));
  src += sizeof(T) / sizeof(uint32_t);
  return err;
}

// Launch the instance of a kernel for the group that the batch chooses.
template <typename Kernel>
int launch_lanes(Kernel k4, Kernel k2, Kernel k1, long long group4_max, long long group2_max,
                 const void* x, void* out, long long n, int convert, void* stream) {
  const int group = n <= group4_max ? 4 : n <= group2_max ? 2 : 1;
  const unsigned grid = grid_for(n, kThreads / group);
  if (grid == 0) return kErrBatch;
  const Kernel kernel = group == 4 ? k4 : group == 2 ? k2 : k1;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n,
                                                       convert);
  return (int)cudaGetLastError();
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
      kLimbs + (long long)(sizeof(g_r2) + sizeof(g_ark) + sizeof(g_mds) +
                           sizeof(g_ark_fr) + sizeof(g_c0) + sizeof(g_u) +
                           sizeof(g_w) + sizeof(g_m) + sizeof(g_d) +
                           sizeof(g_final)) / (long long)sizeof(uint32_t);
  if (words != total) return kErrTableSize;
  for (int j = 0; j < kLimbs; ++j) {
    if (tables[j] != p_limb(j)) return kErrModulus;
  }
  const uint32_t* src = tables + kLimbs;
  const cudaError_t errs[] = {
      upload(g_r2, src), upload(g_ark, src), upload(g_mds, src), upload(g_ark_fr, src),
      upload(g_c0, src), upload(g_u, src),   upload(g_w, src),   upload(g_m, src),
      upload(g_d, src),  upload(g_final, src)};
  for (cudaError_t err : errs) {
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int hades_perm_naive_launch(const void* x, void* out, long long n, int convert,
                            void* stream) {
  return launch_lanes(hades_perm_naive<4>, hades_perm_naive<2>, hades_perm_naive<1>,
                      kNaiveGroup4Max, kNaiveGroup2Max, x, out, n, convert, stream);
}

int hades_perm_opt_launch(const void* x, void* out, long long n, int convert,
                          void* stream) {
  return launch_lanes(hades_perm_opt<4>, hades_perm_opt<2>, hades_perm_opt<1>, kGroup4Max,
                      kGroup2Max, x, out, n, convert, stream);
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
