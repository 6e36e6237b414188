// The `mxu8` schedule of the Hades252 permutation for Hopper (sm_90a).
//
// Replaces _perm_kernel_mxu8 (hades252_tpu/ops/perm_pallas.py:640, body
// _perm_kernel_mxu_impl :731, _MxuOps :653, REDCs _redc_words_mxu :580): the
// dense 67-round schedule, whose MDS layer is an 8-bit integer product with
// 32-bit sums, the state's 160 byte rows times w_lin (5 blocks of 63
// base-256 columns, each padded to 64 rows). Here it runs on the tensor
// cores as wgmma m64n64k32 u8 x u8 -> s32, exact (column sums below 160 *
// 255^2 < 2^24). Same interface as the other kernels: planar (5, 16, B)
// int32 digits in and out, canonical (convert=1) or Montgomery (convert=0),
// any B. perm_mxu.cu runs the same template on bf16.
//
// What the TPU kernel did and this one does otherwise. There every
// Montgomery reduction is two more byte dots (w_pp and w_p), since the TPU's
// vector unit has no widening multiply: 632 reductions a permutation (5 an
// MDS layer, 3 an S-box). The first port kept them on the tensor cores as
// mma.sync between six block barriers each, and a block spent 0.37 of its
// clocks in those dots, 0.29 in the MDS dots and 0.14 turning their sums
// back into limbs (tools/probe_chains.py, part 4). This card's CUDA cores
// have a 32-bit multiply-add with carry, so here every reduction is
// field.cuh's carry chains in the thread's registers and the S-box is
// field.cuh's (perm_dense.cuh), with no shared memory and no barrier.
//
// What bounds it now: one thread's dependent chain, about 113,600 32-bit
// operations a state (99 S-boxes, 632 reductions, the ARK, the MDS sums'
// recombination), against 3.4 M byte multiply-adds of MDS dots on the tensor
// cores, 0.1113 ms and 0.0559 ms for 2^14 states at the card's rates.
//
// What the design does about it.
// - A block is one warpgroup of 128 states, one thread a state
//   (perm_dense_block.cuh). The only barriers are the warpgroup's own named
//   barrier around the MDS sums' trip through shared memory (one at the put,
//   two a block of w_lin); nothing waits on another warpgroup.
// - The MDS dot is warpgroup-local wgmma, the block's 128 states as N: the
//   state bytes are put into shared memory in wgmma's core-matrix order
//   (wgmma.cuh), w_lin lies there packed on the host in the same order, and
//   each of the 5 blocks is 10 wgmmas (two halves of N = 64, five steps of
//   32 bytes of K) between one fence and one commit. The MDS tile product
//   alone ran 2,728 clocks a round on a warpgroup this way against 7,342
//   for mma.sync m16n8k32 on a warp's 32 states (one warp a scheduler,
//   part 4), so the warp-local shape of hybp's consumer was not taken.
// - The wgmmas are asynchronous: block k + 1's run while the threads
//   recombine block k; the five values are then reduced together, five
//   independent chains (perm_dense.cuh: mds). Reducing each value under the
//   next block's wgmmas instead was 1-4% slower (tools/probe_chains.py,
//   part 6).
// - Shared memory: w_lin 51,200 B, the states 20,480 B, one block's sums
//   34,816 B: 106,496 B, two blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_dense_block.cuh"

using namespace hades;

__global__ void __launch_bounds__(dense::kThreads)
hades_perm_mxu8(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                int convert, const uint32_t* __restrict__ consts,
                const uint8_t* __restrict__ weights) {
  extern __shared__ __align__(128) uint8_t smem[];
  dense::perm_block<false>(x, out, n, convert, consts, weights, smem);
}

// The MDS product alone, through the kernel's own dot, so that its operand
// order and fragment layout can be held against a matmul.
__global__ void __launch_bounds__(dense::kThreads)
hades_mxu8_dot(const uint8_t* __restrict__ weights, const uint8_t* __restrict__ xt,
               int32_t* __restrict__ out, long long n) {
  extern __shared__ __align__(128) uint8_t smem[];
  dense::dot_block<false>(weights, xt, out, n, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// consts: mxu8::kConstWords uint32 (the dense Montgomery ARK, then R^2, as
// 32-bit limbs); weights: w_lin packed in wgmma's order, 51,200 B
// (perm_cuda.dense_kernel_tables), 16-byte aligned. Both are device pointers
// the caller keeps alive.
int hades_perm_mxu8_launch(const void* x, void* out, long long n, int convert,
                           const void* consts, const void* weights, void* stream) {
  return dense::launch_dense<false>(hades_perm_mxu8, n, stream, weights, (const int32_t*)x,
                                    (int32_t*)out, n, convert, (const uint32_t*)consts,
                                    (const uint8_t*)weights);
}

// out (320, n) int32 = weights (a packed (320, 160) u8 matrix, as the
// kernel's) times xt^T, xt (n, 160) u8.
int hades_mxu8_dot_launch(const void* weights, const void* xt, void* out, long long n,
                          void* stream) {
  return dense::launch_dense<false>(hades_mxu8_dot, n, stream, weights, (const uint8_t*)weights,
                                    (const uint8_t*)xt, (int32_t*)out, n);
}

}  // extern "C"
