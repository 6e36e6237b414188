// The `mxu` schedule of the Hades252 permutation for Hopper (sm_90a).
//
// Replaces _perm_kernel_mxu (hades252_tpu/ops/perm_pallas.py:629, body
// _perm_kernel_mxu_impl :731, dot _dot_u32 :493, cast _bytes_cast :517):
// mxu8's dense 67-round schedule with the MDS layer's product as a bf16 x
// bf16 product of byte operands with f32 sums. Here it runs on the tensor
// cores as wgmma m64n64k16 bf16 x bf16 -> f32. A byte is exact in bf16, a
// product of two is an integer below 2^16, and a column sums at most 160 of
// them: every sum and partial sum is an integer below 160 * 255^2 =
// 10,404,000 < 2^24, which f32 holds exactly, so the outputs are
// bit-identical to the other schedules'. Same interface as the other
// kernels: planar (5, 16, B) int32 digits in and out, canonical
// (convert=1) or Montgomery (convert=0), any B.
//
// What bounds it, and the design: the mxu8 kernel's (perm_mxu8.cu), one
// template with the other dot type (perm_dense_block.cuh). The reductions
// that the TPU kernel ran as bf16 dots run on the CUDA cores. Two things
// differ from mxu8:
// - w_lin is held in shared memory as bf16, 102,400 B, widened once on the
//   host (perm_cuda.dense_kernel_tables); the first port widened every
//   weight byte again for each MMA, five instructions a byte pair, and spent
//   1.9x mxu8's clocks in its dots (tools/probe_chains.py, part 4). The
//   state's bytes are widened once, when they are put (20,480 B a half).
// - a block is 178,176 B, one block an SM, and each block of w_lin is 20
//   wgmmas of 16 values of K (the MDS tile product alone: 4,411 clocks a
//   round a warpgroup against u8's 2,728).
// Those, the widening at the put and the f32 sums' conversion to int32 (64
// a thread a block, at the card's 16 conversions a clock an SM) are what
// mxu spends beyond mxu8 (tools/probe_chains.py, part 4).
// The bound is the bf16 rate's: 0.1119 ms for 2^14 states, level with the
// CUDA cores' 0.1113.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_dense_block.cuh"

using namespace hades;

__global__ void __launch_bounds__(dense::kThreads)
hades_perm_mxu(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert, const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ weights) {
  extern __shared__ __align__(128) uint8_t smem[];
  dense::perm_block<true>(x, out, n, convert, consts, weights, smem);
}

// The bf16 MDS product alone, through the kernel's own dot, so that its
// layout and the exactness of its f32 sums can be held against a float64
// matmul.
__global__ void __launch_bounds__(dense::kThreads)
hades_mxu_dot(const uint8_t* __restrict__ weights, const uint8_t* __restrict__ xt,
              int32_t* __restrict__ out, long long n) {
  extern __shared__ __align__(128) uint8_t smem[];
  dense::dot_block<true>(weights, xt, out, n, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// As hades_perm_mxu8_launch, with weights w_lin as bf16 packed in wgmma's
// order, 102,400 B (perm_cuda.dense_kernel_tables).
int hades_perm_mxu_launch(const void* x, void* out, long long n, int convert,
                          const void* consts, const void* weights, void* stream) {
  return dense::launch_dense<true>(hades_perm_mxu, n, stream, weights, (const int32_t*)x,
                                   (int32_t*)out, n, convert, (const uint32_t*)consts,
                                   (const uint8_t*)weights);
}

// As hades_mxu8_dot_launch, with the weights as the bf16 kernel's.
int hades_mxu_dot_launch(const void* weights, const void* xt, void* out, long long n,
                         void* stream) {
  return dense::launch_dense<true>(hades_mxu_dot, n, stream, weights, (const uint8_t*)weights,
                                   (const uint8_t*)xt, (int32_t*)out, n);
}

}  // extern "C"
