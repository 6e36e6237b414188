// The field inversion for Hopper (sm_90a): a^-1 mod p of every element of a
// tensor, by Fermat, in one launch.
//
// Replaces no TPU kernel. The JAX package inverts with a jitted lax.scan of
// Montgomery products (hades252_tpu/field.py:224 `invert`), which the port
// first ran as torch ops, some 200 small launches a product and 420 products
// an inversion: the DEEP denominators of fri_cuda's device provers and the
// grand product's of prover_cuda's phase 2 spent most of their time
// launching them. Here one thread takes one element through the whole
// exponentiation in its registers (field.cuh's fermat_invert: the same
// square-and-multiply, so every output is bit-identical to the torch ops').
//
// Interface: a contiguous (..., 16) int32 array of 16-bit little-endian
// digits, n elements, in and out; mont_in says whether the input is in the
// Montgomery form (else canonical, lifted by one product with R^2). The
// output is in the Montgomery form, which both callers take. Inputs are
// below p.
//
// What bounds it: the multiply-adds. An element is 64 B read and 64 B
// written against some 50,000 32-bit operations (254 squarings of 108, 163
// products of 136), so the bound is the CUDA cores' rate (utils/roofline.
// invert_bound); each thread's chain of dependent products is 417 long, and
// at the callers' sizes (1,024 to 65,536 elements) the card holds one to
// four warps a scheduler, too few to hide the chain's latency fully. Blocks
// are 64 threads so that 2^14 elements already spread over 256 blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace hades;

namespace {

constexpr int kInvThreads = 64;

}  // namespace

__global__ void __launch_bounds__(kInvThreads)
hades_field_invert(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                   int mont_in) {
  const long long i = (long long)blockIdx.x * kInvThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t* src = x + i * kDigits;
  uint32_t a[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) a[k] = (uint32_t)src[2 * k] | ((uint32_t)src[2 * k + 1] << 16);
  fermat_invert(a, a, mont_in != 0);
  int32_t* dst = out + i * kDigits;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    dst[2 * k] = (int32_t)(a[k] & 0xFFFFu);
    dst[2 * k + 1] = (int32_t)(a[k] >> 16);
  }
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/field_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// x and out: n elements of 16 int32 digits each, on the current device;
// launched on `stream`. Returns 0, kErrBatch for an n out of range, or the
// launch's CUDA error.
int hades_field_invert_launch(const void* x, void* out, long long n, int mont_in, void* stream) {
  const unsigned grid = grid_for(n, kInvThreads);
  if (grid == 0) return kErrBatch;
  hades_field_invert<<<grid, kInvThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, mont_in);
  return (int)cudaGetLastError();
}

}  // extern "C"
