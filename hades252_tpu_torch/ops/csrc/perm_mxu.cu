// The `mxu` schedule of the Hades252 permutation for Hopper (sm_90a).
//
// Replaces _perm_kernel_mxu (hades252_tpu/ops/perm_pallas.py:629, body
// _perm_kernel_mxu_impl :731, dot _dot_u32 :493, cast _bytes_cast :517):
// mxu8's dense 67-round schedule with the three constant products (the MDS
// layer's 315 x 160, and each REDC's 32 x 32 and 63 x 32) as bf16 x bf16
// products of byte operands with f32 sums. Here they run in this kernel's
// own body on the tensor cores as mma.sync m16n8k16 bf16 x bf16 -> f32
// (mma_tile.cuh: block_dot_bf16). A byte is exact in bf16, a product of
// two is an integer below 2^16, and a column sums at most 160 of them:
// every sum and partial sum is an integer below 160 * 255^2 = 10,404,000
// < 2^24, which f32 holds exactly, so the outputs are bit-identical to the
// other schedules'. Same interface as the other kernels: planar (5, 16, B)
// int32 digits in and out, canonical (convert=1) or Montgomery
// (convert=0), any B.
//
// What bounds it: what bounds the mxu8 kernel (the CUDA-core work around
// the dots and the block barriers; perm_mxu8.cu), and on top of it the
// widening of bytes to bf16. The dots are 5.4 M multiply-adds a state,
// 1.8e11 operations for 2^14 states, some 180 us at the card's published
// dense bf16 peak, twice mxu8's share because that peak is half the int8
// one; still a small part of a kernel time in milliseconds.
//
// What the design does about it, simply: everything outside the tile
// product is the mxu8 kernel's (per-state code, block shape, tables, the
// tail's zero states). Of the two ways to feed bf16 MMAs, this kernel
// keeps the weights and the byte rows as bytes in shared memory (mxu8's
// 111,616 B a block, two blocks an SM) and widens them in registers at
// fragment load, five instructions a byte pair. Keeping the weights as
// bf16 would double them to 108,544 B and the block to about 166 KB, one
// block of four warps an SM, for a kernel that is bound by latency. The
// price is arithmetic: a weight fragment is widened again for each of its
// MMAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

using namespace hades;
using namespace hades::mxu8;

__global__ void __launch_bounds__(mxu8::kThreads)
hades_perm_mxu(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert, const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ weights) {
  extern __shared__ __align__(16) uint8_t smem[];
  dense_block<BlockDotBf16>(x, out, n, convert, consts, weights, smem);
}

// The bf16 tile product alone (mma_tile.cuh: dot_tiles), so that its
// fragment layout and the exactness of its f32 sums can be held against a
// float64 matmul.
__global__ void __launch_bounds__(mxu8::kThreads)
hades_mxu_dot(const uint8_t* __restrict__ w, const uint8_t* __restrict__ xt,
              int32_t* __restrict__ out, int m, int k, long long n) {
  extern __shared__ __align__(16) uint8_t smem[];
  dot_tiles_k<true>(w, xt, out, m, k, n, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// As hades_perm_mxu8_launch: consts is kConstWords uint32 (the dense
// Montgomery ARK, then R^2), weights kWeightBytes of w_lin, w_pp, w_p as
// bytes (params.mxu_tables), 16-byte aligned; device pointers the caller
// keeps alive.
int hades_perm_mxu_launch(const void* x, void* out, long long n, int convert,
                          const void* consts, const void* weights, void* stream) {
  const unsigned grid = grid_for(n, mxu8::kThreads);
  if (grid == 0) return kErrBatch;
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0) return kErrShape;
  cudaError_t err = allow_smem(hades_perm_mxu);
  if (err != cudaSuccess) return (int)err;
  hades_perm_mxu<<<grid, mxu8::kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert, (const uint32_t*)consts,
      (const uint8_t*)weights);
  return (int)cudaGetLastError();
}

int hades_mxu_dot_launch(const void* w, const void* xt, void* out, int m, int k,
                         long long n, void* stream) {
  if (m <= 0 || m % 16 != 0 || m * k > kLinBytes || k <= 0 || k % 32 != 0 || k > kLinK) {
    return kErrShape;
  }
  const unsigned grid = grid_for(n, mxu8::kThreads);
  if (grid == 0) return kErrBatch;
  cudaError_t err = allow_smem(hades_mxu_dot);
  if (err != cudaSuccess) return (int)err;
  hades_mxu_dot<<<grid, mxu8::kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)w, (const uint8_t*)xt, (int32_t*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
