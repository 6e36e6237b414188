// The `mxu8` schedule of the Hades252 permutation for Hopper (sm_90a).
//
// Replaces _perm_kernel_mxu8 (hades252_tpu/ops/perm_pallas.py:640, body
// _perm_kernel_mxu_impl :731): the dense 67-round schedule with every
// constant product on the matrix unit as an 8-bit integer product with
// 32-bit sums. Here they run on the tensor cores as mma.sync m16n8k32
// u8 x u8 -> s32:
//   - the MDS layer: one dot of the state's 160 byte rows with w_lin
//     (5 blocks of 63 base-256 columns, each padded to 64 rows);
//   - every Montgomery REDC: m = T_lo p' mod R with w_pp (32 x 32) and
//     m p with w_p (63 x 32, padded to 64).
// The variable x variable S-box products stay on the CUDA cores (32-bit
// limb schoolbook), as the TPU kernel keeps them on its vector unit. Same
// interface as perm.cu's kernels: planar (5, 16, B) int32 digits in and
// out, canonical (convert=1) or Montgomery (convert=0), any B.
//
// Hopper's integer MMA takes unsigned bytes, so the weights and byte rows
// enter as they are and the dot is exact (max column sum 160 * 255^2 <
// 2^24): no offset encoding and none of _dot_u32_i8's corrections.
//
// What bounds it: not the tensor cores. A permutation needs 632 REDCs
// (5 per MDS layer, 3 per S-box), each two dots of 32 and 64 rows, plus 67
// MDS dots of 320 x 160: about 5.4 M byte multiply-adds, or 8.8e10 for
// 2^14 states, some 90 us at the card's published int8 peak against a
// kernel time in milliseconds. The time goes to
// the CUDA-core work around the dots (the S-box schoolbook, the carry
// chains that turn 63 column sums back into limbs, the conditional
// subtracts) and to the block-wide barriers: each REDC is two round trips
// through shared memory, six __syncthreads() in all, and each one
// serialises the block.
//
// What the design does about it, simply: one thread owns one state and
// does all of its per-state work in registers (perm_mxu8.cuh); a block of
// 128 states writes its byte rows into a shared tile, the 4 warps run the
// MMAs over it (each warp 4 of the 16 8-state column tiles), and the int32
// sums come back through shared memory for each thread to read its own
// column. The weights (54,272 B) are too large for __constant__ next to
// perm.cu's tables and live in a device tensor that the wrapper owns; each
// block stages them into dynamic shared memory. Per block: weights 54,272
// + byte tile 22,528 + sums 34,816 (64 rows at a time) = 111,616 B, so two
// blocks fit on an SM. Tail lanes of the last block run a zero state,
// since every thread must reach the barriers and the warp-wide MMAs; only
// their store is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

using namespace hades;
using namespace hades::mxu8;

__global__ void __launch_bounds__(mxu8::kThreads)
hades_perm_mxu8(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                int convert, const uint32_t* __restrict__ consts,
                const uint8_t* __restrict__ weights) {
  extern __shared__ __align__(16) uint8_t smem[];
  dense_block<BlockDot>(x, out, n, convert, consts, weights, smem);
}

// The tile product alone (mma_tile.cuh: dot_tiles), so that the MMA's
// fragment layout can be held against a matmul.
__global__ void __launch_bounds__(mxu8::kThreads)
hades_mxu8_dot(const uint8_t* __restrict__ w, const uint8_t* __restrict__ xt,
               int32_t* __restrict__ out, int m, int k, long long n) {
  extern __shared__ __align__(16) uint8_t smem[];
  dot_tiles_k<false>(w, xt, out, m, k, n, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// consts: kConstWords uint32 (the dense Montgomery ARK, then R^2, as 32-bit
// limbs); weights: kWeightBytes of w_lin, w_pp, w_p (params.mxu8_tables),
// 16-byte aligned. Both are device pointers the caller keeps alive.
int hades_perm_mxu8_launch(const void* x, void* out, long long n, int convert,
                           const void* consts, const void* weights, void* stream) {
  const unsigned grid = grid_for(n, mxu8::kThreads);
  if (grid == 0) return kErrBatch;
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0) return kErrShape;
  cudaError_t err = allow_smem(hades_perm_mxu8);
  if (err != cudaSuccess) return (int)err;
  hades_perm_mxu8<<<grid, mxu8::kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert, (const uint32_t*)consts,
      (const uint8_t*)weights);
  return (int)cudaGetLastError();
}

int hades_mxu8_dot_launch(const void* w, const void* xt, void* out, int m, int k,
                          long long n, void* stream) {
  if (m <= 0 || m % 16 != 0 || m * k > kLinBytes || k <= 0 || k % 32 != 0 || k > kLinK) {
    return kErrShape;
  }
  const unsigned grid = grid_for(n, mxu8::kThreads);
  if (grid == 0) return kErrBatch;
  cudaError_t err = allow_smem(hades_mxu8_dot);
  if (err != cudaSuccess) return (int)err;
  hades_mxu8_dot<<<grid, mxu8::kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)w, (const uint8_t*)xt, (int32_t*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
