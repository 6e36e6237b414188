// The first port's block-level device code of the chained kernels: the
// wide tile product, the card's dot with the basis buffer, the block's body
// and the launch, for perm_hyb13.cu (hyb13, hybp13), and the wide tile
// product alone for perm_hyb.cu. perm_hyb13.cu's opening comment says what
// bounds these kernels and what the design does about it. Device code only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"
#include "perm_hyb.cuh"

namespace hades {
namespace hyb {

using mxu8::kCStride;
using mxu8::kThreads;

constexpr int kYVecs = kBasisBytes / 16;     // 16-byte vectors of a state's basis
constexpr int kStagedBytes = kBlockRows * 32;  // hybp's staged block of w_new
// The stage of the wide dot's weights: 64 rows of up to 512 bytes of K, at
// a stride of 576 bytes, which spreads the 16-byte loads of a quarter warp
// (2 rows of 64 bytes) over all banks.
constexpr int kStageK = 512;
constexpr int kStageVecs = (kStageK + 64) / 16;
constexpr int kStageBytes = kBlockRows * kStageVecs * 16;  // 36,864 B
static_assert(kStageBytes <= mxu8::kLinBytes, "the stage takes w_lin's place");

// The block's wide tile product: C[m][n] = sum_i W[m][i] Y[n][i] for m < 64,
// n < kThreads, i < k (a multiple of 64). W is row-major bytes in global
// memory, k a row; Y holds kThreads rows of bytes in global memory at a
// stride of ystride 16-byte vectors; both are 16-byte aligned. C is the
// shared sums buffer, rows of kCStride int32, and stage kStageBytes of
// shared memory. The block copies kStageK bytes of K of all 64 rows of W
// into the stage, every thread 16 vectors, and multiplies from there. Warp
// v takes columns 32 v .. 32 v + 31, the states of its own threads, as 4
// tiles of 8, and all 4 row tiles of 16. Each step takes 64 bytes of k:
// lane (g, q) loads bytes 16 q .. 16 q + 15 of its rows of W and Y and
// gives words (x, y) to one MMA and (z, w) to a second, as the fragments
// (a0 | a1, a2 | a3) and (b0, b1) of mma_tile.cuh; both operands place a
// byte of k in the same slot, which is all the sum needs. Y is written by
// this block during the kernel, so it is read with plain loads (not the
// read-only path) after a barrier; the loop's first barrier is that one.
// Not inlined: one copy of the loop, whose arguments are pointers and
// sizes; static, since two sources include this header. Every thread of
// the block must call it.
static __device__ __noinline__ void wide_dot(const uint8_t* __restrict__ w, int k,
                                             const uint4* y, int ystride, int32_t* c,
                                             uint4* stage) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, warp = threadIdx.x >> 5;
  const int kv = k >> 4;  // 16-byte vectors per row of W
  const uint4* wg = reinterpret_cast<const uint4*>(w);
  const uint4* wr = stage + g * kStageVecs + q;
  const uint4* yr = y + (size_t)(warp * 32 + g) * ystride + q;
  int32_t acc[4][4][4];  // [column tile][row tile][fragment]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0;
    }
  }
#pragma unroll 1
  for (int v0 = 0; v0 < kv; v0 += kStageK / 16) {
    const int vecs = kv - v0 < kStageK / 16 ? kv - v0 : kStageK / 16;  // of a row, this turn
    __syncthreads();  // the stage is free (and, first, the basis is written)
    for (int i = threadIdx.x; i < kBlockRows * vecs; i += kThreads) {
      const int r = i / vecs, v = i - r * vecs;
      stage[r * kStageVecs + v] = wg[(size_t)r * kv + v0 + v];
    }
    __syncthreads();
#pragma unroll 2
    for (int kc = 0; kc < (vecs >> 2); ++kc) {
      uint4 b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = yr[(size_t)(nt * 8) * ystride + v0 + kc * 4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint4 lo = wr[(mt * 16) * kStageVecs + kc * 4];      // row 16 mt + g
        const uint4 hi = wr[(mt * 16 + 8) * kStageVecs + kc * 4];  // row 16 mt + g + 8
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mxu8::mma_u8(acc[nt][mt], lo.x, hi.x, lo.y, hi.y, b[nt].x, b[nt].y);
          mxu8::mma_u8(acc[nt][mt], lo.z, hi.z, lo.w, hi.w, b[nt].z, b[nt].w);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      int32_t* cr = c + (mt * 16 + g) * kCStride + (warp * 4 + nt) * 8 + 2 * q;
      cr[0] = acc[nt][mt][0];
      cr[1] = acc[nt][mt][1];
      cr[8 * kCStride] = acc[nt][mt][2];
      cr[8 * kCStride + 1] = acc[nt][mt][3];
    }
  }
}

// The card's dot with the basis buffer (perm_hyb.cuh): y points at this
// block's kThreads rows of the scratch tensor.
struct BlockDot : mxu8::BlockDot {
  uint4* y;
  uint4* staged;         // kStagedBytes of shared memory (hybp)
  const uint4* weights;  // mxu8's weights in global memory, w_lin first

  __device__ __forceinline__ void basis_put(int j, const uint32_t* words) {
    uint4* dst = y + (size_t)threadIdx.x * kYVecs + 2 * j;
    dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
    dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
  }
  // The weights pass through w_lin's place, which the chain leaves idle.
  __device__ __forceinline__ void run_basis(const uint8_t* w, int k) {
    wide_dot(w, k, y, kYVecs, c,
             reinterpret_cast<uint4*>(const_cast<uint8_t*>(w_lin)));
    __syncthreads();
  }
  // w_lin back into its place, for the full rounds after the chain.
  __device__ __forceinline__ void end_chain() {
    uint4* dst = reinterpret_cast<uint4*>(const_cast<uint8_t*>(w_lin));
    for (int i = threadIdx.x; i < mxu8::kLinBytes / 16; i += kThreads) dst[i] = weights[i];
    __syncthreads();
  }
  // 16 bytes a thread; the barrier that ends the put before the run makes
  // them visible, and the one that ends the run frees the buffer again.
  __device__ __forceinline__ const uint8_t* stage_new(const uint8_t* w) {
    static_assert(kStagedBytes == 16 * kThreads, "one vector a thread");
    staged[threadIdx.x] = reinterpret_cast<const uint4*>(w)[threadIdx.x];
    return reinterpret_cast<const uint8_t*>(staged);
  }
};

// Dynamic shared memory of a block: mxu8's, and for hybp the staged block.
constexpr int smem_bytes(bool pipelined) {
  return mxu8::kSmemBytes + (pipelined ? kStagedBytes : 0);
}

template <bool kPipelined, bool kSbox13>
__device__ __forceinline__ void perm_block(const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out, long long n, int convert,
                                           const uint32_t* __restrict__ consts,
                                           const uint8_t* __restrict__ weights,
                                           const uint8_t* __restrict__ chain_w,
                                           uint4* scratch, uint8_t* smem) {
  const uint4* src = reinterpret_cast<const uint4*>(weights);
  for (int i = threadIdx.x; i < mxu8::kWeightBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = src[i];
  }
  __syncthreads();
  BlockDot d{{smem, smem + mxu8::kLinBytes, smem + mxu8::kLinBytes + mxu8::kPpBytes,
              reinterpret_cast<uint32_t*>(smem + mxu8::kWeightBytes),
              reinterpret_cast<int32_t*>(smem + mxu8::kWeightBytes + mxu8::kXBytes)},
             scratch + (size_t)blockIdx.x * kThreads * kYVecs,
             reinterpret_cast<uint4*>(smem + mxu8::kSmemBytes), src};
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < n;
  uint32_t s[kWidth][kLimbs];
  if (live) {
    load_state(s, x, b, n);
  } else {
#pragma unroll
    for (int w = 0; w < kWidth; ++w) {
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) s[w][j] = 0;
    }
  }
  perm<kPipelined, kSbox13>(d, s, consts, chain_w, convert != 0);
  if (live) store_state(out, s, b, n);
}

}  // namespace hyb

// Check the pointers and the scratch size, allow the block's shared memory
// and launch one of the chained kernels; returns its status.
template <typename Kernel>
static int launch_perm(Kernel kernel, bool pipelined, const void* x, void* out, long long n,
                       int convert, const void* consts, const void* weights,
                       const void* chain_w, void* scratch, long long scratch_bytes,
                       void* stream) {
  const unsigned grid = grid_for(n, hyb::kThreads);
  if (grid == 0) return kErrBatch;
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(chain_w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      scratch_bytes < (long long)grid * hyb::kThreads * hyb::kBasisBytes) {
    return kErrShape;
  }
  cudaError_t err = mxu8::allow_smem(kernel, hyb::smem_bytes(pipelined));
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, hyb::kThreads, hyb::smem_bytes(pipelined), (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert, (const uint32_t*)consts,
      (const uint8_t*)weights, (const uint8_t*)chain_w, (uint4*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace hades

