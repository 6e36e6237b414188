// The block of the dense kernels (perm_mxu8.cu, perm_mxu.cu): one warpgroup,
// one thread a state, the per-state code of perm_dense.cuh, and the MDS dot
// as wgmma from shared memory. One template with two dot types, u8 x u8 ->
// s32 (mxu8) and bf16 x bf16 -> f32 (mxu), so that the two schedules cannot
// drift apart. perm_mxu8.cu's opening comment says what bounds the kernels
// and why the dot is a warpgroup's. Device code only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "perm_dense.cuh"
#include "wgmma.cuh"

namespace hades {
namespace dense {

constexpr int kThreads = 128;               // one warpgroup: 128 states a block
constexpr int kSumStride = kThreads + 8;    // int32 a row of sums
constexpr int kSumBytes = kBlockRows * kSumStride * 4;  // 34,816 B

// Shared memory of a block, in wgmma's order (wgmma.cuh): the five 64-row
// blocks of w_lin, then the states as two 64-row halves, each a panel of
// 160 values a row (bytes for u8, bf16 for bf16), then the sums of one
// block, 64 rows of the block's 128 states.
template <bool kBf16>
struct Layout {
  static constexpr int kVecs = (kBf16 ? 2 : 1) * kLinK / 16;  // 16-byte vectors a row
  static constexpr int kPanel = kVecs * kVecBytes;             // 64 rows: 10,240 / 20,480 B
  static constexpr int kSteps = kLinK / (kBf16 ? 16 : 32);     // wgmmas along K
  static constexpr int kWeightBytes = kWidth * kPanel;         // 51,200 / 102,400 B
  static constexpr int kOffX = kWeightBytes;
  static constexpr int kOffSums = kOffX + 2 * kPanel;
  static constexpr int kSmemBytes = kOffSums + kSumBytes;      // 106,496 / 178,176 B
};
static_assert(Layout<true>::kSmemBytes <= 232448, "an SM's shared memory");

// The block's threads, and nothing else, meet here (named barrier 1): the
// block is one warpgroup.
__device__ __forceinline__ void sync_block() { named_barrier(1, kThreads); }

// Bytes 2 kPair and 2 kPair + 1 of w widened to two bf16 in one register,
// the lower byte in the lower half. 0x4B000000 | byte is the float 2^23 +
// byte; less 2^23 it is the byte as a float, whose significand has at most
// 8 bits, so its low 16 bits are zero and its high half is the same value
// in bf16, exactly.
template <int kPair>
__device__ __forceinline__ uint32_t widen_bf16x2(uint32_t w) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + 2 * kPair)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441 + 2 * kPair)) - 8388608.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The card's dot (perm_dense.cuh): thread t is state t of the block. A
// block's product is the warpgroup's wgmmas, w_lin's block k as A (64
// rows) and the states as B (two halves of N = 64), the 64 x 128 sums in
// the warpgroup's registers; they go through shared memory so that each
// thread reads its own column. The wgmmas of block k + 1 are issued as soon
// as block k's sums are out of the registers, and run while the threads
// recombine block k. Every sum is an integer below 160 * 255^2 <
// 2^24, and so is every partial sum, so bf16's f32 accumulation is exact in
// any order and its conversion to int32 too.
template <bool kBf16>
struct WarpgroupDot {
  using L = Layout<kBf16>;
  uint8_t* smem;
  int t;
  std::conditional_t<kBf16, float, int32_t> acc[2][32];

  __device__ __forceinline__ int32_t* sums() const {
    return reinterpret_cast<int32_t*>(smem + L::kOffSums);
  }
  // Nothing but wgmmas between the fence and the commit (with a branch
  // among them, the assembler serialises them).
  __device__ __forceinline__ void issue(int k) {
    const uint64_t a = smem_desc(smem + k * L::kPanel);
    const uint64_t b0 = smem_desc(smem + L::kOffX), b1 = smem_desc(smem + L::kOffX + L::kPanel);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int s = 0; s < L::kSteps; ++s) {
        if constexpr (kBf16) {
          wgmma_bf16(acc[h], a + s * kDescStep, (h ? b1 : b0) + s * kDescStep, s);
        } else {
          wgmma_u8(acc[h], a + s * kDescStep, (h ? b1 : b0) + s * kDescStep, s);
        }
      }
    }
    wgmma_commit();
  }
  // Row t % 64 of half t / 64: vector v at v * 1024 + row group * 128 + row
  // in the group * 16. Bytes go in as they are; for bf16 each byte is
  // widened once, here.
  __device__ __forceinline__ void mds_put(const uint32_t* words) {
    uint8_t* row = smem + L::kOffX + (t >> 6) * L::kPanel + ((t & 63) >> 3) * kRowGroupBytes +
                   (t & 7) * 16;
#pragma unroll
    for (int v = 0; v < L::kVecs; ++v) {
      uint4 u;
      if constexpr (kBf16) {
        u = make_uint4(widen_bf16x2<0>(words[2 * v]), widen_bf16x2<1>(words[2 * v]),
                       widen_bf16x2<0>(words[2 * v + 1]), widen_bf16x2<1>(words[2 * v + 1]));
      } else {
        u = make_uint4(words[4 * v], words[4 * v + 1], words[4 * v + 2], words[4 * v + 3]);
      }
      *reinterpret_cast<uint4*>(row + v * kVecBytes) = u;
    }
    fence_async_smem();  // the puts, before the wgmmas read them
    sync_block();
    issue(0);
  }
  // Block k's sums out of the registers (warp w holds rows 16 w + g and
  // 16 w + g + 8, columns 64 h + 8 j + 2 q and the next) into shared memory,
  // then block k + 1's wgmmas into them.
  __device__ __forceinline__ void mds_run(int k) {
    wgmma_wait<0>();
    pin(acc[0]);
    pin(acc[1]);
    const int lane = t & 31, g = lane >> 2, q = lane & 3, warp = t >> 5;
    int32_t* c = sums() + (16 * warp + g) * kSumStride + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kBf16) {
            v[i] = __float2int_rn(acc[h][4 * j + i]);
          } else {
            v[i] = acc[h][4 * j + i];
          }
        }
        int32_t* cr = c + 64 * h + 8 * j;
        *reinterpret_cast<int2*>(cr) = make_int2(v[0], v[1]);
        *reinterpret_cast<int2*>(cr + 8 * kSumStride) = make_int2(v[2], v[3]);
      }
    }
    sync_block();
    if (k + 1 < kWidth) issue(k + 1);
  }
  __device__ __forceinline__ uint32_t col(int i) const {
    return (uint32_t)sums()[i * kSumStride + t];
  }
  __device__ __forceinline__ void mds_done() { sync_block(); }
};

// w_lin, packed in wgmma's order (perm_cuda.dense_kernel_tables), into its
// place; then the block may start.
template <bool kBf16>
__device__ __forceinline__ void stage_weights(uint8_t* smem, const uint8_t* __restrict__ weights) {
  const uint4* src = reinterpret_cast<const uint4*>(weights);
  for (int i = threadIdx.x; i < Layout<kBf16>::kWeightBytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = src[i];
  }
  fence_async_smem();
  sync_block();
}

// The body of a dense kernel's block: stage w_lin, run the 67 rounds on one
// state a thread, store. Tail lanes of the last block run a zero state,
// since every thread must reach the barriers and the wgmmas; only their
// store is masked.
template <bool kBf16>
__device__ __forceinline__ void perm_block(const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out, long long n, int convert,
                                           const uint32_t* __restrict__ consts,
                                           const uint8_t* __restrict__ weights, uint8_t* smem) {
  stage_weights<kBf16>(smem, weights);
  WarpgroupDot<kBf16> d{smem, (int)threadIdx.x};
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
  perm(d, s, consts, convert != 0);
  if (live) store_state(out, s, b, n);
}

// The MDS product alone, through the same dot: out (320, n) int32 = w_lin
// (packed as the kernel's) times xt^T, xt (n, 160) bytes, each block 128
// columns; the tail's columns are zero bytes and are not stored.
template <bool kBf16>
__device__ __forceinline__ void dot_block(const uint8_t* __restrict__ weights,
                                          const uint8_t* __restrict__ xt,
                                          int32_t* __restrict__ out, long long n, uint8_t* smem) {
  stage_weights<kBf16>(smem, weights);
  WarpgroupDot<kBf16> d{smem, (int)threadIdx.x};
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t words[kWidth * kLimbs];
  const uint32_t* src = reinterpret_cast<const uint32_t*>(xt + col * kLinK);
#pragma unroll
  for (int i = 0; i < kWidth * kLimbs; ++i) words[i] = col < n ? src[i] : 0u;
  d.mds_put(words);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    d.mds_run(k);
    if (col < n) {
      for (int i = 0; i < kBlockRows; ++i) out[(k * kBlockRows + i) * n + col] = (int32_t)d.col(i);
    }
    d.mds_done();
  }
}

// Check the pointers, allow the block's shared memory and launch.
template <bool kBf16, typename Kernel, typename... Args>
static int launch_dense(Kernel kernel, long long n, void* stream, const void* weights,
                        Args... args) {
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return kErrBatch;
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0) return kErrShape;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<kBf16>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, Layout<kBf16>::kSmemBytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dense
}  // namespace hades
