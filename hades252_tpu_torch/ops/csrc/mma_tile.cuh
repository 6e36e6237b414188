// The block-wide tensor-core tile product of the chained kernels in the
// first port's shape (perm_hyb.cu, perm_hyb13.cu; perm_hybp.cu takes its
// fragment order and the MMA), and the dot object that perm_mxu8.cuh's
// per-state code is written against there. Device code only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_mxu8.cuh"

namespace hades {
namespace mxu8 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kXBytes = kThreads * (kLinK + 16);        // byte rows, padded rows
constexpr int kCStride = kThreads + 8;                  // int32 per row of sums
constexpr int kCBytes = kBlockRows * kCStride * 4;
constexpr int kSmemBytes = kWeightBytes + kXBytes + kCBytes;

// c += a b on the tensor cores: a 16 x 32 tile of u8 weights (row major)
// times a 32 x 8 tile of u8 byte rows, s32 sums.
__device__ __forceinline__ void mma_u8(int32_t c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The block's tile product: C[m][n] = sum_k W[m][k] X[n][k] for m < 16
// mtiles, n < kThreads, k < 32 KS. W is row-major bytes (K = 32 KS per
// row); X holds kThreads rows of K bytes at a stride of K + 16 bytes (which
// spreads a fragment load over all banks); C rows are kCStride int32.
// Fragments of m16n8k32 (PTX ISA), with g = lane / 4 and q = lane % 4:
//   A: a0 = W[g][4q..4q+3], a1 = W[g+8][4q..], a2 = W[g][16+4q..], a3 = W[g+8][16+4q..]
//   B: b0 = X[n=g][4q..4q+3], b1 = X[n=g][16+4q..]
//   C: c0 = C[g][2q], c1 = C[g][2q+1], c2 = C[g+8][2q], c3 = C[g+8][2q+1]
// Bytes with the lower k sit in the lower bits of a register, which is how
// a little-endian 32-bit load of 4 consecutive bytes packs them.
template <int KS>
__device__ __forceinline__ void block_dot(const uint8_t* __restrict__ w, int mtiles,
                                          const uint32_t* __restrict__ x,
                                          int32_t* __restrict__ c) {
  constexpr int kw = 8 * KS;   // 32-bit words per row of W
  constexpr int xs = kw + 4;   // 32-bit words per row of X
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int nt = threadIdx.x >> 5; nt < kThreads / 8; nt += kWarps) {
    uint32_t b[KS][2];
    const uint32_t* xr = x + (nt * 8 + g) * xs;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      b[ks][0] = xr[ks * 8 + q];
      b[ks][1] = xr[ks * 8 + 4 + q];
    }
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      const uint32_t* w0 = w32 + (mt * 16 + g) * kw;
      const uint32_t* w1 = w0 + 8 * kw;
      int32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_u8(acc, w0[ks * 8 + q], w1[ks * 8 + q], w0[ks * 8 + 4 + q], w1[ks * 8 + 4 + q],
               b[ks][0], b[ks][1]);
      }
      int32_t* cr = c + (mt * 16 + g) * kCStride + nt * 8 + 2 * q;
      cr[0] = acc[0];
      cr[1] = acc[1];
      cr[8 * kCStride] = acc[2];
      cr[8 * kCStride + 1] = acc[3];
    }
  }
}

// The card's dot (see perm_mxu8.cuh): one column per thread of the block.
struct BlockDot {
  const uint8_t* w_lin;
  const uint8_t* w_pp;
  const uint8_t* w_p;
  uint32_t* x;
  int32_t* c;

  template <int N>
  __device__ __forceinline__ void put(const uint32_t* words) {
    uint32_t* row = x + threadIdx.x * (N + 4);
#pragma unroll
    for (int i = 0; i < N; ++i) row[i] = words[i];
    __syncthreads();
  }
  template <int M, int K>
  __device__ __forceinline__ void run(const uint8_t* w) {
    static_assert(M % 16 == 0 && K % 32 == 0, "MMA tile shape");
    block_dot<K / 32>(w, M / 16, x, c);
    __syncthreads();
  }
  __device__ __forceinline__ uint32_t col(int i) const {
    return (uint32_t)c[i * kCStride + threadIdx.x];
  }
  __device__ __forceinline__ void done() { __syncthreads(); }
};

// The tile product alone, over any u8 (m, k) x (k, n): m a multiple of 16 up
// to 320, k = 32 KS up to 160. w is (m, k) row-major, xt the right operand
// transposed, (n, k) row-major; out is (m, n) int32. Each block takes 128
// columns and runs block_dot over 64 rows at a time.
template <int KS>
__device__ void dot_tiles(const uint8_t* __restrict__ w, const uint8_t* __restrict__ xt,
                          int32_t* __restrict__ out, int m, long long n, uint8_t* smem) {
  constexpr int k = 32 * KS;
  uint8_t* ws = smem;
  uint8_t* xs = smem + kLinBytes;
  int32_t* cs = reinterpret_cast<int32_t*>(smem + kLinBytes + kXBytes);
  for (int i = threadIdx.x; i < m * k; i += kThreads) ws[i] = w[i];
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int i = 0; i < k; ++i) xs[threadIdx.x * (k + 16) + i] = col < n ? xt[col * k + i] : 0;
  __syncthreads();
  for (int m0 = 0; m0 < m; m0 += kBlockRows) {
    const int rows = m - m0 < kBlockRows ? m - m0 : kBlockRows;
    block_dot<KS>(ws + m0 * k, rows / 16, reinterpret_cast<const uint32_t*>(xs), cs);
    __syncthreads();
    if (col < n) {
      for (int r = 0; r < rows; ++r) out[(m0 + r) * n + col] = cs[r * kCStride + threadIdx.x];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void dot_tiles_k(const uint8_t* __restrict__ w,
                                            const uint8_t* __restrict__ xt,
                                            int32_t* __restrict__ out, int m, int k, long long n,
                                            uint8_t* smem) {
  switch (k / 32) {
    case 1: dot_tiles<1>(w, xt, out, m, n, smem); break;
    case 2: dot_tiles<2>(w, xt, out, m, n, smem); break;
    case 3: dot_tiles<3>(w, xt, out, m, n, smem); break;
    case 4: dot_tiles<4>(w, xt, out, m, n, smem); break;
    default: dot_tiles<5>(w, xt, out, m, n, smem); break;
  }
}

// Allow the dynamic shared memory a block needs (above the 48 KB default).
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int bytes = kSmemBytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace mxu8
}  // namespace hades

