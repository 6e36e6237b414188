// Hopper's warpgroup MMA (wgmma) from shared memory, and the barriers and
// fences around it, for the kernels that run it: perm_hybp.cu (the chain's
// big dots) and perm_dense.cu (the dense schedules' MDS dots). Device code
// only.
//
// Both operands lie in shared memory in wgmma's core-matrix order without
// swizzle: a matrix of 64 rows (weight rows, or states) by K bytes is cut
// into 16-byte vectors, vector v of row r at v * 1024 + (r / 8) * 128 +
// (r % 8) * 16: 8 rows of one vector are one core matrix of 128 B, the 8 row
// groups follow each other, then the next vector. The descriptor's leading
// offset (from a core matrix to the next along K) is then 1,024 B and its
// stride offset (to the next 8 rows) 128 B. One wgmma takes 32 bytes of K
// (32 u8 or 16 bf16): two vectors, so the next one's descriptors are 2,048
// B further on. The host packs weights in this order
// (perm_cuda.core_order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hades {

constexpr int kVecBytes = 1024;      // 64 rows x 16 B: one vector of every row
constexpr int kRowGroupBytes = 128;  // 8 rows x 16 B: one core matrix
constexpr uint64_t kDescStep = (2 * kVecBytes) >> 4;  // a wgmma's 32 bytes of K, in a descriptor

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// Writes to shared memory by ordinary stores become visible to wgmma's
// reads (the asynchronous proxy) only past this fence, which the writer
// runs before it signals.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The descriptor of a 64-row operand at p, in the order above.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)(kVecBytes >> 4) << 16) |
         ((uint64_t)(kRowGroupBytes >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// The accumulators stay where they are while MMAs are in flight.
__device__ __forceinline__ void pin(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64 n64 k32, u8 x u8 -> s32, d <- a b (scale_d = 0) or d + a b; the
// 64 x 64 sums in the warpgroup's registers, 32 a thread: warp w holds rows
// 16 w .. 16 w + 15, and within it a lane's registers 4 j .. 4 j + 3 are the
// m16 n8 fragment of columns 8 j .. 8 j + 7 (rows g and g + 8, columns 2 q
// and 2 q + 1, with g = lane / 4 and q = lane % 4).
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// m64 n64 k16, bf16 x bf16 -> f32, both operands K-major (no transpose),
// unscaled; the sums in the same places as wgmma_u8's.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace hades
