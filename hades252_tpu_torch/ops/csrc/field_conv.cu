// The Montgomery conversion for Hopper (sm_90a): a R mod p (into the form)
// or a R^-1 mod p (out of it) of every element of a tensor, in one launch.
//
// Replaces no TPU kernel. The JAX package converts with jitted field ops
// (hades252_tpu/field.py `to_mont` / `from_mont`: one Montgomery product by
// a constant), which the port first ran as torch ops: some 200 small
// launches a conversion and 6 KB of int64 temporaries an element, so the
// Merkle build's conversion of 4^11 leaves took most of a tree's device
// time and memory. Here a thread takes one element through field.cuh's
// mont_convert (one mont_mul by R^2 or by 1) in its registers, so every
// output is bit-identical to the torch ops'.
//
// Interface: n input elements of 16 int32 little-endian 16-bit digits, the
// digits contiguous and the elements `stride` int32 apart (any stride that
// keeps an element's 64 B on a 16-byte boundary: the Merkle verifier's node
// is a column of the permutation's (K, 5, 16) output, read in place); a
// contiguous output of n elements. Digits below 2^16.
//
// What bounds it: the bytes. An element is 64 B read and 64 B written
// against one product's 136 multiply-adds, so at 3.35 TB/s and 16.7 T int32
// operations a second the memory takes some five times the arithmetic's
// time (utils/roofline.convert_bound). So the design serves the loads and
// stores: a warp moves its 32 elements as 16-byte vectors, four lanes an
// element, so a warp's load or store instruction covers eight whole
// elements (512 contiguous bytes where the rows are contiguous), and hands
// them to the lanes that own them through shared memory. The 16-byte slots
// are swizzled (slot q of element e at 4 e + (q ^ ((e >> 1) & 3))), so
// that neither the lanes' vector writes nor their element-wise reads
// collide on a bank. Nothing but the output goes to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace hades;

namespace {

constexpr int kConvThreads = 256;
constexpr int kConvWarps = kConvThreads / 32;
constexpr int kVecs = kDigits / 4;  // 16-byte vectors an element

__device__ __forceinline__ int slot(int e, int q) { return 4 * e + (q ^ ((e >> 1) & 3)); }

}  // namespace

template <bool kTo>
__global__ void __launch_bounds__(kConvThreads)
hades_field_convert(const int32_t* __restrict__ x, long long stride, long long n,
                    int32_t* __restrict__ out) {
  __shared__ int4 tile[kConvWarps][32 * kVecs];
  const int lane = threadIdx.x & 31;
  int4* t = tile[threadIdx.x >> 5];
  const long long first = ((long long)blockIdx.x * kConvWarps + (threadIdx.x >> 5)) * 32;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 8 * j + (lane >> 2);
    const long long i = first + e;
    int4 v = make_int4(0, 0, 0, 0);
    if (i < n) v = __ldg(reinterpret_cast<const int4*>(x + i * stride) + q);
    t[slot(e, q)] = v;
  }
  __syncwarp();
  uint32_t a[kLimbs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int4 v = t[slot(lane, k)];
    a[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    a[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  mont_convert<kTo>(a, a);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    t[slot(lane, k)] = make_int4((int)(a[2 * k] & 0xFFFFu), (int)(a[2 * k] >> 16),
                                 (int)(a[2 * k + 1] & 0xFFFFu), (int)(a[2 * k + 1] >> 16));
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 8 * j + (lane >> 2);
    const long long i = first + e;
    if (i < n) reinterpret_cast<int4*>(out + i * kDigits)[q] = t[slot(e, q)];
  }
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/field_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// x: n elements `stride` int32 apart, 16-byte aligned (the wrapper checks);
// out: n contiguous elements, on the current device; to_mont selects the
// direction; launched on `stream`. Returns 0, kErrBatch for an n out of
// range, or the launch's CUDA error.
int hades_field_convert_launch(const void* x, long long stride, long long n, void* out,
                               int to_mont, void* stream) {
  const unsigned grid = grid_for(n, kConvThreads);
  if (grid == 0) return kErrBatch;
  auto kernel = to_mont ? hades_field_convert<true> : hades_field_convert<false>;
  kernel<<<grid, kConvThreads, 0, (cudaStream_t)stream>>>((const int32_t*)x, stride, n,
                                                          (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
