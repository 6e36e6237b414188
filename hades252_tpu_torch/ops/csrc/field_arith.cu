// The element-wise field ops for Hopper (sm_90a): the Montgomery product
// a b R^-1 mod p, a + b mod p or a - b mod p of every element of two
// broadcast operands, in one launch.
//
// Replaces no TPU kernel. The JAX package runs these as jitted field ops
// (hades252_tpu/field.py `mont_mul`, `add_mod`, `sub_mod`; no Pallas
// kernel), which the port first ran as torch ops: a product was some 200
// launches and 25 KB of int64 temporaries an element, a sum or difference
// some 76 launches and 2 KB, and the provers' NTT stages and quotient
// phases are chains of them. Here a thread takes one element through
// field.cuh's field_arith (mont_mul, add_mod or sub_mod) in its registers,
// so every output is bit-identical to the torch ops'.
//
// Interface: two operands of 16 int32 little-endian 16-bit digits an
// element, the digits contiguous, each a pointer and element strides (in
// int32) over up to four axes of the output's shape, the innermost first;
// a stride of 0 broadcasts the operand along its axis. So the provers'
// challenges and tables (a (B, 1, 1, 16) challenge against (1, 4, n, 16)
// columns, an NTT stage's (L/2, 16) twiddle row against its (.., N/L, L/2,
// 16) half) and the NTT's strided halves are read in place, never
// expanded or copied. Every element's 64 B must lie on a 16-byte boundary
// (the wrapper refuses other layouts). The output is n contiguous
// elements. Digits below 2^16, values below p.
//
// What bounds it: the bytes. An element streams 64 B of each operand that
// is not broadcast and writes 64 B, against one product's 136 multiply-adds
// (mul) or some 16 32-bit operations (add, sub): at 3.35 TB/s and 16.7 T
// int32 operations a second the memory takes longer than the arithmetic,
// for mul by some seven times (utils/roofline.arith_bound). So the loads
// and stores are field_conv.cu's: a warp moves its 32 elements as 16-byte
// vectors, four lanes an element, so that a warp's load or store covers
// eight whole elements (512 contiguous bytes where the rows are
// contiguous), and hands them to the lanes that own them through swizzled
// shared memory. Each lane finds its own element's offsets in the two
// operands from its index over the axes (one 32-bit division an axis) and
// shuffles them to the lanes that load for it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace hades;

constexpr int kArithAxes = 4;

// The kernel's arguments, by value.
struct ArithOperand {
  const int32_t* p;
  long long stride[kArithAxes];  // int32 between neighbours along each axis, innermost first
};

struct ArithShape {
  unsigned size[kArithAxes];  // the output's axes, innermost first; 1 past `axes`
  int axes;
  long long n;  // elements: the product of the sizes
};

namespace {

constexpr int kArithThreads = 256;
constexpr int kArithWarps = kArithThreads / 32;
constexpr int kVecs = kDigits / 4;  // 16-byte vectors an element

__device__ __forceinline__ int slot(int e, int q) { return 4 * e + (q ^ ((e >> 1) & 3)); }

// The warp's 32 elements of one operand (the lane's element at `off`) into
// the lane's limbs, through the warp's tile.
__device__ __forceinline__ void load_limbs(uint32_t x[kLimbs], int4* t,
                                           const int32_t* __restrict__ p, long long off,
                                           long long first, long long n, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 8 * j + (lane >> 2);
    const long long o = __shfl_sync(0xFFFFFFFFu, off, e);
    int4 v = make_int4(0, 0, 0, 0);
    if (first + e < n) v = __ldg(reinterpret_cast<const int4*>(p + o) + q);
    t[slot(e, q)] = v;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int4 v = t[slot(lane, k)];
    x[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    x[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  __syncwarp();  // every lane has read the tile before it is written again
}

}  // namespace

template <int kOp>
__global__ void __launch_bounds__(kArithThreads)
hades_field_arith(ArithOperand a, ArithOperand b, ArithShape s, int32_t* __restrict__ out) {
  __shared__ int4 tile[kArithWarps][32 * kVecs];
  const int lane = threadIdx.x & 31;
  int4* t = tile[threadIdx.x >> 5];
  const long long first = ((long long)blockIdx.x * kArithWarps + (threadIdx.x >> 5)) * 32;
  long long oa = 0, ob = 0;
  if (first + lane < s.n) {
    unsigned r = (unsigned)(first + lane);  // below 2^32: the wrapper's bound
#pragma unroll
    for (int k = 0; k < kArithAxes; ++k) {
      unsigned c = r;
      if (k + 1 < s.axes) {
        const unsigned d = r / s.size[k];
        c = r - d * s.size[k];
        r = d;
      } else {
        r = 0u;
      }
      oa += (long long)c * a.stride[k];
      ob += (long long)c * b.stride[k];
    }
  }
  uint32_t x[kLimbs], y[kLimbs];
  load_limbs(x, t, a.p, oa, first, s.n, lane);
  load_limbs(y, t, b.p, ob, first, s.n, lane);
  field_arith<kOp>(x, x, y);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    t[slot(lane, k)] = make_int4((int)(x[2 * k] & 0xFFFFu), (int)(x[2 * k] >> 16),
                                 (int)(x[2 * k + 1] & 0xFFFFu), (int)(x[2 * k + 1] >> 16));
  }
  __syncwarp();
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 8 * j + (lane >> 2);
    const long long i = first + e;
    if (i < s.n) reinterpret_cast<int4*>(out + i * kDigits)[q] = t[slot(e, q)];
  }
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/field_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// op: kArithMul, kArithAdd or kArithSub; a and b with `axes` (1 to 4)
// element strides each, sizes the output's `axes` sizes, innermost first,
// n their product (below 2^32); out: n contiguous elements, on the current
// device; launched on `stream`. Returns 0, kErrBatch for an n out of
// range, kErrShape for an op, axes or sizes the kernel does not take, or
// the launch's CUDA error.
int hades_field_arith_launch(int op, const void* a, const long long* a_strides, const void* b,
                             const long long* b_strides, const long long* sizes, int axes,
                             long long n, void* out, void* stream) {
  const unsigned grid = grid_for(n, kArithThreads);
  if (grid == 0 || n >= (1LL << 32)) return kErrBatch;
  if (axes < 1 || axes > kArithAxes) return kErrShape;
  ArithOperand oa{(const int32_t*)a, {0, 0, 0, 0}}, ob{(const int32_t*)b, {0, 0, 0, 0}};
  ArithShape s{{1u, 1u, 1u, 1u}, axes, n};
  long long count = 1;
  for (int k = 0; k < axes; ++k) {
    if (sizes[k] < 1 || sizes[k] > n / count) return kErrShape;
    s.size[k] = (unsigned)sizes[k];
    oa.stride[k] = a_strides[k];
    ob.stride[k] = b_strides[k];
    count *= sizes[k];
  }
  if (count != n) return kErrShape;
  void (*kernel)(ArithOperand, ArithOperand, ArithShape, int32_t*) = nullptr;
  switch (op) {
    case kArithMul: kernel = hades_field_arith<kArithMul>; break;
    case kArithAdd: kernel = hades_field_arith<kArithAdd>; break;
    case kArithSub: kernel = hades_field_arith<kArithSub>; break;
    default: return kErrShape;
  }
  kernel<<<grid, kArithThreads, 0, (cudaStream_t)stream>>>(oa, ob, s, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
