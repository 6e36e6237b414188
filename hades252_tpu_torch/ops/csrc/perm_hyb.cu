// The `hyb` and `hybp` schedules of the Hades252 permutation for Hopper
// (sm_90a).
//
// hades_perm_hyb replaces _perm_kernel_hyb (hades252_tpu/ops/perm_pallas.py
// :845) and hades_perm_hybp replaces _perm_kernel_hybp (:945, the JAX
// package's default schedule): the 8 full rounds as the mxu8 kernel runs
// them, and the 59 partial rounds as the full-expansion chain
// (perm_hyb.cuh). Each partial round is one 8-bit integer product of that
// round's (63, 32 k) weights with the basis [1, x_0..x_4, s_0..s_{r-1}],
// one big Montgomery REDC and one S-box; the chain's exit is one (315, 2080)
// product. Every product runs in this kernel's own body on the tensor cores
// as mma.sync m16n8k32 u8 x u8 -> s32, exact (column sums < 2^28). Same
// interface as the other kernels: planar (5, 16, B) int32 digits in and
// out, canonical (convert=1) or Montgomery (convert=0), any B.
//
// What bounds it: the CUDA-core work and the block barriers around the
// dots, as in the mxu8 kernel, and after them the bytes the chain's dots
// pull through L2; not the tensor cores and not device memory. A state
// needs about 400 REDCs (8 full rounds x 20, 59 chain rounds x 4, 5 at the
// exit) against mxu8's 632, each two small dots between six barriers. The
// chain's dots are 6.6 M byte multiply-adds a state on top of the full
// rounds' 0.8 M: 1.2e11 for 2^14 states, some 120 us at the card's
// published int8 peak. But their operands do not fit in shared memory: the
// weights are 6.6 MB (6.8 MB for hybp) and the basis is 2,080 B a state,
// 266 KB a block. Both stream from L2: a block reads each round's weights
// (64 or 128 KB) and its states' basis (128 or 256 KB), 20 MB a
// permutation, 2.6 GB for 2^14 states.
//
// What the design does about it, simply: the block shape, the shared tile
// and the per-state code are the mxu8 kernel's (128 states a block, one
// thread a state, 111,616 B of dynamic shared memory and 2,048 B more for
// hybp, two blocks an SM), and the basis lives in a scratch tensor that the
// wrapper allocates (2,080 B a state, padded to 2,112, for every state of
// every block), which the MMA's B fragments read straight from global
// memory. The other way, 64 states a block with the basis in shared memory
// (about 215 KB), would leave one block of 2 warps on an SM, too few to
// hide the latency of the carry chains that bound the kernel, and would
// need a second shape of the tile code. The chain's weights live in a
// device tensor, as mxu8's do, and pass through shared memory 512 bytes of
// K at a time, so that a block pulls them through L2 once and not once per
// warp; the stage is w_lin's place, idle during the chain, and w_lin is
// staged again at its end. In the big dot each warp takes the 32 states
// of its own threads (4 column tiles) and all 64 rows, and keeps the 64 s32
// sums of each lane in registers over the whole K loop, so that a weight
// fragment is loaded once for four MMAs. A lane loads 16 bytes at a time
// and feeds them to two MMAs: the sum over k does not care which byte meets
// which slot of the MMA as long as both operands agree, so the fragments
// need not follow the MMA's own stride of 4 bytes in 16. hybp's small dot
// reads its (64, 32) weights from a 2 KB shared buffer that the block
// refills each round. hybp runs its split in the JAX order, in sequence:
// with one thread a state and the MMAs in the same warps, starting the big
// dot before the S-box overlaps nothing by itself; its big dot's value
// waits across the S-box as 17 limbs in registers. Tail lanes of the last
// block run a zero state (every thread must reach the barriers and the
// warp-wide MMAs), and only their store is masked.

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
// sizes. Every thread of the block must call it.
__device__ __noinline__ void wide_dot(const uint8_t* __restrict__ w, int k, const uint4* y,
                                      int ystride, int32_t* c, uint4* stage) {
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

template <bool kPipelined>
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
  perm<kPipelined>(d, s, consts, chain_w, convert != 0);
  if (live) store_state(out, s, b, n);
}

}  // namespace hyb
}  // namespace hades

using namespace hades;

__global__ void __launch_bounds__(hyb::kThreads)
hades_perm_hyb(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert, const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
               uint4* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  hyb::perm_block<false>(x, out, n, convert, consts, weights, chain_w, scratch, smem);
}

__global__ void __launch_bounds__(hyb::kThreads)
hades_perm_hybp(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                int convert, const uint32_t* __restrict__ consts,
                const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                uint4* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  hyb::perm_block<true>(x, out, n, convert, consts, weights, chain_w, scratch, smem);
}

// The wide tile product alone, over any u8 (m, k) x (k, n) with m and k
// multiples of 64: w is (m, k) row-major, xt the right operand transposed
// and padded to whole blocks, (128 blocks, k) row-major; out is (m, n)
// int32. Each block takes 128 columns and runs wide_dot over 64 rows at a
// time.
__global__ void __launch_bounds__(hyb::kThreads)
hades_hyb_dot(const uint8_t* __restrict__ w, const uint8_t* xt, int32_t* __restrict__ out,
              int m, int k, long long n) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* c = reinterpret_cast<int32_t*>(smem + hyb::kStageBytes);
  const long long col = (long long)blockIdx.x * hyb::kThreads + threadIdx.x;
  const uint4* y = reinterpret_cast<const uint4*>(xt + (size_t)blockIdx.x * hyb::kThreads * k);
  for (int m0 = 0; m0 < m; m0 += mxu8::kBlockRows) {
    hyb::wide_dot(w + (size_t)m0 * k, k, y, k >> 4, c, reinterpret_cast<uint4*>(smem));
    __syncthreads();
    if (col < n) {
      for (int r = 0; r < mxu8::kBlockRows; ++r) {
        out[(size_t)(m0 + r) * n + col] = c[r * mxu8::kCStride + threadIdx.x];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

namespace {

template <typename Kernel>
int launch_perm(Kernel kernel, bool pipelined, const void* x, void* out, long long n,
                int convert, const void* consts, const void* weights, const void* chain_w,
                void* scratch, long long scratch_bytes, void* stream) {
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

}  // namespace

extern "C" {

// consts: hyb::kConstWords uint32 (the dense Montgomery ARK, R^2, R mod p,
// as 32-bit limbs); weights: mxu8::kWeightBytes of w_lin, w_pp, w_p;
// chain_w: hyb::chain_bytes(false) of w_seg1, w_seg2, w_out
// (params.hyb_tables); scratch: hyb::kBasisBytes for every state of every
// block, of any content. All are device pointers, 16-byte aligned, that the
// caller keeps alive.
int hades_perm_hyb_launch(const void* x, void* out, long long n, int convert,
                          const void* consts, const void* weights, const void* chain_w,
                          void* scratch, long long scratch_bytes, void* stream) {
  return launch_perm(hades_perm_hyb, false, x, out, n, convert, consts, weights, chain_w,
                     scratch, scratch_bytes, stream);
}

// As hades_perm_hyb_launch; chain_w: hyb::chain_bytes(true) of wo_seg1,
// wo_seg2, w_new, w_out (params.hybp_tables).
int hades_perm_hybp_launch(const void* x, void* out, long long n, int convert,
                           const void* consts, const void* weights, const void* chain_w,
                           void* scratch, long long scratch_bytes, void* stream) {
  return launch_perm(hades_perm_hybp, true, x, out, n, convert, consts, weights, chain_w,
                     scratch, scratch_bytes, stream);
}

// xt holds whole blocks of 128 rows: (128 * ceil(n / 128), k) bytes.
int hades_hyb_dot_launch(const void* w, const void* xt, void* out, int m, int k, long long n,
                         void* stream) {
  if (m <= 0 || m % mxu8::kBlockRows != 0 || k <= 0 || k % 64 != 0) return kErrShape;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(xt) % 16 != 0) {
    return kErrShape;
  }
  const unsigned grid = grid_for(n, hyb::kThreads);
  if (grid == 0) return kErrBatch;
  constexpr int smem_bytes = hyb::kStageBytes + mxu8::kCBytes;
  cudaError_t err = mxu8::allow_smem(hades_hyb_dot, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  hades_hyb_dot<<<grid, hyb::kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)w, (const uint8_t*)xt, (int32_t*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
