// The first port's tile products of the chained kernels, alone, so that
// their MMA fragment layouts can be held against a matmul on the card. Only
// `hyb13` and `hybp13` (perm_hyb13.cu) still run the first port's block code
// (perm_hyb_block.cuh: 128 states a block, one thread a state, every
// reduction as two mma.sync dots between block barriers, the basis in a
// scratch tensor in global memory). `hyb` and `hybp` are the two instances
// of perm_hybp.cu's warp-specialised block.
//
// hades_hyb_dot: the wide dot of the chain (perm_hyb_block.cuh: wide_dot),
// both operands read from global memory, the weights staged through shared
// memory 512 bytes of K at a time; a warp takes the 32 states of its own
// threads and all 64 rows, and keeps its sums in registers over the K loop.
// hades_block_dot: the block-wide tile product (mma_tile.cuh: dot_tiles)
// of the REDCs and the full rounds. Both mma.sync m16n8k32 u8 x u8 -> s32.

#include "perm_hyb_block.cuh"

using namespace hades;

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

// The block-wide tile product alone (mma_tile.cuh: dot_tiles), the one that
// the REDCs and the full rounds of hyb13 and hybp13 run, so that its
// MMA fragment layout can be held against a matmul.
__global__ void __launch_bounds__(hyb::kThreads)
hades_block_dot(const uint8_t* __restrict__ w, const uint8_t* __restrict__ xt,
                int32_t* __restrict__ out, int m, int k, long long n) {
  extern __shared__ __align__(16) uint8_t smem[];
  mxu8::dot_tiles_k(w, xt, out, m, k, n, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

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

int hades_block_dot_launch(const void* w, const void* xt, void* out, int m, int k, long long n,
                           void* stream) {
  if (m <= 0 || m % 16 != 0 || m * k > mxu8::kLinBytes || k <= 0 || k % 32 != 0 ||
      k > mxu8::kLinK) {
    return kErrShape;
  }
  const unsigned grid = grid_for(n, hyb::kThreads);
  if (grid == 0) return kErrBatch;
  cudaError_t err = mxu8::allow_smem(hades_block_dot);
  if (err != cudaSuccess) return (int)err;
  hades_block_dot<<<grid, hyb::kThreads, mxu8::kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)w, (const uint8_t*)xt, (int32_t*)out, m, k, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
