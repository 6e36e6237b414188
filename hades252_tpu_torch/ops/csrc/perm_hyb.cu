// The `hyb` schedule of the Hades252 permutation for Hopper (sm_90a), in the
// shape of the first port; perm_hyb13.cu runs `hyb13` and `hybp13` on the
// same block code (perm_hyb_block.cuh). `hybp` has its own design in
// perm_hybp.cu.
//
// hades_perm_hyb replaces _perm_kernel_hyb (hades252_tpu/ops/perm_pallas.py
// :845): the 8 full rounds as the mxu8 kernel runs them, and the 59 partial
// rounds as the full-expansion chain (perm_hyb.cuh). Each partial round is
// one 8-bit integer product of that round's (63, 32 k) weights with the
// basis [1, x_0..x_4, s_0..s_{r-1}], one big Montgomery REDC and one S-box;
// the chain's exit is one (315, 2080) product. Every product runs in this
// kernel's own body on the tensor cores as mma.sync m16n8k32 u8 x u8 ->
// s32, exact (column sums < 2^28). Same interface as the other kernels:
// planar (5, 16, B) int32 digits in and out, canonical (convert=1) or
// Montgomery (convert=0), any B.
//
// What bounds it: the CUDA-core work and the block barriers around the
// dots, as in the mxu8 kernel, and after them the bytes the chain's dots
// pull through L2; not the tensor cores and not device memory. A state
// needs about 400 REDCs (8 full rounds x 20, 59 chain rounds x 4, 5 at the
// exit) against mxu8's 632, each two small dots between six barriers. The
// chain's dots are 6.6 M byte multiply-adds a state on top of the full
// rounds' 0.8 M: 1.2e11 for 2^14 states, some 120 us at the card's
// published int8 peak. But their operands do not fit in shared memory at
// 128 states a block: the weights are 6.6 MB and the basis is 2,080 B a
// state, 266 KB a block. Both stream from L2.
//
// What the design does about it, simply: the block shape, the shared tile
// and the per-state code are the mxu8 kernel's (128 states a block, one
// thread a state, 111,616 B of dynamic shared memory, two blocks an SM),
// and the basis lives in a scratch tensor that the wrapper allocates (2,080
// B a state, padded to 2,112, for every state of every block), which the
// MMA's B fragments read straight from global memory. The chain's weights
// live in a device tensor, as mxu8's do, and pass through shared memory 512
// bytes of K at a time, so that a block pulls them through L2 once and not
// once per warp; the stage is w_lin's place, idle during the chain, and
// w_lin is staged again at its end. In the big dot each warp takes the 32
// states of its own threads (4 column tiles) and all 64 rows, and keeps the
// 64 s32 sums of each lane in registers over the whole K loop, so that a
// weight fragment is loaded once for four MMAs. A lane loads 16 bytes at a
// time and feeds them to two MMAs: the sum over k does not care which byte
// meets which slot of the MMA as long as both operands agree, so the
// fragments need not follow the MMA's own stride of 4 bytes in 16. Tail
// lanes of the last block run a zero state (every thread must reach the
// barriers and the warp-wide MMAs), and only their store is masked.
//
// The block-level code (the wide dot, the dot object, the block's body and
// the launch) is in perm_hyb_block.cuh, which perm_hyb13.cu shares: the two
// files are separate sources so that they compile side by side.

#include "perm_hyb_block.cuh"

using namespace hades;

__global__ void __launch_bounds__(hyb::kThreads)
hades_perm_hyb(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert, const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
               uint4* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  hyb::perm_block<false, false>(x, out, n, convert, consts, weights, chain_w, scratch, smem);
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

// The block-wide tile product alone (mma_tile.cuh: dot_tiles), the one that
// the REDCs and the full rounds of hyb, hyb13 and hybp13 run, so that its
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
