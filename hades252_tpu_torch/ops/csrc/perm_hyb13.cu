// The `hyb13` and `hybp13` schedules of the Hades252 permutation for Hopper
// (sm_90a).
//
// hades_perm_hyb13 replaces _perm_kernel_hyb (hades252_tpu/ops/perm_pallas.py
// :845) and hades_perm_hybp13 replaces _perm_kernel_hybp (:945), both with
// sbox13=True: the first port's hyb and hybp kernels with every S-box
// product, in the full rounds and the chain alike, as a base-2^13
// schoolbook (_MxuOps.sbox_words :687-700; _to13 :181, _sqr13_cols :208,
// _mul13_cols :195, _cols13_to16 :225). An operand is 20 digits of 13 bits;
// the 210 (square) or 400 (product) raw products are below 2^26 and add up
// in 32-bit columns with no lo/hi split (below 2^31); the columns then go
// back to the 16 limbs that the REDC takes (perm_mxu8.cuh: to13, mul13).
// The products' values are those of the 32-bit-limb schoolbook, so the
// outputs are bit-identical to every other schedule's. hyb's and hybp's
// tables, and a scratch tensor for the basis.
//
// What bounds it: the CUDA-core work and the block barriers around the
// dots, then the bytes the chain's dots pull through L2, as in the first
// port's hyb and hybp: about 400 REDCs a state, each two small dots between
// six barriers, and the basis (2,112 B a state) in a scratch tensor that
// the MMA's B fragments read straight from global memory.
// The S-box's share of that work changes: a state runs 99 S-boxes, each
// two squares and a product. In 32-bit limbs that is 3 x 64 wide
// multiply-adds with carries; in 13-bit digits 820 narrow ones without,
// 60 digit windows and 117 column shifts into a 64-bit accumulator.
//
// What the design does about it, simply: one thread holds a state in 8
// limbs of 32 bits, so the repack need not pass through 16-bit columns as
// the TPU body's does: a column is finished in one register (product
// scanning), shifted to its bit position 13 k and added into a 64-bit
// accumulator that emits the limbs in order. The 39 columns are never live
// together, which is what keeps the digits (40 registers for a product)
// beside the state and hybp's 17 waiting limbs at all. Everything else is
// perm_hyb_block.cuh's (128 states a block, one thread a state, the
// weights staged through shared memory); perm_hyb.cu exports its tile
// products alone.

#include "perm_hyb_block.cuh"

using namespace hades;

__global__ void __launch_bounds__(hyb::kThreads)
hades_perm_hyb13(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                 int convert, const uint32_t* __restrict__ consts,
                 const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                 uint4* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  hyb::perm_block<false, true>(x, out, n, convert, consts, weights, chain_w, scratch, smem);
}

__global__ void __launch_bounds__(hyb::kThreads)
hades_perm_hybp13(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                  int convert, const uint32_t* __restrict__ consts,
                  const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                  uint4* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  hyb::perm_block<true, true>(x, out, n, convert, consts, weights, chain_w, scratch, smem);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

extern "C" {

// As hades_perm_hyb_launch, with hyb's tables (params.hyb_tables).
int hades_perm_hyb13_launch(const void* x, void* out, long long n, int convert,
                            const void* consts, const void* weights, const void* chain_w,
                            void* scratch, long long scratch_bytes, void* stream) {
  return launch_perm(hades_perm_hyb13, false, x, out, n, convert, consts, weights, chain_w,
                     scratch, scratch_bytes, stream);
}

// As hades_perm_hybp_launch, with hybp's tables (params.hybp_tables).
int hades_perm_hybp13_launch(const void* x, void* out, long long n, int convert,
                             const void* consts, const void* weights, const void* chain_w,
                             void* scratch, long long scratch_bytes, void* stream) {
  return launch_perm(hades_perm_hybp13, true, x, out, n, convert, consts, weights, chain_w,
                     scratch, scratch_bytes, stream);
}

}  // extern "C"
