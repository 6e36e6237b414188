// The fused 67-round Hades252 permutation for Hopper (sm_90a).
//
// Replaces the two TPU kernels of hades252_tpu/ops/perm_pallas.py that
// the dense and sparse schedules run:
//   hades_perm_naive  <- _perm_kernel      (perm_pallas.py:330, "naive")
//   hades_perm_opt    <- _perm_kernel_opt  (perm_pallas.py:390, "opt")
// Both keep the Pallas kernels' interface: a planar (5, 16, B) int32
// array of 16-bit little-endian digits in, the same out, canonical
// (convert=1) or Montgomery-domain (convert=0).
//
// What bounds it: 32-bit integer multiply-add issue, not memory. A state
// is 320 B in and 320 B out against about 2,000 (naive) or 1,050 (opt)
// Montgomery products of 128 wide multiply-adds each (64 for a b, 64 for
// the reduction's m p), so the kernel does on the order of 10^3 integer
// operations per byte moved.
//
// What the design does about it: one thread owns one state for all 67
// rounds. The state (5 words x 8 limbs) and every intermediate stay in
// registers, so there is no shared memory, no synchronisation and no
// traffic between rounds; the batch supplies the parallelism and each
// thread's long serial chain of products supplies the work. The Pallas
// kernels' 16-bit digits exist because the TPU's vector unit has no
// widening multiply; Hopper has a 32x32 -> 64-bit multiply-add, so the
// kernel works on 8 limbs of 32 bits (64 products per Montgomery
// multiply instead of 256). Constants sit in __constant__ memory, read
// as broadcasts. Loads and stores are coalesced: thread b touches
// x[w, d, b], and neighbouring threads neighbouring addresses.
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a, 128 threads per block):
//   hades_perm_naive  194 registers, no spill
//   hades_perm_opt    255 registers, 44 B spill stores, 32 B spill loads
// The state (40 registers) and a product's 9-word accumulator plus its
// operands are the pressure point; the MDS layer's 5 output words add 40.

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm.cuh"

namespace hades {

constexpr int kThreads = 128;

}  // namespace hades

using namespace hades;

__global__ void __launch_bounds__(kThreads)
hades_perm_naive(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                 long long n, int convert) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;  // the ragged tail: no padding needed
  uint32_t s[kWidth][kLimbs];
  load_state(s, x, b, n);
  perm_naive(s, convert != 0);
  store_state(out, s, b, n);
}

__global__ void __launch_bounds__(kThreads)
hades_perm_opt(const int32_t* __restrict__ x, int32_t* __restrict__ out,
               long long n, int convert) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  uint32_t s[kWidth][kLimbs];
  load_state(s, x, b, n);
  perm_opt(s, convert != 0);
  store_state(out, s, b, n);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

namespace {

// Copy the next sizeof(symbol) bytes of src to a __constant__ table.
template <typename T>
cudaError_t upload(const T& symbol, const uint32_t*& src) {
  const cudaError_t err = cudaMemcpyToSymbol(symbol, src, sizeof(T));
  src += sizeof(T) / sizeof(uint32_t);
  return err;
}

}  // namespace

extern "C" {

// Upload the constant tables to the current device. `tables` holds, back
// to back as 32-bit limbs: p, R^2, the dense ARK and MDS, then the sparse
// schedule's ark_fr, c0, u, w, m, d and final (the order of perm.cuh's
// declarations); `words` is their total. p is checked against the modulus
// this file is built for and not stored.
int hades_init(const uint32_t* tables, long long words) {
  const long long total =
      kLimbs + (long long)(sizeof(c_r2) + sizeof(c_ark) + sizeof(c_mds) +
                           sizeof(c_ark_fr) + sizeof(c_c0) + sizeof(c_u) +
                           sizeof(c_w) + sizeof(c_m) + sizeof(c_d) +
                           sizeof(c_final)) / (long long)sizeof(uint32_t);
  if (words != total) return kErrTableSize;
  for (int j = 0; j < kLimbs; ++j) {
    if (tables[j] != p_limb(j)) return kErrModulus;
  }
  const uint32_t* src = tables + kLimbs;
  const cudaError_t errs[] = {
      upload(c_r2, src),     upload(c_ark, src), upload(c_mds, src),
      upload(c_ark_fr, src), upload(c_c0, src),  upload(c_u, src),
      upload(c_w, src),      upload(c_m, src),   upload(c_d, src),
      upload(c_final, src)};
  for (cudaError_t err : errs) {
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int hades_perm_naive_launch(const void* x, void* out, long long n, int convert,
                            void* stream) {
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return kErrBatch;
  hades_perm_naive<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert);
  return (int)cudaGetLastError();
}

int hades_perm_opt_launch(const void* x, void* out, long long n, int convert,
                          void* stream) {
  const unsigned grid = grid_for(n, kThreads);
  if (grid == 0) return kErrBatch;
  hades_perm_opt<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert);
  return (int)cudaGetLastError();
}

const char* hades_error_string(int code) {
  switch (code) {
    case kErrTableSize: return "constant tables have the wrong size";
    case kErrModulus: return "constant tables were built for another modulus";
    case kErrBatch: return "batch size out of range for one launch";
    case kErrShape: return "matrix shape not supported by the kernel";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
