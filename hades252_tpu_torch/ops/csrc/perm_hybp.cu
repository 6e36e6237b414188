// The `hybp`, `hyb`, `hybp13` and `hyb13` schedules of the Hades252
// permutation for Hopper (sm_90a): one block design, four instances of it.
//   hades_perm_hybp   <- _perm_kernel_hybp (hades252_tpu/ops/perm_pallas.py
//                        :945), the JAX package's default schedule (kSplit)
//   hades_perm_hyb    <- _perm_kernel_hyb  (perm_pallas.py:845)
//   hades_perm_hybp13 <- _perm_kernel_hybp with sbox13=True (kSplit, kSbox13)
//   hades_perm_hyb13  <- _perm_kernel_hyb with sbox13=True (kSbox13)
// All keep what makes the schedules: the 8 full rounds with the MDS layer
// as a byte dot, the 59 partial rounds as the full-expansion chain over the
// basis [1, x_0..x_4, s_0..s_58] (perm_hybp.cuh), each round one dot of the
// basis, a big reduction and an S-box, and the exit map. hybp splits each
// round's dot into the big one over the older elements (params.hybp_tables)
// and the small one of the newest element, so that round r + 1's big dot
// can run under round r's S-box; hyb runs each round's whole dot
// (params.hyb_tables) once the newest element is in. The `13` instances
// take the same tables and jobs and differ in the S-box alone: its three
// raw products in base-2^13 digits (field.cuh: to13, mul13, sbox13;
// _MxuOps.sbox_words :678-700), in the full rounds and the chain alike, as
// the JAX kernels do; a product's value does not depend on its base, so
// every output bit is the other instances'. Every dot runs in this
// kernel's own body on the tensor cores, u8 x u8 -> s32, exact (column
// sums < 2^28): the chain's dots and the exit as wgmma m64 n64 k32, hybp's
// small dot and the MDS dots as mma.sync m16 n8 k32. Same interface as the
// other kernels: planar (5, 16, B) int32 digits in and out, canonical
// (convert=1) or Montgomery (convert=0), any B.
//
// What bounds them on this card: a state's chain is serial (round r's
// S-box input needs s_{r-1}), so one thread's dependent multiply-adds,
// about 4 Montgomery products and a 17-limb reduction a round, set the time
// of a hybp block (tools/probe_chains.py, part 3: its consumer waits for
// the producer a tenth of its time). hyb adds the dots themselves to that
// chain: job r + 1 needs s_r, so the producer idles through the consumer's
// reduction and S-box and the consumer through the producer's dot, about
// 1,100 B of K (5 stages of 8 wgmmas) a round on average. The tensor-core
// work (6.9e10 byte multiply-adds for 2^14 states, 35 us at the int8 peak)
// and the weights that stream through L2 (5.3 MB a block) are far below
// either, and the basis (2,112 B a state) keeps an SM to 64 states. The
// first port carried the TPU's shape over: every reduction as two more dots
// between six block barriers, the basis in a scratch tensor in global
// memory, the weights staged with the whole block stopped, and the big dot
// and the S-box one after the other in the same warps. The base-2^13 S-box
// adds to the consumer's chain: 820 narrow multiply-adds with no carry and
// 117 shift-and-adds a call, where sbox's products are 136 wide ones with
// carry chains; its reductions are sbox's.
//
// What the design does about it.
// - The block is warp-specialised: 64 states, a producer warpgroup (threads
//   0..127) and 2 consumer warps (threads 128..191, one thread a state). The
//   producer runs the 64 jobs of the chain (perm_hybp.cuh: a round's dot,
//   then the 5 blocks of the exit) as soon as the consumer's signal allows
//   each: for hybp, job r + 1 starts when s_{r-1} is in the basis, at the
//   top of the consumer's round r, so it runs under round r's reduction and
//   S-box; for hyb, job r starts there. They hand over through mbarriers in
//   shared memory (`ready`: a basis element is in; `full` / `free`: a sums
//   buffer, two of them), never through a block-wide barrier.
// - The chain's dots are wgmma, both operands from shared memory, the
//   64 x 64 sums in the warpgroup's registers. mma.sync, tried first for
//   hybp's big dot, ran 28-34 clocks an MMA a warp on this card, whatever
//   the order of its accumulators, and the producer, not the consumer, set
//   the block's time (1.14 ms a 2^14 batch against 0.80).
// - The weights arrive by bulk copies (the TMA engine; no tensor map, the
//   bytes are contiguous) into a ring of three stages of 256 bytes of K (64
//   rows, 16,384 B a stage), two chunks ahead of the MMAs, across jobs: the
//   weights do not depend on the states, so the ring is full when a job's
//   signal comes. The host packs them in the order of the stage
//   (perm_cuda.packed_weights) and fills every job up to whole stages with
//   zeros, so that a chunk is always the same 8 wgmmas in a straight line:
//   with a branch among them the assembler serialised the MMAs (228 clocks
//   each, not 32).
// - The basis lives in shared memory as bytes, 2,112 B a state, 135,168 B
//   a block, in wgmma's core-matrix order (below), which the consumer's
//   puts and hybp's small dot's fragment loads follow; the scratch tensor of
//   the first port is gone.
// - The reductions left the tensor cores (perm_hybp.cuh says why): they are
//   carry chains in the consumer's registers. hybp's small dot of the
//   newest element and the MDS dots are warp-local: a consumer warp's 32
//   states are an m64 n32 problem of their own, synchronised with
//   __syncwarp(), with several accumulators in flight (an MMA straight
//   after the one it depends on waits out its whole latency).
// - The MDS weights (51,200 B) take the basis's place outside the chain:
//   the producer stages them at the start and again after its last job.
// - The base-2^13 S-box (kSbox13) is field.cuh's sbox13 in the consumer's
//   registers: each raw product a column at a time into a 64-bit
//   accumulator (the 39 columns are never live together), each reduced at
//   once by the same carry chains as sbox's. It is inlined at each call
//   site, the chain's and the full rounds' loops: one copy of it behind a
//   __noinline__ call, and its products rolled into one loop of the
//   general product, ran 2-9% slower at B = 2^14 (tools/probe_chains.py,
//   part 8), and none of the shapes spilled. Instruction fetch does not
//   hold this consumer back as it held the first port's one-thread naive.
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a): hades_perm_hybp 202 registers,
// hades_perm_hyb 198, no spill, 3 barriers; both 225,408 B of dynamic shared
// memory, 192 threads and one block an SM. hyb's consumer waits for its
// job's sums 36% of its clocks (tools/probe_chains.py, part 3; hybp's 11%).

#include <cuda_runtime.h>
#include <stdint.h>

#include "perm_hybp.cuh"
#include "wgmma.cuh"

namespace hades {
namespace hybp {

constexpr int kStates = 64;                    // states a block
constexpr int kProducers = 128;                // threads 0..127: one warpgroup, the producer
constexpr int kConsumers = kStates;            // threads 128..191: one a state
constexpr int kThreads = kProducers + kConsumers;
// Both operands of the producer's wgmma lie in shared memory in its
// core-matrix order without swizzle (wgmma.cuh).
constexpr int kStageK = 256;                   // bytes of K a stage of the ring
constexpr int kStageBytes = kBlockRows * kStageK;           // 16,384 B
constexpr int kStages = 3;
constexpr int kSumStride = kStates + 8;                     // int32 a row of sums
constexpr int kSumBytes = kBlockRows * kSumStride * 4;      // 18,432 B a buffer
constexpr int kNewBytes = kBlockRows * 32;                  // a round's w_new block
constexpr int kXStride = kLinK / 4 + 4;                     // words a row of state bytes

// Dynamic shared memory. The MDS weights and the consumer's tile of state
// bytes take the basis's place while the chain is not running.
constexpr int kOffBasis = 0;
constexpr int kOffLin = 0;
constexpr int kOffX = mxu8::kLinBytes;
static_assert(kOffX + kStates * kXStride * 4 <= kStates * kBasisBytes, "tiles within the basis");
constexpr int kOffRing = kStates * kBasisBytes;
constexpr int kOffSums = kOffRing + kStages * kStageBytes;
constexpr int kOffNew = kOffSums + 2 * kSumBytes;
constexpr int kOffBars = kOffNew + 2 * kNewBytes;
constexpr int kSmemBytes = kOffBars + 16 * 8;
static_assert(kStageK == 256, "perm_cuda.packed_weights fills every job up to whole stages of 256");
static_assert(kSmemBytes <= 232448, "an SM's shared memory");

// Barriers: ready[2] (a signal of the consumer; its 64 threads arrive),
// full[2] (a job's sums and, for a round, its w_new block are in buffer
// q & 1; the producer's 128 threads arrive), free[2] (the consumer has read
// buffer q & 1), lin (the MDS weights are in place), stage[kStages] (a
// chunk of weights has landed in a stage of the ring: one arrival, which
// states the bytes, and the copy's own count of them). Event number n of a
// barrier that alternates with a twin is completion n >> 1 of its own
// barrier and is awaited with parity (n >> 1) & 1.
enum { kBarReady = 0, kBarFull = 2, kBarFree = 4, kBarLin = 6, kBarStage = 8 };

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// A wait that never ends (a fault in the hand-over) traps, so that the
// launch fails and does not hang the card: each try sleeps up to the
// hardware's time slice, and 2^22 of them are seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  int tries = 0;
  do {
    if (++tries > (1 << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One bulk copy (the TMA engine, no tensor map: the bytes are contiguous on
// both sides) of `bytes` from global memory into a stage; the stage's
// barrier is told the count first and completes when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma_u8 (wgmma.cuh): the big dot's sums, 64 x 64, in the warpgroup's
// registers, 32 a thread.

// One MMA of the consumer's, m16 n8 k32, u8 x u8 -> s32, onto c: C[m][n] +=
// sum_k W[m][k] X[n][k] over a 16 x 32 tile of weights (row major) and a
// 32 x 8 tile of byte rows. Fragments (PTX ISA), with g = lane / 4 and
// q = lane % 4:
//   A: a0 = W[g][4q..4q+3], a1 = W[g+8][4q..], a2 = W[g][16+4q..], a3 = W[g+8][16+4q..]
//   B: b0 = X[n=g][4q..4q+3], b1 = X[n=g][16+4q..]
//   C: c0 = C[g][2q], c1 = C[g][2q+1], c2 = C[g+8][2q], c3 = C[g+8][2q+1]
// Bytes with the lower k sit in the lower bits of a register, which is how
// a little-endian 32-bit load of 4 consecutive bytes packs them. Not
// `volatile`: the value depends on the operands alone, and the loops below
// hand the compiler several accumulators at once, so that an MMA need not
// wait for the one before it.
__device__ __forceinline__ void mma(int32_t c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's four sums of an m16 n8 tile, rows g and g + 8, columns 2 q and
// 2 q + 1, to and from a buffer of sums (cr points at row g, column 2 q).
__device__ __forceinline__ void tile_store(int32_t* cr, const int32_t acc[4]) {
  *reinterpret_cast<int2*>(cr) = make_int2(acc[0], acc[1]);
  *reinterpret_cast<int2*>(cr + 8 * kSumStride) = make_int2(acc[2], acc[3]);
}
__device__ __forceinline__ void tile_load(int32_t acc[4], const int32_t* cr) {
  const int2 lo = *reinterpret_cast<const int2*>(cr);
  const int2 hi = *reinterpret_cast<const int2*>(cr + 8 * kSumStride);
  acc[0] = lo.x, acc[1] = lo.y, acc[2] = hi.x, acc[3] = hi.y;
}

// ---------------------------------------------------------------------------
// The consumer's dot (perm_hybp.cuh): thread kProducers + t is state t.
// ---------------------------------------------------------------------------
template <bool kSplit>
struct ConsumerDot {
  uint8_t* smem;
  uint64_t* bars;
  int t;               // the state of the block, 0..63
  const int32_t* cur;  // the sums that col reads
  int signals, lins;

  __device__ __forceinline__ int32_t* sums(int buf) const {
    return reinterpret_cast<int32_t*>(smem + kOffSums + buf * kSumBytes);
  }
  __device__ __forceinline__ void lin_wait() { mbar_wait(bars + kBarLin, lins++ & 1); }

  __device__ __forceinline__ void mds_put(const uint32_t* words) {
    uint32_t* row = reinterpret_cast<uint32_t*>(smem + kOffX) + t * kXStride;
#pragma unroll
    for (int i = 0; i < kWidth * kLimbs; ++i) row[i] = words[i];
    __syncwarp();
  }
  // The warp's own 32 states times block k of the MDS weights: 4 column
  // tiles of 8, 4 row tiles of 16, 5 steps of 32 bytes of K; fragments as
  // `mma` describes them. The sums go to buffer 0.
  __device__ __forceinline__ void mds_run(int k) {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(smem + kOffLin) +
                          k * (kBlockRows * kLinK / 4);
    const uint32_t* x = reinterpret_cast<const uint32_t*>(smem + kOffX);
    int32_t* c = sums(0);
    const int lane = t & 31, g = lane >> 2, q = lane & 3, warp = t >> 5;
    constexpr int kw = kLinK / 4, ks_n = kLinK / 32;
#pragma unroll 1
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b[ks_n][2];
      const uint32_t* xr = x + (warp * 32 + nt * 8 + g) * kXStride;
#pragma unroll
      for (int ks = 0; ks < ks_n; ++ks) {
        b[ks][0] = xr[ks * 8 + q];
        b[ks][1] = xr[ks * 8 + 4 + q];
      }
      // the four row tiles side by side: four accumulators in flight
      int32_t acc[kBlockRows / 16][4];
#pragma unroll
      for (int mt = 0; mt < kBlockRows / 16; ++mt) {
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
      }
#pragma unroll
      for (int ks = 0; ks < ks_n; ++ks) {
#pragma unroll
        for (int mt = 0; mt < kBlockRows / 16; ++mt) {
          const uint32_t* w0 = w32 + (mt * 16 + g) * kw;
          const uint32_t* w1 = w0 + 8 * kw;
          mma(acc[mt], w0[ks * 8 + q], w1[ks * 8 + q], w0[ks * 8 + 4 + q], w1[ks * 8 + 4 + q],
              b[ks][0], b[ks][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kBlockRows / 16; ++mt) {
        tile_store(c + (mt * 16 + g) * kSumStride + warp * 32 + nt * 8 + 2 * q, acc[mt]);
      }
    }
    __syncwarp();
    cur = c;
  }
  __device__ __forceinline__ void mds_done() { __syncwarp(); }

  // Both consumer warps have left the full rounds: the basis may overwrite
  // the MDS weights.
  __device__ __forceinline__ void chain_begin() {
    named_barrier(2, kConsumers);
    signals = 0;
  }
  // Element j of this state: vectors 2 j and 2 j + 1 of row t.
  __device__ __forceinline__ void basis_put(int j, const uint32_t* words) {
    uint8_t* dst = smem + kOffBasis + 2 * j * kVecBytes + (t >> 3) * kRowGroupBytes + (t & 7) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    *reinterpret_cast<uint4*>(dst + kVecBytes) = make_uint4(words[4], words[5], words[6], words[7]);
  }
  __device__ __forceinline__ void basis_signal() {
    fence_async_smem();  // the puts, before the producer's wgmma reads them
    mbar_arrive(bars + kBarReady + (signals & 1));
    ++signals;
  }
  // Wait for the producer's sums of job q; with the split, for a round after
  // the first, add the newest element's dot on top of them, in place: the
  // warp's 32 states (their element 5 + q, which the warp's own threads have
  // just put) times the round's 64 x 32 block of w_new, 16 MMAs.
  __device__ __forceinline__ void job_cols(int q) {
    const int buf = q & 1;
    mbar_wait(bars + kBarFull + buf, (q >> 1) & 1);
    int32_t* c = sums(buf);
    if (kSplit && q > 0 && q < kPartialRounds) {
      __syncwarp();  // the warp's puts of s_{q-1}
      const int lane = t & 31, g = lane >> 2, qq = lane & 3, warp = t >> 5;
      const uint32_t* w32 = reinterpret_cast<const uint32_t*>(smem + kOffNew + buf * kNewBytes);
      // row g of the warp's row group nt of the element's two vectors
      const uint8_t* y = smem + kOffBasis + 2 * (kWidth + q) * kVecBytes +
                         warp * 4 * kRowGroupBytes + g * 16 + 4 * qq;
      // all the loads, then the 16 MMAs (each onto its own tile of the
      // sums), then all the stores: written in turn, a tile's load would
      // wait for the store of the tile before it
      int32_t acc[4][kBlockRows / 16][4];
      uint32_t a[kBlockRows / 16][4], bb[4][2];
      int32_t* c0 = c + g * kSumStride + warp * 32 + 2 * qq;
#pragma unroll
      for (int mt = 0; mt < kBlockRows / 16; ++mt) {
        const uint32_t* w0 = w32 + (mt * 16 + g) * 8;
        a[mt][0] = w0[qq], a[mt][1] = w0[8 * 8 + qq], a[mt][2] = w0[4 + qq],
        a[mt][3] = w0[8 * 8 + 4 + qq];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bb[nt][0] = *reinterpret_cast<const uint32_t*>(y + nt * kRowGroupBytes);
        bb[nt][1] = *reinterpret_cast<const uint32_t*>(y + nt * kRowGroupBytes + kVecBytes);
#pragma unroll
        for (int mt = 0; mt < kBlockRows / 16; ++mt) {
          tile_load(acc[nt][mt], c0 + mt * 16 * kSumStride + nt * 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int mt = 0; mt < kBlockRows / 16; ++mt) {
          mma(acc[nt][mt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], bb[nt][0], bb[nt][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int mt = 0; mt < kBlockRows / 16; ++mt) {
          tile_store(c0 + mt * 16 * kSumStride + nt * 8, acc[nt][mt]);
        }
      }
      __syncwarp();
    }
    cur = c;
  }
  __device__ __forceinline__ void job_done(int q) { mbar_arrive(bars + kBarFree + (q & 1)); }
  __device__ __forceinline__ uint32_t col(int i) const {
    return (uint32_t)cur[i * kSumStride + t];
  }
};

// ---------------------------------------------------------------------------
// The producer: threads 0..127, one warpgroup.
// ---------------------------------------------------------------------------

// The MDS weights into their place, then the `lin` barrier.
__device__ __forceinline__ void stage_lin(uint8_t* smem, uint64_t* bars, const uint4* weights,
                                          int p) {
  uint4* dst = reinterpret_cast<uint4*>(smem + kOffLin);
  for (int i = p; i < mxu8::kLinBytes / 16; i += kProducers) dst[i] = weights[i];
  mbar_arrive(bars + kBarLin);
}

// A job's K in whole stages: the packed table (packed_weights,
// ops/perm_cuda.py) fills the rows up with zeros, which meet whatever lies
// behind the job's bytes of the basis (for the exit, the ring). Every chunk
// is then the same straight run of kStageK / 32 wgmmas, with no branch
// among them: the assembler keeps MMAs in flight only where it can follow
// every use of their registers.
template <bool kSplit>
__device__ __forceinline__ int job_chunks(int q) {
  return (job_k(q, kSplit) + kStageK - 1) / kStageK;
}

// The producer's place in the packed table: chunk c of job q, at byte `at`.
template <bool kSplit>
struct Chunk {
  int q, c;
  uint32_t at;
  __device__ __forceinline__ void next() {
    at += kStageBytes;
    if (++c == job_chunks<kSplit>(q)) {
      ++q;
      c = 0;
    }
  }
};

// The 64 jobs of the table kSplit chooses. A job is one m64 n64 product over K = job_k(q) bytes: a wgmma
// takes 32 bytes of K, its A operand the weights of a stage of the ring, its
// B operand the basis, both by descriptor; the 64 x 64 sums stay in the
// warpgroup's registers over the job. Thread 0 keeps the ring kStages - 1
// chunks ahead of the MMAs, across jobs: the weights do not depend on the
// states. Chunk number `turn` sits in stage turn % kStages.
template <bool kSplit>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* bars,
                                        const uint8_t* __restrict__ packed,
                                        const uint8_t* __restrict__ chain_w,
                                        const uint4* weights, int p) {
  stage_lin(smem, bars, weights, p);
  const int lane = p & 31, g = lane >> 2, q4 = lane & 3, warp = p >> 5;
  int turn = 0;
  Chunk<kSplit> ahead{0, 0, 0u};
  if (p == 0) {
#pragma unroll 1
    for (int i = 0; i < kStages - 1; ++i, ahead.next()) {
      bulk_copy(smem + kOffRing + i * kStageBytes, packed + ahead.at, kStageBytes,
                bars + kBarStage + i);
    }
  }
#pragma unroll 1
  for (int q = 0; q < kJobs; ++q) {
    const int sig = job_signal(q, kSplit);
    mbar_wait(bars + kBarReady + (sig & 1), (sig >> 1) & 1);
    // the round's block of w_new, for the consumer's small dot: asked for
    // now, put beside the sums at the end
    const bool with_new = kSplit && q > 0 && q < kPartialRounds;
    uint4 nw = make_uint4(0u, 0u, 0u, 0u);
    static_assert(kNewBytes == 16 * kProducers, "a vector a thread");
    if (with_new) nw = reinterpret_cast<const uint4*>(new_w(chain_w, q))[p];
    int32_t acc[32];
    pin(acc);
    const int chunks = job_chunks<kSplit>(q);
#pragma unroll 1
    for (int c = 0; c < chunks; ++c, ++turn) {
      const int stage = turn % kStages;
      mbar_wait(bars + kBarStage + stage, (turn / kStages) & 1);
      const uint64_t da = smem_desc(smem + kOffRing + stage * kStageBytes);
      const uint64_t db = smem_desc(smem + kOffBasis + c * (kStageK / 16) * kVecBytes);
      wgmma_fence();
      wgmma_u8(acc, da, db, c != 0);
#pragma unroll
      for (int s = 1; s < kStageK / 32; ++s) {
        // 32 bytes of K on: two vectors
        wgmma_u8(acc, da + s * kDescStep, db + s * kDescStep, 1);
      }
      wgmma_commit();
      // the chunk before is done in this warp, then in all four: its stage
      // is free for the chunk kStages - 1 ahead
      wgmma_wait<1>();
      named_barrier(1, kProducers);
      if (p == 0) {
        if (ahead.q < kJobs) {
          const int into = (turn + kStages - 1) % kStages;
          bulk_copy(smem + kOffRing + into * kStageBytes, packed + ahead.at, kStageBytes,
                    bars + kBarStage + into);
          ahead.next();
        }
      }
    }
    wgmma_wait<0>();
    pin(acc);
    // hand the sums over in buffer q & 1, once job q - 2's have been read
    const int buf = q & 1;
    if (q >= 2) mbar_wait(bars + kBarFree + buf, ((q - 2) >> 1) & 1);
    int32_t* cs = reinterpret_cast<int32_t*>(smem + kOffSums + buf * kSumBytes) +
                  (warp * 16 + g) * kSumStride + 2 * q4;
#pragma unroll
    for (int j = 0; j < kStates / 8; ++j) tile_store(cs + 8 * j, acc + 4 * j);
    if (with_new) reinterpret_cast<uint4*>(smem + kOffNew + buf * kNewBytes)[p] = nw;
    mbar_arrive(bars + kBarFull + buf);
  }
  // every warp's last MMA has read the basis: the MDS weights take its place
  named_barrier(1, kProducers);
  stage_lin(smem, bars, weights, p);
}

// A block: the producer warpgroup, then the consumer's 64 threads, one a
// state. Tail lanes of the last block run a zero state (every consumer
// thread must reach the barriers and the warp-wide MMAs); only their store
// is masked. kSbox13 chooses the consumer's S-box, kSplit the job table.
template <bool kSplit, bool kSbox13>
__device__ __forceinline__ void perm_block(uint8_t* smem, const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out, long long n, int convert,
                                           const uint32_t* __restrict__ consts,
                                           const uint8_t* __restrict__ weights,
                                           const uint8_t* __restrict__ chain_w,
                                           const uint8_t* __restrict__ packed) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kOffBars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + kBarReady + i, kConsumers);
      mbar_init(bars + kBarFull + i, kProducers);
      mbar_init(bars + kBarFree + i, kConsumers);
    }
    mbar_init(bars + kBarLin, kProducers);
    for (int i = 0; i < kStages; ++i) mbar_init(bars + kBarStage + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < kProducers) {
    produce<kSplit>(smem, bars, packed, chain_w, reinterpret_cast<const uint4*>(weights),
                    (int)threadIdx.x);
    return;
  }
  const int t = (int)threadIdx.x - kProducers;
  const long long b = (long long)blockIdx.x * kStates + t;
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
  ConsumerDot<kSplit> d{smem, bars, t, nullptr, 0, 0};
  perm<kSbox13>(d, s, consts, convert != 0);
  if (live) store_state(out, s, b, n);
}

}  // namespace hybp
}  // namespace hades

using namespace hades;

__global__ void __launch_bounds__(hybp::kThreads, 1)
hades_perm_hybp(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                int convert, const uint32_t* __restrict__ consts,
                const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                const uint8_t* __restrict__ packed) {
  extern __shared__ __align__(128) uint8_t smem[];
  hybp::perm_block<true, false>(smem, x, out, n, convert, consts, weights, chain_w, packed);
}

__global__ void __launch_bounds__(hybp::kThreads, 1)
hades_perm_hyb(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
               int convert, const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
               const uint8_t* __restrict__ packed) {
  extern __shared__ __align__(128) uint8_t smem[];
  hybp::perm_block<false, false>(smem, x, out, n, convert, consts, weights, chain_w, packed);
}

__global__ void __launch_bounds__(hybp::kThreads, 1)
hades_perm_hybp13(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                  int convert, const uint32_t* __restrict__ consts,
                  const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                  const uint8_t* __restrict__ packed) {
  extern __shared__ __align__(128) uint8_t smem[];
  hybp::perm_block<true, true>(smem, x, out, n, convert, consts, weights, chain_w, packed);
}

__global__ void __launch_bounds__(hybp::kThreads, 1)
hades_perm_hyb13(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                 int convert, const uint32_t* __restrict__ consts,
                 const uint8_t* __restrict__ weights, const uint8_t* __restrict__ chain_w,
                 const uint8_t* __restrict__ packed) {
  extern __shared__ __align__(128) uint8_t smem[];
  hybp::perm_block<false, true>(smem, x, out, n, convert, consts, weights, chain_w, packed);
}

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes (ops/perm_cuda.py)
// ---------------------------------------------------------------------------

// Check the pointers, allow the block's shared memory (above the 48 KB
// default) and launch one of the four instances; returns its status.
template <typename Kernel>
static int launch_chain(Kernel kernel, const void* x, void* out, long long n, int convert,
                        const void* consts, const void* weights, const void* chain_w,
                        const void* packed, void* stream) {
  const unsigned grid = grid_for(n, hybp::kStates);
  if (grid == 0) return kErrBatch;
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(chain_w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return kErrShape;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hybp::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, hybp::kThreads, hybp::kSmemBytes, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n, convert, (const uint32_t*)consts,
      (const uint8_t*)weights, (const uint8_t*)chain_w, (const uint8_t*)packed);
  return (int)cudaGetLastError();
}

extern "C" {

// consts: hybp::kConstWords uint32 (the dense Montgomery ARK, R^2, R mod p,
// as 32-bit limbs); weights: mxu8::kWeightBytes, of which the kernel takes
// w_lin, the first mxu8::kLinBytes; chain_w: hybp::chain_bytes(true) of
// wo_seg1, wo_seg2, w_new, w_out (params.hybp_tables), of which the kernel
// reads w_new; packed: the 64 jobs' weights in the order of the ring's
// stages (perm_cuda.packed_weights("hybp")). All are device pointers,
// 16-byte aligned, that the caller keeps alive.
int hades_perm_hybp_launch(const void* x, void* out, long long n, int convert,
                           const void* consts, const void* weights, const void* chain_w,
                           const void* packed, void* stream) {
  return launch_chain(hades_perm_hybp, x, out, n, convert, consts, weights, chain_w, packed,
                      stream);
}

// As hades_perm_hybp_launch, with hyb's tables: chain_w holds
// hybp::chain_bytes(false) of w_seg1, w_seg2, w_out (params.hyb_tables),
// which the kernel does not read; packed is perm_cuda.packed_weights("hyb"),
// each round's whole dot a job.
int hades_perm_hyb_launch(const void* x, void* out, long long n, int convert,
                          const void* consts, const void* weights, const void* chain_w,
                          const void* packed, void* stream) {
  return launch_chain(hades_perm_hyb, x, out, n, convert, consts, weights, chain_w, packed,
                      stream);
}

// As hades_perm_hybp_launch (hybp's tables and packed jobs), with every
// S-box's raw products in base-2^13 digits.
int hades_perm_hybp13_launch(const void* x, void* out, long long n, int convert,
                             const void* consts, const void* weights, const void* chain_w,
                             const void* packed, void* stream) {
  return launch_chain(hades_perm_hybp13, x, out, n, convert, consts, weights, chain_w, packed,
                      stream);
}

// As hades_perm_hyb_launch (hyb's tables and packed jobs), with every S-box's
// raw products in base-2^13 digits.
int hades_perm_hyb13_launch(const void* x, void* out, long long n, int convert,
                            const void* consts, const void* weights, const void* chain_w,
                            const void* packed, void* stream) {
  return launch_chain(hades_perm_hyb13, x, out, n, convert, consts, weights, chain_w, packed,
                      stream);
}

}  // extern "C"
