"""Probe where the permutation kernels' dependent chains spend their cycles.

    python3 tools/probe_chains.py            (on a host with an H100 and nvcc)

The card's host has no profiler that reads a kernel's stalls, so this
script builds variants of the kernels' sources and times them. It copies
`hades252_tpu_torch/ops/csrc/` (or the directory after `--csrc`, for the
sources of another commit) into `build/probe/<variant>/`, applies the
variant's textual patches and flags, compiles one `.cu` file with nvcc and
calls the launch entry through ctypes; the compilers all run at once. A
patch whose text is not in the tree (the sources moved on) drops its variant
with a note; the others run. `--parts 1,3` runs only those parts.

Part 1, `perm.cu` (`naive`, `opt`), B = 2^14, CUDA events, median of 7:
  base           the sources as they are;
  noreduce       `mont_mul` without its reduction half (m p is not added;
                 outputs are wrong, the chain's length is what is timed);
  nocondsub      `cond_sub_p` returns its input;
  r128, r168     `-maxrregcount` 128 and 168;
  t64, t256      64 and 256 threads a block;
and the base at B = 2^10, 2^16 and 2^18. The SASS of a kernel that holds
one `mont_mul` is counted by opcode (`cuobjdump -sass`).

Part 2, the first port's `perm_hyb.cu` (`hyb`, and `hybp` in the oldest
sources), B = 2^14, only with `--csrc` naming a tree that still has that
file (an earlier commit's sources; this tree has none, and the part says so
and is skipped): `clock64()` sums of thread 0
of every block, a section at a time (the wide dot with its stage copies and
barriers; the small dots; the barriers of `put` and `done`; `recombine`;
`mul_wide`; `ladder9`), divided by the number of blocks. The sections are
leaves, so they do not overlap; the rest of the kernel's clocks is the
remainder. Outputs stay right on this build and are checked against the
uninstrumented `naive` kernel.

Part 3, on this tree's sources. `perm.cu`: `hades_perm_opt` and
`hades_perm_naive` with their group of lanes forced to 4, 2 and 1 at B =
2^10 .. 2^18, outputs held against `opt`'s, which is where the thresholds
(`kGroup4Max`, `kGroup2Max`, `kNaiveGroup4Max`, `kNaiveGroup2Max`) come
from; and `naive` at 4 and 2 lanes with row 4 of the MDS whole in every
lane (`g4w`, `g2w`) in place of a share a lane summed over the group.
`perm_hybp.cu`, `hybp`, `hyb`, `hybp13` and `hyb13`: `clock64()` sums of the first
consumer thread and the first producer thread of every block, a section at
a time (consumer: the wait for a job's sums, the small dot, `recombine`, the
big reduction, the S-box, the MDS dots; producer: the waits for a basis
element, for a stage of weights, for the MMAs of the chunk before with the
warpgroup's barrier, for a free sums buffer, and the write of the sums; the
rest of the producer's time goes to its wgmma instructions), at B = 2^10 (one
block an SM, no second wave) and 2^14.

Part 4, the dense kernels `mxu8` and `mxu`: the first port's (the sources
after `--csrc`; skipped with a note where its patches do not apply) and
this tree's, by section as in part 2 (first port: the S-box's raw products,
the REDCs' dots, the MDS dots, the `put` and `done` barriers, `recombine`,
the ladder; this tree: the S-box, the 17-limb reductions, `recombine`, and
the dot's `mds_put`, `mds_run` and `mds_done`), at B = 2^14; then the MDS
tile product alone (67 rounds of 5 blocks of 64 x 160, both operands in
shared memory) through `mma.sync` m16n8k32 u8 on a warp's 32 states and
through `wgmma` m64n64k32 u8 and m64n64k16 bf16 on a warpgroup's 128, at 1
to 4 warps a scheduler.

Part 5: every kernel (`COMPARE`), each built from the sources after
`--csrc` and from this tree's, from whichever source file of each tree
exports its launch, and timed in turns in one process (parent, change,
change, parent) at B = 2^14, outputs compared: what a change moved and
what it must not move.

Part 6: the dense kernels' variants (`DENSE_VARIANTS`: the MDS layer's five
values reduced together after the last dot, as the sources do, or each
under the next block's wgmmas), timed in turns at B = 2^14 and 2^18.

Part 7, `perm.cu`'s one-thread-a-state `naive` (the sources after
`--csrc`): the SASS instruction count of `hades_perm_naive`, its registers
and its time at B = 2^10 and 2^14 as it is and with `#pragma unroll 1` over
`mds_layer`'s rows, over `full_round`'s words, and over both: whether
instruction fetch holds it back.

Part 8, the base-2^13 S-box's code shape in the `hyb13` and `hybp13`
kernels (`S13_VARIANTS`): sbox13 inlined at each call site as written
(the chain's and each full-round loop's), one copy of it behind a
`__noinline__` call, its three products rolled into one loop of the
general product, and both; for each the kernels' registers, SASS
instruction counts and times at B = 2^10 and 2^14 (outputs against the
plain `opt`), and the consumer's clocks by section at 2^14 as in part 3.

Everything is printed, with the card's name and power limit on every line
that carries a time, and written to `probe_chains.txt` (and the SASS of one
`mont_mul` to `probe_one_mul.sass`) under `build/probe/`, or under the
directory after `--out`.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hades252_tpu_torch.ops import _build, perm_cuda  # noqa: E402

# `--csrc DIR` probes another tree's sources (an earlier commit's, unpacked
# with `git archive`) through this tree's tables and wrappers.
CSRC = Path(sys.argv[sys.argv.index("--csrc") + 1]).resolve() if "--csrc" in sys.argv \
    else _build.CSRC
OUT = ROOT / "build" / "probe"
REPORTS = Path(sys.argv[sys.argv.index("--out") + 1]).resolve() if "--out" in sys.argv else OUT
LINES: list[str] = []
BASE: dict = {}  # the unpatched naive launch, part 2's reference
STARTED: dict = {}  # variant -> its running compiler
FINISHED: dict = {}  # variant -> its library, once its compiler is done (part 5)


def say(msg: str) -> None:
    print(msg, flush=True)
    LINES.append(msg)


# variant -> (patches [(file, old, new)], extra nvcc flags)
REDUCE_OLD = "      c += (uint64_t)m * p_limb(j) + t[j];"
REDUCE_NEW = "      c += (uint64_t)t[j];"
CONDSUB_OLD = "  for (int j = 0; j < kLimbs; ++j) r[j] = borrow ? t[j] : d[j];\n}\n\n// r = (a + b)"
CONDSUB_NEW = "  for (int j = 0; j < kLimbs; ++j) r[j] = t[j];\n}\n\n// r = (a + b)"
THREADS_OLD = "constexpr int kThreads = 128;"
ONE_MUL = """
__global__ void probe_one_mul(uint32_t* v) {
  uint32_t a[kLimbs], b[kLimbs];
  for (int j = 0; j < kLimbs; ++j) { a[j] = v[j]; b[j] = v[kLimbs + j]; }
  mont_mul(a, a, b);
  for (int j = 0; j < kLimbs; ++j) v[j] = a[j];
}
"""
PERM_VARIANTS = {
    "base": ([("perm.cu", 'extern "C" {', ONE_MUL + '\nextern "C" {')], []),
    "noreduce": ([("field.cuh", REDUCE_OLD, REDUCE_NEW)], []),
    "nocondsub": ([("field.cuh", CONDSUB_OLD, CONDSUB_NEW)], []),
    "r128": ([], ["-maxrregcount", "128"]),
    "r168": ([], ["-maxrregcount", "168"]),
    "t64": ([("perm.cu", THREADS_OLD, "constexpr int kThreads = 64;")], []),
    "t256": ([("perm.cu", THREADS_OLD, "constexpr int kThreads = 256;")], []),
}

PROF_HEAD = """
#ifdef __CUDACC__
namespace hades { namespace prof {
static __device__ unsigned long long g_clk[8];
struct Tic {
  long long t0; int k;
#ifdef __CUDA_ARCH__
  __device__ __forceinline__ Tic(int kk) : t0(clock64()), k(kk) {}
  __device__ __forceinline__ ~Tic() {
    if (threadIdx.x == 0) atomicAdd(&g_clk[k], (unsigned long long)(clock64() - t0));
  }
#else
  __device__ Tic(int kk) : t0(0), k(kk) {}
#endif
};
} }
#define PROF(k) hades::prof::Tic prof_tic_(k)
#else
#define PROF(k)
#endif
"""
SECTIONS = ["kernel", "wide dot (stage copies, barriers)", "small dots", "put barrier",
            "done barrier", "recombine", "mul_wide", "ladder9"]
HYB_PATCHES = [
    ("field.cuh", "namespace hades {\n\nconstexpr int kLimbs", PROF_HEAD + "\nnamespace hades {\n\nconstexpr int kLimbs"),
    ("perm_hyb_block.cuh", "    wide_dot(w, k, y, kYVecs, c,", "    PROF(1);\n    wide_dot(w, k, y, kYVecs, c,"),
    ("mma_tile.cuh", '    static_assert(M % 16 == 0 && K % 32 == 0, "MMA tile shape");\n    block_dot<K / 32>',
     '    PROF(2);\n    block_dot<K / 32>'),
    ("mma_tile.cuh", "    for (int i = 0; i < N; ++i) row[i] = words[i];\n    __syncthreads();",
     "    for (int i = 0; i < N; ++i) row[i] = words[i];\n    PROF(3);\n    __syncthreads();"),
    ("mma_tile.cuh", "void done() { __syncthreads(); }", "void done() { PROF(4); __syncthreads(); }"),
    ("perm_mxu8.cuh", "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n",
     "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n  PROF(5);\n"),
    ("perm_mxu8.cuh", "                       const uint32_t b[kLimbs]) {\n#pragma unroll\n  for (int j = 0; j < 2 * kLimbs; ++j) t[j] = 0;",
     "                       const uint32_t b[kLimbs]) {\n  PROF(6);\n#pragma unroll\n  for (int j = 0; j < 2 * kLimbs; ++j) t[j] = 0;"),
    ("perm_mxu8.cuh", 'static_assert(RUNGS >= 0 && RUNGS <= 5, "2^(RUNGS-1) p must fit 9 limbs");',
     'static_assert(RUNGS >= 0 && RUNGS <= 5, "2^(RUNGS-1) p must fit 9 limbs");\n  PROF(7);'),
    ("perm_hyb_block.cuh", "  const uint4* src = reinterpret_cast<const uint4*>(weights);\n  for (int i = threadIdx.x; i < mxu8::kWeightBytes / 16; i += kThreads) {\n    reinterpret_cast<uint4*>(smem)[i] = src[i];",
     "  PROF(0);\n  const uint4* src = reinterpret_cast<const uint4*>(weights);\n  for (int i = threadIdx.x; i < mxu8::kWeightBytes / 16; i += kThreads) {\n    reinterpret_cast<uint4*>(smem)[i] = src[i];"),
    ("perm_hyb.cu", 'extern "C" {', 'extern "C" {\nint hades_prof_read(unsigned long long* out) {\n'
     '  cudaError_t e = cudaMemcpyFromSymbol(out, hades::prof::g_clk, sizeof(hades::prof::g_clk));\n'
     '  unsigned long long z[8] = {0};\n  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hades::prof::g_clk, z, sizeof(z));\n'
     '  return (int)e;\n}\n'),
]


def group_variants() -> dict:
    """opt's and naive's thresholds (the lines of this tree's perm.cu), each
    pair forced to one group size; naive at 4 and 2 lanes also with row 4
    whole (ROW4_WHOLE)."""
    text = (_build.CSRC / "perm.cu").read_text()
    old = {(kernel, g): re.search(rf"constexpr long long k{kernel}Group{g}Max = [^;]*;",
                                  text).group(0)
           for kernel in ("", "Naive") for g in (2, 4)}
    variants = {
        name: [("perm.cu", old[(kernel, g)], f"constexpr long long k{kernel}Group{g}Max = {value};")
               for kernel in ("", "Naive") for g, value in zip((4, 2), values)]
        for name, values in (("g4", ("1LL << 40", "1LL << 40")), ("g2", ("0", "1LL << 40")),
                             ("g1", ("0", "0")))
    }
    for name in ("g4", "g2"):
        variants[f"{name}w"] = variants[name] + [("perm.cuh", ROW4_SHARE, ROW4_WHOLE)]
    return variants


# naive's row 4 as every lane's whole row (5 products), in place of the
# sources' share a lane summed over the group by exchanges plus m[4][4] x4
# (2 products at 4 lanes), with the group forced (group_variants).
ROW4_SHARE = """#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) {
      uint32_t t[kLimbs];
      mont_mul(t, g.own[l][k], g_mds[4][g.lane(l) + G * k]);
      if (k == 0) copy(part[l], t); else add_mod(part[l], part[l], t);
    }
#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) row_dot<kWidth>(g.own[l][k], g_mds[g.lane(l) + G * k], all[l]);
  }
#pragma unroll
  for (int mask = 1; mask < G; mask <<= 1) {
    lanes_xor<G>(other, part, mask);
    HADES_EACH_LANE(l) add_mod(part[l], part[l], other[l]);
  }
  HADES_EACH_LANE(l) {
    uint32_t t[kLimbs];
    mont_mul(t, all[l][4], g_mds[4][4]);
    add_mod(g.s4[l], part[l], t);
  }
}"""
ROW4_WHOLE = """#pragma unroll 1
    for (int k = 0; k < kOwn; ++k) row_dot<kWidth>(g.own[l][k], g_mds[g.lane(l) + G * k], all[l]);
    row_dot<kWidth>(g.s4[l], g_mds[4], all[l]);
  }
  (void)part;
  (void)other;
}"""

HYBP = "perm_hybp.cu"
HYBP_SECTIONS = ["consumer: kernel", "consumer: wait for a job's sums", "consumer: small dot",
                 "consumer: recombine", "consumer: big reduction", "consumer: S-box",
                 "consumer: MDS dots", "consumer: wait for the MDS weights",
                 "producer: kernel", "producer: wait for a basis element",
                 "producer: wait for a stage of weights",
                 "producer: wait for the chunk before, and the barrier",
                 "producer: wait for a free sums buffer", "producer: write the sums",
                 "producer: wait for a job's last MMAs"]
HYBP_PATCHES = [
    ("field.cuh", "namespace hades {\n\nconstexpr int kLimbs",
     PROF_HEAD.replace("g_clk[8]", "g_clk[16]")
     .replace("threadIdx.x == 0", "threadIdx.x == 0 || threadIdx.x == 128")
     + "\nnamespace hades {\n\nconstexpr int kLimbs"),
    (HYBP, "  ConsumerDot<kSplit> d{smem, bars, t, nullptr, 0, 0};",
     "  PROF(0);\n  ConsumerDot<kSplit> d{smem, bars, t, nullptr, 0, 0};"),
    (HYBP, "    mbar_wait(bars + kBarFull + buf, (q >> 1) & 1);\n    int32_t* c = sums(buf);",
     "    { PROF(1); mbar_wait(bars + kBarFull + buf, (q >> 1) & 1); }\n    int32_t* c = sums(buf);"),
    (HYBP, "      __syncwarp();  // the warp's puts of s_{q-1}",
     "      PROF(2);\n      __syncwarp();  // the warp's puts of s_{q-1}"),
    ("perm_mxu8.cuh", "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n",
     "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n  PROF(3);\n"),
    ("perm_dense.cuh", "  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>",
     "  PROF(4);\n  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>"),
    ("field.cuh", "  uint32_t x2[kLimbs], x4[kLimbs];\n  mont_sqr(x2, x);",
     "  PROF(5);\n  uint32_t x2[kLimbs], x4[kLimbs];\n  mont_sqr(x2, x);"),
    ("field.cuh", "HADES_FN void sbox13(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {\n",
     "HADES_FN void sbox13(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {\n  PROF(5);\n"),
    (HYBP, "  __device__ __forceinline__ void mds_run(int k) {\n",
     "  __device__ __forceinline__ void mds_run(int k) {\n    PROF(6);\n"),
    (HYBP, "  __device__ __forceinline__ void lin_wait() { mbar_wait(bars + kBarLin, lins++ & 1); }",
     "  __device__ __forceinline__ void lin_wait() { PROF(7); mbar_wait(bars + kBarLin, lins++ & 1); }"),
    (HYBP, "  stage_lin(smem, bars, weights, p);\n  const int lane = p & 31",
     "  PROF(8);\n  stage_lin(smem, bars, weights, p);\n  const int lane = p & 31"),
    (HYBP, "    mbar_wait(bars + kBarReady + (sig & 1), (sig >> 1) & 1);",
     "    { PROF(9); mbar_wait(bars + kBarReady + (sig & 1), (sig >> 1) & 1); }"),
    (HYBP, "      mbar_wait(bars + kBarStage + stage, (turn / kStages) & 1);",
     "      { PROF(10); mbar_wait(bars + kBarStage + stage, (turn / kStages) & 1); }"),
    (HYBP, "      wgmma_wait<1>();\n      named_barrier(1, kProducers);",
     "      { PROF(11); wgmma_wait<1>();\n      named_barrier(1, kProducers); }"),
    (HYBP, "    wgmma_wait<0>();\n    pin(acc);", "    { PROF(14); wgmma_wait<0>(); }\n    pin(acc);"),
    (HYBP, "    if (q >= 2) mbar_wait(bars + kBarFree + buf, ((q - 2) >> 1) & 1);",
     "    if (q >= 2) { PROF(12); mbar_wait(bars + kBarFree + buf, ((q - 2) >> 1) & 1); }\n"
     "    PROF(13);"),
    (HYBP, 'extern "C" {', 'extern "C" {\nint hades_prof_read(unsigned long long* out) {\n'
     '  cudaError_t e = cudaMemcpyFromSymbol(out, hades::prof::g_clk, sizeof(hades::prof::g_clk));\n'
     '  unsigned long long z[16] = {0};\n  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hades::prof::g_clk, z, sizeof(z));\n'
     '  return (int)e;\n}\n'),
]


# Part 4: where the first port's dense kernels (`mxu8`, `mxu`: perm_mxu8.cuh's
# per-state code on mma_tile.cuh's block dot) spend a block's clocks. Thread
# 0 of every block sums its clocks by section; the sections are leaves.
DENSE_SECTIONS = ["kernel", "S-box raw products (mul_wide)",
                  "REDC dots: MMAs and the barrier after them",
                  "MDS dots: MMAs and the barrier after them", "put: barrier",
                  "done: barrier", "recombine", "ladder9"]
DENSE_PATCHES = [
    HYB_PATCHES[0],
    ("mma_tile.cuh", "  perm(d, s, consts, convert != 0);\n  if (live) store_state",
     "  { PROF(0); perm(d, s, consts, convert != 0); }\n  if (live) store_state"),
    ("mma_tile.cuh", '"MMA tile shape");\n    block_dot<K / 32>(w',
     '"MMA tile shape");\n    hades::prof::Tic prof_tic_(K == 32 ? 2 : 3);\n    block_dot<K / 32>(w'),
    ("mma_tile.cuh", '"MMA tile shape");\n    block_dot_bf16<K / 32>(w',
     '"MMA tile shape");\n    hades::prof::Tic prof_tic_(K == 32 ? 2 : 3);\n    block_dot_bf16<K / 32>(w'),
    (HYB_PATCHES[3][0], HYB_PATCHES[3][1], HYB_PATCHES[3][2].replace("PROF(3)", "PROF(4)")),
    ("mma_tile.cuh", "void done() { __syncthreads(); }", "void done() { PROF(5); __syncthreads(); }"),
    (HYB_PATCHES[5][0], HYB_PATCHES[5][1], HYB_PATCHES[5][2].replace("PROF(5)", "PROF(6)")),
    (HYB_PATCHES[6][0], HYB_PATCHES[6][1], HYB_PATCHES[6][2].replace("PROF(6)", "PROF(1)")),
    HYB_PATCHES[7],
]
PROF_READ = ('extern "C" {', 'extern "C" {\nint hades_prof_read(unsigned long long* out) {\n'
             '  cudaError_t e = cudaMemcpyFromSymbol(out, hades::prof::g_clk, sizeof(hades::prof::g_clk));\n'
             '  unsigned long long z[8] = {0};\n  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hades::prof::g_clk, z, sizeof(z));\n'
             '  return (int)e;\n}\n')

# The MDS tile product alone at the dense kernels' shape, 67 rounds of 5
# blocks of (64 x 160) weights times the state bytes, both operands in
# shared memory, no reduction around it: each warp's 32 states through
# mma.sync m16n8k32 u8 (the loop of perm_hybp.cu's mds_run), or each
# warpgroup's 128 states through wgmma m64n64k32 u8 or m64n64k16 bf16 (two
# halves of 64 states, 10 or 20 wgmmas a block between one fence and one
# commit). Blocks of W warpgroups, one block an SM: W warps a scheduler.
MDS_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "wgmma.cuh"
using namespace hades;
constexpr int kR = 67;
__device__ unsigned long long g_clk[2];  // clocks summed over warps, and warps
__device__ __forceinline__ void mma(int32_t c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void tally(long long t0, int chk, int* sink) {
  const long long t1 = clock64();
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_clk[0], (unsigned long long)(t1 - t0));
    atomicAdd(&g_clk[1], 1ull);
  }
  if (chk == 0x1234567) sink[0] = chk;
}
__global__ void probe_mma(int* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* w32 = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 51200 / 4; i += blockDim.x) w32[i] = i * 2654435761u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint32_t* xw = w32 + 51200 / 4 + warp * 32 * 44;
  for (int i = lane; i < 32 * 44; i += 32) xw[i] = i * 40503u + warp;
  __syncthreads();
  int chk = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < kR; ++r) {
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
#pragma unroll 1
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b[5][2];
        const uint32_t* xr = xw + (nt * 8 + g) * 44;
#pragma unroll
        for (int ks = 0; ks < 5; ++ks) b[ks][0] = xr[ks * 8 + q], b[ks][1] = xr[ks * 8 + 4 + q];
        int32_t acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < 5; ++ks) {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            const uint32_t* w0 = w32 + k * 64 * 40 + (mt * 16 + g) * 40;
            const uint32_t* w1 = w0 + 8 * 40;
            mma(acc[mt], w0[ks * 8 + q], w1[ks * 8 + q], w0[ks * 8 + 4 + q], w1[ks * 8 + 4 + q],
                b[ks][0], b[ks][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) chk += acc[mt][0] ^ acc[mt][3];
      }
    }
  }
  tally(t0, chk, sink);
}
template <bool kBf16>
__global__ void probe_wgmma(int* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kBlk = (kBf16 ? 20 : 10) * kVecBytes, kSteps = kBf16 ? 10 : 5;
  uint32_t* w32 = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < 7 * kBlk / 4; i += blockDim.x) {
    w32[i] = kBf16 ? 0x3F803F80u : (i * 2654435761u) & 0x7F7F7F7Fu;
  }
  fence_async_smem();
  __syncthreads();
  const uint64_t db0 = smem_desc(smem + 5 * kBlk), db1 = smem_desc(smem + 6 * kBlk);
  int chk = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < kR; ++r) {
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
      const uint64_t da = smem_desc(smem + k * kBlk);
      if (kBf16) {
        float acc[2][32];
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s) wgmma_bf16(acc[0], da + s * kDescStep, db0 + s * kDescStep, s);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) wgmma_bf16(acc[1], da + s * kDescStep, db1 + s * kDescStep, s);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) chk += __float_as_int(acc[0][i]) ^ __float_as_int(acc[1][i]);
      } else {
        int32_t acc[2][32];
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s) wgmma_u8(acc[0], da + s * kDescStep, db0 + s * kDescStep, s);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) wgmma_u8(acc[1], da + s * kDescStep, db1 + s * kDescStep, s);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc[0]);
        pin(acc[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) chk += acc[0][i] ^ acc[1][i];
      }
    }
  }
  tally(t0, chk, sink);
}
extern "C" {
int mds_probe(int which, int warpgroups, int sms, int* sink, unsigned long long* clk) {
  const int threads = 128 * warpgroups;
  const int smem = which == 0 ? 51200 + 4 * warpgroups * 32 * 176 : 7 * (which == 2 ? 20 : 10) * 1024;
  unsigned long long z[2] = {0, 0};
  cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  cudaError_t e;
  if (which == 0) {
    cudaFuncSetAttribute(probe_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_mma<<<sms, threads, smem>>>(sink);
  } else if (which == 1) {
    cudaFuncSetAttribute(probe_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_wgmma<false><<<sms, threads, smem>>>(sink);
  } else {
    cudaFuncSetAttribute(probe_wgmma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_wgmma<true><<<sms, threads, smem>>>(sink);
  }
  e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(z));
  return (int)e;
}
}
"""


# The redesigned dense kernels (perm_dense_block.cuh) by section, on this
# tree's sources.
NEW_DENSE_SECTIONS = ["kernel", "S-box (field.cuh sbox)", "17-limb reductions (redc_big)",
                      "recombine", "mds_run: wait for the wgmmas",
                      "mds_put: put, fence, barrier, first wgmmas", "mds_done: barrier",
                      "mds_run: issue of the next block's wgmmas"]
NEW_DENSE_PATCHES = [
    HYB_PATCHES[0],
    ("perm_dense_block.cuh", "  perm(d, s, consts, convert != 0);\n  if (live) store_state",
     "  { PROF(0); perm(d, s, consts, convert != 0); }\n  if (live) store_state"),
    (HYBP_PATCHES[6][0], HYBP_PATCHES[6][1], HYBP_PATCHES[6][2].replace("PROF(5)", "PROF(1)")),
    ("perm_dense.cuh", "  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>",
     "  PROF(2);\n  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>"),
    (HYB_PATCHES[5][0], HYB_PATCHES[5][1], HYB_PATCHES[5][2].replace("PROF(5)", "PROF(3)")),
    ("perm_dense_block.cuh", "  __device__ __forceinline__ void mds_run(int k) {\n    wgmma_wait<0>();",
     "  __device__ __forceinline__ void mds_run(int k) {\n    { PROF(4); wgmma_wait<0>(); }"),
    ("perm_dense_block.cuh", "    if (k + 1 < kWidth) issue(k + 1);",
     "    if (k + 1 < kWidth) { PROF(7); issue(k + 1); }"),
    ("perm_dense_block.cuh", "  __device__ __forceinline__ void mds_put(const uint32_t* words) {\n",
     "  __device__ __forceinline__ void mds_put(const uint32_t* words) {\n    PROF(5);\n"),
    ("perm_dense_block.cuh", "void mds_done() { sync_block(); }",
     "void mds_done() { PROF(6); sync_block(); }"),
]

# Part 5: the kernels this tree's change must not move, built from the
# sources after `--csrc` (the parent's) and from this tree's, timed in turns
# in one process: parent, change, change, parent.
# Part 6: the dense kernels' variants on this tree's sources, timed in one
# process at B = 2^14 and 2^18, outputs held against the plain opt.
DENSE_VARIANTS = {
    "after": [],  # the sources: the five MDS values reduced together, after the last dot
    "each": [("perm_dense.cuh", """#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    d.mds_run(k);
    mxu8::recombine<63, kT>(d, t[k]);
    d.mds_done();
  }
#pragma unroll
  for (int k = 0; k < kWidth; ++k) redc_big<2>(s[k], t[k]);""", """#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    d.mds_run(k);
    mxu8::recombine<63, kT>(d, t[k]);
    d.mds_done();
    redc_big<2>(s[k], t[k]);
  }""")],
}

# Part 7: the one-thread-a-state `naive` kernel with its round's loops
# rolled, which tests whether instruction fetch holds it back: a full round's
# 40 inlined products are some 16 k instructions.
MDS_ROWS_OLD = """#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    mont_mul(out[k], s[0], c_mds[k][0]);"""
FULL_WORDS_OLD = """                         const uint32_t ark[kWidth][kLimbs]) {
#pragma unroll
  for (int w = 0; w < kWidth; ++w) {"""
LOOP_VARIANTS = {
    "loop_base": [],
    "loop_mdsrows1": [("perm.cuh", MDS_ROWS_OLD, MDS_ROWS_OLD.replace("unroll", "unroll 1"))],
    "loop_fullwords1": [("perm.cuh", FULL_WORDS_OLD, FULL_WORDS_OLD.replace("unroll", "unroll 1"))],
    "loop_both": [("perm.cuh", MDS_ROWS_OLD, MDS_ROWS_OLD.replace("unroll", "unroll 1")),
                  ("perm.cuh", FULL_WORDS_OLD, FULL_WORDS_OLD.replace("unroll", "unroll 1"))],
}

COMPARE = ("opt", "naive", "hybp", "hyb", "mxu8", "mxu", "hyb13", "hybp13")

# Part 8: the base-2^13 S-box's code shape. "inline": field.cuh as it is;
# "once": one copy of sbox13 behind a __noinline__ call that takes and
# returns the value in registers; "rolled": its three products as one loop
# of the general product (400 multiply-adds each, squares included);
# "rolled_once": both.
SBOX_OF_13 = "  if constexpr (kSbox13) {\n    sbox13(r, x);"
SBOX13_ONCE = """struct Fe13 {
  uint32_t v[kLimbs];
};
static __device__ __noinline__ Fe13 sbox13_call(Fe13 x) {
  Fe13 r;
  sbox13(r.v, x.v);
  return r;
}
HADES_FN void sbox13_once(uint32_t r[kLimbs], const uint32_t x[kLimbs]) {
  Fe13 in;
  for (int j = 0; j < kLimbs; ++j) in.v[j] = x[j];
  const Fe13 out = sbox13_call(in);
  for (int j = 0; j < kLimbs; ++j) r[j] = out.v[j];
}

// The S-box of a kernel"""
SBOX13_BODY = """  uint32_t a[kD13], b[kD13], t[2 * kLimbs], x4[kLimbs];
  to13(a, x);
  mul13<true>(t, a, a);
  redc(x4, t);  // x^2
  to13(a, x4);
  mul13<true>(t, a, a);
  redc(x4, t);
  to13(a, x4);
  to13(b, x);
  mul13<false>(t, a, b);
  redc(r, t);
}"""
SBOX13_ROLLED = """  uint32_t a[kD13], b[kD13], t[2 * kLimbs], y[kLimbs], z[kLimbs];
  copy(y, x);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) z[j] = i < 2 ? y[j] : x[j];
    to13(a, y);
    to13(b, z);
    mul13<false>(t, a, b);
    redc(y, t);
  }
  copy(r, y);
}"""
S13_ONCE_PATCHES = [("field.cuh", "// The S-box of a kernel", SBOX13_ONCE),
                    ("field.cuh", SBOX_OF_13, SBOX_OF_13.replace("sbox13(r, x)", "sbox13_once(r, x)"))]
S13_VARIANTS = {
    "inline": [],
    "once": S13_ONCE_PATCHES,
    "rolled": [("field.cuh", SBOX13_BODY, SBOX13_ROLLED)],
    "rolled_once": [("field.cuh", SBOX13_BODY, SBOX13_ROLLED)] + S13_ONCE_PATCHES,
}


def source_of(kernel: str, tree: Path) -> str | None:
    """The source file of a tree that exports a kernel's launch."""
    for path in sorted(tree.glob("*.cu")):
        if f"hades_perm_{kernel}_launch(" in path.read_text():
            return path.name
    return None


def start_variant(name: str, patches, flags, source: str, csrc: Path | None = None):
    """Copy csrc (`--csrc`, or the one given), patch, start nvcc on `source`;
    returns the process and the library's path, or None when a patch does
    not apply."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc or CSRC, d)
    for fname, old, new in patches:
        text = (d / fname).read_text() if (d / fname).exists() else ""
        if old not in text:
            say(f"[probe] variant {name}: patch of {fname} does not apply to this tree; skipped")
            return None
        (d / fname).write_text(text.replace(old, new, 1))
    lib = d / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(d / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def start_probe_source(name: str, text: str):
    """Write a probe's own source beside a copy of this tree's csrc (whose
    headers it includes) and start nvcc on it."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    (d / f"{name}.cu").write_text(text)
    lib = d / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def finish_variant(name: str, started):
    """Wait for a variant's compiler; returns the CDLL and the report, or
    (None, "") when it was skipped or the compiler refused."""
    if started is None:
        return None, ""
    proc, lib = started
    report = proc.communicate()[0]
    if proc.returncode != 0:
        say(f"[probe] variant {name}: nvcc failed:\n{report}")
        return None, ""
    return ctypes.CDLL(str(lib)), report


def make_variant(name: str, patches, flags, source: str):
    return finish_variant(name, start_variant(name, patches, flags, source))


def cuda_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def states(b: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 16, size=(5, 16, b), dtype=np.int64)
    d[:, 15, :] %= 0x73ED
    return torch.from_numpy(d.astype(np.int32)).cuda()


def ptxas(report: str) -> str:
    return "; ".join(line.split(": ", 1)[1] for line in _build.ptxas_summary(report)
                     if "hades_perm" in line)


def part1(smi: str) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = perm_cuda.kernel_tables()
    stream = torch.cuda.current_stream().cuda_stream
    for name in PERM_VARIANTS:
        lib, report = finish_variant(name, STARTED[name])
        if lib is None:
            continue
        lib.hades_init.argtypes = [p, i64]
        if lib.hades_init(tables.ctypes.data, tables.size) != 0:
            say(f"[probe] variant {name}: hades_init failed")
            continue
        say(f"[probe] {name}: ptxas {ptxas(report)}")
        sizes = (1 << 10, 1 << 14, 1 << 16, 1 << 18) if name == "base" else (1 << 14,)
        for kernel in ("naive", "opt"):
            fn = getattr(lib, f"hades_perm_{kernel}_launch", None)
            if fn is None:
                continue
            fn.argtypes = [p, p, i64, i32, p]
            if name == "base":
                BASE[kernel] = fn
            for b in sizes:
                x = states(b, 1)
                out = torch.empty_like(x)
                ms = cuda_ms(lambda: fn(x.data_ptr(), out.data_ptr(), b, 0, stream))
                say(f"[probe] {name} {kernel} B={b}: {ms:.4f} ms, {ms / b * (1 << 14):.4f} ms a 2^14 | {smi}")
        if name == "base":
            sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(OUT / name / f"lib{name}.so")],
                                  capture_output=True, text=True).stdout
            REPORTS.mkdir(parents=True, exist_ok=True)
            fns = re.split(r"\n\s*Function : ", sass)
            for body in fns[1:]:
                fname = body.split("\n", 1)[0].strip()
                ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", body)
                hist: dict[str, int] = {}
                for op in ops:
                    key = op.split(".")[0] + (".WIDE" if ".WIDE" in op else "")
                    hist[key] = hist.get(key, 0) + 1
                top = sorted(hist.items(), key=lambda kv: -kv[1])[:10]
                say(f"[probe] SASS {fname}: {len(ops)} instructions; {top}")
                if "probe_one_mul" in fname:
                    (REPORTS / "probe_one_mul.sass").write_text(body)


def sass_sizes(lib_path: Path) -> dict[str, int]:
    """Each kernel of a library by its instruction count (`cuobjdump -sass`)."""
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", body)
        out[body.split("\n", 1)[0].strip()] = len(ops)
    return out


def kernel_sass(lib_path: Path, kernel: str) -> list[str]:
    """The SASS instructions of a kernel's instances in a library (all its
    template instances), without addresses."""
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    name = f"hades_perm_{kernel}"
    mangled = re.compile(rf"_Z{len(name)}{name}[IP]")
    out = []
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        if mangled.match(body.split("\n", 1)[0].strip()):
            out += re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body)
    return out


def part7(smi: str) -> None:
    """The naive kernel's loop shapes: instructions, registers and times."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = perm_cuda.kernel_tables()
    stream = torch.cuda.current_stream().cuda_stream
    for name in LOOP_VARIANTS:
        lib, report = finish_variant(name, STARTED[name])
        if lib is None:
            continue
        lib.hades_init.argtypes = [p, i64]
        if lib.hades_init(tables.ctypes.data, tables.size) != 0:
            say(f"[probe] variant {name}: hades_init failed")
            continue
        sizes = {k: v for k, v in sass_sizes(OUT / name / f"lib{name}.so").items() if "naive" in k}
        say(f"[probe] {name}: ptxas {ptxas(report)}; SASS instructions {sizes}")
        fn = lib.hades_perm_naive_launch
        fn.argtypes = [p, p, i64, i32, p]
        if name == "loop_base":
            BASE["naive"] = fn
        for b in (1 << 10, 1 << 14):
            x = states(b, 7)
            out = torch.empty_like(x)
            ms = cuda_ms(lambda: fn(x.data_ptr(), out.data_ptr(), b, 0, stream))
            say(f"[probe] {name} naive B={b}: {ms:.4f} ms, {ms / b * (1 << 14):.4f} ms a 2^14 | {smi}")


def part2(smi: str) -> None:
    lib, report = finish_variant("hybclk", STARTED["hybclk"])
    if lib is None:
        return
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    b = 1 << 14
    x = states(b, 2)
    want = torch.empty_like(x)
    BASE["naive"](x.data_ptr(), want.data_ptr(), b, 0, stream)
    say(f"[probe] hybclk: ptxas {ptxas(report)}")
    for kernel in ("hyb", "hybp"):
        fn = getattr(lib, f"hades_perm_{kernel}_launch", None)
        if fn is None:
            continue
        argc = 10
        fn.argtypes = [p, p, i64, i32, p, p, p, p, i64, p][:argc]
        tables = [torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
                  for t in perm_cuda.hyb_kernel_tables(kernel)]
        blocks = -(-b // 128)
        scratch = torch.empty(blocks * 128 * 2112, dtype=torch.uint8, device="cuda")
        out = torch.empty_like(x)

        def launch():
            return fn(x.data_ptr(), out.data_ptr(), b, 0, *(t.data_ptr() for t in tables),
                      scratch.data_ptr(), scratch.numel(), stream)

        status = launch()
        torch.cuda.synchronize()
        if status != 0:
            say(f"[probe] hybclk {kernel}: launch status {status} (another interface?); skipped")
            continue
        ok = torch.equal(out, want)
        clk = (ctypes.c_ulonglong * 8)()
        lib.hades_prof_read(clk)  # the cold launch's
        ms = cuda_ms(launch, reps=3)
        clk = (ctypes.c_ulonglong * 8)()
        lib.hades_prof_read(clk)
        per = [c / (4 * blocks) for c in clk]  # warm-up + 3 timed launches
        rest = per[0] - sum(per[1:])
        say(f"[probe] hybclk {kernel} B={b}: outputs {'==' if ok else '!='} naive; {ms:.4f} ms "
            f"instrumented | {smi}")
        for name, c in zip(SECTIONS, per):
            say(f"[probe]   {kernel} {name}: {c:,.0f} clocks a block ({c / per[0]:.3f})")
        say(f"[probe]   {kernel} everything else: {rest:,.0f} clocks a block ({rest / per[0]:.3f})")


def part3(smi: str) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = perm_cuda.kernel_tables()
    stream = torch.cuda.current_stream().cuda_stream
    ref = None  # an opt launch: the reference of naive's forced groups and of the chains
    for name in group_variants():
        lib, report = finish_variant(name, STARTED[name])
        if lib is None:
            continue
        lib.hades_init.argtypes = [p, i64]
        if lib.hades_init(tables.ctypes.data, tables.size) != 0:
            say(f"[probe] variant {name}: hades_init failed")
            continue
        sizes = {k: v for k, v in sass_sizes(OUT / name / f"lib{name}.so").items()
                 if "hades_perm" in k}
        say(f"[probe] {name}: ptxas {ptxas(report)}; SASS instructions {sizes}")
        for kernel in ("opt", "naive"):
            fn = getattr(lib, f"hades_perm_{kernel}_launch")
            fn.argtypes = [p, p, i64, i32, p]
            ref = ref or (fn if kernel == "opt" else None)
            for b in (1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 18):
                x = states(b, 1)
                out, want = torch.empty_like(x), torch.empty_like(x)
                ms = cuda_ms(lambda: fn(x.data_ptr(), out.data_ptr(), b, 0, stream))
                ref(x.data_ptr(), want.data_ptr(), b, 0, stream)
                torch.cuda.synchronize()
                same = "==" if torch.equal(out, want) else "!="
                say(f"[probe] {kernel} {name} B={b}: {ms:.4f} ms, {ms / b * (1 << 14):.4f} ms a "
                    f"2^14; outputs {same} opt | {smi}")
    lib, report = finish_variant("hybpclk", STARTED["hybpclk"])
    if lib is None or ref is None:
        return
    say(f"[probe] hybpclk: ptxas {ptxas(report)}")

    def reference(x, b):
        want = torch.empty_like(x)
        ref(x.data_ptr(), want.data_ptr(), b, 0, stream)
        return want

    chain_sections(smi, "hybpclk", lib, ("hybp", "hyb", "hybp13", "hyb13"), (1 << 10, 1 << 14),
                   reference)


def chain_launch(lib, kernel: str):
    """The launch of a chained kernel of this tree's interface (perm_hybp.cu)
    with its tables on the card, as a function of (x, out, b)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"hades_perm_{kernel}_launch")
    fn.argtypes = [p, p, i64, i32, p, p, p, p, p]
    base = kernel.removesuffix("13")
    tabs = [torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
            for t in (*perm_cuda.hyb_kernel_tables(base), perm_cuda.packed_weights(base))]
    return lambda x, out, b: fn(x.data_ptr(), out.data_ptr(), b, 0, *(t.data_ptr() for t in tabs),
                                stream)


def chain_sections(smi: str, name: str, lib, kernels, sizes, reference) -> None:
    """The chained kernels of an instrumented build (HYBP_PATCHES) by section:
    the first consumer thread's and the first producer thread's clocks a
    block, outputs against reference(x, b)."""
    for kernel in kernels:
        run = chain_launch(lib, kernel)
        for b in sizes:
            x = states(b, 3)
            out = torch.empty_like(x)
            want = reference(x, b)
            if run(x, out, b) != 0:
                say(f"[probe] {name} {kernel}: the launch failed; skipped")
                break
            torch.cuda.synchronize()
            ok = torch.equal(out, want)
            clk = (ctypes.c_ulonglong * 16)()
            lib.hades_prof_read(clk)  # the first launch's
            ms = cuda_ms(lambda: run(x, out, b), reps=3)
            lib.hades_prof_read(clk)
            per = [c / (4 * -(-b // 64)) for c in clk]  # warm-up + 3 timed launches
            say(f"[probe] {name} {kernel} B={b}: outputs {'==' if ok else '!='} opt; {ms:.4f} ms "
                f"instrumented | {smi}")
            for i, (section, c) in enumerate(zip(HYBP_SECTIONS, per)):
                side = per[0] if i < 8 else per[8]  # the consumer's sections, then the producer's
                say(f"[probe]   {kernel} {section}: {c:,.0f} clocks a block "
                    f"({c / max(side, 1):.3f} of its side's)")


def part8(smi: str) -> None:
    """The base-2^13 S-box's code shapes: registers, SASS instructions, times
    and the consumer's sections of hyb13 and hybp13."""
    def reference(x, b):
        return perm_cuda.permute_planar_plain(x, convert=False, schedule="opt")

    for variant in S13_VARIANTS:
        lib, report = finish_variant(f"s13_{variant}", STARTED[f"s13_{variant}"])
        if lib is not None:
            sizes = {k: v for k, v in sass_sizes(OUT / f"s13_{variant}" / f"libs13_{variant}.so").items()
                     if "hades_perm" in k}
            say(f"[probe] s13_{variant}: ptxas {ptxas(report)}; SASS instructions {sizes}")
            for kernel in ("hyb13", "hybp13"):
                run = chain_launch(lib, kernel)
                for b in (1 << 10, 1 << 14):
                    x = states(b, 8)
                    out = torch.empty_like(x)
                    ms = cuda_ms(lambda: run(x, out, b))
                    same = "==" if torch.equal(out, reference(x, b)) else "!="
                    say(f"[probe] s13_{variant} {kernel} B={b}: {ms:.4f} ms, "
                        f"{ms / b * (1 << 14):.4f} ms a 2^14; outputs {same} plain opt | {smi}")
        lib, report = finish_variant(f"s13clk_{variant}", STARTED[f"s13clk_{variant}"])
        if lib is not None:
            chain_sections(smi, f"s13clk_{variant}", lib, ("hyb13", "hybp13"), (1 << 14,), reference)


def part4(smi: str) -> None:
    """The first port's mxu8 and mxu by section, then the MDS tile product alone."""
    dense_sections(smi, "clk", ("mxu8", "mxu"), DENSE_SECTIONS)
    dense_sections(smi, "new", ("mxu8", "mxu"), NEW_DENSE_SECTIONS)
    i32 = ctypes.c_int
    p = ctypes.c_void_p
    lib, report = finish_variant("mdsdot", STARTED["mdsdot"])
    if lib is None:
        return
    say(f"[probe] mdsdot: ptxas {'; '.join(ln.split(': ', 1)[1] for ln in _build.ptxas_summary(report))}")
    for line in report.splitlines():
        if "wgmma" in line and "erializ" in line:
            say(f"[probe] mdsdot: ptxas {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    lib.mds_probe.argtypes = [i32, i32, i32, p, p]
    for which, name in enumerate(("mma.sync m16n8k32 u8, a warp's 32 states",
                                  "wgmma m64n64k32 u8, a warpgroup's 128 states",
                                  "wgmma m64n64k16 bf16, a warpgroup's 128 states")):
        for w in (1, 2, 3, 4):
            clk = (ctypes.c_ulonglong * 2)()
            status = lib.mds_probe(which, w, sms, sink.data_ptr(), clk)
            if status != 0:
                say(f"[probe] mdsdot {name}, {w} warps a scheduler: status {status}")
                continue
            a_round = clk[0] / clk[1] / 67
            say(f"[probe] mdsdot {name}, {w} warps a scheduler: {a_round:,.0f} clocks a warp a "
                f"round (5 blocks of 64 x 160), {a_round / w:,.0f} an SM's 128 states a round | {smi}")


def dense_sections(smi: str, variant: str, kernels, sections) -> None:
    """A dense kernel's sections, through its launch with this tree's tables."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    b = 1 << 14
    x = states(b, 4)
    want = perm_cuda.permute_planar_plain(x, convert=False, schedule="opt")
    for kernel in kernels:
        lib, report = finish_variant(f"{kernel}{variant}", STARTED[f"{kernel}{variant}"])
        if lib is None:
            continue
        tables = (perm_cuda.mxu8_kernel_tables() if variant == "clk"
                  else perm_cuda.dense_kernel_tables(kernel))
        consts, weights = (torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
                           for t in tables)
        say(f"[probe] {kernel}{variant}: ptxas {ptxas(report)}")
        fn = getattr(lib, f"hades_perm_{kernel}_launch")
        fn.argtypes = [p, p, i64, i32, p, p, p]
        out = torch.empty_like(x)

        def launch():
            return fn(x.data_ptr(), out.data_ptr(), b, 0, consts.data_ptr(), weights.data_ptr(),
                      stream)

        if launch() != 0:
            say(f"[probe] {kernel}{variant}: the launch failed (another interface?); skipped")
            continue
        torch.cuda.synchronize()
        ok = torch.equal(out, want)
        clk = (ctypes.c_ulonglong * 8)()
        lib.hades_prof_read(clk)  # the first launch's
        ms = cuda_ms(launch, reps=3)
        lib.hades_prof_read(clk)
        per = [c / (4 * -(-b // 128)) for c in clk]  # warm-up + 3 timed launches
        rest = per[0] - sum(per[1:])
        say(f"[probe] {kernel}{variant} B={b}: outputs {'==' if ok else '!='} plain opt; {ms:.4f} ms "
            f"instrumented | {smi}")
        for name, c in zip(sections, per):
            if name != "unused":
                say(f"[probe]   {kernel} {name}: {c:,.0f} clocks a block ({c / per[0]:.3f})")
        say(f"[probe]   {kernel} everything else: {rest:,.0f} clocks a block ({rest / per[0]:.3f})")


def part5(smi: str) -> None:
    """Every kernel of COMPARE: the parent's build and this tree's, in turns,
    at B = 2^14, outputs compared."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    b = 1 << 14
    x = states(b, 5)
    tables = perm_cuda.kernel_tables()
    for kernel in COMPARE:
        sources = [source_of(kernel, tree) for tree in (CSRC, _build.CSRC)]
        if None in sources:
            say(f"[probe] compare {kernel}: no source exports its launch in both trees; skipped")
            continue
        names = [f"{tag}_{Path(src).stem}" for tag, src in zip(("parent", "change"), sources)]
        for name in names:
            if name not in FINISHED:
                FINISHED[name] = finish_variant(name, STARTED[name])[0]
        libs = [FINISHED[name] for name in names]
        if None in libs:
            continue
        sass = [kernel_sass(OUT / name / f"lib{name}.so", kernel) for name in names]
        launches, outs = [], []
        for lib, source, tree in zip(libs, sources, (CSRC, _build.CSRC)):
            fn = getattr(lib, f"hades_perm_{kernel}_launch")
            out = torch.empty_like(x)
            if kernel in ("naive", "opt"):
                lib.hades_init.argtypes = [p, i64]
                lib.hades_init(tables.ctypes.data, tables.size)
                fn.argtypes = [p, p, i64, i32, p]
                tabs, args = [], ()
            elif kernel in ("mxu8", "mxu"):
                tabs = [torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
                        for t in perm_cuda.dense_kernel_tables(kernel)]
                fn.argtypes = [p, p, i64, i32, p, p, p]
                args = tuple(t.data_ptr() for t in tabs)
            else:
                base = kernel.removesuffix("13")
                tabs = [torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
                        for t in perm_cuda.hyb_kernel_tables(base)]
                if "scratch_bytes" in (tree / source).read_text():
                    # the first port's block: a scratch tensor for the basis
                    scratch = torch.empty(-(-b // 128) * 128 * 2112, dtype=torch.uint8,
                                          device="cuda")
                    tabs.append(scratch)
                    fn.argtypes = [p, p, i64, i32, p, p, p, p, i64, p]
                    args = (*(t.data_ptr() for t in tabs), scratch.numel())
                else:
                    tabs.append(torch.from_numpy(perm_cuda.packed_weights(base)).cuda())
                    fn.argtypes = [p, p, i64, i32, p, p, p, p, p]
                    args = tuple(t.data_ptr() for t in tabs)

            # the launch holds its tables: args holds only their addresses
            def launch(fn=fn, out=out, args=args, tabs=tabs):
                return fn(x.data_ptr(), out.data_ptr(), b, 0, *args, stream)

            launches.append(launch)
            outs.append(out)
        times = {0: [], 1: []}
        for i in (0, 1, 1, 0):
            times[i].append(cuda_ms(launches[i]))
        same = torch.equal(outs[0], outs[1])
        if not same:
            # which build is right: each against the kernel's plain version
            want = perm_cuda.permute_planar_plain(x, convert=False, schedule=kernel)
            for tag, out in zip(("parent", "change"), outs):
                bad = int((out != want).any(dim=(0, 1)).sum())
                say(f"[probe] compare {kernel}: the {tag}'s outputs differ from the plain "
                    f"version's in {bad} of {b} states")
        mean = [statistics.mean(times[i]) for i in (0, 1)]
        say(f"[probe] compare {kernel} B={b} ({sources[0]} / {sources[1]}): parent "
            f"{times[0][0]:.4f}, {times[0][1]:.4f} ms; change {times[1][0]:.4f}, "
            f"{times[1][1]:.4f} ms; change / parent {mean[1] / mean[0]:.4f}; outputs "
            f"{'==' if same else '!='}; SASS {'identical' if sass[0] == sass[1] else 'differs'} "
            f"| {smi}")


def part6(smi: str) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    for kernel in ("mxu8", "mxu"):
        consts, weights = (torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
                           for t in perm_cuda.dense_kernel_tables(kernel))
        fns = {}
        for variant in DENSE_VARIANTS:
            lib, report = finish_variant(f"{kernel}_{variant}", STARTED[f"{kernel}_{variant}"])
            if lib is None:
                continue
            say(f"[probe] {kernel} {variant}: ptxas {ptxas(report)}")
            fn = getattr(lib, f"hades_perm_{kernel}_launch")
            fn.argtypes = [p, p, i64, i32, p, p, p]
            fns[variant] = fn
        for b in (1 << 14, 1 << 18):
            x = states(b, 6)
            want = perm_cuda.permute_planar_plain(x, convert=False, schedule="opt") if b == 1 << 14 \
                else None
            times = {v: [] for v in fns}
            outs = {}
            for variant in (*fns, *reversed(fns)):
                out = torch.empty_like(x)
                fn = fns[variant]
                times[variant].append(cuda_ms(lambda: fn(x.data_ptr(), out.data_ptr(), b, 0,
                                                         consts.data_ptr(), weights.data_ptr(),
                                                         stream)))
                outs[variant] = out
            for variant, ts in times.items():
                ok = "" if want is None else f"; outputs {'==' if torch.equal(outs[variant], want) else '!='} plain opt"
                say(f"[probe] {kernel} {variant} B={b}: {', '.join(f'{t:.4f}' for t in ts)} ms, "
                    f"{statistics.mean(ts) / b * (1 << 14):.4f} ms a 2^14{ok} | {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_chains: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    parts = sys.argv[sys.argv.index("--parts") + 1].split(",") if "--parts" in sys.argv \
        else ["1", "2", "3", "4", "5", "6", "7", "8"]
    if "2" in parts and not (CSRC / "perm_hyb.cu").exists():
        say("[probe] part 2 probes the first port's perm_hyb.cu, which this tree does not have: "
            "name a tree that has it (an earlier commit's sources) with --csrc; skipped")
        parts.remove("2")
    # every variant's compiler at once: one takes a minute or two. Part 2
    # checks against the unpatched naive of part 1 or part 7.
    part1_runs = "1" in parts or ("2" in parts and "7" not in parts)
    if part1_runs:
        for name, (patches, flags) in PERM_VARIANTS.items():
            STARTED[name] = start_variant(name, patches, flags, "perm.cu")
    if "7" in parts:
        for name, patches in LOOP_VARIANTS.items():
            STARTED[name] = start_variant(name, patches, [], "perm.cu")
    if "2" in parts:
        STARTED["hybclk"] = start_variant("hybclk", HYB_PATCHES, [], "perm_hyb.cu")
    if "3" in parts:
        for name, patches in group_variants().items():
            STARTED[name] = start_variant(name, patches, [], "perm.cu", _build.CSRC)
        STARTED["hybpclk"] = start_variant("hybpclk", HYBP_PATCHES, [], HYBP, _build.CSRC)
    if "4" in parts:
        for kernel in ("mxu8", "mxu"):
            STARTED[f"{kernel}clk"] = start_variant(
                f"{kernel}clk", DENSE_PATCHES + [(f"perm_{kernel}.cu", *PROF_READ)], [],
                f"perm_{kernel}.cu")
            STARTED[f"{kernel}new"] = start_variant(
                f"{kernel}new", NEW_DENSE_PATCHES + [(f"perm_{kernel}.cu", *PROF_READ)], [],
                f"perm_{kernel}.cu", _build.CSRC)
        STARTED["mdsdot"] = start_probe_source("mdsdot", MDS_PROBE)
    if "6" in parts:
        for kernel in ("mxu8", "mxu"):
            for variant, patches in DENSE_VARIANTS.items():
                STARTED[f"{kernel}_{variant}"] = start_variant(
                    f"{kernel}_{variant}", patches, [], f"perm_{kernel}.cu", _build.CSRC)
    if "5" in parts:
        for tag, tree in (("parent", CSRC), ("change", _build.CSRC)):
            for source in {source_of(kernel, tree) for kernel in COMPARE} - {None}:
                STARTED[f"{tag}_{Path(source).stem}"] = start_variant(
                    f"{tag}_{Path(source).stem}", [], [], source, tree)
    if "8" in parts:
        for variant, patches in S13_VARIANTS.items():
            STARTED[f"s13_{variant}"] = start_variant(f"s13_{variant}", patches, [], HYBP,
                                                      _build.CSRC)
            STARTED[f"s13clk_{variant}"] = start_variant(f"s13clk_{variant}",
                                                         HYBP_PATCHES + patches, [], HYBP,
                                                         _build.CSRC)
    if part1_runs:
        part1(smi)
    if "7" in parts:
        part7(smi)
    if "2" in parts:
        part2(smi)
    if "3" in parts:
        part3(smi)
    if "4" in parts:
        part4(smi)
    if "5" in parts:
        part5(smi)
    if "6" in parts:
        part6(smi)
    if "8" in parts:
        part8(smi)
    REPORTS.mkdir(parents=True, exist_ok=True)
    name = "probe_chains.txt" if len(parts) == 8 else f"probe_chains_{'_'.join(parts)}.txt"
    (REPORTS / name).write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
