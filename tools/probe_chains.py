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

Part 2, `perm_hyb.cu` (`hyb`, `hybp`), B = 2^14: `clock64()` sums of thread 0
of every block, a section at a time (the wide dot with its stage copies and
barriers; the small dots; the barriers of `put` and `done`; `recombine`;
`mul_wide`; `ladder9`), divided by the number of blocks. The sections are
leaves, so they do not overlap; the rest of the kernel's clocks is the
remainder. Outputs stay right on this build and are checked against the
uninstrumented `naive` kernel.

Part 3, the redesigned kernels. `perm.cu`: `hades_perm_opt` with its group
of lanes forced to 4, 2 and 1 at B = 2^10 .. 2^18, which is where the
thresholds `kGroup4Max` and `kGroup2Max` come from. `perm_hybp.cu`:
`clock64()` sums of the first consumer thread and the first producer thread
of every block, a section at a time (consumer: the wait for a job's sums,
the small dot, `recombine`, the big reduction, the S-box, the MDS dots;
producer: the waits for a basis element, for a stage of weights, for the
MMAs of the chunk before with the warpgroup's barrier, for a free sums
buffer, and the write of the sums; the rest of the producer's time is the
issue of its wgmmas), at B = 2^10 (one block an SM, no second wave) and 2^14.

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


GROUP4_OLD = "constexpr long long kGroup4Max = 1 << 13;"
GROUP2_OLD = "constexpr long long kGroup2Max = 1 << 14;"
GROUP_VARIANTS = {
    "g4": [("perm.cu", GROUP4_OLD, "constexpr long long kGroup4Max = 1LL << 40;")],
    "g2": [("perm.cu", GROUP4_OLD, "constexpr long long kGroup4Max = 0;"),
           ("perm.cu", GROUP2_OLD, "constexpr long long kGroup2Max = 1LL << 40;")],
    "g1": [("perm.cu", GROUP4_OLD, "constexpr long long kGroup4Max = 0;"),
           ("perm.cu", GROUP2_OLD, "constexpr long long kGroup2Max = 0;")],
}

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
    (HYBP, "  hybp::ConsumerDot d{smem, bars, t, nullptr, 0, 0};",
     "  PROF(0);\n  hybp::ConsumerDot d{smem, bars, t, nullptr, 0, 0};"),
    (HYBP, "    mbar_wait(bars + kBarFull + buf, (q >> 1) & 1);\n    int32_t* c = sums(buf);",
     "    { PROF(1); mbar_wait(bars + kBarFull + buf, (q >> 1) & 1); }\n    int32_t* c = sums(buf);"),
    (HYBP, "      __syncwarp();  // the warp's puts of s_{q-1}",
     "      PROF(2);\n      __syncwarp();  // the warp's puts of s_{q-1}"),
    ("perm_mxu8.cuh", "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n",
     "HADES_FN void recombine(const Dot& d, uint32_t out[L]) {\n  PROF(3);\n"),
    ("perm_hybp.cuh", "  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>",
     "  PROF(4);\n  redc_steps<kT>(t);\n  mxu8::ladder9<RUNGS>"),
    ("field.cuh", "  uint32_t x2[kLimbs], x4[kLimbs];\n  mont_sqr(x2, x);",
     "  PROF(5);\n  uint32_t x2[kLimbs], x4[kLimbs];\n  mont_sqr(x2, x);"),
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


def start_variant(name: str, patches, flags, source: str):
    """Copy csrc, patch, start nvcc on `source`; returns the process and the
    library's path, or None when a patch does not apply."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, old, new in patches:
        text = (d / fname).read_text()
        if old not in text:
            say(f"[probe] variant {name}: patch of {fname} does not apply to this tree; skipped")
            return None
        (d / fname).write_text(text.replace(old, new, 1))
    lib = d / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib), str(d / source)]
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
                ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", body)
                hist: dict[str, int] = {}
                for op in ops:
                    key = op.split(".")[0] + (".WIDE" if ".WIDE" in op else "")
                    hist[key] = hist.get(key, 0) + 1
                top = sorted(hist.items(), key=lambda kv: -kv[1])[:10]
                say(f"[probe] SASS {fname}: {len(ops)} instructions; {top}")
                if "probe_one_mul" in fname:
                    (REPORTS / "probe_one_mul.sass").write_text(body)


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
    naive = None
    for name in GROUP_VARIANTS:
        lib, report = finish_variant(name, STARTED[name])
        if lib is None:
            continue
        lib.hades_init.argtypes = [p, i64]
        if lib.hades_init(tables.ctypes.data, tables.size) != 0:
            say(f"[probe] variant {name}: hades_init failed")
            continue
        fn = lib.hades_perm_opt_launch
        fn.argtypes = [p, p, i64, i32, p]
        naive = naive or lib.hades_perm_naive_launch
        naive.argtypes = [p, p, i64, i32, p]
        for b in (1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 18):
            x = states(b, 1)
            out = torch.empty_like(x)
            ms = cuda_ms(lambda: fn(x.data_ptr(), out.data_ptr(), b, 0, stream))
            say(f"[probe] opt {name} B={b}: {ms:.4f} ms, {ms / b * (1 << 14):.4f} ms a 2^14 | {smi}")
    lib, report = finish_variant("hybpclk", STARTED["hybpclk"])
    if lib is None or naive is None:
        return
    say(f"[probe] hybpclk: ptxas {ptxas(report)}")
    fn = lib.hades_perm_hybp_launch
    fn.argtypes = [p, p, i64, i32, p, p, p, p, p]
    tabs = [torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).cuda()
            for t in (*perm_cuda.hyb_kernel_tables("hybp"), perm_cuda.packed_weights())]
    for b in (1 << 10, 1 << 14):
        x = states(b, 3)
        out, want = torch.empty_like(x), torch.empty_like(x)

        def launch():
            return fn(x.data_ptr(), out.data_ptr(), b, 0, *(t.data_ptr() for t in tabs), stream)

        naive(x.data_ptr(), want.data_ptr(), b, 0, stream)
        if launch() != 0:
            say("[probe] hybpclk: the launch failed; skipped")
            return
        torch.cuda.synchronize()
        ok = torch.equal(out, want)
        clk = (ctypes.c_ulonglong * 16)()
        lib.hades_prof_read(clk)  # the first launch's
        ms = cuda_ms(launch, reps=3)
        lib.hades_prof_read(clk)
        per = [c / (4 * -(-b // 64)) for c in clk]  # warm-up + 3 timed launches
        say(f"[probe] hybpclk hybp B={b}: outputs {'==' if ok else '!='} naive; {ms:.4f} ms "
            f"instrumented | {smi}")
        for name, c in zip(HYBP_SECTIONS, per):
            say(f"[probe]   {name}: {c:,.0f} clocks a block")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_chains: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    parts = sys.argv[sys.argv.index("--parts") + 1].split(",") if "--parts" in sys.argv \
        else ["1", "2", "3"]
    # every variant's compiler at once: one takes a minute or two
    if "1" in parts or "2" in parts:  # part 2 checks against part 1's naive
        for name, (patches, flags) in PERM_VARIANTS.items():
            STARTED[name] = start_variant(name, patches, flags, "perm.cu")
    if "2" in parts:
        STARTED["hybclk"] = start_variant("hybclk", HYB_PATCHES, [], "perm_hyb.cu")
    if "3" in parts:
        for name, patches in GROUP_VARIANTS.items():
            STARTED[name] = start_variant(name, patches, [], "perm.cu")
        STARTED["hybpclk"] = start_variant("hybpclk", HYBP_PATCHES, [], HYBP)
    if "1" in parts or "2" in parts:
        part1(smi)
    if "2" in parts:
        part2(smi)
    if "3" in parts:
        part3(smi)
    REPORTS.mkdir(parents=True, exist_ok=True)
    name = "probe_chains.txt" if len(parts) == 3 else f"probe_chains_{'_'.join(parts)}.txt"
    (REPORTS / name).write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
