"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA. It builds the permutation
kernels from `hades252_tpu_torch/ops/csrc/`, then:

  1. prints the card, its power limit and the toolchain;
  2. builds the kernels and prints ptxas's register and spill counts (and
     any warning of ptxas about wgmma), and the dense kernels' shared
     memory;
  3. runs the KAT gate: the 128 selftest vectors tiled to 2^14 lanes
     through all eight kernels (`naive`, `opt`, `mxu8`, `hyb`, `hybp`,
     `mxu`, `hyb13`, `hybp13`), canonical and Montgomery paths, against the
     exact int oracle (which is itself held against the four SURVEY known
     answers);
  4. holds each kernel against its plain PyTorch version on the card at
     B = 2^14, 4096 and a ragged 1000, both `convert` values, and `naive`,
     `opt`, `mxu8`, `mxu`, `hyb`, `hyb13` and `hybp13` at the first Merkle
     level's B = 2^18 on the Montgomery path; every kernel, `naive` and
     `opt` (a group of lanes a state), `hyb`, `hybp`, `hyb13` and `hybp13`
     (64 states a block), `mxu8` and `mxu` (a warpgroup of 128), also at
     B = 1, 5, 127, 129 and 2^14 + 1, where `opt` is held against the
     native engine too (built here: an engine that does not build fails the
     run); and holds the MDS products of `mxu8` (u8 wgmma) and `mxu` (bf16
     wgmma, float32 sums) against a float64 matmul with w_lin and with
     all-255 operands at 320 x 160, the largest sum they can meet;
  5. builds the arity-4 Merkle root over 2^20 seeded leaves through
     `merkle_root` (BASELINE config 4) with the default `opt` kernel, and
     over their first 2^16 with the `opt`, `naive` and `mxu8` kernels, and
     checks that the roots agree, the launch counts, a 4096-leaf tree
     against the plain version and a 16-leaf tree against the int oracle;
     then the openings: `merkle_levels` over the 2^20 leaves through
     `hybp` (the root must be `opt`'s), `merkle_open_batched` for 2^14
     seeded leaf indices, and `merkle_verify_batched` through `hybp`,
     `hyb` and `opt` (all true, and equal), with rows 0..63 of the
     openings against the loop of `merkle_open_compact`, one opening
     through `merkle_verify` and an int-oracle walk up its path, and the
     rejections: a tampered sibling digit and a position of 4 fail their
     own rows only, a height of 9 fails every row;
  6. hashes 2^14 streams of 64 elements through `sponge_hash` (BASELINE
     config 3) and checks the first 64 digests against the plain version
     and stream 0 against the int oracle; then streams the same messages
     through `SpongeState` on its default device (the card), in pieces of
     12 words, whose digests must equal `sponge_hash`'s;
  7. encrypts 2^14 streams of 32 elements through the duplex cipher
     (`cipher.encrypt`) with the `mxu8` kernel, and checks the ciphertexts
     and tags against the `opt` kernel's, rows 0..63 against the plain
     version, row 0 against the int oracle of the cipher spec, the
     round trip through `decrypt`, and the rejection of a tampered word
     (its row only) and of a truncated ciphertext (every row);
  7b. builds the same 2^20-leaf tree through `merkle_root_checkpointed`
     into a fresh temporary directory with the `mxu` kernel (10 launches;
     the root must be `opt`'s of phase 5), then deletes the level files
     above level 4 and truncates level 4's, and resumes through `hyb13`,
     and after the same damage through `hybp13`: the same root, 7 launches
     each (levels 4 to 10 from level 3: the truncated file is ignored), a
     directory of other leaves refused with ValueError, and `level_10.bin`
     decoding to the root. The directory is removed at the end, also on
     failure;
  7c. holds the port against the native CPU engine (`native/hades_cpu.cpp`,
     built with the host compiler in phase 4): 64 seeded states through
     `perm_batch_digits` against the `opt` kernel, the 4096-leaf root of
     phase 5 against `merkle_root_digits`; prints its single-thread
     rates with the host CPU's model name;
  7d. drives the batched PLONK prover (`prover_cuda.prove_batched`) on its
     default device, the card, at the width of bench.py's plonk mode: 64
     instances of the 973-gate permutation-preimage circuit (numpy seed 0,
     n = 1024, the 4n = 4096 coset), keyed by `plonk.preprocess`. The 16
     proofs of B = 16 must equal the host `plonk.prove`'s field by field
     and verify; B = 64's first 16 must equal them and all 64 verify; a
     proof with one `t` coefficient changed must fail `plonk.verify`, and
     composers of two circuits must raise ValueError. The path launches no
     permutation kernel (its transcripts permute on the host), and its
     counts must say so. Then the NTT: `ops.ntt.ntt_batched` over 64 rows
     of 2^12 and 2^14 points inverts to its input, rows 0-1 at 2^12 equal
     the host `plonk.ntt`, 4 rows of 2^10 equal the same call on the CPU,
     and the coset transforms at 2^12 round-trip (row 0 equal to the host
     `plonk._coset_eval`);
  7e. drives the succinct DEEP-FRI argument (`fri`) and its aggregation
     (`aggregate`) with their commitment trees, leaf-block sponges,
     proof-of-work grinding and pooled multiproof checks on the kernels,
     through `fri_cuda.device_pool_perm`, and holds every path against the
     same path through the native engine (`fri.default_pcs_perm()`): the
     first instance of phase 7d's circuit, keyed by `fri.preprocess_succinct`
     at the default preset (blowup 8, 35 queries, final degree 64, 16 PoW
     bits), is proved 3 times through `opt`, each proof byte-identical
     through `serialize.proof_to_bytes` to the native engine's, the key's
     and the proof's bytes round-trip and the decoded proof verifies through
     `hybp`; the same with `zk=True` and one seeded generator on each side;
     16 instances proved at bench.py verify mode's "fast" preset (blowup 4,
     16 queries, final degree 64, 8 PoW bits) by the native engine in a pool
     of host processes, two of them spoiled (a changed claimed evaluation,
     a changed byte through `proof_from_bytes`), are verified together by
     `verify_succinct_batched` through `hybp`: false in those two slots
     only, and equal to the native engine's verdicts; the aggregate of 4
     instances through `opt` is byte-identical through
     `serialize.aggregate_to_bytes` to the native engine's, verifies through
     `hybp`, and fails with a changed claimed evaluation. Each path must
     launch its kernel exactly as often as the native engine is called on
     the same path (no call falls back), and no other kernel;
  8. times the kernels, their plain versions, the trees, the openings,
     the sponge, the cipher and the checkpointed build (beside the plain
     `merkle_root` through the same kernel, so the cost of the ten
     device-to-host copies and file writes is a number), and the `naive`
     cross-check tree over 2^16 leaves beside `opt`'s, with CUDA events
     (median of 5 after a warm-up), and works out each kernel's bound: the
     least time the card could take for the same states (`bound`); every
     kernel also at B = 2^10, 2^16 and 2^18. The prover: proofs/s at B = 16
     and 64 (host clock around the call, median of 3 after a warm-up), the
     split into its three device phases (CUDA events around each) and the
     host's share, the peak device memory, the host `plonk.prove`'s rate on
     the same host, `field.invert` over the grand product's denominators
     and `ntt_batched` over 64 rows of 2^12 and 2^14 points. The succinct
     paths of phase 7e (timed there, printed here): the seconds of a "prod"
     proof through the card beside the native engine's (median of 3, host
     clock), of the pooled verification of 16 "fast" proofs (median of 3)
     and of the aggregate of 4 instances (one run each), each with its
     permutation launches' device ms (CUDA events around every launch) and
     their share of the wall.

Each path of phases 5-7b and 7e runs with the launch counts set to 0 just
before it and read just after; the kernels' JSON line reports their sum. The
earlier paths run at the depth they had: the `naive` and `mxu8` cross-check
trees over 2^16 leaves, everything else at full size. No
single PyTorch call computes a 255-bit modular permutation, so the line's
`library_ms` is null for every kernel.

With `--profile` it also traces one warm call of the tree, the sponge and
the cipher through `opt`, of the 2^16-leaf tree through `naive` and `opt`,
of the cipher through `mxu8`, of each of the
openings' paths, of the checkpointed build (through `mxu`), of its two
resumes (through `hyb13` and `hybp13`, the damage included) and of one
`prove_batched` at B = 16 and of one "prod" `fri.prove_succinct` through
`opt` with `torch.profiler` (phase 9) and prints, per path, the span of
its device work, the time the device was busy, the idle share, the
permutation kernel's share and the plain-torch glue's.

Every check is exact (integer arithmetic: tolerance 0). Any failure raises
and the script exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it gives the card's name and
power limit, and the one before that the kernels' JSON summary.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import multiprocessing
import os
import platform
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:
    import hades252_tpu_torch  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "hades252_tpu_torch":
        raise
    sys.exit("chip_smoke: needs the package directory hades252_tpu_torch/ beside it: run it "
             "from the root of a checkout")

from hades252_tpu_torch import aggregate, field, fri, fri_cuda, plonk, prover_cuda, selftest
from hades252_tpu_torch import serialize
from hades252_tpu_torch.gadget import Composer, Constraint, GadgetStrategy
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import _build, make_perm_mont_fn, ntt, perm_cuda
from hades252_tpu_torch.params import P, WIDTH, mxu8_tables
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils import checkpoint, native
from hades252_tpu_torch.utils.encoding import digits_to_ints

SEED = 0x5EED
PERM_BATCH = 1 << 14
MERKLE_LEAVES = 1 << 20
CROSS_LEAVES = 1 << 16      # the naive and mxu8 trees, against opt's over the same leaves
OPENINGS = 1 << 14
SPONGE_STREAMS, SPONGE_LEN = 1 << 14, 64
CIPHER_STREAMS, CIPHER_LEN = 1 << 14, 32
REPS = 5
SOURCES = {
    "naive": "hades252_tpu_torch/ops/csrc/perm.cu",
    "opt": "hades252_tpu_torch/ops/csrc/perm.cu",
    "mxu8": "hades252_tpu_torch/ops/csrc/perm_mxu8.cu",
    "hyb": "hades252_tpu_torch/ops/csrc/perm_hybp.cu",
    "hybp": "hades252_tpu_torch/ops/csrc/perm_hybp.cu",
    "mxu": "hades252_tpu_torch/ops/csrc/perm_mxu.cu",
    "hyb13": "hades252_tpu_torch/ops/csrc/perm_hybp.cu",
    "hybp13": "hades252_tpu_torch/ops/csrc/perm_hybp.cu",
}
REPLACES = {
    "naive": "hades252_tpu/ops/perm_pallas.py:330 (_perm_kernel)",
    "opt": "hades252_tpu/ops/perm_pallas.py:390 (_perm_kernel_opt)",
    "mxu8": "hades252_tpu/ops/perm_pallas.py:640 (_perm_kernel_mxu8)",
    "hyb": "hades252_tpu/ops/perm_pallas.py:845 (_perm_kernel_hyb)",
    "hybp": "hades252_tpu/ops/perm_pallas.py:945 (_perm_kernel_hybp)",
    "mxu": "hades252_tpu/ops/perm_pallas.py:629 (_perm_kernel_mxu)",
    "hyb13": "hades252_tpu/ops/perm_pallas.py:845 (_perm_kernel_hyb, sbox13=True)",
    "hybp13": "hades252_tpu/ops/perm_pallas.py:945 (_perm_kernel_hybp, sbox13=True)",
}
# naive and opt run 4 lanes a state, 32 states a block (one thread a state
# above 2^14), hyb, hybp, hyb13 and hybp13 64 states a block, mxu8 and mxu
# one warpgroup of 128: batches that end inside a group, a warp, a
# warpgroup or a block
RAGGED = (1, 5, 127, 129, PERM_BATCH + 1)
TIMED_SIZES = (1 << 10, 1 << 16, 1 << 18)   # beside PERM_BATCH
CKPT_KEEP = 4               # the damage: level files above it go, its own is cut short
PLONK_BATCHES = (16, 64)    # bench.py's plonk mode: B instances of one 973-gate circuit
PLONK_SEED = 0
PLONK_REPS = 3
NTT_ROWS, NTT_SIZES = 64, (1 << 12, 1 << 14)
PROVER_PHASES = ("_phase1_wires", "_phase2_grand_product", "_phase3_quotient")
# the succinct argument (phase 7e): the reference's default preset ("prod"),
# bench.py verify mode's "fast" preset for the pooled verification of 16
# proofs, an aggregate of 4 instances
SUCCINCT_PROD = fri.FriParams()
SUCCINCT_FAST = fri.FriParams(blowup=4, n_queries=16, final_degree=64, pow_bits=8)
SUCCINCT_REPS = 3
POOLED_PROOFS = 16
AGG_INSTANCES = 4
ZK_SEED = 0x2C

# The card's published peaks (NVIDIA H100 SXM data sheet): dense int8 and
# dense bf16 on the tensor cores, and device memory. Its 32-bit integer rate is not published:
# 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock, one multiply-add a
# lane a clock.
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_elements(shape, rng: np.random.Generator) -> np.ndarray:
    """Canonical field elements as (..., 16) int32 digits: uniform low
    digits under a top digit below p's, so every value is < p."""
    d = rng.integers(0, 1 << 16, size=tuple(shape) + (16,), dtype=np.int64)
    d[..., 15] %= P >> 240
    return d.astype(np.int32)


def plain_planar(x: torch.Tensor, *, convert: bool, schedule: str) -> torch.Tensor:
    """The plain version of a kernel over planar x, in slices of PERM_BATCH
    states (each state is independent), which bounds its int64 temporaries."""
    return torch.cat([perm_cuda.permute_planar_plain(x[:, :, i : i + PERM_BATCH],
                                                     convert=convert, schedule=schedule)
                      for i in range(0, x.shape[2], PERM_BATCH)], dim=2)


def plain_mont_fn(schedule: str):
    """Batch-major Montgomery permutation through the plain version of a
    kernel, on the input's device."""
    def fn(x: torch.Tensor) -> torch.Tensor:
        planar = x.permute(1, 2, 0).contiguous()
        out = perm_cuda.permute_planar_plain(planar, convert=False, schedule=schedule)
        return out.permute(2, 0, 1).contiguous()
    return fn


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(schedule: str, b: int) -> dict:
    """The least time the card could take for b states through `schedule`,
    canonical in and out: the largest of (i) the byte multiply-adds of its
    dots over the int8 peak (for mxu, whose dots are bf16, the bf16 peak),
    (ii) the 32-bit integer operations of its
    CUDA-core work over the int32 rate, and (iii) its bytes over the memory
    rate. Counted per state from the sources (csrc/field.cuh, perm.cuh,
    perm_dense.cuh, perm_hybp.cuh):

    - a Montgomery product is 136 multiply-adds: 64 for a b and 72 for the
      reduction (8 steps of 6 multiply-adds by the limbs of p that are not 1
      or 2^32 - 1, a negate and two adds for those two); a square needs 36
      for a^2 (the 28 products above the diagonal once, the 8 on it), so 108.
      naive runs 1,982 products and opt 1,054 (the 10 conversion products
      included), 198 of them the squares of the 99 S-boxes, with 1,675 and
      984 modular adds of 16 adds and subtracts. What opt's lanes compute
      twice over is the kernel's choice, not work the function needs;
    - the byte-dot kernels run 99 S-boxes of two 36- and one 64-multiply-add
      raw product and the 10 conversion products; every REDC (632 in mxu8
      and mxu, 401 in the chained kernels) runs on the CUDA cores, 72
      multiply-adds and a 9-limb subtract; the tensor cores run the dots
      with constant weights: an MDS dot is (315, 160), round r of the chain
      (63, 32 (6 + r)), the exit (315, 2080), each with 2 adds per
      recombined column on the cores; the chain's 64 big REDCs end in five
      9-limb subtracts; hybp's small dot adds onto the big one's sums in the
      MMA, so hyb's count is hybp's;
    - mxu runs mxu8's schedule: the same counts, its MDS dots at the bf16
      rate (widening the bytes is the kernel's choice, not work the function
      needs);
    - hyb13 and hybp13 run hyb's and hybp's work with the base-2^13 S-box,
      1,420 operations in place of 136: 2 x 210 + 400 narrow multiply-adds, 2 x
      39 column doublings, 4 x 20 digit windows of 3 operations (shift,
      merge, mask), and for each of the 3 products 39 shift-and-adds of two
      operations into the 64-bit accumulator and 16 limbs written;
    - every state is 320 B read and 320 B written, and the tables are read
      once.
    """
    full, partial = 8, 59
    cores = tensor = 0
    sboxes = 5 * full + partial
    if schedule in ("naive", "opt"):
        products, adds = (1982, 1675) if schedule == "naive" else (1054, 984)
        cores = 136 * (products - 2 * sboxes) + 108 * 2 * sboxes + 16 * adds
        table_bytes = perm_cuda.kernel_tables().nbytes
    else:
        base = schedule.removesuffix("13")
        dense = full + partial if base in ("mxu8", "mxu") else full
        chain = 0 if base in ("mxu8", "mxu") else partial
        sbox_ops = 2 * 210 + 400 + 2 * 39 + 4 * 20 * 3 + 3 * (2 * 39 + 16) if base != schedule \
            else 2 * 36 + 64
        redcs = 3 * sboxes + 5 * dense + (chain + 5 if chain else 0)
        dot_cols = 5 * 63 * dense + (63 * (chain + 5) if chain else 0)
        tensor = dense * 315 * 160
        cores = sboxes * sbox_ops + 10 * 136 + redcs * (72 + 9) + 2 * dot_cols + 16 * 5 * dense
        if chain:
            tensor += sum(63 * 32 * (6 + r) for r in range(chain)) + 315 * 2080
            cores += (chain + 5) * 5 * 9
        tables = (perm_cuda.hyb_kernel_tables(base) if chain
                  else perm_cuda.dense_kernel_tables(schedule))
        table_bytes = sum(t.nbytes for t in tables)
    tensor_rate = BF16_OPS_PER_S if schedule == "mxu" else INT8_OPS_PER_S
    times = {"tensor_ms": 2 * tensor * b / tensor_rate * 1e3,
             "cores_ms": cores * b / INT32_OPS_PER_S * 1e3,
             "bytes_ms": (2 * WIDTH * 16 * 4 * b + table_bytes) / HBM_BYTES_PER_S * 1e3}
    bound_ms = max(times.values())
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if bound_ms == times["bytes_ms"] else "operations", **times}


def int_merkle_root(leaves: list[int]) -> int:
    strat, level = ScalarStrategy(), list(leaves)
    while len(level) > 1:
        level = [strat.perm([merkle.TAG] + level[i : i + 4])[merkle.DIGEST_INDEX]
                 for i in range(0, len(level), 4)]
    return level[0]


def int_merkle_walk(leaf: int, siblings: list[list[int]], positions: list[int]) -> int:
    """Walk one compact opening up to the root on ints: per level the node
    goes back among its ARITY - 1 siblings at its position."""
    strat, node = ScalarStrategy(), leaf
    for sibs, pos in zip(siblings, positions):
        children = list(sibs[:pos]) + [node] + list(sibs[pos:])
        node = strat.perm([merkle.TAG] + children)[merkle.DIGEST_INDEX]
    return node


def int_sponge(words: list[int]) -> int:
    strat, state = ScalarStrategy(), [len(words), 0, 0, 0, 0]
    padded = list(words) + [0] * ((-len(words)) % sponge.RATE)
    for c in range(0, len(padded), sponge.RATE):
        for i in range(sponge.RATE):
            state[1 + i] = (state[1 + i] + padded[c + i]) % P
        state = strat.perm(state)
    return state[sponge.DIGEST_INDEX]


def int_cipher(key2: list[int], nonce: int, msg: list[int]) -> tuple[list[int], int]:
    """The duplex cipher's spec (models/cipher.py) on ints: (ciphertext, tag)."""
    strat = ScalarStrategy()
    msg = list(msg) + [0] * ((-len(msg)) % cipher.RATE)
    state = strat.perm([(cipher.TAG_ENC + (len(msg) << 32)) % P, key2[0], key2[1], nonce, 1])
    ct = []
    for off in range(0, len(msg), cipher.RATE):
        for i in range(cipher.RATE):
            c = (msg[off + i] + state[1 + i]) % P
            ct.append(c)
            state[1 + i] = c
        state = strat.perm(state)
    return ct, state[1]


def preimage_instances(b: int, seed: int) -> list:
    """b instances of bench.py's plonk circuit: the permutation gadget on 5
    seeded words, each output bound to its value through the public-input
    column (973 + 5 gates)."""
    rng, strat = np.random.default_rng(seed), ScalarStrategy()
    out = []
    for _ in range(b):
        x = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(WIDTH)]
        expected = strat.perm(list(x))
        c = Composer()
        ws = [c.append_witness(w) for w in x]
        GadgetStrategy.gadget(c, ws)
        for w, e in zip(ws, expected):
            c.append_gate(Constraint().left(1).a(w).public(-e))
        out.append(c)
    return out


def timed_prove(composers: list, key) -> tuple:
    """One prove_batched on the card with CUDA events around each of its
    three device phases: (proofs, wall seconds, {phase: device ms}). The
    host's share is the wall time less the phases'."""
    events, originals = {}, {name: getattr(prover_cuda, name) for name in PROVER_PHASES}

    def timed(name, fn):
        def run_phase(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events[name] = (start, end)
            return out
        return run_phase

    try:
        for name, fn in originals.items():
            setattr(prover_cuda, name, timed(name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs = prover_cuda.prove_batched(composers, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(prover_cuda, name, fn)
    return proofs, wall, {name: start.elapsed_time(end) for name, (start, end) in events.items()}


def same_proof(a, b) -> bool:
    return (a.wires, a.z, a.t, a.commitments) == (b.wires, b.z, b.t, b.commitments)


def int_rows(digits: torch.Tensor) -> list:
    return [[int(v) for v in row] for row in digits_to_ints(digits.cpu().numpy())]


def prover_phase(dev: torch.device, rng: np.random.Generator) -> dict:
    """Phase 7d: the batched prover and the NTT on the card, held against
    the host prover and the host transforms. Returns what phase 8 times."""
    t0 = time.perf_counter()
    composers = preimage_instances(max(PLONK_BATCHES), PLONK_SEED)
    key = plonk.preprocess(composers[0])
    setup_s = time.perf_counter() - t0
    check(key.n == 1024 and len(composers[0].gates) == 978, "the plonk circuit must be 978 gates, n = 1024")
    pis = [[g.pi for g in c.gates] for c in composers]
    b = PLONK_BATCHES[0]
    first, counts = drive(lambda: prover_cuda.prove_batched(composers[:b], key))
    check(not any(counts.values()), f"prove_batched B={b}: launches {counts}, none expected")
    t0 = time.perf_counter()
    host = [plonk.prove(c, key) for c in composers[:b]]
    host_s = (time.perf_counter() - t0) / b
    for i, (got, want) in enumerate(zip(first, host)):
        for name in ("wires", "z", "t", "commitments"):
            check(getattr(got, name) == getattr(want, name),
                  f"prove_batched B={b}, proof {i}: {name} != host plonk.prove's")
        check(plonk.verify(key, got, pis[i]), f"prove_batched B={b}, proof {i} does not verify")
    every, counts = drive(lambda: prover_cuda.prove_batched(composers, key))
    check(not any(counts.values()), f"prove_batched B={len(composers)}: launches {counts}, none expected")
    check(len(every) == len(composers) and all(same_proof(a, c) for a, c in zip(every, first)),
          f"prove_batched B={len(composers)}: the first {b} proofs != B={b}'s")
    t0 = time.perf_counter()
    check(all(plonk.verify(key, pr, pi) for pr, pi in zip(every, pis)),
          f"prove_batched B={len(composers)}: a proof does not verify")
    verify_s = (time.perf_counter() - t0) / len(every)
    bad = plonk.Proof(wires=every[0].wires, z=every[0].z,
                      t=[(every[0].t[0] + 1) % P] + every[0].t[1:], commitments=every[0].commitments)
    check(not plonk.verify(key, bad, pis[0]), "a proof with one t coefficient changed must fail")
    other = Composer()
    a = other.append_witness(3)
    other.gate_mul(Constraint().mult(1).a(a).b(a))
    try:
        prover_cuda.prove_batched([composers[0], other], key)
    except ValueError as e:
        check("circuit structure" in str(e), f"mixed circuits: unexpected refusal {e}")
    else:
        check(False, "composers of two circuits must be refused")
    log(f"[prover] {len(composers)} instances of the {len(composers[0].gates)}-gate permutation-"
        f"preimage circuit (n = {key.n}, built and keyed in {setup_s:.1f} s): B = {b} on the card "
        f"== host plonk.prove field by field ({host_s:.3f} s a host proof), all verify; "
        f"B = {len(composers)}: first {b} == B = {b}'s, all verify ({verify_s:.4f} s a verify); "
        "a changed t coefficient fails; mixed circuits refused")

    xs = {n: torch.from_numpy(random_elements((NTT_ROWS, n), rng)).to(dev) for n in NTT_SIZES}
    for n, x in xs.items():
        check(torch.equal(ntt.ntt_batched(ntt.ntt_batched(x), invert=True), x),
              f"ntt_batched {NTT_ROWS} x {n}: the inverse does not undo the forward")
    x = xs[NTT_SIZES[0]]
    rows = int_rows(x[:2])
    check(int_rows(ntt.ntt_batched(x[:2])) == [plonk.ntt(r) for r in rows],
          f"ntt_batched rows 0-1 at {NTT_SIZES[0]}: card != host plonk.ntt")
    part = x[:4, :1024]
    check(torch.equal(ntt.ntt_batched(part).cpu(), ntt.ntt_batched(part.cpu())),
          "ntt_batched 4 x 1024: card != CPU")
    ev = ntt.coset_eval_batched(x, prover_cuda.QUOTIENT_SHIFT)
    check(torch.equal(ntt.coset_interp_batched(ev, prover_cuda.QUOTIENT_SHIFT), x),
          f"coset transforms {NTT_ROWS} x {NTT_SIZES[0]}: no round trip")
    check(int_rows(ev[:1]) == [plonk._coset_eval(rows[0], NTT_SIZES[0], prover_cuda.QUOTIENT_SHIFT)],
          f"coset_eval_batched row 0 at {NTT_SIZES[0]}: card != host plonk._coset_eval")
    log(f"[ntt] {NTT_ROWS} rows x {', '.join(map(str, NTT_SIZES))} points on the card: inverse "
        f"undoes forward; rows 0-1 at {NTT_SIZES[0]} == host plonk.ntt; 4 x 1024 == the CPU; coset "
        f"eval/interp round-trips, row 0 == host plonk._coset_eval")
    return {"dev": dev, "composers": composers, "key": key, "host_s": host_s, "xs": xs}


def prover_timings(ctx: dict, smi: str) -> None:
    """Phase 8 for the prover: proofs/s, the phase split, peak memory, the
    inversion and the NTT, each line with the card's name and power limit."""
    composers, key = ctx["composers"], ctx["key"]
    for b in PLONK_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        timed_prove(composers[:b], key)  # the warm-up
        peak = torch.cuda.max_memory_allocated()
        runs = [timed_prove(composers[:b], key) for _ in range(PLONK_REPS)]
        wall = statistics.median(r[1] for r in runs)
        split = {name: statistics.median(r[2][name] for r in runs) for name in PROVER_PHASES}
        phases_ms = sum(split.values())
        log(f"[time] prove_batched B={b}, 978 gates, n = {key.n}: {b / wall:.4f} proofs/s, "
            f"{wall:.6f} s a batch (median of {PLONK_REPS} after a warm-up; walls "
            f"{', '.join(f'{r[1]:.6f}' for r in runs)} s); device phases: wires "
            f"{split['_phase1_wires']:.3f} ms, grand product {split['_phase2_grand_product']:.3f} ms, "
            f"quotient {split['_phase3_quotient']:.3f} ms; host {wall * 1e3 - phases_ms:.3f} ms "
            f"(transcripts, commitments, int conversion, copies); peak device memory "
            f"{peak / 2**30:.3f} GiB; host plonk.prove {1 / ctx['host_s']:.4f} proofs/s on the "
            f"same host | {smi}")
        den = torch.from_numpy(random_elements((b, key.n), np.random.default_rng(b))).to(ctx["dev"])
        log(f"[time] field.invert over ({b}, {key.n}) elements (phase 2's denominators): "
            f"{cuda_ms(lambda: field.invert(den)):.3f} ms | {smi}")
    for n, x in ctx["xs"].items():
        log(f"[time] ntt_batched {NTT_ROWS} x {n}: forward {cuda_ms(lambda: ntt.ntt_batched(x)):.3f} "
            f"ms, inverse {cuda_ms(lambda: ntt.ntt_batched(x, invert=True)):.3f} ms | {smi}")


def kernel_timed(fn):
    """Run fn once with CUDA events around every permutation launch:
    (its result, wall seconds by the host clock, the launches' device ms)."""
    events, launch = [], perm_cuda._launch

    def timed_launch(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args, **kwargs)
        end.record()
        events.append((start, end))

    perm_cuda._launch = timed_launch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        perm_cuda._launch = launch
    return out, wall, sum(start.elapsed_time(end) for start, end in events)


def on_card(name: str, fn, schedule: str, want: int) -> tuple:
    """Drive one path of phase 7e through the kernel of `schedule`: it must
    launch exactly `want` times (the host perm's calls on the same path)
    and nothing else. Returns (result, wall s, kernel device ms, launches)."""
    (out, wall, kernel_ms), counts = drive(lambda: kernel_timed(fn))
    expected = {s: want if s == schedule else 0 for s in perm_cuda.SCHEDULES}
    check(want > 0 and counts == expected, f"{name}: launches {counts} != {expected}")
    log(f"[launches] {name}: {counts}")
    return out, wall, kernel_ms, counts


def on_host(fn, host) -> tuple:
    """fn(perm) through the native engine: (result, wall s, the calls that
    permuted at least one state: a kernel launches for those only)."""
    calls = 0

    def perm(states):
        nonlocal calls
        calls += bool(len(states))
        return host(states)

    t0 = time.perf_counter()
    out = fn(perm)
    return out, time.perf_counter() - t0, calls


def prove_on_host(job):
    """One succinct proof through the native engine: a task of phase 7e's
    pool of host processes (it touches no card)."""
    composer, pk = job
    return fri.prove_succinct(composer, pk, fri.default_pcs_perm())


def succinct_phase(composers: list) -> dict:
    """Phase 7e: the succinct and aggregated DEEP-FRI argument with its
    trees, leaf sponges, grinding and pooled multiproof checks on the
    card's kernels (fri_cuda.device_pool_perm), held byte for byte and
    verdict for verdict against the same paths through the native engine.
    Returns what phase 8 prints."""
    host = fri.default_pcs_perm()
    check(host in (fri._pcs_perm_native, fri._pcs_perm_native_mt),
          "the succinct paths' reference must be the native engine")
    card, pool = fri_cuda.device_pool_perm("opt"), fri_cuda.device_pool_perm("hybp")
    c, times, launches = composers[0], {}, {s: 0 for s in perm_cuda.SCHEDULES}

    def add(counts):
        for s, n in counts.items():
            launches[s] += n

    # the "prod" proof: card and native engine in turns, each run held equal
    t0 = time.perf_counter()
    pk, vk = fri.preprocess_succinct(c, SUCCINCT_PROD, host)
    preprocess_s = time.perf_counter() - t0
    check(vk.n == 1024 and vk.n_gates == 978 and vk.params == fri.FriParams(blowup=8, n_queries=35,
          final_degree=64, pow_bits=16), "the prod preset's key: 978 gates, n = 1024, defaults")
    pis = [g.pi for g in c.gates]
    card_runs, host_runs = [], []
    for rep in range(SUCCINCT_REPS):
        proof, host_s, calls = on_host(lambda perm: fri.prove_succinct(c, pk, perm), host)
        want = serialize.proof_to_bytes(proof, vk)
        mine, wall, kernel_ms, counts = on_card(f"prove_succinct prod, run {rep}",
                                                lambda: fri.prove_succinct(c, pk, card), "opt", calls)
        data = serialize.proof_to_bytes(mine, vk)
        check(data == want, f"prove_succinct prod, run {rep}: card bytes != native engine's")
        card_runs.append((wall, kernel_ms, calls))
        host_runs.append(host_s)
        if rep == 0:
            add(counts)
    check(serialize.vk_from_bytes(serialize.vk_to_bytes(vk)) == vk, "vk bytes do not round-trip")
    back = serialize.proof_from_bytes(data, vk)
    check(serialize.proof_to_bytes(back, vk) == data, "proof_from_bytes does not invert proof_to_bytes")
    check(fri.verify_succinct(vk, back, pis, pool), "the card's prod proof does not verify")
    times["prove"] = (card_runs, host_runs)
    log(f"[succinct] prod preset ({vk.params}), 978 gates, n = {vk.n}, keyed in {preprocess_s:.1f} s: "
        f"{SUCCINCT_REPS} proofs through opt == the native engine's byte for byte ({len(data):,} "
        f"bytes, {card_runs[0][2]} permutation calls a proof); vk and proof bytes round-trip; "
        "the decoded proof verifies through hybp")

    # zk: one seeded generator for each side
    pkz, vkz = fri.preprocess_succinct(c, fri.FriParams(zk=True), host)
    zk_host, _, calls = on_host(
        lambda perm: fri.prove_succinct(c, pkz, perm, rng=np.random.default_rng(ZK_SEED)), host)
    zk_card, _, _, counts = on_card("prove_succinct prod zk", lambda: fri.prove_succinct(
        c, pkz, card, rng=np.random.default_rng(ZK_SEED)), "opt", calls)
    add(counts)
    data = serialize.proof_to_bytes(zk_card, vkz)
    check(data == serialize.proof_to_bytes(zk_host, vkz), "prove_succinct zk: card bytes != native's")
    check(serialize.proof_to_bytes(serialize.proof_from_bytes(data, vkz), vkz) == data
          and serialize.vk_from_bytes(serialize.vk_to_bytes(vkz)) == vkz,
          "zk proof or key bytes do not round-trip")
    check(fri.verify_succinct(vkz, zk_card, pis, host), "the card's zk proof does not verify")
    log(f"[succinct] zk, the same seeded generator on both sides: card == native engine byte for "
        f"byte ({len(data):,} bytes); bytes round-trip; verifies")

    # pooled verification of 16 "fast" proofs through hybp, two of them spoiled
    pkf, vkf = fri.preprocess_succinct(c, SUCCINCT_FAST, host)
    # the proofs are host work: one process a core (spawned, so no process
    # inherits the card's context), all ended when the pool closes
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(POOLED_PROOFS, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool_of_hosts:
        proofs = list(pool_of_hosts.map(prove_on_host,
                                        [(ci, pkf) for ci in composers[:POOLED_PROOFS]]))
    proving_s = time.perf_counter() - t0
    statements = [[g.pi for g in ci.gates] for ci in composers[:POOLED_PROOFS]]
    check(all(fri.verify_succinct_batched(vkf, proofs, statements, pool)),
          f"an honest proof of the {POOLED_PROOFS} failed pooled verification through hybp")
    bad_eval, bad_byte = 3, 9
    proofs[bad_eval].evals["a"] = (proofs[bad_eval].evals["a"] + 1) % P
    blob = bytearray(serialize.proof_to_bytes(proofs[bad_byte], vkf))
    blob[len(serialize.MAGIC_PROOF) + serialize._PROOF_HEADER.size] ^= 1  # the first root's low byte
    proofs[bad_byte] = serialize.proof_from_bytes(bytes(blob), vkf)
    expect = [i not in (bad_eval, bad_byte) for i in range(POOLED_PROOFS)]
    card_runs, host_runs = [], []
    for rep in range(SUCCINCT_REPS):
        want, host_s, calls = on_host(
            lambda perm: fri.verify_succinct_batched(vkf, proofs, statements, perm), host)
        got, wall, kernel_ms, counts = on_card(
            f"verify_succinct_batched {POOLED_PROOFS} fast, run {rep}",
            lambda: fri.verify_succinct_batched(vkf, proofs, statements, pool), "hybp", calls)
        check([bool(v) for v in got] == expect, f"pooled verdicts {list(got)} != {expect}")
        check([bool(v) for v in want] == expect, "pooled verdicts through the native engine differ")
        card_runs.append((wall, kernel_ms, calls))
        host_runs.append(host_s)
        if rep == 0:
            add(counts)
    times["verify"] = (card_runs, host_runs)
    log(f"[succinct] pooled verification of {POOLED_PROOFS} fast-preset proofs ({vkf.params}, "
        f"proved by the native engine in {proving_s:.1f} s on {os.cpu_count()} host processes) "
        f"through hybp: the honest ones true; a changed claimed evaluation (slot {bad_eval}) and a "
        f"changed byte (slot {bad_byte}) false in their slots only; == the native engine's")

    # the aggregate of 4 instances at the prod preset
    cs = composers[:AGG_INSTANCES]
    agg_pis = [[g.pi for g in ci.gates] for ci in cs]
    agg_host, host_s, calls = on_host(lambda perm: aggregate.prove_aggregate(cs, pk, perm), host)
    agg, wall, kernel_ms, counts = on_card(f"prove_aggregate {AGG_INSTANCES}",
                                           lambda: aggregate.prove_aggregate(cs, pk, card), "opt",
                                           calls)
    add(counts)
    data = serialize.aggregate_to_bytes(agg, vk)
    check(data == serialize.aggregate_to_bytes(agg_host, vk),
          "prove_aggregate: card bytes != native engine's")
    back = serialize.aggregate_from_bytes(data, vk)
    check(serialize.aggregate_to_bytes(back, vk) == data, "aggregate bytes do not round-trip")
    check(aggregate.verify_aggregate(vk, back, agg_pis, pool), "the card's aggregate does not verify")
    back.evals[2]["z"] = (back.evals[2]["z"] + 1) % P
    check(not aggregate.verify_aggregate(vk, back, agg_pis, pool),
          "an aggregate with a changed claimed evaluation must fail")
    times["aggregate"] = ([(wall, kernel_ms, calls)], [host_s])
    log(f"[succinct] aggregate of {AGG_INSTANCES} instances, prod preset: card == native engine "
        f"byte for byte ({len(data):,} bytes); bytes round-trip; verifies through hybp; a changed "
        "claimed evaluation fails")
    return {"times": times, "launches": launches, "pk": pk, "card": card, "c": c}


def succinct_timings(ctx: dict, smi: str) -> None:
    """Phase 8 for the succinct paths: wall seconds through the card and
    through the native engine, and the permutation launches' device ms
    with their share of the card's wall time."""
    names = {"prove": f"prove_succinct prod (median of {SUCCINCT_REPS})",
             "verify": f"verify_succinct_batched of {POOLED_PROOFS} fast proofs (median of "
                       f"{SUCCINCT_REPS})",
             "aggregate": f"prove_aggregate of {AGG_INSTANCES} instances, prod"}
    for key, name in names.items():
        card_runs, host_runs = ctx["times"][key]
        wall, kernel_ms, calls = sorted(card_runs)[len(card_runs) // 2]
        log(f"[time] {name}: card {wall:.6f} s (walls "
            f"{', '.join(f'{r[0]:.6f}' for r in card_runs)}), of which permutation kernels "
            f"{kernel_ms:.3f} ms in {calls} launches = {kernel_ms / 1e3 / wall:.5f} of the wall; "
            f"native engine {statistics.median(host_runs):.6f} s (walls "
            f"{', '.join(f'{t:.6f}' for t in host_runs)}) | {smi}")


def profile_path(name: str, fn) -> None:
    """Trace one warm call of fn with torch.profiler and print where its
    device time went: the span from the first device operation's start to
    the last one's end, the busy time (the union of the operations'
    intervals), the idle share of the span, the permutation kernels and
    the rest (the plain-torch glue)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    check(bool(ops), f"profile of {name}: no operation ran on the device")
    busy, reach = 0.0, ops[0][0]
    for start, end, _ in ops:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    span = reach - ops[0][0]
    # a kernel that is a template is listed with its return type in front
    perm = [(end - start) for start, end, op in ops if "hades_perm" in op]
    glue = [(end - start) for start, end, op in ops if "hades_perm" not in op]
    log(f"[profile] {name}: span {span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / span:.3f}, permutation kernels {sum(perm) / 1e3:.3f} ms in {len(perm)} "
        f"launches, plain-torch glue {sum(glue) / 1e3:.3f} ms in {len(glue)} launches")


def drive(fn):
    """Run one path of the main path with the launch counts set to 0 just
    before it; returns its result and the counts read just after."""
    perm_cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(perm_cuda.launches)


def cpu_model() -> str:
    """The host CPU's model name: from /proc/cpuinfo, else from lscpu, else
    what the platform module knows (the machine type at least)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next(ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
        return next(ln.split(":", 1)[1].strip() for ln in out.splitlines()
                    if ln.lower().startswith("model name"))
    except (OSError, subprocess.CalledProcessError, StopIteration):
        return f"{platform.processor() or 'model name not reported'} ({platform.machine()})"


def damage(d: str, height: int) -> None:
    """Delete the level files above CKPT_KEEP and cut CKPT_KEEP's own short,
    so that the highest whole level is CKPT_KEEP - 1."""
    for k in range(CKPT_KEEP + 1, height + 1):
        os.remove(os.path.join(d, f"level_{k}.bin"))
    with open(os.path.join(d, f"level_{CKPT_KEEP}.bin"), "r+b") as f:
        f.truncate(31)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    # the checkpoints' directory goes with the run, also when a check fails
    with tempfile.TemporaryDirectory(prefix="hades252_checkpoint_") as ckpt_root:
        return run(ckpt_root)


def run(ckpt_root: str) -> int:
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # 1. the card and the toolchain
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((ln for ln in nvcc.splitlines() if "release" in ln), "?")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | nvcc {release}")

    # 2. build
    t0 = time.perf_counter()
    _, report = _build.build()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s (0 when the library was already built)")
    for line in _build.ptxas_summary(report):
        log(f"[build] ptxas {line}")
    for s in ("mxu8", "mxu"):
        log(f"[build] hades_perm_{s}: {perm_cuda.dense_smem_bytes(s):,} B of dynamic shared memory "
            "a block")

    # 3. KAT gate on 2^14 lanes, every schedule, both paths
    selftest.assert_device_correct(dev)
    log(f"[kat] {', '.join(perm_cuda.SCHEDULES)} x canonical, Montgomery on "
        f"{selftest.BENCH_LANES} lanes: bit-identical to the int oracle (SURVEY KATs included)")

    # 4. kernel vs plain: the sponge's, cipher's and openings' batch, the
    # first Merkle level's batch on the Montgomery path the models use
    # (every kernel but hybp, which covers it through its own 2^20-leaf tree
    # in phase 5), 4096 and a ragged 1000 (the tail mask)
    cases = [(PERM_BATCH, (True, False), perm_cuda.SCHEDULES),
             (MERKLE_LEAVES // merkle.ARITY, (False,),
              ("naive", "opt", "mxu8", "mxu", "hyb", "hyb13", "hybp13")),
             (4096, (True, False), perm_cuda.SCHEDULES),
             (1000, (True, False), perm_cuda.SCHEDULES)]
    max_err = {s: 0 for s in perm_cuda.SCHEDULES}
    for b, converts, schedules in cases:
        x = torch.from_numpy(random_elements((WIDTH, b), rng).transpose(0, 2, 1).copy()).to(dev)
        for schedule in schedules:
            for convert in converts:
                got = perm_cuda.permute_planar(x, convert=convert, schedule=schedule)
                want = plain_planar(x, convert=convert, schedule=schedule)
                err = int((got.long() - want.long()).abs().max())
                max_err[schedule] = max(max_err[schedule], err)
                check(err == 0, f"{schedule} kernel != plain at B={b}, convert={convert}")
        log(f"[plain] {', '.join(schedules)} kernels == plain versions at B = {b}, "
            f"convert in {converts}")

    # the ragged edges of every kernel, and opt against the native
    # engine's sparse schedule (the second, independent reference)
    t0 = time.perf_counter()
    native._lib()  # raises NativeUnavailable where it cannot be built
    native_s = time.perf_counter() - t0
    for b in RAGGED:
        states = random_elements((b, WIDTH), rng)
        x = torch.from_numpy(states.transpose(1, 2, 0).copy()).to(dev)
        for schedule in perm_cuda.SCHEDULES:
            for convert in (True, False):
                got = perm_cuda.permute_planar(x, convert=convert, schedule=schedule)
                want = plain_planar(x, convert=convert, schedule=schedule)
                err = int((got.long() - want.long()).abs().max())
                max_err[schedule] = max(max_err[schedule], err)
                check(err == 0, f"{schedule} kernel != plain at B={b}, convert={convert}")
        got = perm_cuda.permute_planar(x, schedule="opt").permute(2, 0, 1).cpu().numpy()
        check(np.array_equal(native.perm_batch_digits(states), got),
              f"opt kernel != native engine at B={b}")
    log(f"[plain] {', '.join(perm_cuda.SCHEDULES)} kernels == plain versions at B in {RAGGED}, both "
        "convert values; opt kernel == native engine there")

    # the dense kernels' MDS products (warpgroup wgmma, u8 and bf16) against
    # a float64 matmul with w_lin and seeded byte rows at the main path's
    # batch, and with all-255 operands at K = 160: the largest sum,
    # 10,404,000, must come out of the bf16 product's f32 accumulation
    # exactly
    w = torch.from_numpy(mxu8_tables()["w_lin"]).to(dev)
    xb = torch.from_numpy(rng.integers(0, 256, (w.shape[1], PERM_BATCH), dtype=np.uint8)).to(dev)
    ones = torch.full((320, 160), 255, dtype=torch.uint8, device=dev)
    ones_x = torch.full((160, PERM_BATCH), 255, dtype=torch.uint8, device=dev)
    for name, dot in (("mxu8", perm_cuda.mxu8_dot), ("mxu", perm_cuda.mxu_dot)):
        check(torch.equal(dot(w, xb).double(), torch.matmul(w.double(), xb.double())),
              f"{name} MDS product with w_lin != float64 matmul")
        check(bool((dot(ones, ones_x) == 160 * 255 * 255).all()),
              f"{name} MDS product of all-255 operands")
    log(f"[plain] mxu8 (u8) and mxu (bf16) MDS products == float64 matmul for w_lin x {PERM_BATCH} "
        f"columns, and all-255 at 320 x 160 gives {160 * 255 * 255} everywhere")

    # 5a. Merkle checks against the plain version and the int oracle
    small = torch.from_numpy(random_elements((4096,), rng)).to(dev)
    check(torch.equal(merkle.merkle_root(small), merkle.merkle_root(small, plain_mont_fn("opt"))),
          "4096-leaf Merkle root: kernel != plain")
    tiny = random_elements((16,), rng)
    tiny_root = merkle.merkle_root(torch.from_numpy(tiny).to(dev)).cpu().numpy()
    check(int(digits_to_ints(tiny_root)) == int_merkle_root(list(digits_to_ints(tiny))),
          "16-leaf Merkle root: kernel != int oracle")

    leaves = torch.from_numpy(random_elements((MERKLE_LEAVES,), rng)).to(dev)
    msgs = torch.from_numpy(random_elements((SPONGE_STREAMS, SPONGE_LEN), rng)).to(dev)
    keys = torch.from_numpy(random_elements((CIPHER_STREAMS, 2), rng)).to(dev)
    nonces = torch.from_numpy(random_elements((CIPHER_STREAMS,), rng)).to(dev)
    plaintext = torch.from_numpy(random_elements((CIPHER_STREAMS, CIPHER_LEN), rng)).to(dev)
    opened_idx = torch.from_numpy(rng.integers(0, MERKLE_LEAVES, OPENINGS)).to(dev)
    opened = leaves[opened_idx]
    torch.cuda.synchronize()

    # 5b-7. the main path, one entry point at a time; each path's counts are
    # its own launches
    naive_fn, mxu8_fn, hyb_fn, hybp_fn, mxu_fn, hyb13_fn, hybp13_fn = (
        make_perm_mont_fn("cuda", schedule=s)
        for s in ("naive", "mxu8", "hyb", "hybp", "mxu", "hyb13", "hybp13"))
    ckpt_dir = os.path.join(ckpt_root, "main")
    levels, cross_levels = merkle.tree_levels(MERKLE_LEAVES), merkle.tree_levels(CROSS_LEAVES)
    chunks = 1 + CIPHER_LEN // cipher.RATE
    cross = leaves[:CROSS_LEAVES]
    state = {}  # what a later path takes from an earlier one

    def open_many():
        state["sibs"], state["poss"] = merkle.merkle_open_batched(state["levels"], opened_idx)

    def verify_many(fn):
        return lambda: merkle.merkle_verify_batched(root, opened, state["sibs"], state["poss"],
                                                    levels, fn)

    def resume(fn):
        def damaged_then_resumed():
            damage(ckpt_dir, levels)
            check(checkpoint.highest_saved_level(ckpt_dir, levels, MERKLE_LEAVES)
                  == CKPT_KEEP - 1, "a truncated level file must be ignored")
            return checkpoint.merkle_root_checkpointed(leaves, ckpt_dir, fn)
        return damaged_then_resumed

    resumed = levels - (CKPT_KEEP - 1)  # levels recomputed after the damage

    def stream_sponge():
        """The streaming sponge on its default device, fed in uneven pieces."""
        st = sponge.SpongeState(SPONGE_STREAMS, SPONGE_LEN)
        check(st._state.device.type == "cuda", "SpongeState must default to the card")
        for lo in range(0, SPONGE_LEN, 12):
            st.absorb(msgs[:, lo : lo + 12])
        return st.digest()

    paths = {
        "merkle (opt)": (lambda: merkle.merkle_root(leaves), {"opt": levels}),
        "merkle 2^16 (opt)": (lambda: merkle.merkle_root(cross), {"opt": cross_levels}),
        "merkle 2^16 (naive)": (lambda: merkle.merkle_root(cross, naive_fn),
                                {"naive": cross_levels}),
        "merkle 2^16 (mxu8)": (lambda: merkle.merkle_root(cross, mxu8_fn),
                               {"mxu8": cross_levels}),
        "levels (hybp)": (lambda: state.update(levels=merkle.merkle_levels(leaves, hybp_fn)),
                          {"hybp": levels}),
        "open": (open_many, {}),
        "verify (hybp)": (verify_many(hybp_fn), {"hybp": levels}),
        "verify (hyb)": (verify_many(hyb_fn), {"hyb": levels}),
        "verify (opt)": (verify_many(None), {"opt": levels}),
        "verify one (hybp)": (lambda: merkle.merkle_verify(
            root, opened[0], merkle.merkle_open(state["levels"], int(opened_idx[0])), levels,
            hybp_fn), {"hybp": levels}),
        "sponge (opt)": (lambda: sponge.sponge_hash(msgs), {"opt": SPONGE_LEN // sponge.RATE}),
        "sponge streaming (opt)": (stream_sponge, {"opt": SPONGE_LEN // sponge.RATE}),
        "cipher (mxu8)": (lambda: cipher.encrypt(keys, nonces, plaintext, mxu8_fn),
                          {"mxu8": chunks}),
        "cipher (opt)": (lambda: cipher.encrypt(keys, nonces, plaintext), {"opt": chunks}),
        "checkpointed (mxu)": (lambda: checkpoint.merkle_root_checkpointed(
            leaves, ckpt_dir, mxu_fn), {"mxu": levels}),
        "resumed (hyb13)": (resume(hyb13_fn), {"hyb13": resumed}),
        "resumed (hybp13)": (resume(hybp13_fn), {"hybp13": resumed}),
    }
    results, main_launches = {}, {s: 0 for s in perm_cuda.SCHEDULES}
    root = None
    for name, (fn, expected) in paths.items():
        results[name], counts = drive(fn)
        if name == "merkle (opt)":
            root = results[name]
        want = {s: expected.get(s, 0) for s in perm_cuda.SCHEDULES}
        check(counts == want, f"{name}: launches {counts} != {want}")
        log(f"[launches] {name}: {counts}")
        for s in perm_cuda.SCHEDULES:
            main_launches[s] += counts[s]
    check(all(main_launches[s] > 0 for s in perm_cuda.SCHEDULES),
          f"a kernel of the main path never launched: {main_launches}")

    for s in ("naive", "mxu8"):
        check(torch.equal(results["merkle 2^16 (opt)"], results[f"merkle 2^16 ({s})"]),
              f"2^16-leaf Merkle root: opt kernel != {s} kernel")
    check(root.shape == (16,) and bool(((root >= 0) & (root < 1 << 16)).all()),
          "Merkle root is not 16 digits")
    check(torch.equal(root, field.from_mont(state["levels"][-1][0])),
          "2^20-leaf Merkle root: opt kernel != hybp kernel")
    log(f"[merkle] 2^20 leaves, {levels} levels: opt root == hybp root "
        f"== 0x{int(digits_to_ints(root.cpu().numpy())):064x}; 2^16 leaves: opt root == "
        "naive root == mxu8 root")

    # 5c. the openings: shapes, verdicts, the loop, one path on ints, rejections
    sibs, poss = state["sibs"], state["poss"]
    check(sibs.shape == (OPENINGS, levels, merkle.ARITY - 1, 16) and sibs.dtype == torch.int32
          and poss.shape == (OPENINGS, levels) and poss.dtype == torch.int32,
          "openings have the wrong shape")
    ok = results["verify (hybp)"]
    check(ok.shape == (OPENINGS,) and ok.dtype == torch.bool and bool(ok.all()),
          "an honest opening failed through hybp")
    for s in ("hyb", "opt"):
        check(torch.equal(ok, results[f"verify ({s})"]), f"verdicts: hybp kernel != {s} kernel")
    check(results["verify one (hybp)"] is True, "merkle_verify rejected an honest opening")
    loop = [merkle.merkle_open_compact(state["levels"], int(i)) for i in opened_idx[:64]]
    check(torch.equal(sibs[:64], torch.stack([s for s, _ in loop]))
          and torch.equal(poss[:64], torch.stack([p for _, p in loop])),
          "openings 0..63: gathers != the loop of merkle_open_compact")
    walk = int_merkle_walk(
        int(digits_to_ints(opened[0].cpu().numpy())),
        [list(digits_to_ints(row)) for row in field.from_mont(sibs[0]).cpu().numpy()],
        poss[0].tolist())
    check(walk == int(digits_to_ints(root.cpu().numpy())), "opening 0: int oracle walk != root")
    tampered = sibs.clone()
    tampered[5, 3, 1, 0] ^= 1
    bad = merkle.merkle_verify_batched(root, opened, tampered, poss, levels, hybp_fn)
    check(not bool(bad[5]) and int(bad.sum()) == OPENINGS - 1,
          "openings: a tampered sibling must fail its own row and only it")
    out_of_range = poss.clone()
    out_of_range[9, 2] = merkle.ARITY
    bad = merkle.merkle_verify_batched(root, opened, sibs, out_of_range, levels, hybp_fn)
    check(not bool(bad[9]) and int(bad.sum()) == OPENINGS - 1,
          "openings: a position of 4 must fail its own row and only it")
    bad = merkle.merkle_verify_batched(root, opened, sibs, poss, levels - 1, hybp_fn)
    check(not bool(bad.any()), "openings: a wrong height must fail every row")
    log(f"[openings] {OPENINGS} of 2^20 leaves: all verify through hybp, hyb and opt; rows 0..63 "
        "== the loop; opening 0 verifies alone and on ints; a tampered sibling and a position "
        "of 4 fail their rows only; height 9 fails every row")

    digests = results["sponge (opt)"]
    check(digests.shape == (SPONGE_STREAMS, 16), "sponge digests have the wrong shape")
    plain = sponge.sponge_hash(msgs[:64], plain_mont_fn("opt"))
    check(torch.equal(digests[:64], plain), "sponge digests of streams 0..63: kernel != plain")
    words0 = list(digits_to_ints(msgs[0].cpu().numpy()))
    check(int(digits_to_ints(digests[0].cpu().numpy())) == int_sponge(words0),
          "sponge digest of stream 0: kernel != int oracle")
    streamed = results["sponge streaming (opt)"]
    check(streamed.device.type == "cuda" and torch.equal(streamed[:64], digests[:64])
          and torch.equal(streamed, digests),
          "SpongeState on its default device: digests != sponge_hash's")
    log(f"[sponge] {SPONGE_STREAMS} streams x {SPONGE_LEN}: digests 0..63 == plain, "
        "stream 0 == int oracle; SpongeState on its default device (the card), fed in pieces "
        "of 12, == sponge_hash for every stream")

    ct, tag = results["cipher (mxu8)"]
    check(ct.shape == (CIPHER_STREAMS, CIPHER_LEN, 16) and tag.shape == (CIPHER_STREAMS, 16),
          "cipher output has the wrong shape")
    check(all(torch.equal(a, b) for a, b in zip((ct, tag), results["cipher (opt)"])),
          "cipher: mxu8 kernel != opt kernel")
    ct_p, tag_p = cipher.encrypt(keys[:64], nonces[:64], plaintext[:64], plain_mont_fn("mxu8"))
    check(torch.equal(ct[:64], ct_p) and torch.equal(tag[:64], tag_p),
          "cipher rows 0..63: mxu8 kernel != plain")
    want_ct, want_tag = int_cipher(list(digits_to_ints(keys[0].cpu().numpy())),
                                   int(digits_to_ints(nonces[0].cpu().numpy())),
                                   list(digits_to_ints(plaintext[0].cpu().numpy())))
    check(list(digits_to_ints(ct[0].cpu().numpy())) == want_ct
          and int(digits_to_ints(tag[0].cpu().numpy())) == want_tag,
          "cipher row 0: mxu8 kernel != int oracle")
    pt, ok = cipher.decrypt(keys, nonces, ct, tag, mxu8_fn)
    check(bool(ok.all()) and torch.equal(pt, plaintext), "cipher: decrypt does not round-trip")
    tampered = ct.clone()
    tampered[5, 3, 0] ^= 1
    _, ok = cipher.decrypt(keys, nonces, tampered, tag, mxu8_fn)
    check(not bool(ok[5]) and int(ok.sum()) == CIPHER_STREAMS - 1,
          "cipher: a tampered word must fail its own row and only it")
    _, ok = cipher.decrypt(keys, nonces, ct[:, : CIPHER_LEN - cipher.RATE], tag, mxu8_fn)
    check(not bool(ok.any()), "cipher: a truncated ciphertext must fail every row")
    log(f"[cipher] {CIPHER_STREAMS} streams x {CIPHER_LEN}: mxu8 == opt, rows 0..63 == plain, "
        "row 0 == int oracle; decrypt round-trips; tamper fails its row only; truncation "
        "fails every row")

    # 7b. the checkpointed build and its resumes
    for name in ("checkpointed (mxu)", "resumed (hyb13)", "resumed (hybp13)"):
        check(torch.equal(results[name], root), f"{name}: root != opt's merkle_root")
    top = checkpoint.load_level(ckpt_dir, levels, 1)[0]
    check(np.array_equal(top, root.cpu().numpy()), f"level_{levels}.bin does not decode to the root")
    check(checkpoint.highest_saved_level(ckpt_dir, levels, MERKLE_LEAVES) == levels,
          "a resumed directory must be whole again")
    other = leaves.clone()
    other[12345, 3] ^= 1
    perm_cuda.reset_launches()
    try:
        checkpoint.merkle_root_checkpointed(other, ckpt_dir, mxu_fn)
    except ValueError as e:
        check("different build" in str(e), f"other leaves: unexpected refusal {e}")
    else:
        check(False, "a directory built from other leaves must be refused")
    check(not any(perm_cuda.launches.values()), "a refused build must launch nothing")
    log(f"[checkpoint] 2^20 leaves through mxu: root == opt's, {levels} level files; levels "
        f"above {CKPT_KEEP} deleted and level {CKPT_KEEP} truncated, resumed from level "
        f"{CKPT_KEEP - 1} through hyb13 and through hybp13: same root, {resumed} launches each; "
        f"level_{levels}.bin decodes to the root; other leaves refused")

    # 7c. the native CPU engine (built in phase 4) against the port
    states = random_elements((64, WIDTH), rng)
    got = perm_cuda.permute_cuda(torch.from_numpy(states).to(dev)).cpu().numpy()
    check(np.array_equal(native.perm_batch_digits(states), got),
          "64 states: native engine != opt kernel")
    check(np.array_equal(native.merkle_root_digits(small.cpu().numpy()),
                         merkle.merkle_root(small).cpu().numpy()),
          "4096-leaf Merkle root: native engine != opt kernel")
    log(f"[native] built in {native_s:.1f} s; 64 states == opt kernel; 4096-leaf root == opt "
        f"kernel's; one thread: naive {native.bench_perms_per_sec():,.0f} perms/s, sparse "
        f"{native.bench_perms_per_sec_opt():,.0f} perms/s, IFMA batch-8 "
        f"{native.bench_perms_per_sec_opt8():,.0f} perms/s (-1: not compiled in) | "
        f"{cpu_model()}")
    log(f"[launches] main path, summed: {main_launches}")

    # 7d. the batched prover and the NTT on the card
    prover = prover_phase(dev, rng)

    # 7e. the succinct and aggregated argument on the kernels
    succinct = succinct_phase(prover["composers"])
    for s, n in succinct["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7e, summed: {main_launches}")

    # 8. timings at the main path's shapes
    x = torch.from_numpy(random_elements((WIDTH, PERM_BATCH), rng).transpose(0, 2, 1).copy()).to(dev)
    ms, plain_ms, bounds = {}, {}, {}
    for schedule in perm_cuda.SCHEDULES:
        ms[schedule] = cuda_ms(lambda: perm_cuda.permute_planar(x, schedule=schedule))
        plain_ms[schedule] = cuda_ms(
            lambda: perm_cuda.permute_planar_plain(x, schedule=schedule))
        bounds[schedule] = bound(schedule, PERM_BATCH)
        log(f"[time] {schedule}: kernel {ms[schedule]:.4f} ms = "
            f"{PERM_BATCH / ms[schedule] * 1e3:,.0f} perms/s; plain {plain_ms[schedule]:.1f} ms "
            f"= {PERM_BATCH / plain_ms[schedule] * 1e3:,.0f} perms/s; bound "
            + ", ".join(f"{k} {v:.4f}" if k != "bound_by" else f"by {v}"
                        for k, v in bounds[schedule].items())
            + f"; B={PERM_BATCH} | {smi}")
    for b in TIMED_SIZES:
        xb = torch.from_numpy(random_elements((WIDTH, b), rng).transpose(0, 2, 1).copy()).to(dev)
        for schedule in perm_cuda.SCHEDULES:
            t = cuda_ms(lambda: perm_cuda.permute_planar(xb, schedule=schedule))
            bd = bound(schedule, b)["bound_ms"]
            log(f"[time] {schedule}: kernel {t:.4f} ms = {b / t * 1e3:,.0f} perms/s, "
                f"{t / b * PERM_BATCH:.4f} ms a 2^14; bound {bd:.4f} ms ({bd / t:.3f} of the "
                f"time); B={b} | {smi}")
    tree_ms = cuda_ms(lambda: merkle.merkle_root(leaves))
    log(f"[time] merkle_root 2^20 leaves (opt): {tree_ms / 1e3:.6f} s/tree = "
        f"{MERKLE_LEAVES / tree_ms * 1e3:,.0f} leaves/s | {smi}")
    for schedule, fn in (("naive", naive_fn), ("opt", None)):
        tree_ms = cuda_ms(lambda: merkle.merkle_root(cross, fn))
        log(f"[time] merkle_root 2^16 leaves ({schedule}, the cross-check tree): "
            f"{tree_ms:.4f} ms/tree = {CROSS_LEAVES / tree_ms * 1e3:,.0f} leaves/s | {smi}")
    tree_ms = cuda_ms(lambda: merkle.merkle_levels(leaves, hybp_fn))
    log(f"[time] merkle_levels 2^20 leaves (hybp): {tree_ms / 1e3:.6f} s/tree = "
        f"{MERKLE_LEAVES / tree_ms * 1e3:,.0f} leaves/s | {smi}")
    fresh = itertools.count()  # a directory of its own for every timed build

    def checkpointed_build():
        return checkpoint.merkle_root_checkpointed(
            leaves, os.path.join(ckpt_root, f"timed{next(fresh)}"), mxu_fn)

    tree_ms = cuda_ms(lambda: merkle.merkle_root(leaves, mxu_fn))
    ckpt_ms = cuda_ms(checkpointed_build)
    log(f"[time] merkle_root 2^20 leaves (mxu): {tree_ms / 1e3:.6f} s/tree; "
        f"merkle_root_checkpointed into a fresh directory (mxu): {ckpt_ms / 1e3:.6f} s/tree = "
        f"{MERKLE_LEAVES / ckpt_ms * 1e3:,.0f} leaves/s; the fingerprint, {levels} copies to "
        f"the host and {levels} files cost {(ckpt_ms - tree_ms) / 1e3:.6f} s | {smi}")
    for schedule, fn in (("hyb13", hyb13_fn), ("hybp13", hybp13_fn)):
        resume_ms = cuda_ms(resume(fn))
        log(f"[time] resume from level {CKPT_KEEP - 1} ({schedule}, {resumed} launches, damage "
            f"included): {resume_ms / 1e3:.6f} s | {smi}")
    open_ms = cuda_ms(open_many)
    log(f"[time] merkle_open_batched {OPENINGS} of 2^20: {open_ms:.3f} ms = "
        f"{OPENINGS / open_ms * 1e3:,.0f} openings/s | {smi}")
    for schedule, fn in (("hybp", hybp_fn), ("hyb", hyb_fn), ("opt", None)):
        verify_ms = cuda_ms(verify_many(fn))
        log(f"[time] merkle_verify_batched {OPENINGS} x height {levels} ({schedule}): "
            f"{verify_ms:.3f} ms = {OPENINGS / verify_ms * 1e3:,.0f} openings verified/s | {smi}")
    sponge_ms = cuda_ms(lambda: sponge.sponge_hash(msgs))
    log(f"[time] sponge_hash {SPONGE_STREAMS} x {SPONGE_LEN} (opt): {sponge_ms:.3f} ms = "
        f"{SPONGE_STREAMS * SPONGE_LEN / sponge_ms * 1e3:,.0f} elements/s | {smi}")
    for schedule, fn in (("mxu8", mxu8_fn), ("opt", None)):
        enc_ms = cuda_ms(lambda: cipher.encrypt(keys, nonces, plaintext, fn))
        log(f"[time] cipher.encrypt {CIPHER_STREAMS} x {CIPHER_LEN} ({schedule}): "
            f"{enc_ms:.3f} ms = {CIPHER_STREAMS * CIPHER_LEN / enc_ms * 1e3:,.0f} elements/s "
            f"| {smi}")

    prover_timings(prover, smi)
    succinct_timings(succinct, smi)

    # 9. on request: where the openings' paths spend their device time
    if "--profile" in sys.argv[1:]:
        for name, fn in (("merkle_root 2^20 (opt)", lambda: merkle.merkle_root(leaves)),
                         ("merkle_root 2^16 (naive)", lambda: merkle.merkle_root(cross, naive_fn)),
                         ("merkle_root 2^16 (opt)", lambda: merkle.merkle_root(cross)),
                         (f"sponge_hash {SPONGE_STREAMS} x {SPONGE_LEN} (opt)",
                          lambda: sponge.sponge_hash(msgs)),
                         (f"cipher.encrypt {CIPHER_STREAMS} x {CIPHER_LEN} (opt)",
                          lambda: cipher.encrypt(keys, nonces, plaintext)),
                         (f"cipher.encrypt {CIPHER_STREAMS} x {CIPHER_LEN} (mxu8)",
                          lambda: cipher.encrypt(keys, nonces, plaintext, mxu8_fn)),
                         ("merkle_levels 2^20 (hybp)",
                          lambda: merkle.merkle_levels(leaves, hybp_fn)),
                         (f"merkle_open_batched {OPENINGS}", open_many),
                         (f"merkle_verify_batched {OPENINGS} (hybp)", verify_many(hybp_fn)),
                         (f"merkle_verify_batched {OPENINGS} (hyb)", verify_many(hyb_fn)),
                         (f"merkle_verify_batched {OPENINGS} (opt)", verify_many(None)),
                         ("merkle_root_checkpointed 2^20 (mxu)", checkpointed_build),
                         (f"resume from level {CKPT_KEEP - 1} (hyb13)", resume(hyb13_fn)),
                         (f"resume from level {CKPT_KEEP - 1} (hybp13)", resume(hybp13_fn)),
                         (f"prove_batched B={PLONK_BATCHES[0]} (978 gates)",
                          lambda: prover_cuda.prove_batched(
                              prover["composers"][:PLONK_BATCHES[0]], prover["key"])),
                         ("prove_succinct prod (opt)", lambda: fri.prove_succinct(
                             succinct["c"], succinct["pk"], succinct["card"]))):
            profile_path(f"{name} | {smi}", fn)

    kernels = [
        {"name": f"hades_perm_{s}", "route": "cuda", "source": SOURCES[s],
         "replaces": REPLACES[s], "launches": main_launches[s], "max_abs_err": max_err[s],
         "ms": ms[s], "plain_ms": plain_ms[s], "bound_ms": bounds[s]["bound_ms"],
         "bound_by": bounds[s]["bound_by"], "library_ms": None}
        for s in perm_cuda.SCHEDULES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
