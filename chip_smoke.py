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
     level's B = 2^18 on the Montgomery path (one plain run covers several
     batches side by side, as states are independent); every kernel, `naive` and
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
  7d. drives the batched PLONK prover (`prover_cuda.prove_batched`, each of
     its three phases one CUDA graph a shape, captured at its first use) on
     its default device, the card, at the width of bench.py's plonk mode: 64
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
  7f. drives the device-resident succinct prover
     (`fri_cuda.prove_succinct_device[_batch]`: the polynomials, trees, DEEP
     composition, folds, grinding and openings on the card, the FRI commit
     phase as one CUDA graph) on phase 7e's keys: the prod proof of the same
     instance, a warm-up and 3 timed runs, each byte-identical to phase 7e's
     native-engine proof and verified through `hybp`; the FRI phase's graph
     replay equal to its eager body on seeded inputs, tensor for tensor; the
     zk proof with phase 7e's seeded generator, equal to its native bytes;
     bench.py's fri mode, B = 8 instances at the "fast" preset through
     `prove_succinct_device_batch` (a warm-up and 3 timed runs), equal to the
     first 8 of phase 7e's pooled native proofs and verified through `hybp`;
     composers of two circuits refused with nothing launched. Each shape's
     graph is captured before its runs; each run must launch `opt` exactly
     as `device_proof_launches` says (its trees' chunks and levels and its
     grinding windows by the wrappers' counts, the FRI phase as one replay
     of a graph that holds its launches) and no other kernel;
  7g. drives the device aggregate prover (`fri_cuda.prove_aggregate_device`:
     one argument for B instances, its FRI phase one graph replay) and the
     device verifiers: the aggregate of phase 7e's 4 instances at its prod
     key (a warm-up and 3 timed runs), each byte-identical to phase 7e's
     native-engine aggregate; bench.py's aggregate mode, 8 instances at the
     "fast" preset (a warm-up and 3 timed runs) and the same with `zk=True`
     and one seeded generator a side, each byte-identical to the native
     engine's `aggregate.prove_aggregate` run here; `verify_aggregate_device`
     through `hybp` accepting each and refusing a changed claimed
     evaluation; `verify_succinct_device_batch` through `hybp` on phase 7e's
     16 fast proofs (two spoiled) and on one, fused (the pooled Merkle phase
     as one graph replay) and not (a launch a sponge chunk and a level), 3
     runs each, the native engine's verdicts; `device_chain_fn` on 2^10
     seeded openings of a 2^14-leaf tree (a prod proof's m0/2 positions)
     equal to the host loop of `fri.tree_verify_batched`, a changed value
     failing its row only; the chain's, the fused pool's and the fast
     aggregate's FRI-phase graph replays equal to their eager bodies;
     composers of two circuits refused with nothing launched. Every graph
     is captured before the runs that are counted, and each run must launch
     as `device_aggregate_launches` or `pooled_merkle_launches` says: the
     wrappers' counts, plus each graph's replays times the launches it
     holds, and no other kernel;
  7h. drives the sharded paths (`parallel/dist.py` and the `mesh` of the
     provers and verifiers) on a world-1 NCCL group in this process (TCP on
     127.0.0.1, destroyed at the end): `merkle_root_sharded` over phase 5's
     2^20 leaves (the root and the counters), `permute_sharded` at 2^14
     against `permute_cuda`, `sponge_hash_sharded` and `cipher_sharded`
     against phases 6 and 7, `prove_batched(mesh=)` at B = 16 against phase
     7d's proofs, `prove_succinct_device_batch(mesh=)` and
     `prove_aggregate_device(mesh=)` at the fast preset, B = 8, against
     phases 7f's and 7g's bytes, `verify_succinct_device_batch(mesh=)`
     through `hybp` on phase 7e's 16 fast proofs (two spoiled), and
     `fri_cuda.mesh_chain_fn` through `hybp` on phase 7g's 2^10 openings
     against `device_chain_fn`, each with its launches counted as in phase
     7g; then two ranks spawned on cuda:0 over gloo build the 2^20-leaf tree
     and prove B = 16, every rank's root and proofs equal to phases 5's and
     7d's (10 `opt` launches a rank); on a host with two or more cards, two
     or four NCCL ranks, one card each, build the tree too (the ranks are
     spawned by `multihost.spawn`);
  7i. holds each of the prover's three phase graphs, replayed twice on
     the arguments its buffers hold after a prove_batched at phase 7d's
     B = 16, bit for bit against its eager body, and prints every
     prover graph's replays; runs `entry.entry()` (the KAT gate for `opt`,
     then its kernel on one (5, 16, 1024) planar batch, against the plain
     version); `entry.dryrun_multichip` on one NCCL rank and on two gloo
     ranks sharing cuda:0 (the sharded permutation, sponge, cipher, Merkle
     tree and prover phase 1 against one device; each rank's launches
     predicted); and both examples
     (`python -m hades252_tpu_torch.examples.quickstart`, `multichip_merkle`)
     as subprocesses on the card, every verdict true, with their walls;
  8. times the kernels, their plain versions, the trees, the openings,
     the sponge, the cipher and the checkpointed build (beside the plain
     `merkle_root` through the same kernel, so the cost of the ten
     device-to-host copies and file writes is a number), and the `naive`
     cross-check tree over 2^16 leaves beside `opt`'s, with CUDA events
     (median of 5 after a warm-up), and works out each kernel's bound: the
     least time the card could take for the same states, the resource
     that binds it and the share of the kernel's time it is
     (`utils/roofline.roofline`); every
     kernel also at B = 2^10, 2^16 and 2^18. The prover: proofs/s at B = 16
     and 64 (host clock around the call, median of 3 after a warm-up), the
     split into its three device phases (their spans' CUDA events, read
     from `utils/metrics.snapshot()`) and the
     host's share, the peak device memory, the host `plonk.prove`'s rate on
     the same host, `field.invert` over the grand product's denominators
     and `ntt_batched` over 64 rows of 2^12 and 2^14 points. The succinct
     paths of phase 7e (timed there, printed here): the seconds of a "prod"
     proof through the card beside the native engine's (median of 3, host
     clock), of the pooled verification of 16 "fast" proofs (median of 3)
     and of the aggregate of 4 instances (one run each), each with its
     permutation launches' device ms (CUDA events around every launch) and
     their share of the wall. The device prover of phase 7f: the seconds of
     a prod proof (median of 3, host clock) beside phase 7e's card and
     native walls, proofs/s at fast B = 8, the peak device memory of each,
     the FRI phase's graph replay beside its eager body and
     `_inv_mont_dev` over a prod proof's 2 x 32,768 points (CUDA events).
     Phase 7g's: the seconds of a device aggregate (prod B = 4 and fast
     B = 8, median of 3; zk one run) beside phase 7e's card and native
     walls and the native fast aggregate, of a fused and an unfused
     verification of 16 and of 1 (median of 3) beside phase 7e's pooled
     path, the fused pool's graph replay beside its eager body (CUDA
     events), and the peak device memory of each. Phase 7h's: the sharded
     tree's wall on one NCCL rank beside `merkle_root`'s and on two gloo
     ranks (host clock, median of 5 after a warm-up), `dist.collective_bytes`,
     and where the host has two or more cards the N-card wall and BASELINE
     config 5's scaling efficiency.

Each path of phases 5-7b and 7e-7i runs with the launch counts set to 0 just
before it and read just after; the kernels' JSON line reports their sum (the
spawned ranks' counts of their first tree and of the dry run included; the
examples' subprocesses are not counted). The
earlier paths run at the depth they had: the `naive` and `mxu8` cross-check
trees over 2^16 leaves, everything else at full size. No
single PyTorch call computes a 255-bit modular permutation, so the line's
`library_ms` is null for every kernel.

With `--profile` it also traces one warm call of the tree, the sponge and
the cipher through `opt`, of the 2^16-leaf tree through `naive` and `opt`,
of the cipher through `mxu8`, of each of the
openings' paths, of the checkpointed build (through `mxu`), of its two
resumes (through `hyb13` and `hybp13`, the damage included) and of one
`prove_batched` at B = 16, of one "prod" `fri.prove_succinct` through
`opt`, of one prod `fri_cuda.prove_succinct_device`, of one prod device
aggregate of 4 and of one fused verification of 16 fast proofs with
`torch.profiler` (phase 9, through `utils/profiling.trace`, which writes each
path's Chrome trace to `build/profile/<n>/trace.json`) and prints, per path,
the span of its device work, the time the device was busy, the idle share,
the permutation kernel's share and the plain-torch glue's, and the host's
launch calls (kernels, and graph replays).

Every check is exact (integer arithmetic: tolerance 0). Any failure raises
and the script exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it gives the card's name and
power limit, and the one before that the kernels' JSON summary.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
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
import torch.distributed as tdist

try:
    import hades252_tpu_torch  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "hades252_tpu_torch":
        raise
    sys.exit("chip_smoke: needs the package directory hades252_tpu_torch/ beside it: run it "
             "from the root of a checkout")

from hades252_tpu_torch import aggregate, field, fri, fri_cuda, plonk, prover_cuda, selftest
from hades252_tpu_torch import entry as entry_points
from hades252_tpu_torch import serialize
from hades252_tpu_torch.gadget import Composer, Constraint, GadgetStrategy
from hades252_tpu_torch.models import cipher, merkle, sponge
from hades252_tpu_torch.ops import _build, make_perm_mont_fn, ntt, perm_cuda
from hades252_tpu_torch.parallel import dist, multihost
from hades252_tpu_torch.params import P, WIDTH, mxu8_tables
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils import checkpoint, graphs, metrics, native, profiling, roofline
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

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
# the device-resident prover (phase 7f): bench.py's fri mode proves B = 8
# instances at the "fast" preset through it (bench.py:393-470)
DEVICE_BATCH = 8
# the device aggregate prover and verifiers (phase 7g): bench.py's aggregate
# mode proves B = 8 instances at the "fast" preset (bench.py:488-567)
AGG_FAST_INSTANCES = 8
CHAIN_LEAVES, CHAIN_OPENINGS = 1 << 14, 1 << 10   # a prod proof's m0/2 positions
# the sharded paths (phase 7h): two ranks on one card over gloo; NCCL over two
# or four cards where the host has them
GLOO_RANKS, MAX_CARDS = 2, 4
GROUP_TIMEOUT_S = 120       # a collective's wait for the other ranks
RANKS_WALL_S = 300          # spawned ranks: all must report and exit within it
# the examples (phase 7i): each subprocess's wall limit, the quickstart's
# known perm([1..5])[0] and its count of verdict lines
EXAMPLE_WALL_S = 240
QUICKSTART_PERM = "perm([1..5])[0] = 0x5082aaf0060eeafea9119f97d3fb7b92be07825ab67ec37b8d2df57c1c64080c"
QUICKSTART_VERDICTS = 10
# the plain versions' slice, which bounds their int64 temporaries (phase 4
# prints their peak)
PLAIN_SLICE = 1 << 16
# --profile: each traced path's Chrome trace, <n>/trace.json, beside the builds
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")


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
    """The plain version of a kernel over planar x, in slices of PLAIN_SLICE
    states (each state is independent), which bounds its int64 temporaries."""
    return torch.cat([perm_cuda.permute_planar_plain(x[:, :, i : i + PLAIN_SLICE],
                                                     convert=convert, schedule=schedule)
                      for i in range(0, x.shape[2], PLAIN_SLICE)], dim=2)


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
    """One prove_batched on the card with metrics enabled: (proofs, wall
    seconds, {phase: device ms}), each phase's time read from its span
    `prove.phase<k>` (CUDA events around its graph replay, with its copies
    in and its clones out). The host's share is the wall time less the
    phases'."""
    metrics.reset()
    metrics.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs = prover_cuda.prove_batched(composers, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = metrics.snapshot()["spans"]
    finally:
        metrics.disable()
        metrics.reset()
    return proofs, wall, {name: spans[f"prove.phase{k}"]["device_ms"]
                          for k, name in enumerate(PROVER_PHASES, start=1)}


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
    t0 = time.perf_counter()
    first, counts = drive(lambda: prover_cuda.prove_batched(composers[:b], key))
    first_s = time.perf_counter() - t0
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
        f"== host plonk.prove field by field ({host_s:.3f} s a host proof; the first call, its "
        f"three graphs' capture included, {first_s:.2f} s), all verify; "
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
    return {"dev": dev, "composers": composers, "key": key, "host_s": host_s, "xs": xs,
            "proofs": first}


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
    prod_bytes = want
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
    zk_bytes = data
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
    # phase 7f proves the first DEVICE_BATCH again on the card: their bytes before the spoiling
    fast_bytes = [serialize.proof_to_bytes(p, vkf) for p in proofs[:DEVICE_BATCH]]
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
    aggregate_bytes = serialize.aggregate_to_bytes(agg_host, vk)  # phase 7g's expected bytes
    check(data == aggregate_bytes, "prove_aggregate: card bytes != native engine's")
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
    return {"times": times, "launches": launches, "pk": pk, "card": card, "c": c, "pool": pool,
            "keys": {"prod": (pk, vk), "zk": (pkz, vkz), "fast": (pkf, vkf)},
            "bytes": {"prod": prod_bytes, "zk": zk_bytes, "fast": fast_bytes,
                      "aggregate": aggregate_bytes},
            "pooled": (proofs, statements, expect)}


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


def _grind_windows(params, nonce: int) -> int:
    """The grinding windows the device provers search to find `nonce`."""
    if not params.pow_bits:
        return 0
    return nonce // max(4096, min(2 << params.pow_bits, 1 << 17)) + 1


def _fri_graph_launches(schema: dict) -> int:
    """The launches the FRI phase's graph holds: one challenge a fold and, a
    committed layer, its one sponge chunk, its levels and its root's absorb."""
    return schema["n_folds"] + sum(-(-bs // 4) + h + 1 for (_, bs), h in
                                   zip(schema["sched"], schema["layer_heights"]))


def device_proof_launches(vk, nonces: list) -> tuple:
    """The kernel launches of one fri_cuda.prove_succinct_device_batch under
    vk's parameters, for any B: (eager, in the FRI phase's graph). Eager:
    each leaf-sponge chunk and level of the w, z and t trees, and one a
    grinding window (as many windows as the largest nonce needed)."""
    schema = fri.proof_schema(vk.n, vk.params)
    widths = [2 * len(cols) for tree, cols in fri.tree_columns(vk.params.zk).items() if tree != "k"]
    eager = sum(-(-w // 4) + schema["h_pos"] for w in widths)
    return eager + _grind_windows(vk.params, max(nonces)), _fri_graph_launches(schema)


def device_aggregate_launches(vk, b: int, nonce: int) -> tuple:
    """The kernel launches of one fri_cuda.prove_aggregate_device of b
    instances under vk's parameters: (eager, in the FRI phase's graph).
    Eager: each leaf-sponge chunk and level of the w tree (blocks of 8b
    values: 2b chunks), the z tree (2b values) and the t tree (2b, zk
    2b + 2), and one a grinding window."""
    schema = fri.proof_schema(vk.n, vk.params)
    widths = [w for tree, w in aggregate.agg_tree_specs(vk.params.zk, b).items() if tree != "k"]
    eager = sum(-(-w // 4) + schema["h_pos"] for w in widths)
    return eager + _grind_windows(vk.params, nonce), _fri_graph_launches(schema)


def pooled_merkle_launches(vk, b: int | None = None) -> int:
    """The kernel launches of one pooled Merkle phase of the verifiers under
    vk's parameters, fused (one graph replay) or not (one launch a call):
    one a leaf-sponge chunk of every tree kind and FRI layer (gid), and one
    a level of the tallest tree, for any number of proofs. b: the instances
    of an aggregate, None for succinct proofs."""
    schema = fri.proof_schema(vk.n, vk.params)
    if b is None:
        widths = [2 * len(cols) for cols in fri.tree_columns(vk.params.zk).values()]
    else:
        widths = list(aggregate.agg_tree_specs(vk.params.zk, b).values())
    widths += [bs for _, bs in schema["sched"]]
    return sum(-(-w // 4) for w in widths) + max([schema["h_pos"], *schema["layer_heights"]])


def device_prover_phase(composers: list, succinct: dict) -> dict:
    """Phase 7f: the device-resident succinct prover
    (fri_cuda.prove_succinct_device[_batch]) on phase 7e's keys, held byte
    for byte to phase 7e's native-engine proofs, with exact launch counts:
    the eager ones by the wrappers' counts, the FRI phase's by its graph's
    replays times the launches the graph holds. Each shape's graph is
    captured before its runs, so the counts hold only what the proofs
    launched. Returns what phase 8 prints."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    c, pool = composers[0], succinct["pool"]
    pis = [g.pi for g in c.gates]
    launches, times = {s: 0 for s in perm_cuda.SCHEDULES}, {}

    def prepare(b, vk):
        schema = fri.proof_schema(vk.n, vk.params)
        t0 = time.perf_counter()
        graph = fri_cuda.fri_phase_graph(b, schema["m0"], schema["n_folds"], "opt", dev)
        torch.cuda.synchronize()
        return graph, time.perf_counter() - t0

    def counted(name, fn, vk, graph):
        """fn() with the counts at 0 just before it: (its proofs, wall s,
        peak device bytes); every opt launch as device_proof_launches says,
        none of another kernel."""
        replays = graph.replays

        def timed():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

        (proofs, wall, peak), counts = drive(timed)
        eager, in_graph = device_proof_launches(vk, [p.pow_nonce for p in proofs])
        only_opt = {s: 0 for s in perm_cuda.SCHEDULES}
        check(counts == {**only_opt, "opt": eager}, f"{name}: launches {counts}, {eager} opt expected")
        check(graph.replays == replays + 1 and graph.held == {**only_opt, "opt": in_graph},
              f"{name}: {graph.replays - replays} replays of a graph of {graph.held}, one of "
              f"{in_graph} opt expected")
        for s in perm_cuda.SCHEDULES:
            launches[s] += counts[s] + graph.held[s]
        log(f"[launches] {name}: opt {eager} eager + {in_graph} in one replay of the FRI phase's graph")
        return proofs, wall, peak

    # prod: the first instance at phase 7e's key, a warm-up run and SUCCINCT_REPS timed ones
    pk, vk = succinct["keys"]["prod"]
    graph, capture_s = prepare(1, vk)
    runs = []
    for rep in range(1 + SUCCINCT_REPS):
        (proof,), wall, peak = counted(f"prove_succinct_device prod, run {rep}",
                                       lambda: [fri_cuda.prove_succinct_device(c, pk)], vk, graph)
        check(serialize.proof_to_bytes(proof, vk) == succinct["bytes"]["prod"],
              f"prove_succinct_device prod, run {rep}: bytes != phase 7e's native engine's")
        check(fri.verify_succinct(vk, proof, pis, pool), f"prove_succinct_device prod, run {rep}: "
              "does not verify through hybp")
        runs.append((wall, peak))
    times["prod"] = runs[1:]
    log(f"[device prover] prod preset, {len(c.gates)} gates, n = {vk.n}: the FRI phase's graph captured in "
        f"{capture_s:.2f} s; {1 + SUCCINCT_REPS} proofs through prove_succinct_device == phase 7e's "
        "native-engine proof byte for byte, each verifies through hybp")

    # the graph's replay against the eager body on the same inputs
    rng = np.random.default_rng(SEED + 7)
    schema = fri.proof_schema(vk.n, vk.params)
    m0, n_folds = schema["m0"], schema["n_folds"]
    f0 = torch.from_numpy(random_elements((1, m0), rng)).to(dev)
    tr = torch.from_numpy(random_elements((1, WIDTH), rng)).to(dev)
    consts = fri_cuda._fri_phase_consts(m0, n_folds, dev)

    def eager():
        return fri_cuda._fri_phase_body(f0, tr, *consts, fri_cuda._perm_fn("opt"))

    got, want = flat_tensors(graph(f0, tr)), flat_tensors(eager())
    check(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)),
          "the FRI phase's graph replay != its eager body")
    log(f"[device prover] the FRI phase's graph (B = 1, m0 = {m0}, {n_folds} folds, "
        f"{graph.held['opt']} opt launches) replays the eager body's outputs bit for bit "
        f"({len(got)} tensors)")

    # zk with the seeded generator of phase 7e
    pkz, vkz = succinct["keys"]["zk"]
    graph_zk, _ = prepare(1, vkz)
    (proof,), wall, peak = counted("prove_succinct_device prod zk", lambda: [fri_cuda.prove_succinct_device(
        c, pkz, rng=np.random.default_rng(ZK_SEED))], vkz, graph_zk)
    check(serialize.proof_to_bytes(proof, vkz) == succinct["bytes"]["zk"],
          "prove_succinct_device zk: bytes != phase 7e's native engine's")
    check(fri.verify_succinct(vkz, proof, pis, pool), "prove_succinct_device zk: does not verify")
    times["zk"] = [(wall, peak)]
    log("[device prover] zk, phase 7e's seeded generator: == the native engine's bytes; verifies "
        "through hybp")

    # bench.py's fri mode: B = 8 at the fast preset, against phase 7e's pooled native proofs
    pkf, vkf = succinct["keys"]["fast"]
    cs = composers[:DEVICE_BATCH]
    graph_f, _ = prepare(DEVICE_BATCH, vkf)
    runs = []
    for rep in range(1 + SUCCINCT_REPS):
        proofs, wall, peak = counted(f"prove_succinct_device_batch B={DEVICE_BATCH} fast, run {rep}",
                                     lambda: fri_cuda.prove_succinct_device_batch(cs, pkf), vkf,
                                     graph_f)
        check([serialize.proof_to_bytes(p, vkf) for p in proofs] == succinct["bytes"]["fast"],
              f"prove_succinct_device_batch B={DEVICE_BATCH}, run {rep}: bytes != phase 7e's")
        runs.append((wall, peak))
    check(all(fri.verify_succinct_batched(vkf, proofs, [[g.pi for g in ci.gates] for ci in cs], pool)),
          f"prove_succinct_device_batch B={DEVICE_BATCH}: a proof does not verify through hybp")
    times["fast"] = runs[1:]
    log(f"[device prover] fast preset ({vkf.params}): B = {DEVICE_BATCH} through "
        f"prove_succinct_device_batch == the first {DEVICE_BATCH} of phase 7e's pooled native "
        f"proofs byte for byte, {1 + SUCCINCT_REPS} runs; all verify through hybp")

    # rejections
    other = Composer()
    a = other.append_witness(3)
    other.gate_mul(Constraint().mult(1).a(a).b(a))
    perm_cuda.reset_launches()
    try:
        fri_cuda.prove_succinct_device_batch([c, other], pk)
    except ValueError as e:
        check("circuit structure" in str(e), f"mixed circuits: unexpected refusal {e}")
    else:
        check(False, "prove_succinct_device_batch: composers of two circuits must be refused")
    check(not any(perm_cuda.launches.values()), "a refused batch must launch nothing")
    log("[device prover] composers of two circuits refused, nothing launched; phase 7f took "
        f"{time.perf_counter() - t_phase:.1f} s")

    xs = fri_cuda._on_device(fri_cuda._xs_digits, (m0,), dev)
    points = torch.from_numpy(random_elements((2,), rng)).to(dev)
    return {"times": times, "launches": launches, "graph": graph, "eager": eager,
            "f0": f0, "tr": tr, "capture_s": capture_s, "m0": m0,
            "invert": lambda: fri_cuda._inv_mont_dev(xs, points), "pk": pk, "c": c}


def device_prover_timings(ctx: dict, succinct: dict, smi: str) -> None:
    """Phase 8 for the device prover: seconds a prod proof beside phase 7e's
    host-orchestrated card wall and native wall, proofs/s at B = 8 fast, the
    FRI phase's graph replay beside its eager body, the inversion, and the
    peak device memory."""
    def med(runs):
        return sorted(runs)[len(runs) // 2]

    card_runs, host_runs = succinct["times"]["prove"]
    wall, peak = med(ctx["times"]["prod"])
    log(f"[time] prove_succinct_device prod (median of {SUCCINCT_REPS} after a warm-up): "
        f"{wall:.6f} s (walls {', '.join(f'{r[0]:.6f}' for r in ctx['times']['prod'])}), peak "
        f"device memory {peak / 2**30:.3f} GiB; phase 7e's prove_succinct through the card "
        f"{med(card_runs)[0]:.6f} s, through the native engine {statistics.median(host_runs):.6f} s "
        f"| {smi}")
    wall, peak = ctx["times"]["zk"][0]
    log(f"[time] prove_succinct_device prod zk (one run): {wall:.6f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB | {smi}")
    wall, peak = med(ctx["times"]["fast"])
    log(f"[time] prove_succinct_device_batch B={DEVICE_BATCH} fast (median of {SUCCINCT_REPS} after "
        f"a warm-up): {wall:.6f} s a batch = {DEVICE_BATCH / wall:.4f} proofs/s (walls "
        f"{', '.join(f'{r[0]:.6f}' for r in ctx['times']['fast'])}), peak device memory "
        f"{peak / 2**30:.3f} GiB | {smi}")
    graph = ctx["graph"]
    replay_ms = cuda_ms(lambda: graph(ctx["f0"], ctx["tr"]))
    eager_ms = cuda_ms(ctx["eager"])
    log(f"[time] the FRI phase, prod shape (B = 1, m0 = {ctx['m0']}, {graph.held['opt']} opt "
        f"launches): graph replay {replay_ms:.3f} ms, eager body {eager_ms:.3f} ms; captured in "
        f"{ctx['capture_s']:.3f} s | {smi}")
    log(f"[time] _inv_mont_dev over 2 x {ctx['m0']} points (Fermat an element, the DEEP "
        f"denominators of a prod proof): {cuda_ms(ctx['invert']):.3f} ms | {smi}")


def flat_tensors(out) -> list:
    """The tensors of a graph's or a body's output (nested lists and tuples), in order."""
    return [out] if isinstance(out, torch.Tensor) else [t for x in out for t in flat_tensors(x)]


def graph_replays() -> dict:
    """Every live graph (fri_cuda's and prover_cuda's) with its replay count."""
    return {g: g.replays for g in graphs._LIVE_GRAPHS}


def aggregate_verify_phase(composers: list, succinct: dict) -> dict:
    """Phase 7g: the device aggregate prover (fri_cuda.prove_aggregate_device)
    and the device verifiers (verify_aggregate_device,
    verify_succinct_device_batch fused and not, device_chain_fn), held byte
    for byte and verdict for verdict to the native engine, with exact launch
    counts: the wrappers' counts, and each graph's replays times the
    launches it holds. Every graph is captured before the runs that are
    counted. Returns what phase 8 prints."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    host = fri.default_pcs_perm()
    launches, times = {s: 0 for s in perm_cuda.SCHEDULES}, {}
    none = {s: 0 for s in perm_cuda.SCHEDULES}

    def counted(name, fn, schedule, expect):
        """fn() with the counts at 0 just before it: (its result, wall s, peak
        device bytes above what was allocated before it). expect(result) ->
        (eager, in graph replays): the wrappers' launches of `schedule`, and
        the replays' (held x replays summed over the graphs); no other
        kernel, no graph captured."""
        before = graph_replays()

        def timed():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

        (out, wall, peak), counts = drive(timed)
        after = graph_replays()
        check(set(after) <= set(before), f"{name}: a graph was captured inside the run")
        replayed = {s: sum((n - before[g]) * g.held[s] for g, n in after.items())
                    for s in perm_cuda.SCHEDULES}
        eager, in_graph = expect(out)
        check(counts == {**none, schedule: eager} and replayed == {**none, schedule: in_graph},
              f"{name}: launches {counts} and {replayed} in graph replays, {eager} and {in_graph} "
              f"{schedule} expected")
        for s in perm_cuda.SCHEDULES:
            launches[s] += counts[s] + replayed[s]
        log(f"[launches] {name}: {schedule} {eager} eager + {in_graph} in graph replays")
        return out, wall, peak

    def fri_graph(vk):  # the FRI phase's graph of an aggregate: one row
        schema = fri.proof_schema(vk.n, vk.params)
        return fri_cuda.fri_phase_graph(1, schema["m0"], schema["n_folds"], "opt", dev)

    def device_aggregates(name, cs, pk, vk, want, reps, rng_seed=None):
        """reps counted runs of prove_aggregate_device, each byte-identical
        to `want`; the shape's graphs (the FRI phase's, and the prover
        phases' at B = len(cs)) are captured before them by one run that is
        not counted."""
        fri_graph(vk)
        fri_cuda.prove_aggregate_device(cs, pk, None if rng_seed is None
                                        else np.random.default_rng(rng_seed))
        runs = []
        for rep in range(reps):
            agg, wall, peak = counted(
                f"{name}, run {rep}", lambda: fri_cuda.prove_aggregate_device(
                    cs, pk, None if rng_seed is None else np.random.default_rng(rng_seed)),
                "opt", lambda a: device_aggregate_launches(vk, len(cs), a.pow_nonce))
            check(serialize.aggregate_to_bytes(agg, vk) == want,
                  f"{name}, run {rep}: bytes != the native engine's")
            runs.append((wall, peak))
        return agg, runs

    def verified(name, vk, agg, pis, ok=True):
        """verify_aggregate_device through hybp: its graph captured by a
        first run, then a counted one."""
        fri_cuda.verify_aggregate_device(vk, agg, pis, schedule="hybp")
        got, wall, _ = counted(name, lambda: fri_cuda.verify_aggregate_device(
            vk, agg, pis, schedule="hybp"), "hybp",
            lambda _: (0, pooled_merkle_launches(vk, agg.n_instances) if ok else 0))
        check(bool(got) == ok, f"{name}: verdict {got}, {ok} expected")
        return wall

    # the aggregate of 4 at the prod preset: phase 7e's key and native bytes
    pk, vk = succinct["keys"]["prod"]
    cs = composers[:AGG_INSTANCES]
    agg, runs = device_aggregates(f"prove_aggregate_device {AGG_INSTANCES} prod", cs, pk, vk,
                                  succinct["bytes"]["aggregate"], 1 + SUCCINCT_REPS)
    times["prod"] = runs[1:]
    pis = [[g.pi for g in c.gates] for c in cs]
    times["verify prod"] = verified(f"verify_aggregate_device {AGG_INSTANCES} prod", vk, agg, pis)
    log(f"[device aggregate] prod preset, {AGG_INSTANCES} instances: {1 + SUCCINCT_REPS} runs of "
        "prove_aggregate_device == phase 7e's native-engine aggregate byte for byte; "
        "verify_aggregate_device through hybp accepts")

    # bench.py's aggregate mode: 8 instances at "fast", against the native engine here
    pkf, vkf = succinct["keys"]["fast"]
    cs = composers[:AGG_FAST_INSTANCES]
    pis = [[g.pi for g in c.gates] for c in cs]
    t0 = time.perf_counter()
    want = fast_bytes = serialize.aggregate_to_bytes(aggregate.prove_aggregate(cs, pkf, host), vkf)
    times["fast native"] = time.perf_counter() - t0
    agg, runs = device_aggregates(f"prove_aggregate_device {AGG_FAST_INSTANCES} fast", cs, pkf,
                                  vkf, want, 1 + SUCCINCT_REPS)
    times["fast"] = runs[1:]
    times["verify fast"] = verified(f"verify_aggregate_device {AGG_FAST_INSTANCES} fast", vkf,
                                    agg, pis)
    bad = serialize.aggregate_from_bytes(want, vkf)
    bad.evals[5]["t"] = (bad.evals[5]["t"] + 1) % P
    verified("verify_aggregate_device, a changed claimed evaluation", vkf, bad, pis, ok=False)
    # the same with zk, one seeded generator on each side
    pkz, vkz = fri.preprocess_succinct(composers[0], dataclasses.replace(SUCCINCT_FAST, zk=True), host)
    t0 = time.perf_counter()
    want = serialize.aggregate_to_bytes(aggregate.prove_aggregate(
        cs, pkz, host, rng=np.random.default_rng(ZK_SEED)), vkz)
    times["zk native"] = time.perf_counter() - t0
    agg, runs = device_aggregates(f"prove_aggregate_device {AGG_FAST_INSTANCES} fast zk", cs,
                                  pkz, vkz, want, 1, rng_seed=ZK_SEED)
    times["zk"] = runs
    verified(f"verify_aggregate_device {AGG_FAST_INSTANCES} fast zk", vkz, agg, pis)
    log(f"[device aggregate] bench.py's aggregate mode, {AGG_FAST_INSTANCES} instances at the fast "
        f"preset: {1 + SUCCINCT_REPS} runs == the native engine's aggregate byte for byte (native "
        f"{times['fast native']:.1f} s); zk with one seeded generator a side: == its bytes "
        f"(native {times['zk native']:.1f} s); verify_aggregate_device accepts each and refuses a "
        "changed claimed evaluation")

    # the FRI phase's graph of the fast aggregate (one row): replay == eager body
    schema = fri.proof_schema(vkf.n, vkf.params)
    rng = np.random.default_rng(SEED + 8)
    f0 = torch.from_numpy(random_elements((1, schema["m0"]), rng)).to(dev)
    tr = torch.from_numpy(random_elements((1, WIDTH), rng)).to(dev)
    consts = fri_cuda._fri_phase_consts(schema["m0"], schema["n_folds"], dev)
    got = fri_graph(vkf)(f0, tr)
    want = fri_cuda._fri_phase_body(f0, tr, *consts, fri_cuda._perm_fn("opt"))
    check(all(torch.equal(a, b) for a, b in zip(flat_tensors(got), flat_tensors(want), strict=True)),
          "the fast aggregate's FRI-phase graph replay != its eager body")

    # pooled verification of phase 7e's 16 fast proofs (two spoiled) through hybp
    proofs, statements, expect = succinct["pooled"]
    plans = []

    def spy(entries):  # the plan of the 16, for the graph's check against its body
        plans.append(fri_cuda._fused_verify_plan(entries, vkf.params.n_queries))
        return fri.pooled_entries_verify(entries, host)

    fri.verify_succinct_batched(vkf, proofs, statements, host, entries_check=spy)
    pooled = pooled_merkle_launches(vkf)
    for label, batch, pis, want in ((str(POOLED_PROOFS), proofs, statements, expect),
                                    ("1", proofs[:1], statements[:1], expect[:1])):
        fri_cuda.verify_succinct_device_batch(vkf, batch, pis, schedule="hybp")  # captures
        for fused in (True, False):
            runs = []
            for rep in range(SUCCINCT_REPS):
                got, wall, peak = counted(
                    f"verify_succinct_device_batch {label} fast, fused={fused}, run {rep}",
                    lambda: fri_cuda.verify_succinct_device_batch(vkf, batch, pis, fused,
                                                                  schedule="hybp"),
                    "hybp", lambda _: (0, pooled) if fused else (pooled, 0))
                check([bool(v) for v in got] == want,
                      f"verify_succinct_device_batch {label}: verdicts {list(got)} != {want}")
                runs.append((wall, peak))
            times[f"verify {label} fused={fused}"] = runs
    log(f"[device verify] phase 7e's {POOLED_PROOFS} fast proofs through hybp, fused (one graph "
        f"replay of {pooled} launches) and not ({pooled} launches), {SUCCINCT_REPS} runs each: "
        "false in the two spoiled slots only, == the native engine's; one proof alone: true")

    # the fused pool's graph: replay == eager body on the 16's plan
    plan = plans[0]
    flat_in, counts = fri_cuda._pool_tensors(plan)
    on_card = tuple(x.to(dev) for x in flat_in)
    pool_consts = fri_cuda._fused_pool_consts({b.shape[1] for b in plan[0]}, dev)

    def pool_eager():
        return fri_cuda._fused_pool_body(*fri_cuda._split(on_card, counts),
                                         fri_cuda._perm_fn("hybp"), *pool_consts)

    def pool_run():  # the plan's upload, one replay, the roots' clones
        return fri_cuda._fused_pool_run(plan, "hybp", dev)

    pool_graph = fri_cuda._pool_graph(flat_in, counts, "hybp", dev)

    def pool_replay():  # the inputs already on the card
        return pool_graph(*on_card)

    got, want = pool_run(), pool_eager()
    check(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
          and all(torch.equal(a, b) for a, b in zip(pool_replay(), want)),
          "the fused pool's graph replay != its eager body")

    # device_chain_fn on 2^10 openings of a tree over a prod proof's m0/2 positions
    rng = np.random.default_rng(SEED + 9)
    values = [int(v) for v in digits_to_ints(random_elements((CHAIN_LEAVES,), rng))]
    levels = fri.tree_build(values, host)
    root, height = fri.tree_root(levels), len(levels) - 1
    idx = sorted(int(i) for i in rng.choice(CHAIN_LEAVES, CHAIN_OPENINGS, replace=False))
    sibs, poss = fri.tree_open_batched(levels, idx)
    opened = [values[i] for i in idx]
    chain = functools.partial(fri_cuda.device_chain_fn, schedule="hybp")
    loop = fri.tree_verify_batched(root, opened, sibs, poss, height, idx, host)
    fri.tree_verify_batched(root, opened, sibs, poss, height, idx, host, chain)  # captures
    got, wall, _ = counted(f"device_chain_fn {CHAIN_OPENINGS} x height {height}",
                           lambda: fri.tree_verify_batched(root, opened, sibs, poss, height, idx,
                                                           host, chain),
                           "hybp", lambda _: (0, height))
    check(bool(loop.all()) and np.array_equal(got, loop), "device_chain_fn != the host loop")
    chain_case = (root, list(opened), sibs, poss, height, idx)  # phase 7h shards it
    bad_row = CHAIN_OPENINGS // 3
    opened[bad_row] = (opened[bad_row] + 1) % P
    bad, _, _ = counted("device_chain_fn, a changed value", lambda: fri.tree_verify_batched(
        root, opened, sibs, poss, height, idx, host, chain), "hybp", lambda _: (0, height))
    check(np.array_equal(bad, fri.tree_verify_batched(root, opened, sibs, poss, height, idx, host))
          and not bad[bad_row] and int(bad.sum()) == CHAIN_OPENINGS - 1,
          "device_chain_fn: a changed value must fail its own row and only it")
    node = ints_to_digits(opened, shape=(CHAIN_OPENINGS,))
    chain_eager = (torch.from_numpy(node.astype(np.int32)).to(dev),
                   torch.from_numpy(sibs.astype(np.int32)).to(dev),
                   torch.from_numpy(poss.astype(np.int64)).to(dev))
    graph = fri_cuda.chain_graph(CHAIN_OPENINGS, height, "hybp", dev)
    check(torch.equal(graph(*chain_eager), fri_cuda._chain_nodes_body(
        *chain_eager, fri_cuda._perm_fn("hybp"), fri_cuda._node_tag(dev))),
          "the chain's graph replay != its eager body")
    times["chain"] = wall
    log(f"[device verify] device_chain_fn over {CHAIN_OPENINGS} openings of a "
        f"{CHAIN_LEAVES}-leaf tree (height {height}) through hybp == the host loop of "
        "tree_verify_batched; a changed value fails its row only; the chain's, the fused "
        "pool's and the fast aggregate's FRI-phase graphs replay their eager bodies bit for bit")

    # rejections
    other = Composer()
    a = other.append_witness(3)
    other.gate_mul(Constraint().mult(1).a(a).b(a))
    perm_cuda.reset_launches()
    try:
        fri_cuda.prove_aggregate_device([composers[0], other], pk)
    except ValueError as e:
        check("circuit structure" in str(e), f"mixed circuits: unexpected refusal {e}")
    else:
        check(False, "prove_aggregate_device: composers of two circuits must be refused")
    check(not any(perm_cuda.launches.values()), "a refused aggregate must launch nothing")
    log("[device aggregate] composers of two circuits refused, nothing launched; phase 7g took "
        f"{time.perf_counter() - t_phase:.1f} s")
    # (c) where a verification of the 16 goes: transcript replay and checks,
    # the pooled Merkle phase, the fold algebra (fri.verify_succinct_batched's timings)
    for fused in (True, False):
        split = {}
        fri.verify_succinct_batched(
            vkf, proofs, statements, fri_cuda.device_pool_perm("hybp"),
            entries_check=fri_cuda.fused_entries_check(vkf, schedule="hybp") if fused else None,
            timings=split)
        times[f"split fused={fused}"] = split
    return {"times": times, "launches": launches, "pool": (pool_run, pool_replay, pool_eager),
            "prod": (composers[:AGG_INSTANCES], pk),
            "verify": lambda: fri_cuda.verify_succinct_device_batch(vkf, proofs, statements,
                                                                    schedule="hybp"),
            "fast aggregate": fast_bytes, "chain": chain_case}


def aggregate_verify_timings(ctx: dict, succinct: dict, smi: str) -> None:
    """Phase 8 for phase 7g: seconds a device aggregate beside phase 7e's
    host-orchestrated card wall and the native engine's, seconds a
    verification fused and not beside phase 7e's pooled path with its split,
    the fused pool's graph replay beside its eager body, and the peak device
    memory of each run above what was allocated before it."""
    def med(runs):
        return sorted(runs)[len(runs) // 2]

    def walls(runs):
        return ", ".join(f"{r[0]:.6f}" for r in runs)

    def gib(peak):
        return f"peak device memory {peak / 2**30:.3f} GiB above what was allocated before the run"

    t = ctx["times"]
    card_runs, host_runs = succinct["times"]["aggregate"]
    wall, peak = med(t["prod"])
    log(f"[time] prove_aggregate_device {AGG_INSTANCES} prod (median of {SUCCINCT_REPS} after a "
        f"warm-up): {wall:.6f} s (walls {walls(t['prod'])}), {gib(peak)}; phase 7e's "
        f"prove_aggregate through the card {card_runs[0][0]:.6f} s, through the native engine "
        f"{host_runs[0]:.6f} s | {smi}")
    wall, peak = med(t["fast"])
    log(f"[time] prove_aggregate_device {AGG_FAST_INSTANCES} fast (median of {SUCCINCT_REPS} after "
        f"a warm-up): {wall:.6f} s = {AGG_FAST_INSTANCES / wall:.4f} instances/s (walls "
        f"{walls(t['fast'])}), {gib(peak)}; the native engine's prove_aggregate "
        f"{t['fast native']:.6f} s | {smi}")
    wall, peak = t["zk"][0]
    log(f"[time] prove_aggregate_device {AGG_FAST_INSTANCES} fast zk (one run): {wall:.6f} s, "
        f"{gib(peak)}; the native engine's {t['zk native']:.6f} s | {smi}")
    log(f"[time] verify_aggregate_device (fused, hybp, one run): {AGG_INSTANCES} prod "
        f"{t['verify prod']:.6f} s, {AGG_FAST_INSTANCES} fast {t['verify fast']:.6f} s | {smi}")
    card_runs, host_runs = succinct["times"]["verify"]
    for label in (str(POOLED_PROOFS), "1"):
        for fused in (True, False):
            runs = t[f"verify {label} fused={fused}"]
            wall, peak = med(runs)
            log(f"[time] verify_succinct_device_batch {label} fast, fused={fused} (median of "
                f"{SUCCINCT_REPS}): {wall:.6f} s (walls {walls(runs)}), {gib(peak)}; phase 7e's "
                f"pooled verification of {POOLED_PROOFS} through the card "
                f"{med(card_runs)[0]:.6f} s, native {statistics.median(host_runs):.6f} s | {smi}")
    for fused in (True, False):
        split = ", ".join(f"{k} {v:.6f} s" for k, v in t[f"split fused={fused}"].items())
        log(f"[time] verify_succinct_batched {POOLED_PROOFS} fast through hybp, fused={fused}, one "
            f"run: {split} | {smi}")
    run, replay, eager = ctx["pool"]
    held = pooled_merkle_launches(succinct["keys"]["fast"][1])
    log(f"[time] the fused pool of {POOLED_PROOFS} fast proofs (hybp, {held} launches): graph "
        f"replay {cuda_ms(replay):.3f} ms, with the plan's upload and the roots' clones "
        f"{cuda_ms(run):.3f} ms; eager body {cuda_ms(eager):.3f} ms; device_chain_fn "
        f"{CHAIN_OPENINGS} openings (the host's checks included) {t['chain']:.6f} s | {smi}")


def host_walls(fn, reps: int = REPS) -> list:
    """Seconds of reps calls of fn() by the host clock, each ending in a
    synchronisation of the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def sharded_rank(rank: int, world: int, coord: str, backend: str, leaves: np.ndarray,
                 prove: bool) -> dict:
    """One spawned rank of phase 7h (multihost.spawn): joins a group of
    `world` over `backend` (gloo: every rank on cuda:0; nccl: rank r on
    cuda:r), builds the sharded tree over `leaves` with its launches and
    collective bytes counted, times it, and with `prove` runs
    prove_batched(mesh=) over phase 7d's first PLONK_BATCHES[0] instances.
    Returns what it found."""
    multihost.initialize(coord, world, rank, backend=backend, timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = multihost.global_mesh(device=torch.device("cuda", 0 if backend == "gloo" else rank))
        x = torch.from_numpy(leaves).to(mesh.device)
        metrics.reset()
        metrics.enable()
        root, counts = drive(lambda: dist.merkle_root_sharded(x, mesh))
        metrics.disable()
        res = {"root": root.cpu().numpy(), "launches": counts,
               "collective_bytes": metrics.snapshot()["counters"]["dist.collective_bytes"],
               "walls": host_walls(lambda: dist.merkle_root_sharded(x, mesh))}
        if prove:
            composers = preimage_instances(PLONK_BATCHES[0], PLONK_SEED)
            key = plonk.preprocess(composers[0])
            proofs, n = drive(lambda: prover_cuda.prove_batched(composers, key, mesh=mesh))
            res["proofs"] = [(p.wires, p.z, p.t, p.commitments) for p in proofs]
            res["launches"] = {s: counts[s] + n[s] for s in perm_cuda.SCHEDULES}
        return res
    finally:
        tdist.destroy_process_group()


def sharded_phase(inputs: dict, prover: dict, succinct: dict, agg_verify: dict) -> dict:
    """Phase 7h: the sharded paths (parallel/dist.py, the provers' and
    verifiers' mesh) on the card. A world-1 NCCL group in this process
    drives each path at full width against phases 5-7g's outputs, each
    with its launches counted; two ranks spawned on cuda:0 over gloo build
    the 2^20-leaf tree and prove B = 16; on a host with two or more cards,
    two or four NCCL ranks with one card each build the tree for BASELINE
    config 5's scaling efficiency. Returns what phase 8 prints."""
    t_phase = time.perf_counter()
    launches, times = {s: 0 for s in perm_cuda.SCHEDULES}, {}
    leaves, root = inputs["leaves"], inputs["root"]

    def counted(name, fn, want):
        """fn() with the counts at 0 just before it: the wrappers' launches
        and the graph replays' (held x replays) must equal want ({schedule:
        launches}, or a function of fn's result giving it); no graph may be
        captured inside it."""
        before = graph_replays()
        out, counts = drive(fn)
        after = graph_replays()
        check(set(after) <= set(before), f"{name}: a graph was captured inside the run")
        total = {s: counts[s] + sum((n - before[g]) * g.held[s] for g, n in after.items())
                 for s in perm_cuda.SCHEDULES}
        want = want(out) if callable(want) else want
        want = {s: want.get(s, 0) for s in perm_cuda.SCHEDULES}
        check(total == want, f"{name}: launches {total} != {want}")
        for s in perm_cuda.SCHEDULES:
            launches[s] += total[s]
        log(f"[launches] {name}: {total}")
        return out

    levels = merkle.tree_levels(MERKLE_LEAVES)
    chunks = 1 + CIPHER_LEN // cipher.RATE
    states = torch.from_numpy(random_elements((PERM_BATCH, WIDTH), np.random.default_rng(SEED + 10)))
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="nccl",
                         timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = multihost.global_mesh()
        check(mesh.device.type == "cuda" and mesh.shape == {dist.AXIS: 1},
              f"the world-1 NCCL mesh: {mesh}")
        metrics.reset()
        metrics.enable()
        got = counted("merkle_root_sharded 2^20 (opt), 1 rank",
                      lambda: dist.merkle_root_sharded(leaves, mesh), {"opt": levels})
        metrics.disable()
        check(torch.equal(got, root), "merkle_root_sharded over NCCL != phase 5's root")
        counters = metrics.snapshot()["counters"]
        check(counters == {"dist.merkle_builds": 1, "perms.executed": (MERKLE_LEAVES - 1) // 3,
                           "dist.collective_bytes": 0}, f"sharded build's counters {counters}")
        x = states.to(mesh.device)
        got = counted(f"permute_sharded {PERM_BATCH} (opt)", lambda: dist.permute_sharded(x, mesh),
                      {"opt": 1})
        check(torch.equal(got, perm_cuda.permute_cuda(x)), "permute_sharded != permute_cuda")
        got = counted(f"sponge_hash_sharded {SPONGE_STREAMS} x {SPONGE_LEN} (opt)",
                      lambda: dist.sponge_hash_sharded(inputs["msgs"], mesh),
                      {"opt": SPONGE_LEN // sponge.RATE})
        check(torch.equal(got, inputs["digests"]), "sponge_hash_sharded != phase 6's digests")
        got = counted(f"cipher_sharded {CIPHER_STREAMS} x {CIPHER_LEN} (opt)",
                      lambda: dist.cipher_sharded(*inputs["cipher"], mesh), {"opt": chunks})
        check(all(torch.equal(a, b) for a, b in zip(got, inputs["ciphertext"], strict=True)),
              "cipher_sharded != phase 7's ciphertexts and tags")

        composers, key = prover["composers"][:PLONK_BATCHES[0]], prover["key"]
        proofs = counted(f"prove_batched B={PLONK_BATCHES[0]}, mesh of 1",
                         lambda: prover_cuda.prove_batched(composers, key, mesh=mesh), {})
        check(len(proofs) == len(prover["proofs"])
              and all(same_proof(a, b) for a, b in zip(proofs, prover["proofs"])),
              "prove_batched(mesh=) != phase 7d's proofs")

        pkf, vkf = succinct["keys"]["fast"]
        schema = fri.proof_schema(vkf.n, vkf.params)
        cs = composers[:DEVICE_BATCH]
        fri_cuda.fri_phase_graph(DEVICE_BATCH, schema["m0"], schema["n_folds"], "opt", mesh.device)
        fri_cuda.fri_phase_graph(1, schema["m0"], schema["n_folds"], "opt", mesh.device)
        proofs = counted(f"prove_succinct_device_batch B={DEVICE_BATCH} fast, mesh of 1",
                         lambda: fri_cuda.prove_succinct_device_batch(cs, pkf, mesh=mesh),
                         lambda out: {"opt": sum(device_proof_launches(
                             vkf, [p.pow_nonce for p in out]))})
        check([serialize.proof_to_bytes(p, vkf) for p in proofs] == succinct["bytes"]["fast"],
              "prove_succinct_device_batch(mesh=) != phase 7f's bytes")
        cs = composers[:AGG_FAST_INSTANCES]
        agg = counted(f"prove_aggregate_device {AGG_FAST_INSTANCES} fast, mesh of 1",
                      lambda: fri_cuda.prove_aggregate_device(cs, pkf, mesh=mesh),
                      lambda out: {"opt": sum(device_aggregate_launches(vkf, len(cs),
                                                                        out.pow_nonce))})
        check(serialize.aggregate_to_bytes(agg, vkf) == agg_verify["fast aggregate"],
              "prove_aggregate_device(mesh=) != phase 7g's bytes")

        proofs_16, statements, expect = succinct["pooled"]
        fri_cuda.verify_succinct_device_batch(vkf, proofs_16, statements, schedule="hybp",
                                              mesh=mesh)  # its graph, if it was let go
        got = counted(f"verify_succinct_device_batch {POOLED_PROOFS} fast, mesh of 1 (hybp)",
                      lambda: fri_cuda.verify_succinct_device_batch(
                          vkf, proofs_16, statements, schedule="hybp", mesh=mesh),
                      {"hybp": pooled_merkle_launches(vkf)})
        check([bool(v) for v in got] == expect, f"verify_succinct_device_batch(mesh=): {list(got)}")
        croot, opened, sibs, poss, height, idx = agg_verify["chain"]
        host = fri.default_pcs_perm()
        node = ints_to_digits(opened, shape=(len(opened),))
        chain = fri_cuda.mesh_chain_fn(mesh, schedule="hybp")
        got = counted(f"mesh_chain_fn {CHAIN_OPENINGS} x height {height} (hybp)",
                      lambda: chain(node, sibs, poss), {"hybp": height})
        check(got.dtype == np.uint32 and np.array_equal(
            got, fri_cuda.device_chain_fn(node, sibs, poss, schedule="hybp")),
              "mesh_chain_fn's digests != device_chain_fn's")
        verdicts = fri.tree_verify_batched(croot, opened, sibs, poss, height, idx, host, chain)
        check(bool(verdicts.all()), "tree_verify_batched through mesh_chain_fn rejected an opening")
        log(f"[sharded] a world-1 NCCL group: merkle_root_sharded over 2^20 leaves == phase 5's "
            f"root (counters {counters}); permute_sharded {PERM_BATCH} == permute_cuda; the "
            f"sponge and the cipher == phases 6 and 7; prove_batched B={PLONK_BATCHES[0]} == phase "
            f"7d's proofs; prove_succinct_device_batch B={DEVICE_BATCH} and prove_aggregate_device "
            f"{AGG_FAST_INSTANCES} fast == phases 7f's and 7g's bytes; verify_succinct_device_batch "
            f"of {POOLED_PROOFS} == phase 7e's verdicts; mesh_chain_fn over {CHAIN_OPENINGS} "
            "openings == device_chain_fn, and tree_verify_batched through it accepts")
        times["tree 1"] = host_walls(lambda: dist.merkle_root_sharded(leaves, mesh))
        times["tree"] = host_walls(lambda: merkle.merkle_root(leaves))
    finally:
        tdist.destroy_process_group()

    leaves_np = leaves.cpu().numpy()
    ranks = multihost.spawn(sharded_rank, GLOO_RANKS, "gloo", leaves_np, True, wall_s=RANKS_WALL_S)
    for r, res in enumerate(ranks):
        check(np.array_equal(res["root"], root.cpu().numpy()),
              f"gloo rank {r}: the sharded root != phase 5's")
        check(res["proofs"] == [(p.wires, p.z, p.t, p.commitments) for p in prover["proofs"]],
              f"gloo rank {r}: prove_batched(mesh=) != phase 7d's proofs")
        check(res["launches"] == {**{s: 0 for s in perm_cuda.SCHEDULES}, "opt": levels},
              f"gloo rank {r}: launches {res['launches']}")
        for s in perm_cuda.SCHEDULES:
            launches[s] += res["launches"][s]
    times["gloo"] = [res["walls"] for res in ranks]
    times["gloo bytes"] = ranks[0]["collective_bytes"]
    log(f"[sharded] {GLOO_RANKS} ranks spawned on cuda:0 over gloo: each rank's root == phase "
        f"5's, its {PLONK_BATCHES[0]} proofs == phase 7d's; launches {ranks[0]['launches']} a "
        f"rank; dist.collective_bytes {times['gloo bytes']} a rank")

    cards = torch.cuda.device_count()
    if cards >= 2:
        world = 1 << (min(cards, MAX_CARDS).bit_length() - 1)  # the tree's leaves divide by it
        ranks = multihost.spawn(sharded_rank, world, "nccl", leaves_np, False, wall_s=RANKS_WALL_S)
        check(all(np.array_equal(res["root"], root.cpu().numpy()) for res in ranks),
              f"nccl ranks of {world}: a root != phase 5's")
        times["cards"] = (world, [res["walls"] for res in ranks])
        log(f"[sharded] {world} NCCL ranks on {world} cards: every root == phase 5's")
    else:
        log("[sharded] one card on this host: BASELINE config 5 (the tree's scaling efficiency "
            "from 1 to N cards) stays unmeasured")
    log(f"[sharded] phase 7h took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "times": times}


def sharded_timings(ctx: dict, smi: str) -> None:
    """Phase 8 for phase 7h: the sharded tree's wall on one NCCL rank beside
    merkle_root's, on two gloo ranks on one card, and on N cards with the
    scaling efficiency where the host has them (host clock, median of 5
    after a warm-up)."""
    t = ctx["times"]

    def walls(runs):
        return ", ".join(f"{w:.6f}" for w in runs)

    one, plain = statistics.median(t["tree 1"]), statistics.median(t["tree"])
    log(f"[time] merkle_root_sharded 2^20 leaves (opt), 1 NCCL rank: {one:.6f} s (walls "
        f"{walls(t['tree 1'])}); merkle_root {plain:.6f} s (walls {walls(t['tree'])}); "
        f"dist.collective_bytes 0 | {smi}")
    gloo = [statistics.median(w) for w in t["gloo"]]
    log(f"[time] merkle_root_sharded 2^20 leaves (opt), {GLOO_RANKS} gloo ranks on one card: "
        f"{max(gloo):.6f} s, the slower rank's median (ranks' walls "
        f"{'; '.join(walls(w) for w in t['gloo'])}); dist.collective_bytes {t['gloo bytes']} a "
        f"rank | {smi}")
    if "cards" in t:
        world, runs = t["cards"]
        t_n = max(statistics.median(w) for w in runs)
        log(f"[time] merkle_root_sharded 2^20 leaves (opt), {world} NCCL ranks on {world} cards: "
            f"{t_n:.6f} s; BASELINE config 5's scaling efficiency {one / (world * t_n):.4f} "
            f"(1 rank {one:.6f} s) | {smi}")


def prover_graphs_against_bodies(prover: dict) -> dict:
    """Phase 7i (a): one prove_batched at phase 7d's B on the card; each
    phase's graph then still holds the arguments of its replay in its
    input buffers, and two more replays on them are held bit for bit
    against the eager body on the same arguments (the graphs of one shape
    share a memory pool, so a phase's static outputs do not outlive the
    next phase's replay: the prover clones them at once). Returns each
    phase's graph."""
    b, key = PLONK_BATCHES[0], prover["key"]
    proofs, counts = drive(lambda: prover_cuda.prove_batched(prover["composers"][:b], key))
    check(not any(counts.values()), f"prove_batched B={b}: launches {counts}, none expected")
    check(all(same_proof(a, c) for a, c in zip(proofs, prover["proofs"], strict=True)),
          f"prove_batched B={b} through the graphs != phase 7d's proofs")
    (group,) = [g for (gb, n, _), (_, g) in prover_cuda._PHASE_GRAPHS.items()
                if (gb, n) == (b, key.n)]
    check(sorted(phase for phase, _, _ in group) == [0, 1, 2],
          f"prove_batched B={b}: graphs of phases {[phase for phase, _, _ in group]}")
    found, shapes = {}, []
    for (i, layout, _), graph in sorted(group.items(), key=lambda kv: kv[0][0]):
        name = PROVER_PHASES[i]
        args = tuple(x.clone() for x in graph._inputs)  # its replay's arguments
        want = prover_cuda._PHASES[i](*prover_cuda._unflatten(args, layout))
        got, again = graph(*args), graph(*args)
        check(torch.equal(got, want) and torch.equal(again, want),
              f"{name}'s graph replay != its eager body at B={b}")
        check(graph.held == {s: 0 for s in perm_cuda.SCHEDULES}, f"{name}'s graph holds {graph.held}")
        found[name] = graph
        shapes.append(f"{name} {tuple(got.shape)}")
    log(f"[graphs] prove_batched B={b} through one graph a phase == phase 7d's proofs; each "
        f"phase's replay == its eager body bit for bit ({', '.join(shapes)})")
    for (gb, n, device), (_, graphs_) in prover_cuda._PHASE_GRAPHS.items():
        for (phase, _, shapes_), graph in graphs_.items():
            log(f"[graphs] prover phase {phase + 1} (B = {gb}, n = {n}, {device}, "
                f"{len(shapes_)} inputs): {graph.replays} replays")
    return found


def example_run(module: str, *args: str, timeout_s: float) -> tuple:
    """python -m <module> <args> in a subprocess from the checkout's root,
    within timeout_s: (its standard output, wall seconds); it must exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                          timeout=timeout_s, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{module}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout, wall


def last_slice_phase(prover: dict) -> dict:
    """Phase 7i: (a) the prover's phase graphs against their eager bodies;
    (b) entry.entry(): the KAT gate for the default kernel, then its fn on
    its args against the plain version; (c) entry.dryrun_multichip on one
    NCCL rank and on two gloo ranks sharing cuda:0, each rank's launches
    as predicted; (d) both examples as subprocesses on the card. Returns
    the launches of (b) and (c)."""
    t_phase = time.perf_counter()
    prover_graphs_against_bodies(prover)

    (out, x), counts = drive(lambda: (lambda fn, args: (fn(*args), args[0]))(*entry_points.entry()))
    want = {**{s: 0 for s in perm_cuda.SCHEDULES}, perm_cuda.DEFAULT_SCHEDULE: 2}
    check(counts == want, f"entry(): launches {counts} != {want} (the KAT gate's and fn's)")
    check(x.shape == (WIDTH, 16, 1024) and x.device.type == "cuda"
          and torch.equal(out, perm_cuda.permute_planar_plain(x)),
          "entry(): fn(*args) != the plain version")
    launches = dict(counts)
    log(f"[entry] entry(): KAT gate ({perm_cuda.DEFAULT_SCHEDULE}, canonical, "
        f"{selftest.BENCH_LANES} lanes) passed; fn(*args) on {tuple(x.shape)} == "
        f"permute_planar_plain; launches {counts}")

    def dry_launches(world: int) -> dict:
        """A rank's launches: the sharded and the one-device permutation,
        sponge (one chunk each) and cipher (two: the init and one chunk),
        and the sharded tree's levels (the one-device references of the
        cipher and the tree are the native engine's)."""
        n_tree = 1 << (world.bit_length() - 1)
        return {**{s: 0 for s in perm_cuda.SCHEDULES},
                "opt": 2 + 2 + 2 + merkle.tree_levels(4 * n_tree)}

    walls = {}
    for world, backend, device in ((1, "nccl", None), (GLOO_RANKS, "gloo", torch.device("cuda", 0))):
        t0 = time.perf_counter()
        ranks = entry_points.dryrun_multichip(world, backend=backend, device=device)
        walls[f"dry run {backend} {world}"] = time.perf_counter() - t0
        check(len(ranks) == world and all(r == dry_launches(world) for r in ranks),
              f"dryrun_multichip({world}, {backend}): launches {ranks} != {dry_launches(world)} a rank")
        for r in ranks:
            for s in perm_cuda.SCHEDULES:
                launches[s] += r[s]
        log(f"[entry] dryrun_multichip({world}, backend={backend!r}): every sharded path == its "
            f"one-device value on every rank; launches {ranks[0]} a rank; "
            f"{walls[f'dry run {backend} {world}']:.1f} s")

    text, walls["quickstart"] = example_run("hades252_tpu_torch.examples.quickstart",
                                            timeout_s=EXAMPLE_WALL_S)
    verdicts = [ln for ln in text.splitlines() if "True" in ln or "False" in ln]
    check(QUICKSTART_PERM in text.splitlines() and len(verdicts) == QUICKSTART_VERDICTS
          and not any("False" in ln for ln in verdicts),
          f"quickstart on the card: verdicts\n{text}")
    text, walls["multichip_merkle"] = example_run("hades252_tpu_torch.examples.multichip_merkle",
                                                  timeout_s=EXAMPLE_WALL_S)
    lines = text.splitlines()
    cards = torch.cuda.device_count()
    check(f"256 leaves over {cards} devices: roots match" in lines
          and "checkpoint/resume: roots match" in lines, f"multichip_merkle: output\n{text}")
    log(f"[examples] quickstart on the card: {len(verdicts)} verdict lines, all True, "
        f"{QUICKSTART_PERM!r}; {walls['quickstart']:.1f} s | multichip_merkle, one NCCL rank a card "
        f"({cards}): roots match, checkpoint/resume match; {walls['multichip_merkle']:.1f} s")
    log(f"[entry] phase 7i took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "walls": walls}


def profile_path(name: str, fn, log_dir: str) -> None:
    """Trace one warm call of fn with utils/profiling.trace, which writes
    the Chrome trace to log_dir/trace.json, and print where its device time
    went: the span from the first device operation's start to the last
    one's end, the busy time (the union of the operations' intervals), the
    idle share of the span, the permutation kernels and the rest (the
    plain-torch glue), and the host's launch calls (kernels and graphs)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profiling.trace(log_dir) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    # the host's launch calls: a graph replay is one cudaGraphLaunch for all its kernels
    calls = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    host_kernels = sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for n in calls)
    host_graphs = sum(n.startswith("cudaGraphLaunch") for n in calls)
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
        f"launches, plain-torch glue {sum(glue) / 1e3:.3f} ms in {len(glue)} launches; host "
        f"launch calls: {host_kernels} kernels, {host_graphs} graphs; trace {log_dir}/trace.json")


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
    t_run = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[run] {what} done at {time.perf_counter() - t_run:.1f} s")
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
    selftest.assert_device_correct(device=dev)
    log(f"[kat] {', '.join(perm_cuda.SCHEDULES)} x canonical, Montgomery on "
        f"{selftest.BENCH_LANES} lanes: bit-identical to the int oracle (SURVEY KATs included)")

    # 4. kernel vs plain. The plain versions are bound by their launches
    # (one small operation after another: about a second a call at 2^14
    # states), and states are independent, so they run over slices of
    # PLAIN_SLICE states and each plain call covers several of a kernel's
    # batches at once: the kernel runs at each batch's own size and its
    # outputs are held against the slices of one plain run over their
    # concatenation
    max_err = {s: 0 for s in perm_cuda.SCHEDULES}
    torch.cuda.reset_peak_memory_stats()

    def hold(schedule: str, convert: bool, runs: list) -> None:
        """runs: [(planar input, the kernel's output on it)], held against one
        plain run of `schedule` over the inputs side by side."""
        want = plain_planar(torch.cat([x for x, _ in runs], dim=2), convert=convert,
                            schedule=schedule)
        lo = 0
        for x, got in runs:
            b = x.shape[2]
            err = int((got.long() - want[:, :, lo : lo + b].long()).abs().max())
            max_err[schedule] = max(max_err[schedule], err)
            check(err == 0, f"{schedule} kernel != plain at B={b}, convert={convert}")
            lo += b

    def planar(b: int) -> torch.Tensor:
        return torch.from_numpy(random_elements((WIDTH, b), rng).transpose(0, 2, 1).copy()).to(dev)

    # the sponge's, cipher's and openings' batch, every kernel, both paths
    x = planar(PERM_BATCH)
    for schedule in perm_cuda.SCHEDULES:
        for convert in (True, False):
            hold(schedule, convert,
                 [(x, perm_cuda.permute_planar(x, convert=convert, schedule=schedule))])
    log(f"[plain] {', '.join(perm_cuda.SCHEDULES)} kernels == plain versions at B = {PERM_BATCH}, "
        "convert in (True, False)")

    # the first Merkle level's batch on the Montgomery path the models use
    # (every kernel but hybp, which covers it through its own 2^20-leaf tree
    # in phase 5), each kernel's whole output
    b = MERKLE_LEAVES // merkle.ARITY
    x, level = planar(b), ("naive", "opt", "mxu8", "mxu", "hyb", "hyb13", "hybp13")
    for schedule in level:
        hold(schedule, False, [(x, perm_cuda.permute_planar(x, convert=False, schedule=schedule))])
    log(f"[plain] {', '.join(level)} kernels == plain versions at B = {b}, convert=False")

    # 4096, a ragged 1000 (the tail mask), and the ragged edges of every
    # kernel; opt against the native engine's sparse schedule there (the
    # second, independent reference)
    edges = [planar(4096), planar(1000)]
    t0 = time.perf_counter()
    native._lib()  # raises NativeUnavailable where it cannot be built
    native_s = time.perf_counter() - t0
    for b in RAGGED:
        states = random_elements((b, WIDTH), rng)
        x = torch.from_numpy(states.transpose(1, 2, 0).copy()).to(dev)
        edges.append(x)
        got = perm_cuda.permute_planar(x, schedule="opt").permute(2, 0, 1).cpu().numpy()
        check(np.array_equal(native.perm_batch_digits(states), got),
              f"opt kernel != native engine at B={b}")
    for schedule in perm_cuda.SCHEDULES:
        for convert in (True, False):
            hold(schedule, convert,
                 [(x, perm_cuda.permute_planar(x, convert=convert, schedule=schedule))
                  for x in edges])
    log(f"[plain] {', '.join(perm_cuda.SCHEDULES)} kernels == plain versions at B = 4096, 1000 "
        f"and {RAGGED}, both convert values; opt kernel == native engine at B in {RAGGED}")

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
    log(f"[plain] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(plain slices of {PLAIN_SLICE} states)")
    torch.cuda.empty_cache()
    mark("phase 4")

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
    mark("phase 7c")

    # 7d. the batched prover and the NTT on the card
    prover = prover_phase(dev, rng)
    log(f"[memory] after phase 7d: max_memory_reserved {torch.cuda.max_memory_reserved() / 2**30:.3f} "
        f"GiB (the prover's graph pools included) | {smi}")
    mark("phase 7d")

    # 7e. the succinct and aggregated argument on the kernels
    succinct = succinct_phase(prover["composers"])
    for s, n in succinct["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7e, summed: {main_launches}")
    mark("phase 7e")

    # 7f. the device-resident succinct prover
    device = device_prover_phase(prover["composers"], succinct)
    for s, n in device["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7f, summed: {main_launches}")
    mark("phase 7f")

    # 7g. the device aggregate prover and the device verifiers
    agg_verify = aggregate_verify_phase(prover["composers"], succinct)
    for s, n in agg_verify["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7g, summed: {main_launches}")
    log(f"[memory] after phase 7g: max_memory_reserved {torch.cuda.max_memory_reserved() / 2**30:.3f} "
        f"GiB | {smi}")
    mark("phase 7g")

    # 7h. the sharded paths
    sharded = sharded_phase(
        {"leaves": leaves, "root": root, "msgs": msgs, "digests": results["sponge (opt)"],
         "cipher": (keys, nonces, plaintext), "ciphertext": results["cipher (opt)"]},
        prover, succinct, agg_verify)
    for s, n in sharded["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7h, summed: {main_launches}")
    mark("phase 7h")

    # 7i. the prover's graphs against their bodies, the entry points, the examples
    last = last_slice_phase(prover)
    for s, n in last["launches"].items():
        main_launches[s] += n
    log(f"[launches] main path with phase 7i, summed: {main_launches}")
    mark("phase 7i")

    # 8. timings at the main path's shapes
    x = torch.from_numpy(random_elements((WIDTH, PERM_BATCH), rng).transpose(0, 2, 1).copy()).to(dev)
    ms, plain_ms, bounds = {}, {}, {}
    for schedule in perm_cuda.SCHEDULES:
        ms[schedule] = cuda_ms(lambda: perm_cuda.permute_planar(x, schedule=schedule))
        plain_ms[schedule] = cuda_ms(
            lambda: perm_cuda.permute_planar_plain(x, schedule=schedule))
        bounds[schedule] = rf = roofline.roofline(schedule, PERM_BATCH, ms[schedule])
        log(f"[time] {schedule}: kernel {ms[schedule]:.4f} ms = "
            f"{PERM_BATCH / ms[schedule] * 1e3:,.0f} perms/s; plain {plain_ms[schedule]:.1f} ms "
            f"= {PERM_BATCH / plain_ms[schedule] * 1e3:,.0f} perms/s; bound {rf['bound_ms']:.4f} "
            f"ms by {rf['bound_by']} ({rf['binding_resource']}: tensor {rf['tensor_ms']:.4f}, "
            f"cores {rf['cores_ms']:.4f}, bytes {rf['bytes_ms']:.4f} ms), "
            f"{rf['achieved_fraction']:.3f} of the time; B={PERM_BATCH} | {smi}")
    for b in TIMED_SIZES:
        xb = torch.from_numpy(random_elements((WIDTH, b), rng).transpose(0, 2, 1).copy()).to(dev)
        for schedule in perm_cuda.SCHEDULES:
            t = cuda_ms(lambda: perm_cuda.permute_planar(xb, schedule=schedule))
            rf = roofline.roofline(schedule, b, t)
            log(f"[time] {schedule}: kernel {t:.4f} ms = {b / t * 1e3:,.0f} perms/s, "
                f"{t / b * PERM_BATCH:.4f} ms a 2^14; bound {rf['bound_ms']:.4f} ms by "
                f"{rf['binding_resource']} ({rf['achieved_fraction']:.3f} of the time); B={b} "
                f"| {smi}")
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
    mark("phase 8's kernels, trees, sponge and cipher")

    prover_timings(prover, smi)
    succinct_timings(succinct, smi)
    device_prover_timings(device, succinct, smi)
    aggregate_verify_timings(agg_verify, succinct, smi)
    sharded_timings(sharded, smi)
    mark("phase 8")

    # 9. on request: where the openings' paths spend their device time
    if "--profile" in sys.argv[1:]:
        traced = itertools.count()
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
                             succinct["c"], succinct["pk"], succinct["card"])),
                         ("prove_succinct_device prod (opt)", lambda: fri_cuda.prove_succinct_device(
                             device["c"], device["pk"])),
                         (f"prove_aggregate_device {AGG_INSTANCES} prod (opt)",
                          lambda: fri_cuda.prove_aggregate_device(*agg_verify["prod"])),
                         (f"verify_succinct_device_batch {POOLED_PROOFS} fast, fused (hybp)",
                          agg_verify["verify"])):
            profile_path(f"{name} | {smi}", fn, os.path.join(PROFILE_DIR, str(next(traced))))

    kernels = [
        {"name": f"hades_perm_{s}", "route": "cuda", "source": SOURCES[s],
         "replaces": REPLACES[s], "launches": main_launches[s], "max_abs_err": max_err[s],
         "ms": ms[s], "plain_ms": plain_ms[s], "bound_ms": bounds[s]["bound_ms"],
         "bound_by": bounds[s]["bound_by"], "library_ms": None}
        for s in perm_cuda.SCHEDULES
    ]
    log(f"[run] {time.perf_counter() - t_run:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
