"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA. It builds the permutation
kernels from `hades252_tpu_torch/ops/csrc/`, then:

  1. prints the card, its power limit and the toolchain;
  2. builds the kernels and prints ptxas's register and spill counts;
  3. runs the KAT gate: the 128 selftest vectors tiled to 2^14 lanes
     through the `naive` and `opt` kernels, canonical and Montgomery
     paths, against the exact int oracle (which is itself held against
     the four SURVEY known answers);
  4. holds each kernel against its plain PyTorch version on the card at
     B = 2^14, 4096 and a ragged 1000, both `convert` values, and at the
     first Merkle level's B = 2^18 on the Montgomery path;
  5. builds the arity-4 Merkle root over 2^20 seeded leaves through
     `merkle_root` (BASELINE config 4), with the default `opt` kernel and
     with the `naive` kernel, and checks the roots agree, the launch
     counts, a 4096-leaf tree against the plain version and a 16-leaf
     tree against the int oracle;
  6. hashes 2^14 streams of 64 elements through `sponge_hash` (BASELINE
     config 3) and checks the first 64 digests against the plain version
     and stream 0 against the int oracle;
  7. times the kernels, their plain versions, the tree and the sponge
     with CUDA events (median of 5 after a warm-up).

Every check is exact (integer arithmetic: tolerance 0). Any failure raises
and the script exits non-zero. The last line of standard output is
{"ok": true, "device": {...}}; the line before it gives the card's name and
power limit, and the one before that the kernels' JSON summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hades252_tpu_torch import selftest
from hades252_tpu_torch.models import merkle, sponge
from hades252_tpu_torch.ops import _build, make_perm_mont_fn, perm_cuda
from hades252_tpu_torch.params import P, WIDTH
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils.encoding import digits_to_ints

SEED = 0x5EED
PERM_BATCH = 1 << 14
MERKLE_LEAVES = 1 << 20
SPONGE_STREAMS, SPONGE_LEN = 1 << 14, 64
REPS = 5
KERNEL_SOURCE = "hades252_tpu_torch/ops/csrc/perm.cu"
REPLACES = {
    "naive": "hades252_tpu/ops/perm_pallas.py:330 (_perm_kernel)",
    "opt": "hades252_tpu/ops/perm_pallas.py:390 (_perm_kernel_opt)",
}


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


def int_merkle_root(leaves: list[int]) -> int:
    strat, level = ScalarStrategy(), list(leaves)
    while len(level) > 1:
        level = [strat.perm([merkle.TAG] + level[i : i + 4])[merkle.DIGEST_INDEX]
                 for i in range(0, len(level), 4)]
    return level[0]


def int_sponge(words: list[int]) -> int:
    strat, state = ScalarStrategy(), [len(words), 0, 0, 0, 0]
    padded = list(words) + [0] * ((-len(words)) % sponge.RATE)
    for c in range(0, len(padded), sponge.RATE):
        for i in range(sponge.RATE):
            state[1 + i] = (state[1 + i] + padded[c + i]) % P
        state = strat.perm(state)
    return state[sponge.DIGEST_INDEX]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
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

    # 3. KAT gate on 2^14 lanes, both schedules, both paths
    selftest.assert_device_correct(dev)
    log(f"[kat] naive, opt x canonical, Montgomery on {selftest.BENCH_LANES} lanes: "
        "bit-identical to the int oracle (SURVEY KATs included)")

    # 4. kernel vs plain: the sponge's batch, the first Merkle level's batch
    # on the Montgomery path the models use, 4096 and a ragged 1000 (the
    # tail mask)
    cases = [(PERM_BATCH, (True, False)), (MERKLE_LEAVES // merkle.ARITY, (False,)),
             (4096, (True, False)), (1000, (True, False))]
    max_err = {s: 0 for s in perm_cuda.SCHEDULES}
    for b, converts in cases:
        x = torch.from_numpy(random_elements((WIDTH, b), rng).transpose(0, 2, 1).copy()).to(dev)
        for schedule in perm_cuda.SCHEDULES:
            for convert in converts:
                got = perm_cuda.permute_planar(x, convert=convert, schedule=schedule)
                want = plain_planar(x, convert=convert, schedule=schedule)
                err = int((got.long() - want.long()).abs().max())
                max_err[schedule] = max(max_err[schedule], err)
                check(err == 0, f"{schedule} kernel != plain at B={b}, convert={convert}")
    log("[plain] kernels == plain versions at B = " +
        ", ".join(f"{b} ({'both convert values' if len(c) == 2 else 'Montgomery'})"
                  for b, c in cases))

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
    torch.cuda.synchronize()

    # 5b + 6. the main path: the counts are the launches of this run only
    perm_cuda.reset_launches()
    root = merkle.merkle_root(leaves)
    check(perm_cuda.launches["opt"] == merkle.tree_levels(MERKLE_LEAVES),
          f"opt launches {perm_cuda.launches['opt']} != {merkle.tree_levels(MERKLE_LEAVES)} levels")
    root_naive = merkle.merkle_root(leaves, make_perm_mont_fn("cuda", schedule="naive"))
    digests = sponge.sponge_hash(msgs)
    torch.cuda.synchronize()
    main_launches = dict(perm_cuda.launches)
    check(all(main_launches[s] > 0 for s in perm_cuda.SCHEDULES),
          f"a kernel of the main path never launched: {main_launches}")
    check(torch.equal(root, root_naive), "2^20-leaf Merkle root: opt kernel != naive kernel")
    check(root.shape == (16,) and bool(((root >= 0) & (root < 1 << 16)).all()),
          "Merkle root is not 16 digits")
    log(f"[merkle] 2^20 leaves, {merkle.tree_levels(MERKLE_LEAVES)} levels: opt root == naive "
        f"root == 0x{int(digits_to_ints(root.cpu().numpy())):064x}")

    check(digests.shape == (SPONGE_STREAMS, 16), "sponge digests have the wrong shape")
    plain = sponge.sponge_hash(msgs[:64], plain_mont_fn("opt"))
    check(torch.equal(digests[:64], plain), "sponge digests of streams 0..63: kernel != plain")
    words0 = list(digits_to_ints(msgs[0].cpu().numpy()))
    check(int(digits_to_ints(digests[0].cpu().numpy())) == int_sponge(words0),
          "sponge digest of stream 0: kernel != int oracle")
    log(f"[sponge] {SPONGE_STREAMS} streams x {SPONGE_LEN}: digests 0..63 == plain, "
        "stream 0 == int oracle")
    log(f"[launches] main path: {main_launches}")

    # 7. timings at the main path's shapes
    x = torch.from_numpy(random_elements((WIDTH, PERM_BATCH), rng).transpose(0, 2, 1).copy()).to(dev)
    ms, plain_ms = {}, {}
    for schedule in perm_cuda.SCHEDULES:
        ms[schedule] = cuda_ms(lambda: perm_cuda.permute_planar(x, schedule=schedule))
        plain_ms[schedule] = cuda_ms(
            lambda: perm_cuda.permute_planar_plain(x, schedule=schedule))
        log(f"[time] {schedule}: kernel {ms[schedule]:.4f} ms = "
            f"{PERM_BATCH / ms[schedule] * 1e3:,.0f} perms/s; plain {plain_ms[schedule]:.1f} ms "
            f"= {PERM_BATCH / plain_ms[schedule] * 1e3:,.0f} perms/s; B={PERM_BATCH} | {smi}")
    tree_ms = cuda_ms(lambda: merkle.merkle_root(leaves))
    log(f"[time] merkle_root 2^20 leaves (opt): {tree_ms / 1e3:.6f} s/tree = "
        f"{MERKLE_LEAVES / tree_ms * 1e3:,.0f} leaves/s | {smi}")
    sponge_ms = cuda_ms(lambda: sponge.sponge_hash(msgs))
    log(f"[time] sponge_hash {SPONGE_STREAMS} x {SPONGE_LEN} (opt): {sponge_ms:.3f} ms = "
        f"{SPONGE_STREAMS * SPONGE_LEN / sponge_ms * 1e3:,.0f} elements/s | {smi}")

    kernels = [
        {"name": f"hades_perm_{s}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[s], "launches": main_launches[s], "max_abs_err": max_err[s],
         "ms": ms[s], "plain_ms": plain_ms[s]}
        for s in perm_cuda.SCHEDULES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
