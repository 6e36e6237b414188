"""The H100's bound on the permutation kernels (the counterpart of
`hades252_tpu/utils/roofline.py`) and on the field inversion's and
conversion's.

The least time the card could take for b states through a schedule,
canonical in and out, is the largest of three times (T / C / M):

  T  the byte multiply-adds of the schedule's dots on the tensor cores
     over the card's dense int8 peak (bf16 for `mxu`, whose dots are bf16);
  C  the 32-bit integer operations of its CUDA-core work over the card's
     int32 rate;
  M  its bytes (each state read and written once, the tables read once)
     over the memory rate.

The JAX package counts the v5e's lane operations by running its emulated
Pallas kernel under a counting ndarray (`count_ops`); that harness belongs
to the TPU kernel. Here the counts are per state, from the CUDA sources
(`ops/csrc/field.cuh`, `perm.cuh`, `perm_dense.cuh`, `perm_hybp.cuh`), as
`bound` sets them out.
"""

from __future__ import annotations

from ..ops import perm_cuda
from ..params import N_DIGITS, WIDTH

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): int8 and bf16 on the tensor cores, and device memory. Its
# 32-bit integer rate is not published: 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock, one multiply-add a lane a clock.
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _bounded(times: dict) -> dict:
    """T / C / M times with the largest as the bound, and which kind binds."""
    bound_ms = max(times.values())
    return {"bound_ms": bound_ms,
            "bound_by": "bytes" if bound_ms == times["bytes_ms"] else "operations", **times}


def bound(schedule: str, b: int) -> dict:
    """The least time the card could take for b states through `schedule`,
    canonical in and out: {"bound_ms", "bound_by" ("bytes" or
    "operations"), "tensor_ms", "cores_ms", "bytes_ms"}. Counted per state
    from the sources:

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
    perm_cuda._check_schedule(schedule)
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
             "bytes_ms": (2 * WIDTH * N_DIGITS * 4 * b + table_bytes) / HBM_BYTES_PER_S * 1e3}
    return _bounded(times)


def invert_bound(n: int, *, mont_in: bool) -> dict:
    """The least time the card could take for `field_cuda.invert` of n
    elements, as `bound` gives it (no tensor-core work), counted from
    `ops/csrc/field.cuh`'s fermat_invert with `bound`'s costs: 254 squarings
    of 108 multiply-adds and 163 products of 136 (square-and-multiply over
    the 255 bits of p - 2, 164 of them set), and one product more to lift a
    canonical input; 64 B read and 64 B written an element."""
    ops = 254 * 108 + 163 * 136 + (0 if mont_in else 136)
    times = {"tensor_ms": 0.0, "cores_ms": ops * n / INT32_OPS_PER_S * 1e3,
             "bytes_ms": 2 * N_DIGITS * 4 * n / HBM_BYTES_PER_S * 1e3}
    return _bounded(times)


def convert_bound(n: int) -> dict:
    """The least time the card could take for `field_cuda.to_mont` or
    `from_mont` of n elements, as `invert_bound` gives it: one Montgomery
    product of 136 multiply-adds an element (`ops/csrc/field.cuh`'s
    mont_convert), 64 B read and 64 B written; bound by the bytes."""
    times = {"tensor_ms": 0.0, "cores_ms": 136 * n / INT32_OPS_PER_S * 1e3,
             "bytes_ms": 2 * N_DIGITS * 4 * n / HBM_BYTES_PER_S * 1e3}
    return _bounded(times)


def arith_bound(n: int, op: str, *, read: int | None = None) -> dict:
    """The least time the card could take for n output elements of
    `field_cuda.mont_mul`, `add_mod` or `sub_mod` (op "mul", "add" or
    "sub"), as `convert_bound` gives it: 136 multiply-adds an element for a
    product, 16 operations for a sum or difference (`ops/csrc/field.cuh`'s
    carry chains), 64 B read for each of the `read` operand elements the
    call holds (2 n, two operands streamed, unless given: a broadcast
    operand's elements are read once) and 64 B written for each output;
    bound by the bytes."""
    ops = {"mul": 136, "add": 16, "sub": 16}[op]
    read = 2 * n if read is None else read
    times = {"tensor_ms": 0.0, "cores_ms": ops * n / INT32_OPS_PER_S * 1e3,
             "bytes_ms": (read + n) * N_DIGITS * 4 / HBM_BYTES_PER_S * 1e3}
    return _bounded(times)


_RESOURCE = {"tensor_ms": "tensor cores", "cores_ms": "cuda cores", "bytes_ms": "memory"}


def roofline(schedule: str, b: int, measured_ms: float | None = None) -> dict:
    """`bound`'s T / C / M times for b states through `schedule`, the
    resource that binds ("tensor cores", "cuda cores" or "memory"), the
    ceiling in permutations a second, and with a measured kernel time the
    achieved fraction of the bound (bound_ms / measured_ms)."""
    out = bound(schedule, b)
    times = {k: out[k] for k in _RESOURCE}
    out["binding_resource"] = _RESOURCE[max(times, key=times.get)]
    out["ceiling_perms_per_sec"] = b / out["bound_ms"] * 1e3
    if measured_ms is not None:
        out["achieved_fraction"] = out["bound_ms"] / measured_ms
    return out
