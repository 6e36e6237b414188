"""The fused Hades252 permutation: CUDA kernels, their wrappers and their
plain PyTorch versions.

Port of the eight schedules of `hades252_tpu/ops/perm_pallas.py`
(`permute_planar` :1270, `_batch_major` :1390). The kernels are `hades_perm_naive` (dense rounds, replacing `_perm_kernel`)
and `hades_perm_opt` (sparse-factored partial rounds, replacing
`_perm_kernel_opt`), both on a group of 4, 2 or 1 lanes a state, in
`csrc/perm.cu`, `hades_perm_mxu8` (dense rounds, the MDS layer as an 8-bit
integer warpgroup MMA and the reductions on the CUDA cores, replacing
`_perm_kernel_mxu8`) in `csrc/perm_mxu8.cu`, `hades_perm_hybp` (the
full-expansion partial chain with each round's dot split, the big one run
ahead by a producer warpgroup as wgmma, the reductions on the CUDA cores,
replacing `_perm_kernel_hybp`), `hades_perm_hyb` (the same block without
the split, each round's whole dot a wgmma job, replacing `_perm_kernel_hyb`)
and `hades_perm_hybp13`, `hades_perm_hyb13` (the same two with every S-box
product as a base-2^13 schoolbook on the CUDA cores, the JAX bodies'
`sbox13=True`) in `csrc/perm_hybp.cu`, and `hades_perm_mxu` (mxu8's
kernel with the MDS layer as bf16 warpgroup MMAs with float32 sums,
replacing `_perm_kernel_mxu`) in `csrc/perm_mxu.cu`.

A wrapper launches its kernel for a CUDA tensor and raises where it cannot;
it takes the plain version only for a tensor on the CPU. The plain versions
(`permute_planar_plain`) run the same schedules with `hades252_tpu_torch.field`
on the tensor's own device: the CPU tests use them, and the card's checks
compare the kernels with them. All schedules give bit-identical outputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import field
from ..params import (
    HYB_N_BASIS,
    HYB_SEG1_ROUNDS,
    MXU8_BLOCK_ROWS,
    N_DIGITS,
    P,
    PARTIAL_ROUNDS,
    ROUNDS,
    TOTAL_FULL_ROUNDS,
    WIDTH,
    digits_to_limbs,
    hyb_tables,
    hyb_weights_np,
    hybp_tables,
    hybp_weights_np,
    int_to_digits,
    mxu8_tables,
    mxu_weights_np,
    opt_schedule_np,
    perm_constants_np,
    perm_tables,
)
from ..utils import metrics
from . import _build, perm_ref

SCHEDULES = ("naive", "opt", "mxu8", "hyb", "hybp", "mxu", "hyb13", "hybp13")
DEFAULT_SCHEDULE = "opt"

#: Kernel launches per schedule. A wrapper adds one where it launches its
#: kernel and nowhere else (a CUDA graph's launches are counted once, at
#: its capture); `reset_launches` sets them to 0.
launches = {s: 0 for s in SCHEDULES}

#: States handed to the kernels per schedule: a wrapper adds its batch where
#: it launches, and `utils/graphs.CudaGraph` adds what one replay holds at
#: every replay (a capture runs nothing). Never reset by `reset_launches`.
states = {s: 0 for s in SCHEDULES}

# device indices whose constant memory holds the tables
_initialized: set[int] = set()


def reset_launches() -> None:
    for s in SCHEDULES:
        launches[s] = 0


def kernel_tables() -> np.ndarray:
    """The constant tables as one flat uint32 array of 32-bit limbs, in the
    order `hades_init` (csrc/perm.cu) takes them."""
    c, o = perm_constants_np(), opt_schedule_np()
    parts = (c["p"], c["r2"], c["ark_mont"], c["mds_mont"], o["ark_fr"], o["c0"],
             o["u"], o["w"], o["m"], o["d"], o["final"])
    return np.concatenate([digits_to_limbs(a).reshape(-1) for a in parts])


def mxu8_kernel_tables() -> tuple[np.ndarray, np.ndarray]:
    """The mxu8 schedule's tables as the chained kernels take them
    (`hyb_kernel_tables`): the dense ARK and R^2 as one flat uint32 array
    of 32-bit limbs, and the weights w_lin, w_pp, w_p as one flat uint8
    array (params.mxu8_tables), of which the kernels read w_lin."""
    t = mxu8_tables()
    consts = np.concatenate([digits_to_limbs(t[k]).reshape(-1) for k in ("ark_mont", "r2")])
    weights = np.concatenate([t[k].reshape(-1) for k in ("w_lin", "w_pp", "w_p")])
    return consts, weights


def core_order(w: torch.Tensor) -> torch.Tensor:
    """A (64 m, 16 v) byte matrix in wgmma's shared-memory operand order
    without swizzle (csrc/wgmma.cuh), flat: each 64-row block cut into
    16-byte vectors, byte j of vector v of row r at v * 1024 + (r // 8) *
    128 + (r % 8) * 16 + j, the blocks one after the other."""
    rows, k = w.shape
    # (block, row group, row, vector, byte) -> (block, vector, row group, row, byte)
    return w.reshape(rows // 64, 8, 8, k // 16, 16).permute(0, 3, 1, 2, 4).reshape(-1)


def widen_bf16(w: torch.Tensor) -> torch.Tensor:
    """A (m, k) byte matrix as (m, 2 k) bytes of bf16 values, each byte
    exactly (at most 8 significant bits), little-endian."""
    return w.to(torch.bfloat16).view(torch.uint8)


def dense_kernel_tables(schedule: str) -> tuple[np.ndarray, np.ndarray]:
    """The mxu8 or mxu kernel's tables as its launch takes them: mxu8's
    consts (the dense ARK and R^2 as uint32 limbs), and w_lin alone, packed
    in `core_order`: as bytes for mxu8 (51,200 B), widened once to bf16 for
    mxu (102,400 B). Their reductions run on the CUDA cores, so w_pp and w_p
    are not read."""
    consts, _ = mxu8_kernel_tables()
    w = torch.from_numpy(mxu8_tables()["w_lin"])
    if schedule == "mxu":
        w = widen_bf16(w)
    return consts, core_order(w).numpy()


def dense_smem_bytes(schedule: str) -> int:
    """The dynamic shared memory of a block of the mxu8 or mxu kernel
    (csrc/perm_dense_block.cuh: Layout): w_lin, the states' two halves of
    64 rows (both 160 values a row, a byte or a bf16 each) and one block's
    sums, 64 rows of its 128 states + 8 int32."""
    panel = 64 * 160 * (2 if schedule == "mxu" else 1)
    return 5 * panel + 2 * panel + 64 * (128 + 8) * 4


def hyb_kernel_tables(schedule: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The hyb or hybp kernel's tables as its launch takes them: mxu8's
    consts with R mod p appended (uint32 limbs), mxu8's weights (of which
    the kernels read the MDS block), and the chain's weights as one flat
    uint8 array: segment 1, segment 2, for hybp w_new, then w_out. hyb13 and
    hybp13 take hyb's and hybp's unchanged (perm_pallas.py:1333-1342). The
    kernels also take `packed_weights`."""
    consts, weights = mxu8_kernel_tables()
    t = hybp_tables() if schedule.startswith("hybp") else hyb_tables()
    consts = np.concatenate([consts, digits_to_limbs(t["one_mont"])])
    chain = np.concatenate([v.reshape(-1) for v in t.values() if v.dtype == np.uint8])
    return consts, weights, chain


#: The rows of a job of the hyb and hybp kernels' producer and the bytes of
#: K a stage of its ring holds (csrc/perm_hybp.cu: kBlockRows, kStageK).
_JOB_ROWS = 64
_STAGE_K = 256


def job_k(q: int, split: bool) -> int:
    """Bytes of the basis that job q of the hyb (split=False) or hybp kernel's
    producer multiplies (csrc/perm_hybp.cuh: job_k): round q's elements
    (hyb's 6 + q; hybp's older ones, 6 in round 0 and 5 + q after), rounded
    up to 64 bytes, or the whole padded basis for the exit's five blocks."""
    if q >= 59:
        return 2112
    elems = 6 + q if not split else 6 if q == 0 else 5 + q
    return (32 * elems + 63) & ~63


@functools.cache
def packed_weights(schedule: str) -> np.ndarray:
    """The weights of the 64 producer jobs of the hyb or hybp kernel (the 59
    rounds' dots: hyb's whole, hybp's big one over the older elements; then
    the exit's 5 blocks), job after job, each job's (64, job_k) block in the
    order of wgmma's shared-memory operand without swizzle: cut into 16-byte
    vectors, vector v of row r at v * 1024 + (r // 8) * 128 + (r % 8) * 16,
    its K filled up with zeros to whole stages of the kernel's ring. A stage
    is then a contiguous run of a job's bytes, which one bulk copy moves.
    hyb13 and hybp13 take hyb's and hybp's jobs."""
    base = schedule.removesuffix("13")
    if base not in ("hyb", "hybp"):
        raise ValueError(f"no producer jobs for schedule {schedule!r}")
    split = base == "hybp"
    t = hybp_tables() if split else hyb_tables()
    seg1, seg2 = (t["wo_seg1"], t["wo_seg2"]) if split else (t["w_seg1"], t["w_seg2"])
    jobs = []
    for q in range(64):
        if q < HYB_SEG1_ROUNDS:
            w = seg1[q]
        elif q < PARTIAL_ROUNDS:
            w = seg2[q - HYB_SEG1_ROUNDS]
        else:
            w = t["w_out"].reshape(5, _JOB_ROWS, -1)[q - PARTIAL_ROUNDS]
        k = job_k(q, split)
        assert w.shape[0] == _JOB_ROWS and not w[:, k:].any()
        padded = np.zeros((_JOB_ROWS, -(-k // _STAGE_K) * _STAGE_K), np.uint8)
        padded[:, :k] = w[:, :k]
        # (row group, row, vector, byte) -> (vector, row group, row, byte)
        jobs.append(padded.reshape(8, 8, -1, 16).transpose(2, 0, 1, 3).reshape(-1))
    return np.ascontiguousarray(np.concatenate(jobs))


#: The dense schedules whose MDS layer is a tile product, and the schedules
#: with the full-expansion chain (whose kernels take `packed_weights`).
_DENSE_DOT = ("mxu8", "mxu")
_CHAINED = ("hyb", "hybp", "hyb13", "hybp13")


@functools.cache
def _device_tables(schedule: str, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The tables of a dot kernel (every schedule but naive and opt) on the
    device. hyb13 and hybp13 take hyb's and hybp's, packed jobs included: the
    same tensors."""
    if schedule in ("hyb13", "hybp13"):
        return _device_tables(schedule.removesuffix("13"), device)
    tables = (dense_kernel_tables(schedule) if schedule in _DENSE_DOT
              else (*hyb_kernel_tables(schedule), packed_weights(schedule)))
    return tuple(torch.from_numpy(t.view(np.int32) if t.dtype == np.uint32 else t).to(device)
                 for t in tables)


def _check_status(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: {lib.hades_error_string(status).decode()} ({status})")


def _launch(x: torch.Tensor, out: torch.Tensor, *, convert: bool, schedule: str) -> None:
    lib = _build.library()
    with torch.cuda.device(x.device):
        dev = torch.cuda.current_device()
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), out.data_ptr(), x.shape[2], int(convert))
        fn = getattr(lib, f"hades_perm_{schedule}_launch")
        if schedule in _DENSE_DOT or schedule in _CHAINED:
            tables = _device_tables(schedule, torch.device("cuda", dev))
            status = fn(*args, *(t.data_ptr() for t in tables), stream)
        else:
            if dev not in _initialized:
                tables = kernel_tables()
                _check_status(lib, lib.hades_init(tables.ctypes.data, tables.size),
                              "hades_init")
                _initialized.add(dev)
            status = fn(*args, stream)
        _check_status(lib, status, f"hades_perm_{schedule}")
    launches[schedule] += 1
    states[schedule] += x.shape[2]


def _check_dot(w: torch.Tensor, x: torch.Tensor, max_m: int, max_k: int) -> None:
    if w.dtype != torch.uint8 or x.dtype != torch.uint8 or w.dim() != 2 or x.dim() != 2:
        raise ValueError("expected two uint8 matrices")
    (m, k), n = w.shape, x.shape[1]
    if x.shape[0] != k or not (0 < m <= max_m and 0 < k <= max_k and n > 0):
        raise ValueError(f"unsupported shapes {tuple(w.shape)} @ {tuple(x.shape)}")
    if w.device.type not in ("cpu", "cuda") or x.device != w.device:
        raise ValueError(f"no kernel for devices {w.device}, {x.device}")


def _call(entry: str, device: torch.device, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _check_status(lib, getattr(lib, f"{entry}_launch")(*args, stream), entry)


def _mds_dot(w: torch.Tensor, x: torch.Tensor, schedule: str) -> torch.Tensor:
    """(M, K) @ (K, N) over uint8 operands with exact int32 sums, M <= 320
    and K <= 160: on a CUDA tensor through the MDS product of the dense
    kernel `schedule` (its own dot: w zero-padded to w_lin's (320, 160),
    packed as `dense_kernel_tables` packs w_lin, and x's columns as the
    states' byte rows); on the CPU in float64 (exact: sums < 2^53)."""
    _check_dot(w, x, 5 * MXU8_BLOCK_ROWS, 160)
    if w.device.type == "cpu":
        return torch.matmul(w.double(), x.double()).to(torch.int32)
    (m, k), n = w.shape, x.shape[1]
    wp = torch.zeros((5 * MXU8_BLOCK_ROWS, 160), dtype=torch.uint8, device=w.device)
    wp[:m, :k] = w
    packed = core_order(widen_bf16(wp) if schedule == "mxu" else wp).contiguous()
    xt = torch.zeros((n, 160), dtype=torch.uint8, device=w.device)
    xt[:, :k] = x.t()
    out = torch.empty((5 * MXU8_BLOCK_ROWS, n), dtype=torch.int32, device=w.device)
    _call(f"hades_{schedule}_dot", w.device, packed.data_ptr(), xt.data_ptr(), out.data_ptr(), n)
    return out[:m]


def mxu8_dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The mxu8 kernel's MDS product (`hades_mxu8_dot`: warpgroup wgmma, u8 x
    u8 -> s32), which exists so that its operand order and fragment layout
    can be checked against a matmul; see `_mds_dot`."""
    return _mds_dot(w, x, "mxu8")


def mxu_dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """As `mxu8_dot`, through the mxu kernel's MDS product (`hades_mxu_dot`):
    the bytes widened to bf16, bf16 x bf16 wgmmas with float32 sums,
    returned as int32. Exact while every sum is below 2^24, which K <= 160
    guarantees (160 * 255^2 = 10,404,000); the card's checks hold it against
    a float64 matmul, all-255 operands included."""
    return _mds_dot(w, x, "mxu")


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; ported: {SCHEDULES}")


def permute_planar(x: torch.Tensor, *, convert: bool = True,
                   schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """The permutation on planar state: x is (WIDTH, N_DIGITS, B) int32
    digits, contiguous, canonical (convert=True) or Montgomery-domain
    (convert=False). Returns a new tensor of the same shape and layout.

    A CUDA tensor goes through the kernel of `schedule`, for any B (the
    kernel masks the tail); a CPU tensor through the plain version.
    """
    with metrics.span("perm.call"):
        return _planar(x, convert=convert, schedule=schedule)


def _planar(x: torch.Tensor, *, convert: bool, schedule: str) -> torch.Tensor:
    _check_schedule(schedule)
    if x.dim() != 3 or tuple(x.shape[:2]) != (WIDTH, N_DIGITS) or x.dtype != torch.int32:
        raise ValueError(
            f"expected ({WIDTH}, {N_DIGITS}, B) int32, got {tuple(x.shape)} {x.dtype}"
        )
    if x.device.type == "cpu":
        return permute_planar_plain(x, convert=convert, schedule=schedule)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous planar tensor")
    out = torch.empty_like(x)
    if x.shape[2]:
        _launch(x, out, convert=convert, schedule=schedule)
    return out


def permute_cuda(x: torch.Tensor, *, schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """The permutation on batch-major canonical state (B, WIDTH, N_DIGITS)."""
    with metrics.span("perm.call"):
        return _batch_major(x, convert=True, schedule=schedule)


def permute_cuda_mont(x: torch.Tensor, *, schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """Like permute_cuda on Montgomery-domain state, which stays in the
    domain: the building block of the sponge and Merkle models."""
    with metrics.span("perm.call"):
        return _batch_major(x, convert=False, schedule=schedule)


def _batch_major(x: torch.Tensor, *, convert: bool, schedule: str) -> torch.Tensor:
    if x.dim() != 3 or tuple(x.shape[1:]) != (WIDTH, N_DIGITS):
        raise ValueError(f"expected (B, {WIDTH}, {N_DIGITS}), got {tuple(x.shape)}")
    planar = x.permute(1, 2, 0).contiguous()
    out = _planar(planar, convert=convert, schedule=schedule)
    return out.permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


@functools.cache
def _opt_tables(device: torch.device) -> dict[str, torch.Tensor]:
    t = perm_tables()
    out = {k: t[k].to(device) for k in ("mds_mont", "ark_fr", "c0", "d", "final")}
    # a sparse round's 9 constants side by side: u_r (4), w_r (4), m
    m = t["m"].expand(PARTIAL_ROUNDS, 1, N_DIGITS)
    out["uwm"] = torch.cat([t["u"], t["w"], m], dim=1).to(device)
    return out


def _full_round(s: torch.Tensor, ark: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    s = field.quintic_sbox_mont(field.add_mod(s, ark))
    return perm_ref._mds(s, mds)


def _fold(prods: torch.Tensor) -> torch.Tensor:
    """Sum (..., k, N_DIGITS) terms mod p over k, ascending."""
    acc = prods[..., 0, :]
    for j in range(1, prods.shape[-2]):
        acc = field.add_mod(acc, prods[..., j, :])
    return acc


def _permute_opt_mont(s: torch.Tensor) -> torch.Tensor:
    """The sparse-factored schedule on (B, WIDTH, N_DIGITS) Montgomery state:
    full rounds 0..3, x = s + c0, 59 sparse rounds, words 0..3 <- A^59 x,
    full rounds 4..7 (params.optimized_partial_int)."""
    t = _opt_tables(s.device)
    half = TOTAL_FULL_ROUNDS // 2
    for r in range(half):
        s = _full_round(s, t["ark_fr"][r], t["mds_mont"])
    s = field.add_mod(s, t["c0"])
    for r in range(PARTIAL_ROUNDS):
        xs = s[:, :4, :]
        x4 = field.quintic_sbox_mont(s[:, 4, :])[:, None, :]
        # the round's 9 products in one call: u_r x4, w_r x[0:4], m x4
        prods = field.mont_mul(t["uwm"][r], torch.cat([x4.expand(-1, 4, -1), xs, x4], dim=1))
        new = field.add_mod(xs, prods[:, :4, :])
        n4 = _fold(prods[:, 4:, :])  # w_r . x[0:4] + m x4
        s = field.add_mod(torch.cat([new, n4[:, None, :]], dim=1), t["d"][r])
    # final[i][j] * x[j] for i, j < 4, folded over j
    fin = _fold(field.mont_mul(t["final"], s[:, None, :4, :]))
    s = torch.cat([fin, s[:, 4:, :]], dim=1)
    for r in range(half, TOTAL_FULL_ROUNDS):
        s = _full_round(s, t["ark_fr"][r], t["mds_mont"])
    return s


# -- mxu8: the dense schedule with every constant product as a byte dot -------
# Follows `_perm_kernel_mxu_impl` (perm_pallas.py:731) and `_MxuOps` (:653)
# step for step, on (..., digits) int64 tensors. A dot runs in float64,
# exact because every sum is < 2^24 (torch has no integer matmul on CUDA).


@functools.cache
def _mxu8_plain_tables(device: torch.device, f32: bool = False) -> dict[str, torch.Tensor]:
    """The dense dot schedules' plain tables. The weights' dtype chooses the
    dot's arithmetic (`_dot_bytes`): float64 for mxu8, float32 (f32) for mxu."""
    w = mxu_weights_np()
    dtype = np.float32 if f32 else np.float64
    out = {k: torch.from_numpy(w[k].astype(dtype)).to(device) for k in w}
    p17 = int_to_digits(P, N_DIGITS + 1).astype(np.int64)
    out["p17"] = torch.from_numpy(p17).to(device)
    out["twop17"] = torch.from_numpy(int_to_digits(2 * P, N_DIGITS + 1).astype(np.int64)).to(device)
    out["ark"] = perm_tables()["ark_mont"].to(device)
    return out


def _byte_rows(x16: torch.Tensor) -> torch.Tensor:
    """(..., 16) digits -> (..., 32) byte rows: the low bytes of digits
    0..15, then their high bytes (params._byte_pos)."""
    x16 = x16.to(torch.int64)
    return torch.cat([x16 & 0xFF, x16 >> 8], dim=-1)


def _dot_bytes(w: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """(M, K) byte weights times (..., K) byte rows -> (..., M) int64 column
    sums. float64 weights: the counterpart of `_dot_u32_i8`
    (perm_pallas.py:524), exact integer sums. float32 weights: the
    counterpart of `_dot_u32` (:493), the mxu kernel's arithmetic, byte
    operands (exact in bf16) with float32 sums, exact while every sum is
    below 2^24, which is asserted as the JAX body asserts it (:500)."""
    if w.dtype != torch.float32:
        return torch.matmul(xb.to(torch.float64), w.t()).to(torch.int64)
    if xb.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the float32 dot needs full float32 sums: TF32 matmuls are on")
    acc = torch.matmul(xb.to(torch.float32), w.t())
    assert float(acc.max()) < float(1 << 24), "f32 matmul exactness bound"
    return acc.to(torch.int64)


def _recombine16(cols: torch.Tensor, n16: int) -> torch.Tensor:
    """Base-256 columns (2 n16 or 2 n16 - 1) -> n16 un-carried 16-bit
    columns: col[2d] + (col[2d + 1] << 8)."""
    hi = cols[..., 1::2]
    hi = F.pad(hi, (0, n16 - hi.shape[-1]))
    return cols[..., 0::2] + (hi << 8)


def _carry(acc: torch.Tensor) -> torch.Tensor:
    """Carry-normalize (..., n) non-negative columns into n 16-bit digits
    (int64); a carry out of the top digit is dropped."""
    n = acc.shape[-1]
    _, digits = field.carry_normalize(F.pad(acc, (0, n % 2)))
    return digits[..., :n].to(torch.int64)


def _carry_lo(acc: torch.Tensor) -> torch.Tensor:
    """Carry-normalize only the first 16 columns (T mod R, which the REDC's
    m-step needs exact); their carry goes into column 16, the high columns
    stay un-carried."""
    carry, lo = field.carry_normalize(acc[..., :N_DIGITS])
    mid = acc[..., N_DIGITS : N_DIGITS + 1] + carry[..., None].to(torch.int64)
    return torch.cat([lo.to(torch.int64), mid, acc[..., N_DIGITS + 1 :]], dim=-1)


def _cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a - m where a >= m, else a: (..., n) digits, m (n,) digits."""
    n = a.shape[-1]
    pad = (0, 2 * N_DIGITS - n)
    borrow, diff = field.sub_digits(F.pad(a, pad), F.pad(m, pad))
    return torch.where((borrow == 0)[..., None], diff[..., :n].to(torch.int64), a)


def _redc_words(t: torch.Tensor, *, wide: bool, normalize: bool = True,
                f32: bool = False) -> torch.Tensor:
    """Montgomery REDC of un-carried columns t, both constant products as
    byte dots (`_redc_words_mxu`, perm_pallas.py:580): (..., 33) columns of
    T < 5p^2 when wide, else (..., 32) of T < 2.2p^2. Returns (..., 16)
    int64 digits: < p, or < 2p where normalize is False (the S-box's x^2
    and x^4, valid under the bounds stated at perm_pallas.py:594-599).
    f32 takes the dots in float32, as the mxu kernel does."""
    c = _mxu8_plain_tables(t.device, f32)
    tcat = _carry_lo(t.to(torch.int64))
    m = _carry(_recombine16(_dot_bytes(c["w_pp"], _byte_rows(tcat[..., :N_DIGITS])), N_DIGITS))
    mp = _recombine16(_dot_bytes(c["w_p"], _byte_rows(m)), 2 * N_DIGITS)
    if wide:
        s = _carry(F.pad(mp, (0, 1)) + tcat)  # 33 digits, t < 3.3p
        return _cond_sub(_cond_sub(s[..., N_DIGITS:], c["twop17"]), c["p17"])[..., :N_DIGITS]
    out = _carry(mp + tcat)[..., N_DIGITS:]  # T + m p < 2.2p^2 + Rp < 2^512
    return field.cond_sub_p(out).to(torch.int64) if normalize else out


# The base-2^13 S-box schoolbook of hyb13 and hybp13, after `_to13` :181,
# `_mul13_cols` :195, `_sqr13_cols` :208 and `_cols13_to16` :225 of
# perm_pallas.py, on (..., digits) int64 tensors. Every value stays below
# 2^32, so int64 repeats the JAX bodies' uint32 arithmetic.

_D13 = 20                       # ceil(256 / 13) thirteen-bit digits
_M13 = (1 << 13) - 1


def _to13(a16: torch.Tensor) -> torch.Tensor:
    """(..., 16) normalized 16-bit digits -> (..., 20) 13-bit digits: bit
    windows, each over at most two source digits."""
    a16 = a16.to(torch.int64)
    out = []
    for k in range(_D13):
        j, r = divmod(13 * k, 16)
        lo = a16[..., j] >> r
        if r + 13 > 16 and j + 1 < N_DIGITS:
            lo = lo | (a16[..., j + 1] << (16 - r))
        out.append(lo & _M13)
    return torch.stack(out, dim=-1)


def _mul13_cols(a13: torch.Tensor, b13: torch.Tensor) -> torch.Tensor:
    """Un-carried base-2^13 schoolbook columns, (..., 39): 400 products
    below 2^26, at most 20 a column, summed with no lo/hi split."""
    shape = torch.broadcast_shapes(a13.shape[:-1], b13.shape[:-1])
    acc = torch.zeros((*shape, 2 * _D13 - 1), dtype=torch.int64, device=a13.device)
    for i in range(_D13):
        acc[..., i : i + _D13] += a13[..., i : i + 1] * b13
    assert int(acc.max()) < (1 << 31), "base-13 column overflow"
    return acc


def _sqr13_cols(a13: torch.Tensor) -> torch.Tensor:
    """The symmetric base-2^13 square: the diagonal once, the off-diagonal
    products doubled; 210 products in place of 400."""
    acc = torch.zeros((*a13.shape[:-1], 2 * _D13 - 1), dtype=torch.int64, device=a13.device)
    for i in range(_D13):
        acc[..., 2 * i] += a13[..., i] * a13[..., i]
        if i + 1 < _D13:
            prod = a13[..., i : i + 1] * a13[..., i + 1 :]
            acc[..., 2 * i + 1 : i + _D13] += prod + prod
    assert int(acc.max()) < (1 << 31), "base-13 square overflow"
    return acc


def _cols13_to16(cols13: torch.Tensor, n_out: int = 2 * N_DIGITS) -> torch.Tensor:
    """Base-2^13 column sums (below 2^31, column k at bit 13 k) -> n_out
    base-2^16 column sums of the same value, carry-free: each source column
    windows into at most three output columns, and at most four sources
    meet in one, so the sums stay below 2^18."""
    acc = torch.zeros((*cols13.shape[:-1], n_out), dtype=torch.int64, device=cols13.device)
    for k in range(2 * _D13 - 1):
        v = cols13[..., k]
        j, r = divmod(13 * k, 16)
        if r == 0:
            parts = (v & 0xFFFF, v >> 16)
        else:
            parts = ((v & ((1 << (16 - r)) - 1)) << r, (v >> (16 - r)) & 0xFFFF)
            if r > 1:
                parts += (v >> (32 - r),)
        for i, part in enumerate(parts):
            if j + i < n_out:
                acc[..., j + i] += part
    assert int(acc.max()) < (1 << 18), "base-13 repack overflow"
    return acc


def _sbox_words(x: torch.Tensor, *, sbox13: bool = False, f32: bool = False) -> torch.Tensor:
    """x^5 = (x^2)^2 x with the raw products as schoolbook columns and
    every REDC through the dots; x^2 and x^4 stay below 2p
    (`_MxuOps.sbox_words`, perm_pallas.py:678). sbox13 takes the raw
    products in base-2^13 digits (:687-700): the values, and so every REDC
    bound, are the same; only the columns' representation changes."""
    def redc(t, normalize=True):
        return _redc_words(t, wide=False, normalize=normalize, f32=f32)

    if sbox13:
        x13 = _to13(x)
        x2 = redc(_cols13_to16(_sqr13_cols(x13)), normalize=False)
        x4 = redc(_cols13_to16(_sqr13_cols(_to13(x2))), normalize=False)
        return redc(_cols13_to16(_mul13_cols(_to13(x4), x13)))
    x2 = redc(field._columns(x, x, 2 * N_DIGITS), normalize=False)
    x4 = redc(field._columns(x2, x2, 2 * N_DIGITS), normalize=False)
    return redc(field._columns(x4, x, 2 * N_DIGITS))


def _mds_mxu(s: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """The MDS layer as one byte dot with w_lin, then one wide REDC per
    word (`_MxuOps.mds_mxu`, perm_pallas.py:707)."""
    c = _mxu8_plain_tables(s.device, f32)
    by = _byte_rows(s).flatten(-2)                       # (B, 5 * 32)
    cols = _dot_bytes(c["w_lin"], by).unflatten(-1, (WIDTH, 63))
    return _redc_words(F.pad(_recombine16(cols, 2 * N_DIGITS), (0, 1)), wide=True, f32=f32)


def _mxu_round(s: torch.Tensor, ark_r: torch.Tensor, *, full: bool, sbox13: bool = False,
               f32: bool = False) -> torch.Tensor:
    """One dense round of the dot schedules (`_MxuOps.round_fn`,
    perm_pallas.py:720): ARK (add_mod), x^5 on every word of a full round
    and on word 4 of a partial one, then the MDS dot."""
    s = field.add_mod(s, ark_r).to(torch.int64)
    sbox = functools.partial(_sbox_words, sbox13=sbox13, f32=f32)
    s = sbox(s) if full else torch.cat([s[:, :-1], sbox(s[:, -1:])], dim=1)
    return _mds_mxu(s, f32)


def _permute_mxu8_mont(s: torch.Tensor, *, f32: bool = False) -> torch.Tensor:
    """The mxu8 schedule on (B, WIDTH, N_DIGITS) Montgomery state: 67
    dense rounds of ARK (add_mod), x^5 and the MDS dot."""
    ark = _mxu8_plain_tables(s.device)["ark"]
    half = TOTAL_FULL_ROUNDS // 2
    for r in range(ROUNDS):
        s = _mxu_round(s, ark[r], full=not half <= r < half + PARTIAL_ROUNDS, f32=f32)
    return s.to(torch.int32)


def _permute_mxu_mont(s: torch.Tensor) -> torch.Tensor:
    """The mxu schedule: mxu8's, with every dot as a float32 matmul of byte
    operands under the asserted bound of 2^24 (`_perm_kernel_mxu`,
    perm_pallas.py:629), so that the plain version repeats the mxu kernel's
    arithmetic and not mxu8's."""
    return _permute_mxu8_mont(s, f32=True)


# -- hyb, hybp: mxu8's full rounds around the full-expansion partial chain ----
# Follow `_perm_kernel_hyb` (perm_pallas.py:845) and `_perm_kernel_hybp`
# (:945) step for step. The basis buffer is (B, 65 * 32) byte rows, element j
# in columns 32 j .. 32 j + 31; the weights are unsigned, so the JAX bodies'
# offset encoding, row sums and running column sum `cs` have no counterpart.
# A dot's sums stay below 65 * 32 * 255^2 < 2^28, exact in float64.


@functools.cache
def _chain_plain_tables(device: torch.device, pipelined: bool) -> dict[str, torch.Tensor]:
    w = hybp_weights_np() if pipelined else hyb_weights_np()
    out = {k: torch.from_numpy(v).to(device) for k, v in w.items() if v.dtype == np.uint8}
    out["pmul17"] = torch.from_numpy(w["pmul17"].astype(np.int64)).to(device)
    out["one_mont"] = torch.from_numpy(w["one_mont"].astype(np.int64)).to(device)
    return out


def _recombine16_wide(cols: torch.Tensor) -> torch.Tensor:
    """63 base-256 columns below 2^28 -> 33 un-carried 16-bit columns, the
    last one zero (`_recombine16_wide`, perm_pallas.py:793): the odd
    column's high bits carry one byte up,
    t16[d] = cols[2d] + ((cols[2d+1] & 0xFF) << 8) + (cols[2d-1] >> 8)."""
    odd = F.pad(cols[..., 1::2], (0, 1))                 # cols[2d+1], 0 for d = 31
    t = cols[..., 0::2] + ((odd & 0xFF) << 8)
    t = t + F.pad(cols[..., 1::2] >> 8, (1, 0))          # cols[2d-1] >> 8, 0 for d = 0
    return F.pad(t, (0, 1))


def _redc_wide_big(t33: torch.Tensor, pmul17: torch.Tensor, n_subs: int = 5) -> torch.Tensor:
    """Montgomery REDC of a `_carry_lo`'d 33-column T < k p^2, k <= 65
    (`_redc_wide_big`, perm_pallas.py:818): t = (T + m p) / R < (0.46 k + 1) p
    is brought below p by the last n_subs rungs of the ladder 16p, 8p, 4p, 2p,
    p (k <= 6: 2, k <= 32: 4, else 5). Returns (..., 16) int64 digits < p."""
    c = _mxu8_plain_tables(t33.device)
    m = _carry(_recombine16(_dot_bytes(c["w_pp"], _byte_rows(t33[..., :N_DIGITS])), N_DIGITS))
    mp = _recombine16(_dot_bytes(c["w_p"], _byte_rows(m)), 2 * N_DIGITS)
    hi = _carry(F.pad(mp, (0, 1)) + t33)[..., N_DIGITS:]           # 17 digits
    for k in range(5 - n_subs, 5):
        hi = _cond_sub(hi, pmul17[k])
    return hi[..., :N_DIGITS]


def _permute_chain_mont(s: torch.Tensor, *, pipelined: bool,
                        sbox13: bool = False) -> torch.Tensor:
    """The hyb (pipelined=False) or hybp schedule on (B, WIDTH, N_DIGITS)
    Montgomery state; with sbox13 every S-box, in the full rounds and the
    chain alike, takes its raw products in base-2^13 digits (hyb13, hybp13)."""
    ark = _mxu8_plain_tables(s.device)["ark"]
    c = _chain_plain_tables(s.device, pipelined)
    half = TOTAL_FULL_ROUNDS // 2
    for r in range(half):
        s = _mxu_round(s, ark[r], full=True, sbox13=sbox13)

    # the basis buffer: [1_mont, x_0..x_4], then s_0..s_58 as they appear
    y = torch.zeros((s.shape[0], 32 * HYB_N_BASIS), dtype=torch.int64, device=s.device)

    def put_elem(j, digits16):
        y[:, 32 * j : 32 * (j + 1)] = _byte_rows(digits16)

    def dot(w, n_elems=None):
        k = w.shape[-1] if n_elems is None else 32 * n_elems
        return _dot_bytes(w.to(torch.float64), y[:, :k])

    def reduce_t(cols, n_subs):
        return _redc_wide_big(_carry_lo(_recombine16_wide(cols)), c["pmul17"], n_subs)

    put_elem(0, c["one_mont"])
    for i in range(WIDTH):
        put_elem(1 + i, s[:, i])
    first, last = HYB_SEG1_ROUNDS, PARTIAL_ROUNDS - 1
    if not pipelined:
        for r in range(PARTIAL_ROUNDS):
            w = c["w_seg1"][r] if r < first else c["w_seg2"][r - first]
            t = reduce_t(dot(w), 4 if r < first else 5)
            put_elem(1 + WIDTH + r, _sbox_words(t, sbox13=sbox13))
    else:
        def older(r):  # round r's big dot, without its newest element
            return dot(c["wo_seg1"][r] if r < first else c["wo_seg2"][r - first])

        # round 0: every input is in the basis; round 1's big dot goes with it
        cols0, d_old = older(0), older(1)
        s_prev = _sbox_words(reduce_t(cols0, 2), sbox13=sbox13)     # s_0 (k = 6)
        # rounds 1..58; at 26 the next dot takes segment 2's width, at 58
        # there is none
        for i in range(1, PARTIAL_ROUNDS):
            sb = _byte_rows(s_prev)
            npart = _dot_bytes(c["w_new"][i].to(torch.float64), sb)
            t = reduce_t(d_old + npart, 4 if i < first else 5)
            y[:, 32 * (WIDTH + i) : 32 * (WIDTH + i + 1)] = sb      # s_{i-1} enters the basis
            if i < last:
                d_old = older(i + 1)
            s_prev = _sbox_words(t, sbox13=sbox13)
        put_elem(HYB_N_BASIS - 1, s_prev)                           # s_58

    # the chain's exit: all 5 words in one dot, one big REDC each
    cols = dot(c["w_out"]).unflatten(-1, (WIDTH, 63))
    s = reduce_t(cols, 5)
    for r in range(half + PARTIAL_ROUNDS, ROUNDS):
        s = _mxu_round(s, ark[r], full=True, sbox13=sbox13)
    return s.to(torch.int32)


def _permute_hyb_mont(s: torch.Tensor) -> torch.Tensor:
    """The hyb schedule: mxu8's full rounds, and each of the 59 partial
    rounds as one byte dot over the basis [1, x_0..x_4, s_0..s_{r-1}], one
    big REDC and one S-box; one (315, 2080) dot at the exit."""
    return _permute_chain_mont(s, pipelined=False)


def _permute_hybp_mont(s: torch.Tensor) -> torch.Tensor:
    """The hybp schedule: hyb with the newest basis element's share of each
    dot split off into a (63, 32) dot, so that round r+1's big dot does not
    wait for round r's S-box; the two are summed before the REDC."""
    return _permute_chain_mont(s, pipelined=True)


_PLAIN = {"naive": perm_ref.permute_mont, "opt": _permute_opt_mont,
          "mxu8": _permute_mxu8_mont, "hyb": _permute_hyb_mont, "hybp": _permute_hybp_mont,
          "mxu": _permute_mxu_mont,
          "hyb13": functools.partial(_permute_chain_mont, pipelined=False, sbox13=True),
          "hybp13": functools.partial(_permute_chain_mont, pipelined=True, sbox13=True)}


def permute_planar_plain(x: torch.Tensor, *, convert: bool = True,
                         schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """The plain PyTorch version of the kernels, on x's own device: same
    planar (WIDTH, N_DIGITS, B) layout, same `convert`, same outputs.
    `naive` runs the dense rounds of ops/perm_ref.py; `opt` the sparse
    schedule from the port's opt tables; `mxu8` the dense rounds with byte
    dots, and `mxu` the same with the dots in float32; `hyb` and `hybp`
    mxu8's full rounds around the full-expansion chain of byte dots over
    the basis, and `hyb13` and `hybp13` the same with the S-box products in
    base-2^13 digits."""
    _check_schedule(schedule)
    if x.dim() != 3 or tuple(x.shape[:2]) != (WIDTH, N_DIGITS):
        raise ValueError(f"expected ({WIDTH}, {N_DIGITS}, B), got {tuple(x.shape)}")
    s = x.permute(2, 0, 1)
    if convert:
        s = field.to_mont(s)
    s = _PLAIN[schedule](s)
    if convert:
        s = field.from_mont(s)
    return s.permute(1, 2, 0).contiguous()
