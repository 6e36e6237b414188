"""The fused Hades252 permutation: CUDA kernels, their wrappers and their
plain PyTorch versions.

Port of the `naive` and `opt` schedules of `hades252_tpu/ops/perm_pallas.py`
(`permute_planar` :1270, `_batch_major` :1390). The kernels are in
`csrc/perm.cu`: `hades_perm_naive` (dense rounds, replacing
`_perm_kernel`) and `hades_perm_opt` (sparse-factored partial rounds,
replacing `_perm_kernel_opt`).

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

from .. import field
from ..params import (
    N_DIGITS,
    PARTIAL_ROUNDS,
    TOTAL_FULL_ROUNDS,
    WIDTH,
    digits_to_limbs,
    opt_schedule_np,
    perm_constants_np,
    perm_tables,
)
from . import _build, perm_ref

SCHEDULES = ("naive", "opt")
DEFAULT_SCHEDULE = "opt"

#: Kernel launches per schedule. A wrapper adds one where it launches its
#: kernel and nowhere else; `reset_launches` sets them to 0.
launches = {s: 0 for s in SCHEDULES}

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


def _check_status(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: {lib.hades_error_string(status).decode()} ({status})")


def _launch(x: torch.Tensor, out: torch.Tensor, *, convert: bool, schedule: str) -> None:
    lib = _build.library()
    with torch.cuda.device(x.device):
        dev = torch.cuda.current_device()
        if dev not in _initialized:
            tables = kernel_tables()
            _check_status(lib, lib.hades_init(tables.ctypes.data, tables.size),
                          "hades_init")
            _initialized.add(dev)
        fn = getattr(lib, f"hades_perm_{schedule}_launch")
        stream = torch.cuda.current_stream().cuda_stream
        _check_status(lib, fn(x.data_ptr(), out.data_ptr(), x.shape[2], int(convert), stream),
                      f"hades_perm_{schedule}")
    launches[schedule] += 1


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
    return _batch_major(x, convert=True, schedule=schedule)


def permute_cuda_mont(x: torch.Tensor, *, schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """Like permute_cuda on Montgomery-domain state, which stays in the
    domain: the building block of the sponge and Merkle models."""
    return _batch_major(x, convert=False, schedule=schedule)


def _batch_major(x: torch.Tensor, *, convert: bool, schedule: str) -> torch.Tensor:
    if x.dim() != 3 or tuple(x.shape[1:]) != (WIDTH, N_DIGITS):
        raise ValueError(f"expected (B, {WIDTH}, {N_DIGITS}), got {tuple(x.shape)}")
    planar = x.permute(1, 2, 0).contiguous()
    out = permute_planar(planar, convert=convert, schedule=schedule)
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


def permute_planar_plain(x: torch.Tensor, *, convert: bool = True,
                         schedule: str = DEFAULT_SCHEDULE) -> torch.Tensor:
    """The plain PyTorch version of the kernels, on x's own device: same
    planar (WIDTH, N_DIGITS, B) layout, same `convert`, same outputs.
    `naive` runs the dense rounds of ops/perm_ref.py; `opt` the sparse
    schedule from the port's opt tables."""
    _check_schedule(schedule)
    if x.dim() != 3 or tuple(x.shape[:2]) != (WIDTH, N_DIGITS):
        raise ValueError(f"expected ({WIDTH}, {N_DIGITS}, B), got {tuple(x.shape)}")
    s = x.permute(2, 0, 1)
    if convert:
        s = field.to_mont(s)
    s = perm_ref.permute_mont(s) if schedule == "naive" else _permute_opt_mont(s)
    if convert:
        s = field.from_mont(s)
    return s.permute(1, 2, 0).contiguous()
