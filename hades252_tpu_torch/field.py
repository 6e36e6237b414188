"""L0 field layer: BLS12-381 scalar-field arithmetic on torch digit tensors.

PyTorch port of `hades252_tpu/field.py`. A field element is 16
little-endian digits of 16 bits along the LAST axis; any leading axes are
batch and broadcast. Every function takes int32 or int64 digit tensors and
returns int32 digits (< 2^16, hence non-negative), on the input's device.

The arithmetic runs in int64: a 16x16-bit digit product needs 32 bits and
a column of 16 such products 36, which int64 holds exactly without the
lo/hi split the JAX package needs in uint32. Carry and borrow chains are a
Python loop, the counterpart of its `lax.scan`, over pairs of digits (limbs
of 32 bits), which int64 also holds: half as many steps as over digits.
Multiplication is schoolbook followed by a full-word Montgomery REDC
(m = T_lo * p' mod R; t = (T + m p) / R). Every output is reduced below p.

These are the plain versions that the CPU runs and that the CUDA kernels
(`ops/csrc/perm.cu`) are held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .params import DIGIT_BITS, DIGIT_MASK, N_DIGITS, P, int_to_digits, perm_constants_np


def _i64(a: torch.Tensor) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"field op requires a torch tensor, got {type(a).__name__}")
    if a.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"field op requires int32/int64 digits, got {a.dtype}")
    if a.shape[-1] not in (N_DIGITS, 2 * N_DIGITS):
        raise ValueError(f"unexpected digit-axis length {a.shape[-1]}")
    return a.to(torch.int64)


@functools.cache
def _const(name: str, device: torch.device) -> torch.Tensor:
    """One of perm_constants_np()'s (N_DIGITS,) tables as int64 on device."""
    return torch.from_numpy(perm_constants_np()[name].astype(np.int64)).to(device)


_LIMB_MASK = (1 << (2 * DIGIT_BITS)) - 1


def _pairs(d: torch.Tensor) -> torch.Tensor:
    """(..., 2n) int64 digits or columns -> (..., n) limbs of two each."""
    if d.shape[-1] % 2:
        raise ValueError(f"digit-axis length {d.shape[-1]} is odd")
    return d[..., 0::2] + (d[..., 1::2] << DIGIT_BITS)


def _unpair(limbs: list[torch.Tensor]) -> torch.Tensor:
    """32-bit limbs -> (..., 2n) int32 digits of 16 bits."""
    lo = torch.stack(limbs, -1)
    return torch.stack([lo & DIGIT_MASK, lo >> DIGIT_BITS], -1).flatten(-2).to(torch.int32)


def carry_normalize(acc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Propagate carries: non-negative column sums (< 2^37) -> digits < 2^16.

    Returns (final_carry, digits), both int32. The represented value is
    preserved: sum(acc[d] 2^(16 d)) == carry 2^(16 n) + sum(digits[d] 2^(16 d)).
    The chain runs over pairs of columns (limbs of 32 bits; a pair of
    columns is < 2^54), half as many steps as over digits.
    """
    limbs = _pairs(acc.to(torch.int64))
    carry = torch.zeros(limbs.shape[:-1], dtype=torch.int64, device=limbs.device)
    out = []
    for limb in limbs.unbind(-1):
        t = limb + carry
        out.append(t & _LIMB_MASK)
        carry = t >> (2 * DIGIT_BITS)
    return carry.to(torch.int32), _unpair(out)


def add_digits(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Digit-wise a + b with carry chain. Returns (carry_out, digits)."""
    return carry_normalize(_i64(a) + _i64(b))


def sub_digits(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Digit-wise a - b with borrow chain, for normalized digits. Returns
    (borrow_out, digits); borrow_out is 1 where b > a (the digits then hold
    a - b + 2^(16 n))."""
    diff = _pairs(_i64(a)) - _pairs(_i64(b))
    borrow = torch.zeros(diff.shape[:-1], dtype=torch.int64, device=diff.device)
    out = []
    for limb in diff.unbind(-1):
        t = limb + borrow
        out.append(t & _LIMB_MASK)
        borrow = t >> 63  # -1 after a borrow, else 0
    return (-borrow).to(torch.int32), _unpair(out)


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """Reduce a in [0, 2p) to [0, p): subtract p when a >= p."""
    borrow, diff = sub_digits(a, _const("p", a.device))
    return torch.where((borrow == 0)[..., None], diff, a.to(torch.int32))


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for normalized inputs (< p); a + b < 2p < 2^256."""
    _, s = add_digits(a, b)
    return cond_sub_p(s)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for normalized inputs (< p)."""
    borrow, diff = sub_digits(a, b)
    _, fixed = add_digits(diff, _const("p", diff.device))
    return torch.where((borrow == 1)[..., None], fixed, diff)


def _columns(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Un-carried schoolbook column sums of a*b, (..., n_out) int64.

    The outer product's row i is shifted right by i digits with one
    pad-and-reshape: in a row-major (16, 33) block, element (i, j) sits at
    flat index 33 i + j = 32 i + (i + j), i.e. at (i, i + j) of the first
    512 entries read as (16, 32). Summing the rows gives the columns.
    """
    prods = _i64(a)[..., :, None] * _i64(b)[..., None, :]  # < 2^32 each
    lead = prods.shape[:-2]
    n = N_DIGITS
    skew = F.pad(prods, (0, n + 1)).reshape(*lead, n * (2 * n + 1))
    cols = skew[..., : 2 * n * n].reshape(*lead, n, 2 * n).sum(-2)
    return cols[..., :n_out]


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact 256x256 -> 512-bit product as 32 normalized digits."""
    _, digits = carry_normalize(_columns(a, b, 2 * N_DIGITS))
    return digits


def mul_low(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^256 as 16 normalized digits."""
    _, digits = carry_normalize(_columns(a, b, N_DIGITS))
    return digits


def mont_reduce(t_wide: torch.Tensor) -> torch.Tensor:
    """Full-word Montgomery REDC: 32 normalized digits holding T < R p ->
    T R^{-1} mod p as 16 normalized digits (< p)."""
    t_wide = _i64(t_wide)
    dev = t_wide.device
    m = mul_low(t_wide[..., :N_DIGITS], _const("p_prime", dev))
    # T + m p < 2 R p < 2^512: one carry pass over T's digits plus m p's
    # columns gives 32 digits with a zero carry out
    _, s = carry_normalize(t_wide + _columns(m, _const("p", dev), 2 * N_DIGITS))
    return cond_sub_p(s[..., N_DIGITS:])  # exact division by R


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^{-1} mod p (normalized inputs)."""
    return mont_reduce(mul_wide(a, b))


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    """Montgomery square."""
    return mont_mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Canonical digits -> Montgomery domain (a R mod p)."""
    return mont_mul(a, _const("r2", a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery domain -> canonical digits (a R^{-1} mod p)."""
    return mont_mul(a, _const("one", a.device))


def quintic_sbox_mont(x: torch.Tensor) -> torch.Tensor:
    """x^5 in the Montgomery domain: (x^2)^2 x, 3 Montgomery muls."""
    x2 = mont_sqr(x)
    x4 = mont_sqr(x2)
    return mont_mul(x4, x)


def invert(a: torch.Tensor) -> torch.Tensor:
    """a^{-1} mod p for canonical digits, by Fermat (a^(p-2)) with
    square-and-multiply over the exponent's bits; invert(0) = 0."""
    a_m = to_mont(a)
    e = P - 2
    acc = to_mont(torch.broadcast_to(_const("one", a.device), a.shape))
    for i in reversed(range(e.bit_length())):
        acc = mont_mul(acc, acc)
        if (e >> i) & 1:
            acc = mont_mul(acc, a_m)
    return from_mont(acc)


# ---------------------------------------------------------------------------
# Host-side conveniences (numpy) for tests and I/O
# ---------------------------------------------------------------------------


def np_random_elements(shape, rng: np.random.Generator) -> np.ndarray:
    """Uniform canonical field elements as (..., N_DIGITS) uint32; the same
    draws as `hades252_tpu.field.np_random_elements` from the same rng."""
    flat = int(np.prod(shape)) if shape else 1
    vals = [rng.integers(0, 1 << 63, 5).tolist() for _ in range(flat)]
    out = np.stack(
        [
            int_to_digits(
                (v[0] | v[1] << 63 | v[2] << 126 | v[3] << 189 | v[4] << 252) % P
            )
            for v in vals
        ]
    )
    return out.reshape(tuple(shape) + (N_DIGITS,))
