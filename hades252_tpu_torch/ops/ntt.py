"""Batched radix-2 NTT over F_r as torch ops on digit tensors.

Port of `hades252_tpu/ops/ntt.py`: the same iterative Cooley-Tukey
schedule as `plonk.ntt` (bit reversal, then log2(N) butterfly stages),
over arbitrary leading batch axes of (..., N, N_DIGITS) canonical digit
tensors, on the port's element-wise field ops (`ops/field_cuda.py`: one
kernel launch each on the card, `field`'s torch ops on the CPU) and on the
input's device.

  * Twiddle factors are precomputed on the host IN MONTGOMERY FORM
    (w^k * R mod p), so each butterfly's twiddle product is one
    `mont_mul` on canonical operands: values stay canonical end to
    end, with no domain conversions inside the transform.
  * Each stage is one reshape, one batched mont_mul and add_mod/sub_mod
    over (..., N/L, L/2, DIGITS), joined with one `torch.cat`; the
    kernels read the stage's strided halves and its (L/2, DIGITS)
    twiddle row in place.
  * The host tables are cached per (n, invert); their tensors per
    (n, invert, device), as `field._const` caches its constants.

Bit-exactness: outputs are identical to plonk.ntt / plonk._coset_eval /
plonk._coset_interp, and to the JAX package's transforms, for every input
(tests/test_torch_ntt.py); the batched prover (prover_cuda.py) relies on
it for proofs bit-identical to the host prover's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import N_DIGITS, P, R
from ..plonk import _domain_root
from ..utils.encoding import ints_to_digits
from . import field_cuda


@functools.cache
def _tables(n: int, invert: bool):
    """(bit-reversal index array, per-stage Montgomery twiddle tables,
    Montgomery n^-1) for an N-point (inverse) NTT, as host numpy arrays."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"NTT size must be a power of two >= 2: {n}")
    # plonk.ntt's in-place swap network realizes the full bit-reversal
    # permutation: rev[i] = reverse of i's log2(n) bits
    bits = n.bit_length() - 1
    rev = np.array([int(f"{i:0{bits}b}"[::-1], 2) for i in range(n)], np.int64)
    stages = []
    length = 2
    while length <= n:
        w_len = _domain_root(length)
        if invert:
            w_len = pow(w_len, P - 2, P)
        tw = [pow(w_len, k, P) * R % P for k in range(length // 2)]
        stages.append(ints_to_digits(tw, shape=(length // 2,)))
        length <<= 1
    n_inv_mont = ints_to_digits([pow(n, P - 2, P) * R % P], shape=(1,))[0]
    return rev, tuple(stages), n_inv_mont


def _digits(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32)).to(device)


@functools.cache
def _device_tables(n: int, invert: bool, device: torch.device):
    rev, stages, n_inv_mont = _tables(n, invert)
    return (torch.from_numpy(rev).to(device), tuple(_digits(tw, device) for tw in stages),
            _digits(n_inv_mont, device))


def ntt_batched(x: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """(..., N, N_DIGITS) canonical digits: coefficients -> evaluations on
    H_N (or the inverse transform). Bit-identical to plonk.ntt per batch
    row. Returns int32 digits on x's device."""
    n = x.shape[-2]
    rev, stages, n_inv_mont = _device_tables(n, invert, x.device)
    x = x.index_select(-2, rev)
    lead = x.shape[:-2]
    for tw in stages:
        half = tw.shape[0]
        length = 2 * half
        xr = x.reshape(*lead, n // length, length, N_DIGITS)
        u = xr[..., :half, :]
        v = field_cuda.mont_mul(xr[..., half:, :], tw)
        x = torch.cat([field_cuda.add_mod(u, v), field_cuda.sub_mod(u, v)], dim=-2)
        x = x.reshape(*lead, n, N_DIGITS)
    if invert:
        x = field_cuda.mont_mul(x, n_inv_mont)
    return x


@functools.cache
def _power_table(n: int, shift: int) -> np.ndarray:
    """(N, N_DIGITS) Montgomery digits of shift^i (coset scaling table)."""
    out, s = [], 1
    for _ in range(n):
        out.append(s * R % P)
        s = s * shift % P
    return ints_to_digits(out, shape=(n,))


@functools.cache
def _device_power_table(n: int, shift: int, device: torch.device) -> torch.Tensor:
    return _digits(_power_table(n, shift), device)


def coset_eval_batched(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate (..., N, D) coefficient rows on the coset shift*H_N
    (bit-identical to plonk._coset_eval with m = N; pad coefficients to N
    first)."""
    n = coeffs.shape[-2]
    scaled = field_cuda.mont_mul(coeffs, _device_power_table(n, shift, coeffs.device))
    return ntt_batched(scaled)


def coset_interp_batched(evals: torch.Tensor, shift: int) -> torch.Tensor:
    """Inverse of coset_eval_batched (bit-identical to
    plonk._coset_interp)."""
    n = evals.shape[-2]
    coeffs = ntt_batched(evals, invert=True)
    inv_shift = pow(shift, P - 2, P)
    return field_cuda.mont_mul(coeffs, _device_power_table(n, inv_shift, coeffs.device))
