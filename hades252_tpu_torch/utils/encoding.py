"""Host-side encodings between Python ints, 32-byte little-endian scalars
and digit arrays.

Port of `hades252_tpu/utils/encoding.py`: the canonical 32-byte
little-endian scalar format (the reference's `BlsScalar::to_bytes`), as
numpy uint32 digit arrays of shape (..., N_DIGITS), exactly the JAX
package's, and byte strings identical to its on every valid input. Callers
hand digit arrays to torch with `torch.from_numpy(a.astype(np.int32))`.
"""

from __future__ import annotations

from itertools import chain

import numpy as np

from ..params import DIGIT_MASK, N_DIGITS, P, digits_to_int


def _flatten_values(values) -> list:
    """Flatten nested lists/tuples/arrays of ints."""
    if isinstance(values, np.ndarray):
        return values.reshape(-1).tolist()
    out = list(values)
    while out and isinstance(out[0], (list, tuple, np.ndarray)):
        out = list(chain.from_iterable(out))
    return out


def ints_to_digits(values, shape=None) -> np.ndarray:
    """List/array of canonical Python ints -> (..., N_DIGITS) uint32."""
    flat = _flatten_values(values)
    if shape is None:
        shape = np.asarray(values, dtype=object).shape
    if not flat:
        return np.zeros(tuple(shape) + (N_DIGITS,), np.uint32)
    try:
        buf = b"".join(int(v).to_bytes(32, "little") for v in flat)
    except (OverflowError, TypeError):
        raise ValueError("not a canonical field element (negative or "
                         "non-int value)") from None
    out = np.frombuffer(buf, dtype="<u2").astype(np.uint32)
    out = out.reshape(tuple(shape) + (N_DIGITS,))
    check_canonical_digits(
        out.reshape(-1, N_DIGITS), "not a canonical field element: value >= p"
    )
    return out


_P_DIGITS = np.asarray([(P >> (16 * i)) & 0xFFFF for i in range(N_DIGITS)], np.uint32)


def digits_to_ints(digits) -> np.ndarray:
    """(..., N_DIGITS) integer digits (numpy array or CPU tensor) -> object
    array of Python ints."""
    digits = np.asarray(digits)
    lead = digits.shape[:-1]
    flat = digits.reshape(-1, digits.shape[-1])
    out = np.empty(flat.shape[0], dtype=object)
    if flat.shape[-1] == N_DIGITS and flat.size and (flat >= 0).all() \
            and (flat < 65536).all():
        buf = memoryview(np.ascontiguousarray(flat).astype("<u2").tobytes())
        for i in range(flat.shape[0]):
            out[i] = int.from_bytes(buf[32 * i : 32 * (i + 1)], "little")
        return out.reshape(lead)
    for i, d in enumerate(flat):
        out[i] = digits_to_int(d)
    return out.reshape(lead)


def check_canonical_digits(flat: np.ndarray, msg: str) -> None:
    """Raise ValueError(msg) unless every row of the (K, N_DIGITS)
    normalized digits is < p."""
    top = flat[:, N_DIGITS - 1]
    p_top = _P_DIGITS[N_DIGITS - 1]
    if bool((top > p_top).any()):
        raise ValueError(msg)
    sus = top == p_top
    if not bool(sus.any()):
        return
    sub = flat[sus]
    ge = np.zeros(sub.shape[0], bool)
    eq = np.ones(sub.shape[0], bool)
    for i in range(N_DIGITS - 2, -1, -1):
        ge |= eq & (sub[:, i] > _P_DIGITS[i])
        eq &= sub[:, i] == _P_DIGITS[i]
    if bool((ge | eq).any()):
        raise ValueError(msg)


def u64_from_buffer(data: bytes, i: int) -> int:
    """The little-endian u64 at byte offset i (the reference's asset-decode
    helper)."""
    return int.from_bytes(data[i : i + 8], "little")


def scalar_to_bytes(x: int) -> bytes:
    """The canonical 32-byte little-endian encoding of a field element."""
    if not 0 <= x < P:
        raise ValueError("not a canonical field element")
    return int(x).to_bytes(32, "little")


def scalar_from_bytes(b: bytes) -> int:
    """Decode a canonical 32-byte little-endian scalar; a value >= p is
    rejected, as `BlsScalar::from_bytes` returns None for it."""
    if len(b) != 32:
        raise ValueError("expected 32 bytes")
    x = int.from_bytes(b, "little")
    if x >= P:
        raise ValueError("non-canonical scalar encoding")
    return x


def digits_to_bytes(digits) -> bytes:
    """(..., N_DIGITS) digits (numpy array or CPU tensor, any integer type)
    -> their concatenated 32-byte little-endian scalars.

    The little-endian uint16 buffer of normalized digits is the canonical
    encoding itself, so one cast serializes the whole array. A digit
    outside [0, 2^16) raises ValueError: the port's digits are int32, which
    can hold a negative one, and a cast would wrap it into a valid-looking
    byte pair. So does a value >= p."""
    digits = np.asarray(digits)
    if digits.size == 0:
        return b""
    if bool((digits < 0).any()) or bool((digits > DIGIT_MASK).any()):
        raise ValueError("digit outside [0, 2^16)")
    if digits.shape[-1] != N_DIGITS:  # another width: through Python ints
        return b"".join(scalar_to_bytes(v) for v in digits_to_ints(digits).reshape(-1))
    flat = digits.reshape(-1, N_DIGITS)
    check_canonical_digits(flat, "not a canonical field element: value >= p")
    return np.ascontiguousarray(flat).astype("<u2").tobytes()


def bytes_to_digits(data: bytes, shape) -> np.ndarray:
    """Concatenated 32-byte little-endian scalars -> (*shape, N_DIGITS)
    uint32 digits; a value >= p is rejected, as by `scalar_from_bytes`."""
    n = len(data) // 32
    out = np.frombuffer(bytes(data[: n * 32]), dtype="<u2").astype(np.uint32)
    out = out.reshape(n, N_DIGITS)
    check_canonical_digits(out, "non-canonical scalar encoding")
    return out.reshape(tuple(shape) + (N_DIGITS,))
