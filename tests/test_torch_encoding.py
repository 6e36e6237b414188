"""The port's byte codecs (`utils/encoding.py`) against the JAX package's:
byte-identical on every valid input, and the one repair of the port's copy,
which rejects a digit outside [0, 2^16)."""

import numpy as np
import pytest
import torch

from hades252_tpu.utils import encoding as jencoding
from hades252_tpu_torch import field
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import encoding

torch.set_num_threads(1)

EDGES = [0, 1, 2, (1 << 16) - 1, 1 << 16, (1 << 255) % P, P - 2, P - 1]


def _values(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return EDGES + [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def test_scalar_codecs_match_jax():
    for x in _values(20, 1):
        b = encoding.scalar_to_bytes(x)
        assert b == jencoding.scalar_to_bytes(x) and len(b) == 32
        assert encoding.scalar_from_bytes(b) == jencoding.scalar_from_bytes(b) == x
        assert encoding.u64_from_buffer(b, 8) == jencoding.u64_from_buffer(b, 8) == (x >> 64) % (1 << 64)
    for bad in (P, P + 1, (1 << 256) - 1, -1):
        with pytest.raises((ValueError, OverflowError)):
            encoding.scalar_to_bytes(bad)
    for fn in (encoding.scalar_from_bytes, jencoding.scalar_from_bytes):
        with pytest.raises(ValueError, match="non-canonical"):
            fn(P.to_bytes(32, "little"))
        with pytest.raises(ValueError, match="32 bytes"):
            fn(b"\0" * 31)


@pytest.mark.parametrize("shape", [(28,), (4, 7), (2, 2, 7)])
def test_digit_codecs_match_jax(shape):
    vals = _values(20, 2)
    digits = encoding.ints_to_digits(vals, shape=(28,)).reshape(shape + (16,))
    data = encoding.digits_to_bytes(digits)
    assert data == jencoding.digits_to_bytes(digits)
    assert data == b"".join(v.to_bytes(32, "little") for v in vals)
    # the port's int32 digits, as an array and as a tensor, give the same bytes
    assert encoding.digits_to_bytes(digits.astype(np.int32)) == data
    assert encoding.digits_to_bytes(torch.from_numpy(digits.astype(np.int32))) == data
    back = encoding.bytes_to_digits(data, shape)
    assert back.dtype == np.uint32 and back.shape == shape + (16,)
    assert np.array_equal(back, digits)
    assert np.array_equal(back, jencoding.bytes_to_digits(data, shape))
    assert encoding.digits_to_bytes(np.zeros((0, 16), np.int32)) == b""


def test_digits_to_bytes_of_another_width_matches_jax():
    narrow = np.array([[1, 2, 3], [0xFFFF, 0, 7]], np.uint32)
    assert encoding.digits_to_bytes(narrow) == jencoding.digits_to_bytes(narrow)


def test_digits_to_bytes_rejects_digits_outside_16_bits():
    """The JAX package's fast path tests only `< 65536`, so a negative digit
    wraps into a valid-looking byte pair; the port's int32 digits can hold
    one, and its copy rejects it."""
    good = field.np_random_elements((3,), np.random.default_rng(3)).astype(np.int32)
    for value in (-1, -65536, 65536, 1 << 20):
        bad = good.copy()
        bad[1, 4] = value
        with pytest.raises(ValueError, match=r"outside \[0, 2\^16\)"):
            encoding.digits_to_bytes(bad)
        with pytest.raises(ValueError, match=r"outside \[0, 2\^16\)"):
            encoding.digits_to_bytes(torch.from_numpy(bad))
    # what the repair is about: the original takes the negative digit
    bad = good.copy()
    bad[1, 4] = -1
    assert len(jencoding.digits_to_bytes(bad)) == 96


def test_non_canonical_values_are_rejected_both_ways():
    p_digits = np.array([[(P >> (16 * i)) & 0xFFFF for i in range(16)]], np.uint32)
    for mod in (encoding, jencoding):
        with pytest.raises(ValueError, match="value >= p"):
            mod.digits_to_bytes(p_digits)
        with pytest.raises(ValueError, match="non-canonical"):
            mod.bytes_to_digits(P.to_bytes(32, "little"), (1,))
        with pytest.raises(ValueError, match="non-canonical"):
            mod.bytes_to_digits(b"\xff" * 64, (2,))
