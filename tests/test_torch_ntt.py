"""The port's batched NTT (ops/ntt.py) against the JAX package's and the
host transforms of plonk, exactly.

The JAX side runs eagerly (no jit), as tests/test_ntt.py runs it; both
take the same seeded digits, the port's as int32 tensors on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.ops import ntt as jntt
from hades252_tpu_torch import plonk
from hades252_tpu_torch.ops import ntt
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

torch.set_num_threads(1)

SIZES = [2, 4, 16, 64]


def _rows(rng, b, n):
    return [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)] for _ in range(b)]


def _as_rows(arr) -> list:
    """(..., n, D) digits (tensor or array) -> list of int rows over the
    flattened leading axes."""
    a = np.asarray(arr)
    return [[int(v) for v in row] for row in digits_to_ints(a.reshape(-1, *a.shape[-2:]))]


def _inputs(rng, n, lead=(2, 3)):
    rows = _rows(rng, int(np.prod(lead)), n)
    digits = ints_to_digits(rows, shape=(len(rows), n)).reshape(*lead, n, 16)
    return rows, torch.from_numpy(digits.astype(np.int32)), jnp.asarray(digits)


@pytest.mark.parametrize("n", SIZES)
def test_ntt_equals_jax_and_host(rng, n):
    """Forward and inverse over a (2, 3) batch of rows."""
    rows, x, jx = _inputs(rng, n)
    for invert in (False, True):
        got = ntt.ntt_batched(x, invert=invert)
        assert got.dtype == torch.int32 and got.shape == x.shape
        want = _as_rows(jntt.ntt_batched(jx, invert=invert))
        assert _as_rows(got) == want
        assert want == [plonk.ntt(r, invert=invert) for r in rows]


@pytest.mark.parametrize("n", SIZES)
def test_coset_transforms_equal_jax_and_host(rng, n):
    rows, x, jx = _inputs(rng, n, lead=(2,))
    ev, jev = ntt.coset_eval_batched(x, 7), jntt.coset_eval_batched(jx, 7)
    assert _as_rows(ev) == _as_rows(jev) == [plonk._coset_eval(r, n, 7) for r in rows]
    back = ntt.coset_interp_batched(ev, 7)
    assert _as_rows(back) == _as_rows(jntt.coset_interp_batched(jev, 7))
    assert _as_rows(back) == rows == [plonk._coset_interp(r, 7) for r in _as_rows(ev)]


def test_round_trip_and_leading_axes(rng):
    """(B, C, N, D), the prover's wire-column shape: the inverse undoes the
    forward, and each row equals the same row transformed alone."""
    rows, x, _ = _inputs(rng, 32, lead=(2, 2))
    fwd = ntt.ntt_batched(x)
    assert torch.equal(ntt.ntt_batched(fwd, invert=True), x)
    alone = torch.cat([ntt.ntt_batched(x[i, j : j + 1]) for i in range(2) for j in range(2)])
    assert torch.equal(fwd.reshape(4, 32, 16), alone)


@pytest.mark.parametrize("n", [1, 3, 12])
def test_size_not_a_power_of_two_raises(n):
    x = torch.zeros((2, n, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt_batched(x)
