"""The port's field layer against `hades252_tpu.field`, exactly, on seeded
random elements plus the edge values 0, 1 and p - 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu import field as jfield
from hades252_tpu_torch import field
from hades252_tpu_torch.params import P, int_to_digits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0xF1E1D)
    edges = np.stack([int_to_digits(v) for v in (0, 1, P - 1)])
    a = np.concatenate([field.np_random_elements((64,), rng), edges, edges])
    b = np.concatenate([field.np_random_elements((64,), rng), edges, edges[::-1]])
    return a, b


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _same(ours: torch.Tensor, theirs) -> None:
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy().astype(np.uint32), np.asarray(theirs))


def test_random_elements_same_draws():
    a = field.np_random_elements((3, 4), np.random.default_rng(7))
    b = jfield.np_random_elements((3, 4), np.random.default_rng(7))
    assert a.shape == (3, 4, 16) and np.array_equal(a, b)


BINARY = ["add_mod", "sub_mod", "mul_wide", "mul_low", "mont_mul"]
UNARY = ["to_mont", "from_mont", "quintic_sbox_mont", "cond_sub_p"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_op_matches_jax(name, operands):
    a, b = operands
    _same(getattr(field, name)(_t(a), _t(b)), getattr(jfield, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", UNARY)
def test_unary_op_matches_jax(name, operands):
    a, _ = operands
    _same(getattr(field, name)(_t(a)), getattr(jfield, name)(jnp.asarray(a)))


def test_carry_normalize_matches_jax(operands):
    a, b = operands
    # un-normalized column sums: two products' columns, < 2^22
    cols = (a[:, :, None] * b[:, None, :] & 0xFFFF).astype(np.uint32)[:, :, :16].sum(-1)
    cols = np.concatenate([cols, cols], axis=-1).astype(np.uint32)
    carry, digits = field.carry_normalize(_t(cols))
    jcarry, jdigits = jfield.carry_normalize(jnp.asarray(cols))
    _same(carry, jcarry)
    _same(digits, jdigits)


def test_mont_reduce_matches_jax(operands):
    a, b = operands
    wide = np.asarray(jfield.mul_wide(jnp.asarray(a), jnp.asarray(b)))
    _same(field.mont_reduce(_t(wide)), jfield.mont_reduce(jnp.asarray(wide)))


def test_invert_matches_jax(operands):
    a, _ = operands
    a = a[::8]  # the square-and-multiply chain is ~380 products long
    inv = field.invert(_t(a))
    _same(inv, jfield.invert(jnp.asarray(a)))
    # a * a^-1 = 1 except at 0
    prod = field.from_mont(field.mont_mul(field.to_mont(_t(a)), field.to_mont(inv)))
    nonzero = (a != 0).any(-1)
    assert (prod.numpy()[nonzero] == int_to_digits(1)).all()


def test_field_rejects_other_dtypes():
    with pytest.raises(TypeError):
        field.add_mod(torch.zeros(16, dtype=torch.float32), torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError):
        field.mont_mul(torch.zeros(15, dtype=torch.int32), torch.zeros(15, dtype=torch.int32))
