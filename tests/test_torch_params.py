"""The port's constant tables, int oracle and KAT vectors against the JAX
package's, bit for bit."""

import numpy as np
import pytest
import torch

from hades252_tpu import params as jparams
from hades252_tpu.ops.perm_pallas import _const_arrays_mxu8
from hades252_tpu import selftest as jselftest
from hades252_tpu.strategy import ScalarStrategy as JaxScalarStrategy
from hades252_tpu_torch import params, selftest
from hades252_tpu_torch.ops.perm_cuda import kernel_tables
from hades252_tpu_torch.strategy import ScalarStrategy

torch.set_num_threads(1)


def test_scalar_constants_match():
    for name in ("WIDTH", "TOTAL_FULL_ROUNDS", "PARTIAL_ROUNDS", "ROUNDS", "P", "R",
                 "R_MOD_P", "R2_MOD_P", "P_PRIME", "N_DIGITS", "DIGIT_BITS"):
        assert getattr(params, name) == getattr(jparams, name), name


def test_assets_decode_identically():
    assert params.round_constants_int() == jparams.round_constants_int()
    assert params.mds_matrix_int() == jparams.mds_matrix_int()
    assert params.optimized_partial_int() == jparams.optimized_partial_int()


def _assert_tables_equal(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype == np.uint32, key
        assert np.array_equal(ours[key], theirs[key]), key


def test_perm_constants_match():
    _assert_tables_equal(params.perm_constants_np(), jparams.perm_constants_np())


def test_opt_schedule_matches():
    _assert_tables_equal(params.opt_schedule_np(), jparams.opt_schedule_np())


def test_from_jax_tables_reproduces_port_tables():
    carried = params.from_jax_tables(jparams.perm_constants_np(), jparams.opt_schedule_np())
    ours = params.perm_tables()
    assert sorted(carried) == sorted(ours)
    for key, t in ours.items():
        assert t.dtype == carried[key].dtype == torch.int32, key
        assert torch.equal(t, carried[key]), key


def test_mxu_weights_match():
    ours, theirs = params.mxu_weights_np(), jparams.mxu_weights_np()
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype == np.float32, key
        assert np.array_equal(ours[key], theirs[key]), key


def test_from_jax_mxu8_tables_reproduces_port_tables():
    carried = params.from_jax_mxu8_tables(_const_arrays_mxu8())
    ours = params.mxu8_tables()
    assert sorted(carried) == sorted(ours) == ["ark_mont", "r2", "w_lin", "w_p", "w_pp"]
    for key, t in ours.items():
        assert t.dtype == carried[key].dtype, key
        assert np.array_equal(t, carried[key]), key
    assert ours["w_lin"].shape == (320, 160) and ours["w_p"].shape == (64, 32)


def test_from_jax_mxu8_tables_checks_row_sums():
    consts = list(_const_arrays_mxu8())
    consts[6] = consts[6] + 1  # w_pp's row sums
    with pytest.raises(ValueError, match="row sums"):
        params.from_jax_mxu8_tables(tuple(consts))


def test_mxu8_weights_in_natural_byte_order():
    """Row c of w_pp times the bytes of x, in natural order, gives the
    base-256 columns of x p' mod R; w_p's those of x p."""
    t = params.mxu8_tables()
    x = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321_1111_2222_3333_4444_5555_6666_7777_8888
    xb = np.frombuffer(x.to_bytes(32, "little"), np.uint8).astype(np.int64)
    value = lambda cols: sum(int(c) << (8 * i) for i, c in enumerate(cols))  # noqa: E731
    assert value(t["w_pp"].astype(np.int64) @ xb) % params.R == x * params.P_PRIME % params.R
    assert value(t["w_p"].astype(np.int64) @ xb) == x * params.P


def test_word_level_montgomery_constant():
    limbs = params.digits_to_limbs(params.perm_constants_np()["p"])
    assert int(limbs[0]) == 1
    assert params.P_PRIME_WORD == 0xFFFFFFFF
    assert (params.P * params.P_PRIME_WORD) % (1 << 32) == (1 << 32) - 1
    # the kernel tables open with p, low limb first
    assert np.array_equal(kernel_tables()[:8], limbs)
    assert sum(int(v) << (32 * i) for i, v in enumerate(limbs)) == params.P


def test_int_oracle_matches_jax(rng):
    ours, theirs = ScalarStrategy(), JaxScalarStrategy()
    states = [list(k) for k in selftest.KATS]
    states += [[int(rng.integers(0, 1 << 62)) * (i + 1) % params.P for i in range(5)]
               for _ in range(16)]
    for s in states:
        assert ours.perm(list(s)) == theirs.perm(list(s)), s
    for inp, out in selftest.KATS.items():
        assert tuple(ours.perm(list(inp))) == out


def test_selftest_vectors_match_jax():
    for a, b in zip(selftest._vectors(), jselftest._vectors()):
        assert a.dtype == b.dtype == np.uint32
        assert np.array_equal(a, b)
