"""The port's constant tables, int oracle and KAT vectors against the JAX
package's, bit for bit."""

import numpy as np
import pytest
import torch

from hades252_tpu import params as jparams
from hades252_tpu.ops.perm_pallas import _const_arrays_mxu, _const_arrays_mxu8
from hades252_tpu import selftest as jselftest
from hades252_tpu.strategy import ScalarStrategy as JaxScalarStrategy
from hades252_tpu_torch import params, selftest
from hades252_tpu_torch.ops import perm_cuda
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


def test_dot_schedule_matches():
    ours, theirs = params.dot_schedule_int(), jparams.dot_schedule_int()
    assert ours == theirs
    assert [len(a) for a in ours["alpha"]] == [6 + r for r in range(59)]
    assert len(ours["omega"]) == 5 and all(len(row) == 65 for row in ours["omega"])
    for name in ("HYB_SEG1_ROUNDS", "HYB_SEG1_ELEMS", "HYB_SEG2_ELEMS", "HYB_N_BASIS"):
        assert getattr(params, name) == getattr(jparams, name), name


_CHAIN = {
    "hyb": (params.hyb_weights_np, params.hyb_tables, params.from_jax_hyb_tables,
            jparams.hyb_weights_np, ("w_seg1", "w_seg2", "w_out")),
    "hybp": (params.hybp_weights_np, params.hybp_tables, params.from_jax_hybp_tables,
             jparams.hybp_weights_np, ("wo_seg1", "wo_seg2", "w_new", "w_out")),
}


@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_chain_weights_match_jax_offset_weights(schedule):
    """The port's unsigned weights are the JAX package's int8 weights plus
    128, key by key; the ladder and R mod p are equal."""
    ours_fn, _, _, theirs_fn, keys = _CHAIN[schedule]
    ours, theirs = ours_fn(), theirs_fn()
    assert sorted(ours) == sorted(k for k in theirs if not k.startswith("rs"))
    for key in keys:
        assert ours[key].dtype == np.uint8 and theirs[key].dtype == np.int8, key
        assert np.array_equal(ours[key].astype(np.int32) - 128, theirs[key].astype(np.int32)), key
    for key in ("pmul17", "one_mont"):
        assert ours[key].dtype == theirs[key].dtype == np.uint32, key
        assert np.array_equal(ours[key], theirs[key]), key


@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_from_jax_chain_tables_reproduce_port_tables(schedule):
    _, own_fn, carry, theirs_fn, keys = _CHAIN[schedule]
    carried, ours = carry(theirs_fn()), own_fn()
    assert sorted(carried) == sorted(ours) == sorted(keys + ("one_mont",))
    for key, t in ours.items():
        assert t.dtype == carried[key].dtype, key
        assert np.array_equal(t, carried[key]), key  # byte for byte
    assert ours[keys[0]].shape == (27, 64, 1024) and ours[keys[1]].shape == (32, 64, 2048)
    assert ours["w_out"].shape == (320, 2112)  # K padded by one zero element block
    if schedule == "hybp":
        assert ours["w_new"].shape == (59, 64, 32) and not ours["w_new"][0].any()


@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_chain_tables_padding_absent_coefficients_and_bounds(schedule):
    _, own_fn, _, _, keys = _CHAIN[schedule]
    t = own_fn()
    seg1, seg2 = t[keys[0]], t[keys[1]]
    w_out = t["w_out"].reshape(5, 64, 2112)
    assert not w_out[:, :, 2080:].any() and w_out[:, :63, 2048:2080].any()
    # every padding row of the 64-row blocks is zero
    assert not seg1[:, 63].any() and not seg2[:, 63].any() and not w_out[:, 63].any()
    # round r uses basis elements [:6 + r] (hybp: without the newest, which
    # w_new carries): every block beyond them is zero
    for r in range(59):
        w = seg1[r] if r < 27 else seg2[r - 27]
        used = 6 + r - (1 if schedule == "hybp" and r > 0 else 0)
        assert not w[:, 32 * used :].any(), r
        assert w[:, : 32 * used].any(), r
    # a column sum is at most the row's weight sum times 255: below 2^27,
    # so int32 sums and the 64-bit recombine are exact
    for key in keys:
        assert int(t[key].sum(axis=-1, dtype=np.int64).max()) * 255 < 1 << 27, key
    if schedule == "hybp":  # the two dots of a round are summed before the REDC
        both = seg2.sum(axis=-1, dtype=np.int64) + t["w_new"][27:].sum(axis=-1, dtype=np.int64)
        assert int(both.max()) * 255 < 1 << 27


@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_from_jax_chain_tables_check_row_sums_and_ladder(schedule):
    _, _, carry, theirs_fn, keys = _CHAIN[schedule]
    theirs = dict(theirs_fn())
    bad = dict(theirs)
    bad["rs" + keys[0][1:]] = theirs["rs" + keys[0][1:]] + 1
    with pytest.raises(ValueError, match="row sums"):
        carry(bad)
    bad = dict(theirs)
    bad["pmul17"] = theirs["pmul17"][::-1]
    with pytest.raises(ValueError, match="pmul17"):
        carry(bad)


def test_chain_weights_in_natural_byte_order():
    """A round's weights times the basis bytes, in natural order, give the
    base-256 columns of sum_j alpha[r][j] R e_j: the lazy sum whose REDC is
    the S-box input."""
    r = 30
    alpha = params.dot_schedule_int()["alpha"][r]
    rng = np.random.default_rng(15)
    basis = [int.from_bytes(rng.bytes(40), "little") % params.P for _ in range(6 + r)]
    yb = np.zeros(2048, np.int64)
    for j, e in enumerate(basis):
        yb[32 * j : 32 * (j + 1)] = np.frombuffer(e.to_bytes(32, "little"), np.uint8)
    cols = params.hyb_tables()["w_seg2"][r - 27].astype(np.int64) @ yb
    value = sum(int(c) << (8 * i) for i, c in enumerate(cols))
    assert value == sum(a * params.R_MOD_P % params.P * e for a, e in zip(alpha, basis))
    # hybp: the older elements' dot plus the newest element's gives the same
    tp = params.hybp_tables()
    cols_p = tp["wo_seg2"][r - 27].astype(np.int64) @ yb
    cols_p += tp["w_new"][r].astype(np.int64) @ yb[32 * (5 + r) : 32 * (6 + r)]
    assert np.array_equal(cols_p, cols)


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


def test_from_jax_mxu_tables_reproduces_port_tables():
    """The JAX package's mxu constants (float32 byte weights) carried across
    equal the port's own mxu tables, which are mxu8's: the mxu kernel keeps
    bytes in shared memory and widens them to bf16 in registers."""
    consts = tuple(np.asarray(a) for a in _const_arrays_mxu(as_bf16=False))
    carried, ours = params.from_jax_mxu_tables(consts), params.mxu_tables()
    assert sorted(carried) == sorted(ours) == sorted(params.mxu8_tables())
    for key, want in ours.items():
        assert carried[key].dtype == want.dtype and np.array_equal(carried[key], want), key
        assert np.array_equal(want, params.mxu8_tables()[key]), key
    assert ours["w_lin"].dtype == np.uint8 and ours["w_lin"].shape == (320, 160)
    # every weight is exact in bf16 (8 significant bits) and a column's sum in float32
    assert int(ours["w_lin"].max()) <= 255 and 160 * 255 * 255 < 1 << 24


def test_from_jax_mxu_tables_rejects_other_tables():
    consts = [np.asarray(a) for a in _const_arrays_mxu(as_bf16=False)]
    with pytest.raises(ValueError, match="5 arrays"):
        params.from_jax_mxu_tables(consts[:4])
    for i, match in ((1, "modulus"), (2, "w_lin"), (4, "w_p")):
        bad = [a.copy() for a in consts]
        bad[i][0, 0] += 1
        with pytest.raises(ValueError, match=match):
            params.from_jax_mxu_tables(bad)
    bad = [a.copy() for a in consts]
    bad[3][0, 0] = 0.5
    with pytest.raises(ValueError, match="not a table of bytes"):
        params.from_jax_mxu_tables(bad)
    bad = [a.copy() for a in consts]
    bad[0][0, 0, 0] ^= 1
    with pytest.raises(ValueError, match="ark_mont"):
        params.from_jax_mxu_tables(bad)


@pytest.mark.parametrize("schedule", ["hyb", "hybp"])
def test_base13_schedules_take_the_chain_tables_unchanged(schedule):
    """hyb13 and hybp13 have no table of their own: the kernels' and the
    plain versions' tables are hyb's and hybp's, as the JAX package passes
    the same constants for sbox13=True (perm_pallas.py:1333-1342)."""
    for ours, theirs in zip(perm_cuda.hyb_kernel_tables(schedule + "13"),
                            perm_cuda.hyb_kernel_tables(schedule)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    mxu_consts, mxu_weights = perm_cuda.mxu8_kernel_tables()
    assert np.array_equal(perm_cuda.hyb_kernel_tables(schedule + "13")[1], mxu_weights)
