"""The port's permutation against the JAX package: the torch oracle against
`ops.perm_ref.permute`, and the plain versions of the CUDA kernels against
the JAX package's own CPU harness for its Pallas kernels
(`permute_planar_emulated`), all exact. The kernels themselves run only on
a CUDA card; their tests are in test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu.ops import perm_pallas
from hades252_tpu.ops.perm_pallas import permute_planar_emulated
from hades252_tpu.ops.perm_ref import permute as jax_permute
from hades252_tpu_torch import field, selftest
from hades252_tpu_torch.ops import perm_cuda
from hades252_tpu_torch.ops.perm_ref import permute, permute_mont
from hades252_tpu_torch.params import P
from hades252_tpu_torch.strategy import ScalarStrategy
from hades252_tpu_torch.utils.encoding import digits_to_ints, ints_to_digits

torch.set_num_threads(1)


def _states(n: int, seed: int) -> np.ndarray:
    """(n, 5, 16) uint32 canonical states from a seed."""
    return field.np_random_elements((n, 5), np.random.default_rng(seed))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def test_oracle_matches_jax_oracle():
    x = _states(8, 1)
    x[0] = ints_to_digits([[0, 1, P - 1, P - 2, 0]], shape=(1, 5))[0]
    ours = permute(_t(x))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(jax_permute(jnp.asarray(x))))


def test_oracle_kats():
    inputs = ints_to_digits([list(k) for k in selftest.KATS], shape=(4, 5))
    out = permute(_t(inputs))
    for row, expected in zip(out.numpy(), selftest.KATS.values()):
        assert tuple(digits_to_ints(row)) == expected


def test_oracle_mont_path():
    x = _t(_states(3, 2))
    assert torch.equal(field.from_mont(permute_mont(field.to_mont(x))), permute(x))


@pytest.mark.parametrize("schedule", ["naive", "opt", "mxu8", "mxu"])
@pytest.mark.parametrize("convert", [True, False])
def test_plain_kernel_matches_jax_kernel_harness(schedule, convert):
    x = np.ascontiguousarray(_states(128, 3).transpose(1, 2, 0))  # planar (5, 16, B)
    ours = perm_cuda.permute_planar_plain(_t(x), convert=convert, schedule=schedule)
    theirs = permute_planar_emulated(x, convert=convert, schedule=schedule)
    assert ours.dtype == torch.int32 and ours.shape == (5, 16, 128)
    assert np.array_equal(ours.numpy().astype(np.uint32), theirs)


@pytest.mark.parametrize("convert", [True, False])
def test_plain_mxu8_matches_jax_kernel_harness_ragged(convert):
    x = np.ascontiguousarray(_states(37, 6).transpose(1, 2, 0))
    ours = perm_cuda.permute_planar_plain(_t(x), convert=convert, schedule="mxu8")
    theirs = permute_planar_emulated(x, convert=convert, schedule="mxu8")
    assert np.array_equal(ours.numpy().astype(np.uint32), theirs)


@pytest.mark.parametrize("b", [8, 5])
@pytest.mark.parametrize("schedule", ["hyb", "hybp", "hyb13", "hybp13"])
@pytest.mark.parametrize("convert", [True, False])
def test_plain_chain_kernel_matches_jax_harness_and_oracles(schedule, convert, b):
    """Plain hyb, hybp, hyb13 and hybp13 against the JAX package's numpy harness for the
    same kernel bodies, the torch oracle and the int oracle, with the edge
    words 0 and p - 1; tolerance 0."""
    x = _states(b, 40 + b)
    x[0] = ints_to_digits([[0, P - 1, 0, P - 1, 1]], shape=(1, 5))[0]
    x[1] = ints_to_digits([[P - 1] * 5], shape=(1, 5))[0]
    if not convert:
        x = field.to_mont(_t(x)).numpy().astype(np.uint32)
    planar = np.ascontiguousarray(x.transpose(1, 2, 0))
    ours = perm_cuda.permute_planar_plain(_t(planar), convert=convert, schedule=schedule)
    assert ours.dtype == torch.int32 and ours.shape == (5, 16, b)
    theirs = permute_planar_emulated(planar, convert=convert, schedule=schedule)
    assert np.array_equal(ours.numpy().astype(np.uint32), theirs)
    batch_major = ours.permute(2, 0, 1)
    assert torch.equal(batch_major, (permute if convert else permute_mont)(_t(x)))
    canonical = batch_major if convert else field.from_mont(batch_major)
    inputs = _t(x) if convert else field.from_mont(_t(x))
    strat = ScalarStrategy()
    for row_in, row_out in zip(inputs.numpy(), canonical.numpy()):
        assert strat.perm([int(v) for v in digits_to_ints(row_in)]) == [
            int(v) for v in digits_to_ints(row_out)]


@pytest.mark.parametrize("n_subs,k", [(2, 6), (4, 32), (5, 65)])
def test_redc_wide_big_matches_jax(n_subs, k):
    """The big REDC of a lazy sum of k products against the JAX package's,
    on its numpy path, with the ladder depth that k warrants."""
    b = 24
    elems = [_states(b, 60 + i)[:, 0].T.copy() for i in range(8)]  # (16, b) digits < p
    token = perm_pallas._EMULATE.set(True)
    try:
        ops = _jax_mxu_ops()
        one = perm_pallas._mul_cols(elems[0], elems[1], 2 * 16 + 1, None).astype(np.uint64)
        cols = (one * k).astype(np.uint32)        # k equal products: T < k p^2
        t33 = perm_pallas._carry_lo(cols)
        pmul = perm_pallas._const_arrays_hyb()[14]
        theirs = perm_pallas._redc_wide_big(t33, ops, pmul, n_subs)
    finally:
        perm_pallas._EMULATE.reset(token)
    plain = perm_cuda._chain_plain_tables(torch.device("cpu"), False)
    ours = perm_cuda._redc_wide_big(torch.from_numpy(t33.T.astype(np.int64)), plain["pmul17"],
                                    n_subs)
    assert ours.shape == (b, 16)
    assert np.array_equal(ours.numpy().T, theirs.astype(np.int64))


def test_recombine16_wide_matches_jax():
    cols = np.random.default_rng(13).integers(0, 1 << 27, (63, 9)).astype(np.uint32)
    token = perm_pallas._EMULATE.set(True)
    try:
        theirs = perm_pallas._recombine16_wide(cols)
    finally:
        perm_pallas._EMULATE.reset(token)
    ours = perm_cuda._recombine16_wide(torch.from_numpy(cols.T.astype(np.int64)))
    assert ours.shape == (9, 33)
    assert np.array_equal(ours.numpy().T, theirs.astype(np.int64))


def _jax_mxu_ops():
    """The JAX package's mxu8 machinery on its numpy emulation path."""
    ark, fc, w_lin, w_pp, w_p, rs_lin, rs_pp, rs_p = perm_pallas._const_arrays_mxu8()
    dot = lambda w, rs: lambda xb: perm_pallas._dot_u32_i8(w, rs, xb)  # noqa: E731
    return perm_pallas._MxuOps(ark, fc, dot(w_lin, rs_lin), dot(w_pp, rs_pp), dot(w_p, rs_p))


def _below_2p(b: int, seed: int) -> np.ndarray:
    """(16, b) digits of values in [p, 2p): the S-box's un-normalised x^2
    and x^4, with 2p - 1, 2p - 2 and p itself among them."""
    rng = np.random.default_rng(seed)
    vals = [2 * P - 1, 2 * P - 2, P] + [P + int.from_bytes(rng.bytes(40), "little") % P
                                        for _ in range(b - 3)]
    digits = [[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals]
    return np.asarray(digits, np.uint32).T.copy()


@pytest.mark.parametrize("inputs", ["canonical", "below 2p"])
def test_base13_products_match_jax(inputs):
    """_to13, _sqr13_cols, _mul13_cols and _cols13_to16 against the JAX
    package's on its numpy path, value for value, on canonical inputs and on
    un-normalised ones just below 2p (which need all 20 digits)."""
    b = 12
    if inputs == "canonical":
        a16, b16 = (_states(b, 70 + i)[:, 0].T.copy() for i in range(2))
    else:
        a16, b16 = _below_2p(b, 72), _below_2p(b, 73)[:, ::-1].copy()
    ta, tb = (torch.from_numpy(v.T.astype(np.int64)) for v in (a16, b16))
    token = perm_pallas._EMULATE.set(True)
    try:
        ja, jb = perm_pallas._to13(a16), perm_pallas._to13(b16)
        jsq, jmul = perm_pallas._sqr13_cols(ja), perm_pallas._mul13_cols(ja, jb)
        jsq16, jmul16 = perm_pallas._cols13_to16(jsq), perm_pallas._cols13_to16(jmul)
    finally:
        perm_pallas._EMULATE.reset(token)
    oa, ob = perm_cuda._to13(ta), perm_cuda._to13(tb)
    assert oa.shape == (b, 20) and oa.dtype == torch.int64
    assert np.array_equal(oa.numpy().T, ja) and np.array_equal(ob.numpy().T, jb)
    osq, omul = perm_cuda._sqr13_cols(oa), perm_cuda._mul13_cols(oa, ob)
    assert osq.shape == omul.shape == (b, 39)
    assert np.array_equal(osq.numpy().T, jsq) and np.array_equal(omul.numpy().T, jmul)
    osq16, omul16 = perm_cuda._cols13_to16(osq), perm_cuda._cols13_to16(omul)
    assert np.array_equal(osq16.numpy().T, jsq16) and np.array_equal(omul16.numpy().T, jmul16)
    # the columns carry the exact products
    for row in range(b):
        x, y = (sum(int(v) << (16 * i) for i, v in enumerate(col)) for col in (a16[:, row],
                                                                               b16[:, row]))
        assert sum(int(v) << (16 * i) for i, v in enumerate(osq16[row])) == x * x
        assert sum(int(v) << (13 * i) for i, v in enumerate(omul[row])) == x * y


def test_base13_bounds_are_asserted():
    """The three bounds of the JAX bodies (columns and squares below 2^31,
    repacked sums below 2^18) are asserted, not assumed."""
    big = torch.full((1, 20), (1 << 14) - 1, dtype=torch.int64)
    with pytest.raises(AssertionError, match="column overflow"):
        perm_cuda._mul13_cols(big, big)
    with pytest.raises(AssertionError, match="square overflow"):
        perm_cuda._sqr13_cols(big)
    with pytest.raises(AssertionError, match="repack overflow"):
        perm_cuda._cols13_to16(torch.full((1, 39), 1 << 40, dtype=torch.int64))


@pytest.mark.parametrize("sbox13", [False, True])
def test_sbox_words_matches_jax(sbox13):
    """x^5 through the dots, with and without the base-2^13 products,
    against `_MxuOps.sbox_words` on the numpy path, with 0, 1 and p - 1."""
    b = 16
    x = _states(b, 80)[:, 0]
    x[:3] = ints_to_digits([0, 1, P - 1])
    token = perm_pallas._EMULATE.set(True)
    try:
        ops = _jax_mxu_ops()
        ops.sbox13 = sbox13
        theirs = ops.sbox_words([x.T.copy()])[0]
    finally:
        perm_pallas._EMULATE.reset(token)
    ours = perm_cuda._sbox_words(torch.from_numpy(x.astype(np.int64)), sbox13=sbox13)
    assert np.array_equal(ours.numpy().T, theirs.astype(np.int64))
    ours32 = perm_cuda._sbox_words(torch.from_numpy(x.astype(np.int64)), sbox13=sbox13, f32=True)
    assert torch.equal(ours, ours32)


def test_dot_bytes_f32_matches_jax_f32_dot_and_asserts_its_bound():
    """The mxu plain dot (float32 weights) against `_dot_u32` on the numpy
    path, all-255 operands at K = 160 included; a sum of 2^24 trips the
    bound as it trips the JAX body's."""
    consts = perm_pallas._const_arrays_mxu(as_bf16=False)
    plain = perm_cuda._mxu8_plain_tables(torch.device("cpu"), True)
    rng = np.random.default_rng(15)
    token = perm_pallas._EMULATE.set(True)
    try:
        for key, w in zip(("w_lin", "w_pp", "w_p"), consts[2:]):
            assert plain[key].dtype == torch.float32
            xb = rng.integers(0, 256, (w.shape[1], 50)).astype(np.uint32)
            xb[:, 0] = 255
            theirs = perm_pallas._dot_u32(w, perm_pallas._bytes_cast(xb))
            ours = perm_cuda._dot_bytes(plain[key], torch.from_numpy(xb.T.astype(np.int64)))
            assert ours.dtype == torch.int64
            assert np.array_equal(ours.numpy().T, theirs.astype(np.int64)), key
    finally:
        perm_pallas._EMULATE.reset(token)
    full = torch.full((4, 160), 255.0, dtype=torch.float32)
    got = perm_cuda._dot_bytes(full, torch.full((3, 160), 255, dtype=torch.int64))
    assert got.tolist() == [[160 * 255 * 255] * 4] * 3
    with pytest.raises(AssertionError, match="exactness bound"):
        perm_cuda._dot_bytes(torch.full((1, 259), 255.0), torch.full((1, 259), 255))


def test_dot_bytes_matches_jax_int8_dot():
    consts = perm_pallas._const_arrays_mxu8()
    plain = perm_cuda._mxu8_plain_tables(torch.device("cpu"))
    rng = np.random.default_rng(11)
    token = perm_pallas._EMULATE.set(True)
    try:
        for key, w_s8, rs in zip(("w_lin", "w_pp", "w_p"), consts[2:5], consts[5:]):
            xb = rng.integers(0, 256, (w_s8.shape[1], 50)).astype(np.uint32)
            theirs = perm_pallas._dot_u32_i8(w_s8, rs, xb)
            ours = perm_cuda._dot_bytes(plain[key], torch.from_numpy(xb.T.astype(np.int64)))
            assert ours.dtype == torch.int64
            assert np.array_equal(ours.numpy().T, theirs.astype(np.int64)), key
    finally:
        perm_pallas._EMULATE.reset(token)


@pytest.mark.parametrize("wide,normalize", [(True, True), (False, True), (False, False)])
def test_redc_words_matches_jax(wide, normalize):
    b = 40
    elems = [_states(b, 30 + k)[:, 0].T.copy() for k in range(10)]  # (16, b) digits < p
    token = perm_pallas._EMULATE.set(True)
    try:
        ops = _jax_mxu_ops()
        if wide:  # a lazy sum of 5 products: T < 5p^2, 33 columns
            cols = None
            for k in range(5):
                cols = perm_pallas._mul_cols(elems[k], elems[5 + k], 2 * 16 + 1, cols)
            theirs = perm_pallas._redc_words_mxu([cols], ops.dot_pp, ops.dot_p, ops.p,
                                                 ops.p17, ops.twop17, wide=True)[0]
        else:  # an S-box square: T < p^2, 32 columns
            cols = perm_pallas._sqr_cols(elems[0])
            theirs = ops.redc_words([cols], normalize=normalize)[0]
    finally:
        perm_pallas._EMULATE.reset(token)
    ours = perm_cuda._redc_words(torch.from_numpy(cols.T.astype(np.int64)), wide=wide,
                                 normalize=normalize)
    assert ours.shape == (b, 16)
    assert np.array_equal(ours.numpy().T, theirs.astype(np.int64))


@functools.cache
def _oracle_outputs(b: int):
    """(x, permute(x), to_mont(x), permute_mont(to_mont(x))) for b states."""
    x = _t(_states(b, 10 + b))
    xm = field.to_mont(x)
    return x, permute(x), xm, permute_mont(xm)


@pytest.mark.parametrize("b", [1, 5, 130])
@pytest.mark.parametrize("schedule", perm_cuda.SCHEDULES)
def test_batch_major_wrappers_on_cpu(b, schedule):
    x, want, xm, want_m = _oracle_outputs(b)
    perm_cuda.reset_launches()
    out = perm_cuda.permute_cuda(x, schedule=schedule)
    assert out.shape == (b, 5, 16) and out.dtype == torch.int32
    assert torch.equal(out, want)
    assert torch.equal(perm_cuda.permute_cuda_mont(xm, schedule=schedule), want_m)
    # the CPU takes the plain version: no kernel was launched
    assert perm_cuda.launches == {s: 0 for s in perm_cuda.SCHEDULES}


def test_scalar_strategy_batched_ref_backend():
    x, want, _, _ = _oracle_outputs(5)
    assert torch.equal(ScalarStrategy().perm(x.numpy().astype(np.uint32)), want)
    assert torch.equal(ScalarStrategy("ref").perm(x[None]), want[None])
    with pytest.raises(ValueError):
        ScalarStrategy("pallas")


def test_wrapper_rejects_bad_input():
    x = _t(_states(2, 4))
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x.to(torch.int64))
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x[:, :4])
    with pytest.raises(ValueError):
        perm_cuda.permute_cuda(x, schedule="hybp16")
    with pytest.raises(ValueError):
        perm_cuda.permute_planar(x.permute(1, 2, 0).to("meta"))


def test_kernel_tables_layout():
    tables = perm_cuda.kernel_tables()
    # p, R^2, dense ARK and MDS, then ark_fr, c0, u, w, m, d, final
    words = 8 * (1 + 1 + 67 * 5 + 25 + 8 * 5 + 5 + 59 * 4 * 2 + 1 + 59 * 5 + 16)
    assert tables.dtype == np.uint32 and tables.shape == (words,)


def test_mxu8_kernel_tables_layout():
    consts, weights = perm_cuda.mxu8_kernel_tables()
    assert consts.dtype == np.uint32 and consts.shape == (8 * (67 * 5 + 1),)
    assert weights.dtype == np.uint8 and weights.shape == (320 * 160 + 32 * 32 + 64 * 32,)
    # every padding row of the 64-row blocks is zero
    w_lin = weights[: 320 * 160].reshape(5, 64, 160)
    assert not w_lin[:, 63].any() and w_lin[:, :63].any()
    assert not weights[-32:].any()


def test_hyb_kernel_tables_layout():
    mxu8_consts, mxu8_weights = perm_cuda.mxu8_kernel_tables()
    for schedule, new in (("hyb", 0), ("hybp", 59 * 64 * 32)):
        consts, weights, chain = perm_cuda.hyb_kernel_tables(schedule)
        assert consts.dtype == np.uint32 and consts.shape == (8 * (67 * 5 + 2),)
        assert np.array_equal(consts[:-8], mxu8_consts) and np.array_equal(weights, mxu8_weights)
        # R mod p closes the consts
        assert sum(int(v) << (32 * i) for i, v in enumerate(consts[-8:])) == (1 << 256) % P
        assert chain.dtype == np.uint8
        assert chain.shape == (27 * 64 * 1024 + 32 * 64 * 2048 + new + 320 * 2112,)
        assert chain.size % 16 == 0


@pytest.mark.parametrize("dot", [perm_cuda.mxu8_dot, perm_cuda.mxu_dot])
def test_mxu8_dot_on_cpu(dot):
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.integers(0, 256, (20, 40)).astype(np.uint8))
    x = torch.from_numpy(rng.integers(0, 256, (40, 7)).astype(np.uint8))
    got = dot(w, x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), w.numpy().astype(np.int64) @ x.numpy().astype(np.int64))
    with pytest.raises(ValueError):
        dot(w.to(torch.int32), x)
    with pytest.raises(ValueError):
        dot(torch.zeros((321, 32), dtype=torch.uint8), torch.zeros((32, 1), dtype=torch.uint8))


def test_schedules_cover_the_jax_package():
    """Every schedule that perm_pallas dispatches on has its counterpart."""
    assert sorted(perm_cuda.SCHEDULES) == sorted(
        ["naive", "opt", "mxu", "mxu8", "hyb", "hybp", "hyb13", "hybp13"])
    assert set(perm_cuda._PLAIN) == set(perm_cuda.launches) == set(perm_cuda.SCHEDULES)
    x = np.zeros((5, 16, 128), np.uint32)
    for schedule in perm_cuda.SCHEDULES:
        perm_pallas.default_block(schedule)  # the JAX package knows the name
    with pytest.raises(ValueError):
        permute_planar_emulated(x, schedule="hybp16")
