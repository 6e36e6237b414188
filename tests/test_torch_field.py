"""The port's field layer against `hades252_tpu.field`, exactly, on seeded
random elements plus the edge values 0, 1 and p - 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hades252_tpu import field as jfield
from hades252_tpu_torch import field
from hades252_tpu_torch.params import P, int_to_digits
from hades252_tpu_torch.utils.encoding import digits_to_ints

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


@pytest.mark.parametrize("mont_in", [False, True])
def test_field_cuda_invert_on_the_cpu_is_the_plain_composition(operands, monkeypatch, mont_in):
    """ops/field_cuda.invert on a CPU tensor: field.invert between the
    conversions, bit for bit, in the callers' forms (DEEP's canonical in,
    phase 2's Montgomery in; the Montgomery form out), the result a^-1 R,
    0 for 0 (DEEP's x - point = 0 included), and no kernel launched."""
    from hades252_tpu_torch.ops import field_cuda

    a, _ = operands
    x = _t(a[::8])
    zero = field.sub_mod(x[:1], x[:1])  # x - point with the point x itself
    x = torch.cat([x, zero])
    given = field.to_mont(x) if mont_in else x
    monkeypatch.setattr(field_cuda, "launches", 0)
    monkeypatch.setattr(field_cuda, "inverted", 0)
    got = field_cuda.invert(given, mont_in=mont_in)
    if mont_in:
        assert torch.equal(got, field.to_mont(field.invert(field.from_mont(given))))
    else:
        assert torch.equal(got, field.to_mont(field.invert(given)))
    want = [pow(int(v), P - 2, P) * (1 << 256) % P
            for v in digits_to_ints(x.numpy().astype(np.uint32))]
    assert [int(v) for v in digits_to_ints(got.numpy().astype(np.uint32))] == want
    assert field_cuda.launches == 0 and field_cuda.inverted == 0


def test_field_cuda_invert_rejects_what_the_kernel_cannot_take():
    from hades252_tpu_torch.ops import field_cuda

    with pytest.raises(ValueError):
        field_cuda.invert(torch.zeros((2, 16), dtype=torch.int64), mont_in=False)
    with pytest.raises(ValueError):
        field_cuda.invert(torch.zeros((2, 15), dtype=torch.int32), mont_in=False)
    with pytest.raises(ValueError):
        field_cuda.invert(torch.zeros((2, 16), dtype=torch.int32, device="meta"), mont_in=False)
    assert field_cuda.invert(torch.zeros((0, 16), dtype=torch.int32), mont_in=True).shape == (0, 16)


def _layouts(a: np.ndarray) -> dict:
    """The digit tensors the conversions' callers pass: rows, a column of a
    permutation's (K, 5, 16) output (rows 80 digits apart, the Merkle
    verifier's node), one element, and a batch of messages."""
    x = _t(a)
    states = torch.stack([x] * 5, dim=1)
    return {"rows": x, "strided_rows": states[:, 1], "one": x[3],
            "batched": x[:70].reshape(2, 35, 16)}


@pytest.mark.parametrize("to", [True, False])
@pytest.mark.parametrize("layout", ["rows", "strided_rows", "one", "batched"])
def test_field_cuda_convert_on_the_cpu_is_field_s(operands, monkeypatch, to, layout):
    """ops/field_cuda.to_mont / from_mont on a CPU tensor: field's own
    conversion, bit for bit, on each layout the callers pass, a contiguous
    result of the input's shape, and no kernel launched."""
    from hades252_tpu_torch.ops import field_cuda

    x = _layouts(operands[0])[layout]
    monkeypatch.setattr(field_cuda, "conversions", 0)
    monkeypatch.setattr(field_cuda, "converted", 0)
    got = (field_cuda.to_mont if to else field_cuda.from_mont)(x)
    assert torch.equal(got, (field.to_mont if to else field.from_mont)(x))
    assert got.shape == x.shape and got.is_contiguous()
    assert field_cuda.conversions == 0 and field_cuda.converted == 0


def test_field_cuda_to_mont_pads_rows_with_zeros(operands):
    """to_mont of leaves zero-padded to a power of four, as the Merkle build
    converts them, is their conversion followed by zero rows (0 is its own
    Montgomery form)."""
    from hades252_tpu_torch.models.merkle import _pad_to_pow4
    from hades252_tpu_torch.ops import field_cuda

    x = _t(operands[0][:13])
    got = field_cuda.to_mont(_pad_to_pow4(x))
    assert got.shape == (16, 16) and not got[13:].any()
    assert torch.equal(got[:13], field.to_mont(x))


def test_field_cuda_convert_rejects_what_the_kernel_cannot_take():
    from hades252_tpu_torch.ops import field_cuda

    x = torch.zeros((4, 16), dtype=torch.int32)
    for convert in (field_cuda.to_mont, field_cuda.from_mont):
        with pytest.raises(ValueError):
            convert(x.long())
        with pytest.raises(ValueError):
            convert(torch.zeros((4, 15), dtype=torch.int32))
        with pytest.raises(ValueError):
            convert(torch.stack([x, x], dim=-1)[..., 0])  # digits 2 int32 apart
        with pytest.raises(ValueError):
            convert(torch.zeros((4, 16), dtype=torch.int32, device="meta"))
        assert convert(torch.zeros((0, 16), dtype=torch.int32)).shape == (0, 16)


def _arith_cases(a: np.ndarray, b: np.ndarray) -> dict:
    """The operand pairs the element-wise ops' callers pass: rows; a
    challenge against a key table, (B, 1, 1, 16) x (1, 4, n, 16); an NTT
    stage's upper half against its (L/2, 16) twiddle row and its two
    strided halves; a row against one element; DEEP's (B, m0) slab against
    a (B, 1) challenge; the grinding word, (B, 1) state words against (1, C)
    nonces; a broadcast constant expanded with stride 0. Then three the
    kernel cannot read in place, which the wrappers refuse on every device
    (`REFUSED`): int64 digits, rows 18 digits apart (off a 16-byte
    boundary) and five axes that do not merge."""
    x, y = _t(a[:64]), _t(b[:64])
    xr = x.reshape(2, 4, 2, 4, 16)  # B = 2, 4 columns, N = 8 at the stage of L = 4
    states = torch.stack([y[:2]] * 5, dim=1)
    odd = torch.cat([x, x[:, :2]], dim=1)[:, :16]
    return {
        "rows": (x, y),
        "challenge_table": (y[:2][:, None, None, :], x.reshape(1, 4, 16, 16)),
        "stage_twiddle": (xr[..., 2:, :], y[:2]),
        "stage_halves": (xr[..., :2, :], xr[..., 2:, :]),
        "row_element": (x[:5], y[3]),
        "deep_slab": (x.reshape(2, 32, 16), y[:2][:, None]),
        "grind_word": (states[:, None, 1], x[:8][None]),
        "expanded": (y[5].expand(2, 3, 1, 16), x[:6].reshape(2, 3, 1, 16)),
        "int64": (x.to(torch.int64), y),
        "unaligned_rows": (odd, y),
        "five_axes": (x[:32].reshape(2, 2, 2, 2, 2, 16).permute(4, 3, 2, 1, 0, 5),
                      y[:32].reshape(2, 2, 2, 2, 2, 16)),
    }


ARITH_CASES = ["rows", "challenge_table", "stage_twiddle", "stage_halves", "row_element",
               "deep_slab", "grind_word", "expanded", "int64", "unaligned_rows", "five_axes"]
REFUSED = {"int64": "int32 digits", "unaligned_rows": "16-byte boundary",
           "five_axes": "at most 4 axes"}


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
@pytest.mark.parametrize("case", ARITH_CASES)
def test_field_cuda_arith_on_the_cpu_is_field_s(operands, monkeypatch, op, case):
    """ops/field_cuda.mont_mul / add_mod / sub_mod on CPU tensors: field's
    own op, bit for bit, at each shape and layout the callers pass, int32
    digits of the broadcast shape, and no kernel launched; a layout the
    kernel cannot read in place refused here as on the card."""
    from hades252_tpu_torch.ops import field_cuda

    a, b = _arith_cases(*operands)[case]
    monkeypatch.setattr(field_cuda, "arith_launches", dict.fromkeys(field_cuda.ARITH_OPS, 0))
    monkeypatch.setattr(field_cuda, "arith_elements", dict.fromkeys(field_cuda.ARITH_OPS, 0))
    if case in REFUSED:
        with pytest.raises(ValueError, match=REFUSED[case]):
            getattr(field_cuda, op)(a, b)
    else:
        got = getattr(field_cuda, op)(a, b)
        want = getattr(field, op)(a, b)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert got.shape == torch.broadcast_shapes(a.shape, b.shape)
    assert not any(field_cuda.arith_launches.values())
    assert not any(field_cuda.arith_elements.values())


def _kernel_reads(x: torch.Tensor, sizes: list, strides: list) -> torch.Tensor:
    """The elements hades_field_arith reads of an operand: output element
    i at the offset its index gives over the axes (innermost first, the
    last axis taking what the others leave), as the kernel computes it."""
    storage = torch.empty(0, dtype=torch.int32).set_(x.untyped_storage())
    rows = []
    for i in range(int(np.prod(sizes))):
        r, off = i, x.storage_offset()
        for k, (size, stride) in enumerate(zip(sizes, strides)):
            c, r = (r % size, r // size) if k + 1 < len(sizes) else (r, 0)
            off += c * stride
        rows.append(storage[off : off + 16])
    return torch.stack(rows)


@pytest.mark.parametrize("case", ARITH_CASES)
def test_field_cuda_kernel_layout_reads_every_operand_element(operands, case):
    """What the wrapper hands hades_field_arith, worked through the
    kernel's own address arithmetic on the CPU: at most four axes, each
    output element's operands where the broadcast puts them, every element
    on a 16-byte boundary, the operands read in place; and a layout the
    kernel cannot read in place refused, not copied."""
    from hades252_tpu_torch.ops import field_cuda

    a, b = _arith_cases(*operands)[case]
    if case in REFUSED:
        with pytest.raises(ValueError, match=REFUSED[case]):
            field_cuda.kernel_layout(a, b) if case != "int64" else field_cuda.mont_mul(a, b)
        return
    shape, sizes, strides = field_cuda.kernel_layout(a, b)
    assert shape == torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    assert 1 <= len(sizes) <= 4 and int(np.prod(sizes)) == int(np.prod(shape))
    for x, st in ((a, strides[0]), (b, strides[1])):
        assert x.dtype == torch.int32 and x.stride(-1) == 1 and x.data_ptr() % 16 == 0
        assert all(s % 4 == 0 for s in st) and len(st) == len(sizes)
        want = x.expand(*shape, 16).reshape(-1, 16)
        assert torch.equal(_kernel_reads(x, sizes, st), want)
    if case == "stage_twiddle":  # the twiddle row broadcast, B x 4 x N/L merged
        assert sizes == [2, 16] and strides == [[16, 64], [16, 0]]
    if case == "challenge_table":
        assert sizes == [64, 2] and strides == [[0, 16], [16, 0]]


def test_field_cuda_arith_rejects_what_the_kernel_cannot_take():
    from hades252_tpu_torch.ops import field_cuda

    x = torch.zeros((4, 16), dtype=torch.int32)
    for op in (field_cuda.mont_mul, field_cuda.add_mod, field_cuda.sub_mod):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            op(x.to("meta"), x.to("meta"))
        with pytest.raises(ValueError, match="two devices"):
            op(x, x.to("meta"))
        with pytest.raises(ValueError, match="int32 digits"):
            op(x.to(torch.float32), x)
        with pytest.raises(ValueError, match="int32 digits"):
            op(x, x.to(torch.int64))
        with pytest.raises(ValueError, match="int32 digits"):
            op(x, x.to(torch.int16))
        with pytest.raises(ValueError, match="int32 digits"):
            op(x[:, :15], x[:, :15])
        with pytest.raises(ValueError, match="int32 digits"):
            op(torch.zeros(32, dtype=torch.int32).reshape(1, 32), x)
        assert op(x[:0], x[:1]).shape == (0, 16)
    with pytest.raises(ValueError, match="do not broadcast"):
        field_cuda.kernel_layout(x[:3], x)
