"""The field inversion, the Montgomery conversions and the element-wise
field ops as CUDA kernels, their wrappers and their plain versions.

`invert` computes the Montgomery form of a^-1 mod p (0 for 0) of every
element of a digit tensor. On a CUDA tensor it is one launch of
`hades_field_invert` (`csrc/field_inv.cu`: one thread an element, Fermat's
a^(p-2) in registers); on a CPU tensor it is the plain composition of
`hades252_tpu_torch.field`'s functions, which the CPU tests and the JAX
comparisons run and the card's checks hold the kernel against. The
inverse is unique and both are exact, so the two are bit-identical.

`to_mont` and `from_mont` are `field.to_mont` and `field.from_mont`: one
launch of `hades_field_convert` (`csrc/field_conv.cu`) on a CUDA tensor,
which reads rows of any 16-byte-aligned stride in place; `field`'s own
functions on a CPU tensor. The same product either way, so the same bits.

`mont_mul`, `add_mod` and `sub_mod` are `field`'s functions of the same
names: one launch of `hades_field_arith` (`csrc/field_arith.cu`) on CUDA
tensors, which reads broadcast and strided int32 operands in place (up to
four axes after the wrapper merges what it can) into a new contiguous
tensor of the broadcast shape; `field`'s own functions on CPU tensors. The
same carry chains either way, so the same bits for every input below p.
What the kernel cannot read in place is refused on either device, never
copied.
"""

from __future__ import annotations

import ctypes

import torch

from .. import field
from ..params import N_DIGITS
from . import _build

#: The inversion kernel's launches: the wrapper adds one where it launches
#: and nowhere else (a CUDA graph's launches are counted once, at its
#: capture).
launches = 0

#: Elements handed to the kernel: the wrapper adds its count where it
#: launches, and `utils/graphs.CudaGraph` adds what one replay holds at
#: every replay (a capture runs nothing).
inverted = 0

#: The conversion kernel's launches and the input elements they converted,
#: apart from the inversion's; `utils/graphs.CudaGraph` holds and adds them
#: as it does the inversion's.
conversions = 0
converted = 0

#: hades_field_arith's ops, by the names of their counters, with the
#: kernel's op codes (field.cuh's kArithMul, kArithAdd, kArithSub).
ARITH_OPS = {"mul": 0, "add": 1, "sub": 2}

#: hades_field_arith's launches and the elements they wrote, per op: the
#: wrapper adds them where it launches; `utils/graphs.CudaGraph` holds a
#: capture's and adds its elements at every replay, as for `inverted`.
arith_launches = dict.fromkeys(ARITH_OPS, 0)
arith_elements = dict.fromkeys(ARITH_OPS, 0)

#: The axes of the output's shape that the kernel takes strides over, and
#: the C array the kernel's entry takes a size or a stride of each in.
_AXES = 4
_AxesArray = ctypes.c_longlong * _AXES


def invert(a: torch.Tensor, *, mont_in: bool) -> torch.Tensor:
    """a^-1 R mod p of each element of a (..., N_DIGITS) int32 digit tensor,
    its elements below p, in the Montgomery form (mont_in) or canonical.
    Returns a new tensor of a's shape on a's device, in the Montgomery
    form. A CUDA tensor must be contiguous."""
    if a.dtype != torch.int32 or a.dim() < 1 or a.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (..., {N_DIGITS}) int32 digits, got {tuple(a.shape)} {a.dtype}")
    if a.device.type == "cpu":
        return invert_plain(a, mont_in=mont_in)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if not a.is_contiguous():
        raise ValueError("the kernel takes a contiguous digit tensor")
    out = torch.empty_like(a)
    n = a.numel() // N_DIGITS
    if n:
        _launch(a, out, n, mont_in=mont_in)
    return out


def _launch(a: torch.Tensor, out: torch.Tensor, n: int, *, mont_in: bool) -> None:
    global launches, inverted
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hades_field_invert_launch(a.data_ptr(), out.data_ptr(), n, int(mont_in),
                                               stream)
    if status != 0:
        raise RuntimeError(f"hades_field_invert: {lib.hades_error_string(status).decode()} "
                           f"({status})")
    launches += 1
    inverted += n


def invert_plain(a: torch.Tensor, *, mont_in: bool) -> torch.Tensor:
    """The plain version: `field.invert` between the conversions, on a's
    own device."""
    return field.to_mont(field.invert(field.from_mont(a) if mont_in else a))


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """a R mod p of each element of a (..., N_DIGITS) int32 canonical digit
    tensor (digits below 2^16, the digit axis of unit stride): a new
    contiguous tensor of a's shape on a's device."""
    return _convert(a, to=True)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """a R^-1 mod p of each element of a (..., N_DIGITS) int32 Montgomery
    digit tensor, as `to_mont` takes it."""
    return _convert(a, to=False)


def _convert(a: torch.Tensor, *, to: bool) -> torch.Tensor:
    if a.dtype != torch.int32 or a.dim() < 1 or a.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (..., {N_DIGITS}) int32 digits, got {tuple(a.shape)} {a.dtype}")
    if a.stride(-1) != 1:
        raise ValueError("the digits of an element must be contiguous")
    if a.device.type == "cpu":
        return field.to_mont(a) if to else field.from_mont(a)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    n = a.numel() // N_DIGITS
    flat = a.reshape(n, N_DIGITS)  # a view unless the leading axes cannot merge
    if flat.data_ptr() % 16 or flat.stride(0) % 4:
        flat = flat.contiguous()
    out = torch.empty((n, N_DIGITS), dtype=torch.int32, device=a.device)
    if n:
        _launch_convert(flat, out, n, to=to)
    return out.view(a.shape)


def _launch_convert(x: torch.Tensor, out: torch.Tensor, n: int, *, to: bool) -> None:
    global conversions, converted
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hades_field_convert_launch(x.data_ptr(), x.stride(0), n, out.data_ptr(),
                                                int(to), stream)
    if status != 0:
        raise RuntimeError(f"hades_field_convert: {lib.hades_error_string(status).decode()} "
                           f"({status})")
    conversions += 1
    converted += n


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`field.mont_mul`: a b R^-1 mod p of (..., N_DIGITS) int32 digit
    tensors that broadcast, values below p, each element's 64 B on a 16-byte
    boundary and at most four axes left once the wrapper has merged what it
    can (`kernel_layout`). Returns a new contiguous int32 tensor of the
    broadcast shape on their device."""
    return _arith("mul", a, b, field.mont_mul)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`field.add_mod`: (a + b) mod p, as `mont_mul` takes and returns it."""
    return _arith("add", a, b, field.add_mod)


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`field.sub_mod`: (a - b) mod p, as `mont_mul` takes and returns it."""
    return _arith("sub", a, b, field.sub_mod)


def _arith(op: str, a: torch.Tensor, b: torch.Tensor, plain) -> torch.Tensor:
    for x in (a, b):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() < 1
                or x.shape[-1] != N_DIGITS):
            got = (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(f"expected (..., {N_DIGITS}) int32 digits, got {got}")
    if a.device != b.device:
        raise ValueError(f"operands on two devices: {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {a.device}")
    shape, sizes, strides = kernel_layout(a, b)  # the CPU too refuses what the kernel cannot read
    if a.device.type == "cpu":
        return plain(a, b)
    out = torch.empty((*shape, N_DIGITS), dtype=torch.int32, device=a.device)
    n = out.numel() // N_DIGITS
    if n:
        _launch_arith(op, a, b, out, sizes, strides, n)
    return out


def kernel_layout(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """What the kernel is handed for int32 operands a and b: the broadcast
    shape of their elements, and the output's axes, innermost first, with
    each operand's element strides on them (`_merged_axes`). Raises
    ValueError where the kernel cannot read an operand in place: digits not
    contiguous, an element off a 16-byte boundary, or more than four axes
    left after merging. Plain tuples, not views: the wrapper runs once a
    launch, and the provers launch thousands a proof."""
    for x in (a, b):
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                st % 4 for st, size in zip(x.stride()[:-1], x.shape[:-1]) if size > 1):
            raise ValueError(f"the kernel reads each element's digits contiguous on a 16-byte "
                             f"boundary; got strides {x.stride()} at offset {x.storage_offset()}")
    shape, strides = _broadcast(a, b)
    sizes, merged = _merged_axes(shape, strides)
    if len(sizes) > _AXES:
        raise ValueError(f"the kernel takes at most {_AXES} axes; shape {shape} with strides "
                         f"{strides} leaves {len(sizes)}")
    return torch.Size(shape), sizes, merged


def _broadcast(*xs) -> tuple:
    """The broadcast shape of the operands' elements (their leading axes,
    aligned at the right), and each operand's element strides over it, 0
    along an axis where it has one element."""
    nd = max(x.dim() for x in xs) - 1
    shape, per = [1] * nd, []
    for x in xs:
        pad = nd - x.dim() + 1
        sizes, strides = (1,) * pad + tuple(x.shape[:-1]), (0,) * pad + x.stride()[:-1]
        for k, size in enumerate(sizes):
            if size != 1:
                if shape[k] not in (1, size):
                    raise ValueError(f"shapes {[tuple(y.shape) for y in xs]} do not broadcast")
                shape[k] = size
        per.append([st if size != 1 else 0 for size, st in zip(sizes, strides)])
    return shape, per


def _merged_axes(shape, strides) -> tuple:
    """The output's axes of more than one element, innermost first, with
    each operand's element strides on them, and neighbours merged wherever
    every operand steps over the two as over one axis (the output is
    contiguous, so it always does)."""
    sizes, merged = [], [[] for _ in strides]
    for k in reversed(range(len(shape))):
        if shape[k] == 1:
            continue
        if sizes and all(st[k] == m[-1] * sizes[-1] for st, m in zip(strides, merged)):
            sizes[-1] *= shape[k]
            continue
        sizes.append(shape[k])
        for st, m in zip(strides, merged):
            m.append(st[k])
    if not sizes:
        return [1], [[0] for _ in strides]
    return sizes, merged


def _launch_arith(op: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, sizes: list,
                  strides: list, n: int) -> None:
    lib = _build.library()
    pad = [0] * (_AXES - len(sizes))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hades_field_arith_launch(
            ARITH_OPS[op], a.data_ptr(), _AxesArray(*strides[0], *pad), b.data_ptr(),
            _AxesArray(*strides[1], *pad), _AxesArray(*sizes, *pad), len(sizes), n,
            out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"hades_field_arith: {lib.hades_error_string(status).decode()} "
                           f"({status})")
    arith_launches[op] += 1
    arith_elements[op] += n
