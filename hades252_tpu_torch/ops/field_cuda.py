"""The field inversion and the Montgomery conversions as CUDA kernels, their
wrappers and their plain versions.

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
"""

from __future__ import annotations

import torch

from .. import field
from ..params import N_DIGITS
from . import _build

#: Kernel launches: the wrapper adds one where it launches and nowhere else
#: (a CUDA graph's launches are counted once, at its capture).
launches = 0

#: Elements handed to the kernel: the wrapper adds its count where it
#: launches, and `utils/graphs.CudaGraph` adds what one replay holds at
#: every replay (a capture runs nothing).
inverted = 0

#: The conversion kernel's launches and the input elements they converted,
#: apart from the inversion's (which `utils/graphs.CudaGraph` reads).
conversions = 0
converted = 0


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
