"""The field inversion as one CUDA kernel, its wrapper and its plain version.

`invert` computes the Montgomery form of a^-1 mod p (0 for 0) of every
element of a digit tensor. On a CUDA tensor it is one launch of
`hades_field_invert` (`csrc/field_inv.cu`: one thread an element, Fermat's
a^(p-2) in registers); on a CPU tensor it is the plain composition of
`hades252_tpu_torch.field`'s functions, which the CPU tests and the JAX
comparisons run and the card's checks hold the kernel against. The
inverse is unique and both are exact, so the two are bit-identical.
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
