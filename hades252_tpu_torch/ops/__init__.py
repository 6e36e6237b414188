"""Compute ops: the permutation backends.

`make_perm_mont_fn` is the seam the models (sponge, Merkle, cipher) build on:
a function (B, WIDTH, N_DIGITS) Montgomery-domain state -> permuted state.
`resolve_device` is every device entry point's one device rule.
"""

from __future__ import annotations

import functools

import torch

from .perm_cuda import DEFAULT_SCHEDULE, _check_schedule, permute_cuda_mont
from .perm_ref import permute, permute_mont  # noqa: F401


def resolve_device(who: str, device) -> torch.device:
    """The device the entry point `who` runs on: "cuda" gets the current
    card's index, so that caches keyed by device meet one key whichever
    entry point filled them. Raises RuntimeError without a card, ValueError
    for a device that is neither the CPU nor a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"no kernel for device {dev}")
    return dev


def default_perm_mont_fn(device):
    """The Montgomery-domain permutation the models use when none is
    passed: the `opt` CUDA kernel for a CUDA device, the torch oracle for
    the CPU (bit-identical either way)."""
    if torch.device(device).type == "cuda":
        return functools.partial(permute_cuda_mont, schedule=DEFAULT_SCHEDULE)
    return permute_mont


def make_perm_mont_fn(backend: str = "ref", *, schedule: str = DEFAULT_SCHEDULE):
    """A Montgomery-domain batched permutation.

    backend "ref": the torch oracle (dense schedule, any device).
    backend "cuda": the CUDA kernel of `schedule` (perm_cuda.SCHEDULES:
    "naive", "opt", "mxu8", "mxu", "hyb", "hybp", the JAX package's default,
    "hyb13" or "hybp13") for a CUDA tensor; for a CPU tensor, that kernel's
    plain version.
    """
    if backend == "ref":
        return permute_mont
    if backend == "cuda":
        _check_schedule(schedule)
        return functools.partial(permute_cuda_mont, schedule=schedule)
    raise ValueError(f"unknown backend: {backend}")
