"""The inputs of a run, made from its seed: the same seed gives the same
inputs. The program and the reference are handed the same ones."""

from __future__ import annotations

import numpy as np
import torch

from hbench.reference import hades

#: p's top 16-bit digit: a top digit below it keeps an element below p.
_P_TOP = hades.P >> 240


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def leaves(g: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """Canonical field elements as (*shape, 16) int32 digits, made on the
    device in two calls: 15 uniform low digits and a top digit below p's."""
    low = torch.randint(0, 1 << 16, (*shape, 15), generator=g, device=device, dtype=torch.int32)
    top = torch.randint(0, _P_TOP, (*shape, 1), generator=g, device=device, dtype=torch.int32)
    return torch.cat([low, top], -1)


def preimages(seed: int, count: int) -> tuple[list, list]:
    """`count` instances of the permutation-preimage statement: 5 uniform
    words each (40 random bytes reduced mod p) and their image under the
    permutation, which the reference computes."""
    rng = np.random.default_rng(seed % (1 << 64))
    words = [[int.from_bytes(rng.bytes(40), "little") % hades.P for _ in range(hades.WIDTH)]
             for _ in range(count)]
    return words, [hades.perm_int(w) for w in words]
