"""Arity-4 Merkle tree over the Hades252 permutation.

Port of `hades252_tpu/models/merkle.py:30-98` (BASELINE.md config 4).

Node rule: parent = perm([TAG, c0, c1, c2, c3])[DIGEST_INDEX], where
TAG = 4 sits in the capacity word and c0..c3 are the children in index
order. Leaves are canonical field elements; a level with fewer than 4^k
leaves is zero-padded on the right. Each level is one batched permutation
call over all its parents, and the whole build stays in the Montgomery
domain: only the leaves are converted in and the root out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import field
from ..params import N_DIGITS
from ..utils import metrics
from ..utils.encoding import ints_to_digits

ARITY = 4
TAG = ARITY  # capacity-word domain tag
DIGEST_INDEX = 1


@functools.cache
def _tag_mont(device: torch.device) -> torch.Tensor:
    tag = torch.from_numpy(ints_to_digits([TAG])[0].astype(np.int32))
    return field.to_mont(tag).to(device)


def tree_levels(n_leaves: int) -> int:
    levels = 0
    n = 1
    while n < n_leaves:
        n *= ARITY
        levels += 1
    return levels


def _pad_to_pow4(leaves: torch.Tensor) -> torch.Tensor:
    n = leaves.shape[0]
    full = ARITY ** tree_levels(n)
    return torch.nn.functional.pad(leaves, (0, 0, 0, full - n))


def _level_up(nodes_mont: torch.Tensor, perm_mont_fn) -> torch.Tensor:
    """One tree level: (N, D) Montgomery node values -> (N/4, D) parents."""
    n = nodes_mont.shape[0]
    children = nodes_mont.reshape(n // ARITY, ARITY, N_DIGITS)
    tag = _tag_mont(nodes_mont.device).expand(n // ARITY, 1, N_DIGITS)
    states = torch.cat([tag, children], dim=1)  # (N/4, WIDTH, D)
    return perm_mont_fn(states)[:, DIGEST_INDEX, :]


def merkle_levels(leaves: torch.Tensor, perm_mont_fn=None) -> list[torch.Tensor]:
    """All levels, leaves first, as (N_k, N_DIGITS) int32 Montgomery digits.

    leaves: (N, N_DIGITS) int32 canonical digits, N >= 1, on the device the
    tree is built on. perm_mont_fn defaults to ops.default_perm_mont_fn for
    that device.
    """
    if leaves.dim() != 2 or leaves.shape[-1] != N_DIGITS:
        raise ValueError(f"expected (N, {N_DIGITS}), got {tuple(leaves.shape)}")
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(leaves.device)
    level = field.to_mont(_pad_to_pow4(leaves))
    levels = [level]
    while level.shape[0] > 1:
        metrics.count("merkle.levels", 1)
        metrics.count("perms.executed", level.shape[0] // ARITY)
        level = _level_up(level, perm_mont_fn)
        levels.append(level)
    return levels


def merkle_root(leaves: torch.Tensor, perm_mont_fn=None) -> torch.Tensor:
    """The arity-4 tree root over canonical leaf digits (N, N_DIGITS) int32;
    returns (N_DIGITS,) int32 canonical root digits."""
    return field.from_mont(merkle_levels(leaves, perm_mont_fn)[-1][0])
