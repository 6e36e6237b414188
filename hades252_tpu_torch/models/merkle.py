"""Arity-4 Merkle tree over the Hades252 permutation.

Port of `hades252_tpu/models/merkle.py` (BASELINE.md config 4): the build,
the openings (inclusion proofs) and their verification.

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


# ---------------------------------------------------------------------------
# Openings (inclusion proofs) and their verification
# ---------------------------------------------------------------------------


def _check_index(levels: list[torch.Tensor], index: int) -> None:
    if not 0 <= index < levels[0].shape[0]:
        raise ValueError(f"leaf index {index} out of range")


def merkle_open(levels: list[torch.Tensor], index: int):
    """The opening path of leaf `index` from `merkle_levels`' output: per
    level (siblings, position), where siblings is the (ARITY, N_DIGITS)
    Montgomery-domain group that holds the node and position the node's
    index within it."""
    _check_index(levels, index)
    path = []
    for level in levels[:-1]:
        group = index // ARITY
        path.append((level[group * ARITY : (group + 1) * ARITY], index % ARITY))
        index = group
    return path


def merkle_open_compact(levels: list[torch.Tensor], index: int):
    """The compact opening of leaf `index`: per level only the ARITY - 1
    siblings and the node's position (3 * 32 * height bytes).

    Returns (siblings, positions): (height, ARITY - 1, N_DIGITS) int32
    Montgomery digits and (height,) int32, as merkle_verify_batched takes
    them."""
    _check_index(levels, index)
    sibs, poss = [], []
    for level in levels[:-1]:
        group, pos = index // ARITY, index % ARITY
        g = level[group * ARITY : (group + 1) * ARITY]
        sibs.append(torch.cat([g[:pos], g[pos + 1 :]], dim=0))
        poss.append(pos)
        index = group
    return torch.stack(sibs), torch.tensor(poss, dtype=torch.int32, device=levels[0].device)


def merkle_open_batched(levels: list[torch.Tensor], indices):
    """Compact openings of many leaves: (K, height, ARITY - 1, N_DIGITS)
    siblings and (K, height) int32 positions, the same arrays as stacking
    merkle_open_compact over `indices`. Each level is one gather of the K
    groups and one of their siblings, by index arithmetic, instead of K
    slices."""
    dev = levels[0].device
    index = torch.as_tensor(indices, dtype=torch.int64, device=dev).reshape(-1)
    if index.numel() and not (0 <= int(index.min()) and int(index.max()) < levels[0].shape[0]):
        raise ValueError("leaf index out of range")
    others = torch.arange(ARITY - 1, device=dev)
    sibs, poss = [], []
    for level in levels[:-1]:
        group, pos = index // ARITY, index % ARITY
        groups = level.view(-1, ARITY, N_DIGITS)[group]              # (K, ARITY, D)
        # sibling j is child j, or child j + 1 from the node's position on
        child = others + (others >= pos[:, None])                     # (K, ARITY - 1)
        sibs.append(torch.gather(groups, 1, child[:, :, None].expand(-1, -1, N_DIGITS)))
        poss.append(pos.to(torch.int32))
        index = group
    return torch.stack(sibs, dim=1), torch.stack(poss, dim=1)


def _insert_at(node: torch.Tensor, sibs: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rebuild the ARITY-child group: node (K, D) placed at pos (K,) among
    siblings (K, ARITY - 1, D). A position outside [0, ARITY) places the
    node nowhere."""
    cols = []
    for j in range(ARITY):
        idx = torch.where(j > pos, j - 1, j).clamp(0, ARITY - 2)
        s = torch.gather(sibs, 1, idx[:, None, None].expand(-1, 1, sibs.shape[-1]))[:, 0]
        cols.append(torch.where((pos == j)[:, None], node, s))
    return torch.stack(cols, dim=1)


def merkle_verify_batched(root, leaves, sibs, poss, height: int, perm_mont_fn=None):
    """Verify K compact openings with one batched permutation per level.

    root: (N_DIGITS,) canonical; leaves: (K, N_DIGITS) canonical; sibs:
    (K, height, ARITY - 1, N_DIGITS) Montgomery digits (from
    merkle_open_batched); poss: (K, height). Returns (K,) bool.

    `height` is required for soundness: the node rule is the same at every
    level, so an unbound path length would let an internal node verify as a
    leaf; a path of another length rejects every row. Positions come from
    the prover and are range-checked: for a position outside [0, ARITY)
    `_insert_at` never places the node, so the group would be all
    proof-supplied siblings, which on a padded tree (where duplicate
    sibling digests exist) could forge membership. The check is folded into
    the verdict.
    """
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(leaves.device)
    k = leaves.shape[0]
    if sibs.shape[1] != height or poss.shape[1] != height:
        return torch.zeros((k,), dtype=torch.bool, device=leaves.device)
    poss = poss.to(torch.int64)
    pos_ok = ((poss >= 0) & (poss < ARITY)).all(dim=1)
    node = field.to_mont(leaves)
    tag = _tag_mont(leaves.device).expand(k, 1, N_DIGITS)
    for lvl in range(height):
        children = _insert_at(node, sibs[:, lvl], poss[:, lvl])
        node = perm_mont_fn(torch.cat([tag, children], dim=1))[:, DIGEST_INDEX, :]
    digest_ok = (field.from_mont(node) == root[None]).all(dim=-1)
    return pos_ok & digest_ok


def merkle_verify(root, leaf, path, height: int, perm_mont_fn=None) -> bool:
    """Check one opening path from merkle_open. `height` is the tree height
    the verifier expects (log4 of the padded leaf count), required for
    soundness as in merkle_verify_batched."""
    if len(path) != height:
        return False
    if perm_mont_fn is None:
        from ..ops import default_perm_mont_fn

        perm_mont_fn = default_perm_mont_fn(leaf.device)
    node = field.to_mont(leaf)
    tag = _tag_mont(leaf.device)
    for sibs, pos in path:
        if not torch.equal(sibs[pos], node):
            return False
        node = perm_mont_fn(torch.cat([tag[None, None], sibs[None]], dim=1))[0, DIGEST_INDEX, :]
    return torch.equal(field.from_mont(node), root)
