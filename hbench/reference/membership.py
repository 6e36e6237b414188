"""The plain reference of the note-membership circuit and its PLONK proof.

Written for this benchmark; it imports nothing of the package it judges. It
builds the populated tree with `hbench/reference/hades.py` (`tree_levels`),
extends each path to the tree's stated height with the empty subtrees'
digests (`empty_digests`), builds the membership circuit gate for gate as
the package's `circuits.merkle_membership_circuit(..., index=None)` does,
on `hbench/reference/plonk.py`'s composer and permutation gadget, and
proves it with that file's `preprocess` and `prove`.

Departures from Dusk's circuit (poseidon-merkle's `zk::opening_gadget`, as
phoenix-circuits' `TxCircuit` uses it once an input note):

- the node rule is the package's, parent = word 1 of perm([4, c0, c1, c2,
  c3]), not Dusk's sponge over the four children;
- the statement is the opening alone: a private leaf and private position
  bits (the index is not public) under the public root; the note's
  commitment, nullifier and value checks of the transfer circuit are left
  out;
- the position is selected by the package's 2-bit multiplexer (13 gates a
  level with the booleanity of both bits and the node's equality).

Gate count at height h: the reserved zero gate, one constant gate for the
tag, h levels of 13 selection gates and one 972-gate permutation, and one
public gate for the root: 3 + 985 h (16,748 at h = 17, n = 32,768).
"""

from __future__ import annotations

import torch

from hbench.reference import hades
from hbench.reference import plonk as pl

P = hades.P
ARITY = hades.ARITY


def _append(cs: pl.Composer, g: pl.Gate, wires: list[int]) -> None:
    """A gate on existing witnesses, allocating nothing."""
    g.wires = list(wires)
    cs.gates.append(g)


def membership_circuit(leaf: int, groups: list, positions: list, root: int) -> pl.Composer:
    """Knowledge of a leaf and its path of full 4-child groups (bottom up),
    with its positions, to the public root."""
    cs = pl.Composer()
    leaf_w = cs.witness(leaf)
    groups_w = [[cs.witness(v) for v in g] for g in groups]
    bits_w = [(cs.witness(p & 1), cs.witness(p >> 1)) for p in positions]
    tag = cs.add(pl.Gate(q_c=hades.TAG))
    node = leaf_w
    for g, (b0, b1) in zip(groups_w, bits_w):
        for b in (b0, b1):                                   # b * b - b = 0
            _append(cs, pl.Gate(q_m=1, q_o=P - 1), [b, b, b, 0])
        t = cs.add(pl.Gate(q_m=1), a=b0, b=b1)
        e1 = cs.add(pl.Gate(q_l=1, q_r=P - 1), a=g[1], b=g[0])
        e2 = cs.add(pl.Gate(q_l=1, q_r=P - 1), a=g[2], b=g[0])
        e3a = cs.add(pl.Gate(q_l=1, q_r=P - 1, q_4=P - 1), a=g[3], b=g[2], d=g[1])
        e3 = cs.add(pl.Gate(q_l=1, q_r=1), a=e3a, b=g[0])
        m1 = cs.add(pl.Gate(q_m=1), a=b0, b=e1)
        m2 = cs.add(pl.Gate(q_m=1), a=b1, b=e2)
        m3 = cs.add(pl.Gate(q_m=1), a=t, b=e3)
        s1 = cs.add(pl.Gate(q_l=1, q_r=1, q_4=1), a=g[0], b=m1, d=m2)
        sel = cs.add(pl.Gate(q_l=1, q_r=1), a=s1, b=m3)
        _append(cs, pl.Gate(q_l=1, q_r=P - 1), [sel, node, 0, 0])   # sel == node
        node = pl.gadget(cs, [tag] + g)[hades.DIGEST_INDEX]
    _append(cs, pl.Gate(q_l=1, pi=(-root) % P), [node, 0, 0, 0])
    return cs


def paths(leaves: torch.Tensor, indices: list, height: int,
          partial_rounds: int = hades.PARTIAL_ROUNDS) -> list:
    """(leaf, groups, positions, root) as ints for each index: the tree of
    `height` whose leftmost leaves are `leaves` (N, 16) canonical digits,
    every other leaf 0. Above the populated subtree each group is the node
    and three empty subtrees' digests, the node at position 0."""
    levels = hades.tree_levels(leaves, partial_rounds)
    dense = len(levels) - 1
    if height < dense:
        raise ValueError(f"height {height} is below the populated tree's {dense}")
    empty = hades.empty_digests(height, leaves.device, partial_rounds)
    tops = [levels[-1][0].to(torch.int32)]                   # the leftmost path's nodes
    for h in range(dense, height):
        group = torch.stack([tops[-1], empty[h], empty[h], empty[h]])[None]
        state = torch.cat([hades._tag(1, leaves.device), group], 1)
        tops.append(hades.permute(state, partial_rounds)[0, hades.DIGEST_INDEX])
    ints = hades.digits_to_ints
    root = ints(tops[-1])
    out = []
    for index in indices:
        groups, positions = [], []
        for lvl in range(dense):
            groups.append(ints(levels[lvl].reshape(-1, ARITY, 16)[index >> (2 * lvl + 2)]))
            positions.append((index >> (2 * lvl)) & 3)
        for h in range(dense, height):
            groups.append(ints(torch.stack([tops[h - dense], empty[h], empty[h], empty[h]])))
            positions.append(0)
        out.append((ints(levels[0][index]), groups, positions, root))
    return out


def prove_path(path: tuple, partial_rounds: int = hades.PARTIAL_ROUNDS) -> pl.Proof:
    """The proof of one path's membership circuit under its own key (every
    path of one height has the same circuit, so the same key)."""
    cs = membership_circuit(*path)
    return pl.prove(cs, pl.preprocess(cs), partial_rounds)
