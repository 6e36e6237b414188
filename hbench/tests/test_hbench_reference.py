"""The plain reference: the published known answers, its batched form
against its one-state form, and the tree and verdicts against a small tree
built by hand."""

from __future__ import annotations

import random

import pytest
import torch

from hbench.reference import hades

# perm([0, 1, 2, 3, 4]) and perm([17] * 5), as published (SURVEY.md §2.3)
KAT = {
    (0, 1, 2, 3, 4): [
        0x4C78FE2E2CDB6E76B43742B08A782A771258F76F57B5FFE586F2391A0363013A,
        0x24CE8F38F8E02C94B2E0B44EDEE20579D1CB7E0E34EA5889B76AF5531DE48654,
        0x41BD94C473E11F8A1FA63BDA8DB2C872467187EC72668B90FF20DAAD076D2FD9,
        0x5C6ABBEF811655FF079FAB41E11932F1D784F363C4C36C1234C5C0F600E55E43,
        0x02E47CFE251226D450F518946A0ABCF1E7F721C0685A4382CAB9409AEE71FF9A],
    (17,) * 5: [
        0x4A335A5BE470B8C178E7E78DFD8ABCEDEE607C75AFBFF0491C074BAE3415B320,
        0x04F108127CC563090C4724A4C394334FD38B6B59654E38FAE442351793024684,
        0x4C5A86584CB6661CCE9074CC64D18D56AAF1DC1A0C6C0DAE0319A5AFCD6C1033,
        0x432C2C79D317CC36030483F9B06879DCE6F0B7C5A421555EE32DE0DBB8FB5444,
        0x5E0F4E5BF6FA474CF727CE87DD64E6A4753F60758BB8273E04715A469AB14F91],
}


@pytest.mark.parametrize("words", list(KAT), ids=str)
def test_known_answers(words):
    assert hades.perm_int(list(words)) == KAT[words]
    got = hades.permute(torch.from_numpy(hades.ints_to_digits([list(words)])))
    assert hades.digits_to_ints(got) == [KAT[words]]


def test_batched_equals_one_state():
    rng = random.Random(7)
    states = [[rng.randrange(hades.P) for _ in range(5)] for _ in range(20)]
    states += [[hades.P - 1] * 5, [0] * 5]
    got = hades.permute(torch.from_numpy(hades.ints_to_digits(states)), block=8)
    assert hades.digits_to_ints(got) == [hades.perm_int(s) for s in states]


def test_control_differs():
    words = [1, 2, 3, 4, 5]
    assert hades.perm_int(words, partial_rounds=58) != hades.perm_int(words)
    x = torch.from_numpy(hades.ints_to_digits([words]))
    assert hades.digits_to_ints(hades.permute(x, 58)) == [hades.perm_int(words, 58)]


def test_montgomery_forms():
    vals = [0, 1, 5, hades.P - 1, 2**255 % hades.P]
    x = torch.from_numpy(hades.ints_to_digits(vals))
    m = hades.to_mont256(x)
    assert hades.digits_to_ints(m) == [v * 2**256 % hades.P for v in vals]
    assert hades.digits_to_ints(hades.from_mont256(m)) == vals


def _hand_tree(leaves: list[int], size: int = 16) -> list[list[int]]:
    """The levels of the tree by hand: pad to `size` with zeros, hash groups
    of four under the tag 4, keep word 1."""
    level, levels = leaves + [0] * (size - len(leaves)), []
    levels.append(level)
    while len(level) > 1:
        level = [hades.perm_int([4] + level[i:i + 4])[1] for i in range(0, len(level), 4)]
        levels.append(level)
    return levels


def test_tree_and_verdicts_by_hand():
    rng = random.Random(3)
    leaves = [rng.randrange(hades.P) for _ in range(13)]
    want = _hand_tree(leaves)
    got = hades.tree_levels(torch.from_numpy(hades.ints_to_digits(leaves)))
    assert [hades.digits_to_ints(lv) for lv in got] == want
    # openings of leaves 0, 6 and 12, by hand, and one with a changed sibling
    idx = [0, 6, 12, 6]
    sibs, poss = [], []
    for i in idx:
        s, p = [], []
        for level in want[:-1]:
            g, pos = divmod(i, 4)
            s.append([v for j, v in enumerate(level[4 * g:4 * g + 4]) if j != pos])
            p.append(pos)
            i = g
        sibs.append(s)
        poss.append(p)
    sibs[3][1][2] = (sibs[3][1][2] + 1) % hades.P
    roots = hades.walk(torch.from_numpy(hades.ints_to_digits([leaves[i] for i in idx])),
                       torch.from_numpy(hades.ints_to_digits(sibs)), torch.tensor(poss))
    assert [r == want[-1][0] for r in hades.digits_to_ints(roots)] == [True, True, True, False]


@pytest.mark.parametrize("height", [2, 3, 4])
def test_lifted_root_by_hand(height):
    """A 16-leaf subtree lifted to `height` is the tree over its leaves
    zero-padded to 4^height, and its empty subtrees' digests are the roots
    of zero leaves."""
    rng = random.Random(5)
    leaves = [rng.randrange(hades.P) for _ in range(13)]
    dense = hades.tree_levels(torch.from_numpy(hades.ints_to_digits(leaves)))[-1][0]
    got = hades.lift_root(dense, 2, height)
    assert hades.digits_to_ints(got[None]) == [_hand_tree(leaves, 4**height)[-1][0]]
    z = hades.empty_digests(height, torch.device("cpu"))
    assert hades.digits_to_ints(z) == [_hand_tree([], 4**h)[-1][0] for h in range(height)]
