"""Note-membership proofs: openings at a stated height, their paths, the
17-level membership circuit and its batched proof, against the plain
reference of the benchmark (`hbench/reference/membership.py`, which imports
nothing of the package), on the CPU."""

import pytest
import torch

from hades252_tpu_torch import circuits, field, plonk, prover_cuda
from hades252_tpu_torch.models import merkle
from hades252_tpu_torch.utils import metrics
from hbench import inputs
from hbench.drivers.plonk_batch import _parts
from hbench.reference import hades
from hbench.reference import membership as ref

torch.set_num_threads(1)

CPU = torch.device("cpu")
HEIGHT = 17


def _leaves(n: int, seed: int) -> torch.Tensor:
    return inputs.leaves(inputs.generator(seed, CPU), (n,), CPU)


@pytest.fixture(scope="module")
def tree():
    """A 4^2-leaf tree, built by the port, and the reference's levels."""
    leaves = _leaves(16, 4294967311)
    return leaves, merkle.merkle_levels(leaves), hades.tree_levels(leaves)


def test_empty_digests_equal_the_reference():
    got = merkle.empty_digests(HEIGHT, CPU)
    assert got.shape == (HEIGHT, 16) and not got[0].any()
    assert torch.equal(field.from_mont(got), hades.empty_digests(HEIGHT, CPU))
    assert merkle.empty_digests(HEIGHT, CPU) is got          # a constant of the shape


def test_height17_openings_equal_the_reference_and_verify(tree):
    leaves, levels, rlevels = tree
    idx = torch.tensor([0, 5, 9, 15])
    sibs, poss = merkle.merkle_open_batched(levels, idx, HEIGHT)
    assert sibs.shape == (4, HEIGHT, 3, 16) and poss.shape == (4, HEIGHT)
    assert poss.dtype == torch.int32
    # the built levels: the compact openings of the built tree, unchanged
    low_sibs, low_poss = merkle.merkle_open_batched(levels, idx)
    assert torch.equal(sibs[:, :2], low_sibs) and torch.equal(poss[:, :2], low_poss)
    for lvl in range(2):
        groups = rlevels[lvl].reshape(-1, 4, 16)[idx >> (2 * lvl + 2)]
        for k, i in enumerate(idx.tolist()):
            pos = (i >> (2 * lvl)) & 3
            want = torch.cat([groups[k, :pos], groups[k, pos + 1:]])
            assert int(poss[k, lvl]) == pos
            assert torch.equal(field.from_mont(sibs[k, lvl]), want)
    # above it: position 0, three empty subtrees' digests of the level
    empty = hades.empty_digests(HEIGHT, CPU)
    assert not poss[:, 2:].any()
    assert torch.equal(field.from_mont(sibs[:, 2:]),
                       empty[None, 2:, None].expand(4, -1, 3, -1))
    root = hades.lift_root(rlevels[-1][0], 2, HEIGHT)
    assert torch.equal(field.from_mont(merkle.merkle_lift(levels, HEIGHT)[-1]), root)
    forged = sibs.clone()
    forged[1, 9, 2, 0] ^= 1                  # one bit of one sibling above the built tree
    both = merkle.merkle_verify_batched(root, torch.cat([leaves[idx]] * 2),
                                        torch.cat([sibs, forged]), torch.cat([poss, poss]),
                                        HEIGHT)
    assert both.tolist() == [True] * 4 + [True, False, True, True]
    with pytest.raises(ValueError, match="below"):
        merkle.merkle_open_batched(levels, idx, 1)


def test_merkle_lift_at_the_built_height_is_the_root(tree):
    _, levels, _ = tree
    assert torch.equal(merkle.merkle_lift(levels, 2), levels[-1][:1])


@pytest.fixture(scope="module")
def paths17(tree):
    """merkle_path_ints over four indices at height 17, and the spans it
    recorded."""
    _, levels, _ = tree
    metrics.reset()
    metrics.enable()
    try:
        got = circuits.merkle_path_ints(levels, [3, 12, 10, 7], HEIGHT)
        spans = {k: s["calls"] for k, s in metrics.snapshot()["spans"].items()}
    finally:
        metrics.disable()
        metrics.reset()
    return got, spans


def test_path_ints_at_height17_equal_the_reference(tree, paths17):
    leaves, levels, _ = tree
    got, spans = paths17
    assert spans["merkle.paths"] == 1
    assert got == ref.paths(leaves, [3, 12, 10, 7], HEIGHT)
    for leaf, groups, positions, _ in got:
        assert len(groups) == len(positions) == HEIGHT and groups[0][positions[0]] == leaf
    # the one-index form is a case of it
    assert circuits.merkle_path_ints(levels, 12, HEIGHT) == got[1]
    for bad in ([3, 16], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            circuits.merkle_path_ints(levels, bad, HEIGHT)


def test_membership_circuit_equals_the_reference_gate_for_gate(paths17):
    path = paths17[0][2]
    c = circuits.merkle_membership_circuit(*path)
    r = ref.membership_circuit(*path)
    assert len(c.gates) == len(r.gates) == 16_748
    for g, h in zip(c.gates, r.gates):
        assert (g.q_m, g.q_l, g.q_r, g.q_o, g.q_4, g.q_c, g.pi) == \
            (h.q_m, h.q_l, h.q_r, h.q_o, h.q_4, h.q_c, h.pi)
        assert [g.w_a.index, g.w_b.index, g.w_o.index, g.w_d.index] == h.wires
    assert c._values == r.values
    assert circuits.public_input_column(c) == [g.pi for g in r.gates]
    assert c.check_satisfied()


def test_prove_batched_at_height1_equals_the_reference():
    """B = 2 instances of the 1-level circuit (988 gates, n = 1,024) through
    the batched prover's eager bodies."""
    leaves = _leaves(4, 2718281828)
    paths = circuits.merkle_path_ints(merkle.merkle_levels(leaves), [1, 2], 1)
    composers = [circuits.merkle_membership_circuit(*p) for p in paths]
    key = plonk.preprocess(composers[0])
    assert (key.n, key.n_gates) == (1024, 988)
    proofs = prover_cuda.prove_batched(composers, key, device="cpu")
    want = [ref.prove_path(p) for p in ref.paths(leaves, [1, 2], 1)]
    assert [_parts(p) for p in proofs] == [_parts(w) for w in want]
    assert plonk.verify(key, proofs[0], circuits.public_input_column(composers[0]))
