"""The port's succinct argument (`hades252_tpu_torch.fri`) against the JAX
package's `hades252_tpu.fri`, on the CPU.

The same seeded inputs go through both packages' host code (no XLA
compile): commitment trees, leaf-block sponges, multiproofs, grinding, the
FRI layer schedule, the parameter presets, the keys, the proofs (through
both packages' `serialize`) and the verdicts, tampered proofs included.
Tolerance: none. Every digit, byte, nonce and verdict must be equal.

Sizes are the JAX tests' own: the tiny composers and
`FriParams(blowup=4, n_queries=6, final_degree=16, pow_bits=2)`. The cases
that run the plain PyTorch permutation (the fallback of `default_pcs_perm`,
and `fri_cuda.device_pool_perm(device="cpu")`) prove at `pow_bits=0`,
because a grind runs 4,096 states a call and the plain version takes 10-20
ms a state here; their grinding is held to the JAX package's with a small
batch instead, which gives the same nonce.
"""

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from hades252_tpu import fri as jfri
from hades252_tpu import gadget as jgadget
from hades252_tpu import plonk as jplonk
from hades252_tpu import serialize as jser
from hades252_tpu_torch import fri, fri_cuda, gadget, plonk, serialize
from hades252_tpu_torch.params import P
from hades252_tpu_torch.utils import native
from hades252_tpu_torch.utils.encoding import ints_to_digits

torch.set_num_threads(1)

JPERM = jfri.default_pcs_perm()
PERM = fri.default_pcs_perm()
PARAMS = dict(blowup=4, n_queries=6, final_degree=16, pow_bits=2)


def _ints(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def tiny(g, a_val: int = 3, b_val: int = 5, mult: int = 1):
    """The JAX tests' two-gate circuit, built with either package's
    gadget module: a * b, then a + b against a public input."""
    c = g.Composer()
    a = c.append_witness(a_val)
    b = c.append_witness(b_val)
    c.gate_mul(g.Constraint().mult(mult).a(a).b(b))
    c.gate_add(g.Constraint().left(1).a(a).right(1).b(b).public(-(a_val + b_val)))
    return c


def chain(g, values):
    """A wider circuit (shared wires, a constant, a public output): 2
    len(values) gates."""
    c = g.Composer()
    ws = [c.append_witness(v) for v in values]
    acc = ws[0]
    for w in ws[1:]:
        prod = c.gate_mul(g.Constraint().mult(1).a(acc).b(w))
        acc = c.gate_add(g.Constraint().left(1).a(prod).right(2).b(w).fourth(3).d(ws[0])
                         .constant(5))
    c.append_gate(g.Constraint().left(1).a(acc).public(-c.value(acc)))
    return c


def _pi(c) -> list[int]:
    return [g.pi for g in c.gates]


def _both_keys(build, **params):
    jc, c = build(jgadget), build(gadget)
    jpk, jvk = jfri.preprocess_succinct(jc, jfri.FriParams(**params), JPERM)
    pk, vk = fri.preprocess_succinct(c, fri.FriParams(**params), PERM)
    return jc, jpk, jvk, c, pk, vk


@pytest.fixture(scope="module")
def tiny_keys():
    return _both_keys(tiny, **PARAMS)


@pytest.fixture(scope="module")
def tiny_proofs(tiny_keys):
    jc, jpk, jvk, c, pk, vk = tiny_keys
    return jfri.prove_succinct(jc, jpk, JPERM), fri.prove_succinct(c, pk, PERM)


@pytest.fixture(scope="module")
def zk_keys():
    return _both_keys(tiny, **{**PARAMS, "zk": True})


# -- commitment trees --------------------------------------------------------


@pytest.mark.parametrize("n", [2, 5, 16, 50, 257])
def test_trees_build_open_and_verify_alike(n):
    vals = _ints(n, 100 + n)
    jl, levels = jfri.tree_build(vals, JPERM), fri.tree_build(vals, PERM)
    assert len(levels) == len(jl) and all(np.array_equal(a, b) for a, b in zip(levels, jl))
    root = fri.tree_root(levels)
    assert root == jfri.tree_root(jl)
    idx = sorted({0, n - 1, n // 2, (7 * n) // 9})
    sibs, poss = fri.tree_open_batched(levels, idx)
    jsibs, jposs = jfri.tree_open_batched(jl, idx)
    assert np.array_equal(np.asarray(sibs), np.asarray(jsibs))
    assert np.array_equal(np.asarray(poss), np.asarray(jposs))
    h = fri._tree_height(n)
    assert h == jfri._tree_height(n)
    opened = [vals[i] for i in idx]
    bad = list(opened)
    bad[-1] = (bad[-1] + 1) % P
    cases = [(opened, poss, idx), (bad, poss, idx), (opened, poss, [i + 1 for i in idx])]
    if h:
        forged = np.asarray(poss).copy()
        forged[0, 0] = fri.ARITY
        cases.append((opened, forged, idx))
    for values, ps, expected in cases:
        got = fri.tree_verify_batched(root, values, sibs, ps, h, expected, PERM)
        want = jfri.tree_verify_batched(root, values, jsibs, ps, h, expected, JPERM)
        assert list(got) == list(want)
    assert all(fri.tree_verify_batched(root, opened, sibs, poss, h, idx, PERM))


# -- leaf-block sponges, multiproofs -------------------------------------------


def test_add_mod_digits_alike():
    a, b = _ints(40, 1) + [P - 1, 0, P - 1], _ints(40, 2) + [1, 0, P - 1]
    da, db = ints_to_digits(a, shape=(len(a),)), ints_to_digits(b, shape=(len(b),))
    assert np.array_equal(fri.add_mod_digits_np(da, db), jfri.add_mod_digits_np(da, db))


@pytest.mark.parametrize("bs", [1, 3, 4, 8, 10])
def test_block_digests_alike(bs):
    blocks = ints_to_digits(_ints(7 * bs, 200 + bs), shape=(7, bs))
    got = fri.block_digests(blocks, PERM)
    assert got.dtype == np.uint32 and np.array_equal(got, jfri.block_digests(blocks, JPERM))
    assert fri.leaf_tag_int(bs) == jfri.leaf_tag_int(bs)


@pytest.mark.parametrize("size", [16, 64, 200, 256])
def test_multiproofs_open_and_verify_alike(size):
    digits = ints_to_digits(_ints(size, 300 + size), shape=(size,))
    levels = fri.tree_build_digits(digits, PERM)
    jl = jfri.tree_build_digits(digits, JPERM)
    height = len(levels) - 1
    rng = np.random.default_rng(size)
    root = fri.tree_root(levels)
    entries = []
    for idx in ([0], [size - 1], [8, 9, 10, 11],
                sorted({int(v) for v in rng.integers(0, size, 12)})):
        assert fri.multiproof_plan(idx, height) == jfri.multiproof_plan(idx, height)
        assert fri.multiproof_nodes_total(idx, height) == jfri.multiproof_nodes_total(idx, height)
        nodes = fri.multiproof_open(levels, idx)
        assert np.array_equal(nodes, jfri.multiproof_open(jl, idx))
        leaf = digits[idx]
        entries.append((root, leaf, idx, nodes, height))
        bad_leaf = leaf.copy()
        bad_leaf[0, 0] ^= 1
        entries.append((root, bad_leaf, idx, nodes, height))
        if nodes.shape[0] >= 2:
            swapped = nodes.copy()
            swapped[[0, 1]] = swapped[[1, 0]]
            entries.append((root, leaf, idx, swapped, height))
        entries.append((root, leaf, idx, nodes[:-1], height))
    entries.append((root, digits[[3, 3]], [3, 3], fri.multiproof_open(levels, [3]), height))
    got = fri.multiproof_verify_many(entries, PERM)
    assert list(got) == list(jfri.multiproof_verify_many(entries, JPERM))
    assert got[0] and not got[1]


def test_pooled_entries_verify_alike():
    """Leaf sponges grouped by width, then one pooled multiproof pass over
    trees of several heights, one entry tampered."""
    entries = []
    for gid, (size, bs, idx) in enumerate(((16, 2, [0, 5]), (64, 4, [1, 2, 63]), (4, 3, [2]))):
        blocks = ints_to_digits(_ints(size * bs, 400 + gid), shape=(size, bs))
        levels = fri.tree_build_digits(fri.block_digests(blocks, PERM), PERM)
        opened = blocks[idx].copy()
        if gid == 1:
            opened[0, 0, 0] ^= 1
        entries.append((bs, fri.tree_root(levels), opened, idx,
                        fri.multiproof_open(levels, idx), len(levels) - 1))
    got = fri.pooled_entries_verify(entries, PERM)
    assert list(got) == list(jfri.pooled_entries_verify(entries, JPERM)) == [True, False, True]


# -- grinding --------------------------------------------------------------------


@pytest.mark.parametrize("pow_bits", [0, 1, 4, 8])
def test_grind_nonce_alike(pow_bits):
    tr, jtr = plonk.Transcript(), jplonk.Transcript()
    for t in (tr, jtr):
        t.absorb(12345, 678 + pow_bits)
    nonce = fri.grind_transcript(tr, pow_bits, PERM, batch=64)
    assert nonce == jfri.grind_transcript(jtr, pow_bits, JPERM)
    assert tr.state == jtr.state
    replay = plonk.Transcript()
    replay.absorb(12345, 678 + pow_bits)
    replay.absorb(nonce)
    assert fri.pow_mask_ok(replay.challenge(), pow_bits)


@pytest.mark.parametrize("perm", ["plain fallback", "device_pool_perm cpu"])
def test_grind_through_the_plain_permutation(perm):
    fn = fri._pcs_perm_plain if perm == "plain fallback" else fri_cuda.device_pool_perm(
        device="cpu")
    tr, jtr = plonk.Transcript(), jplonk.Transcript()
    tr.absorb(99)
    jtr.absorb(99)
    assert fri.grind_transcript(tr, 2, fn, batch=8) == jfri.grind_transcript(jtr, 2, JPERM)
    assert tr.state == jtr.state


# -- the FRI layer schedule, folds, parameters -----------------------------------


@pytest.mark.parametrize("n_folds", range(0, 10))
def test_layer_schedule_and_positions_alike(n_folds):
    sched = fri.layer_schedule(n_folds)
    assert sched == jfri.layer_schedule(n_folds)
    m0 = 1 << (n_folds + 4)
    for q in (0, 1, m0 // 3, m0 // 2 - 1):
        assert fri.layer_positions(q, m0, sched) == jfri.layer_positions(q, m0, sched)


def test_fold_evals_alike():
    evals = _ints(32, 500)
    assert fri.fold_evals(evals, 7, 0xBE7A) == jfri.fold_evals(evals, 7, 0xBE7A)


@pytest.mark.parametrize("name,kwargs", [
    ("default", {}), ("fast", dict(blowup=4, n_queries=16, final_degree=64, pow_bits=8)),
    ("tests", PARAMS), ("zk", dict(PARAMS, zk=True)), ("no grinding", dict(pow_bits=0)),
    ("capped", dict(blowup=8, n_queries=10_000)), ("proven", None), ("proven 16", 16),
])
def test_params_presets_and_security_bits_alike(name, kwargs):
    if kwargs is None or isinstance(kwargs, int):
        extra = {} if kwargs is None else {"blowup": kwargs}
        p, jp = fri.FriParams.proven(**extra), jfri.FriParams.proven(**extra)
    else:
        p, jp = fri.FriParams(**kwargs), jfri.FriParams(**kwargs)
    fields = ("blowup", "n_queries", "final_degree", "pow_bits", "zk")
    assert [getattr(p, f) for f in fields] == [getattr(jp, f) for f in fields]
    for n in (4, 1024, 1 << 20):
        assert p.security_bits(n) == jp.security_bits(n)
        assert p.proven_security_bits(n) == jp.proven_security_bits(n)
    assert fri.proof_schema(1024, p) == jfri.proof_schema(1024, jp)
    assert fri._bounds(1024, p) == jfri._bounds(1024, jp)
    assert serialize.expected_proof_size(1024, p) == jser.expected_proof_size(1024, jp)


def test_proven_preset_rejects_an_uncapped_target():
    for mod in (fri, jfri):
        with pytest.raises(ValueError, match="target_bits"):
            mod.FriParams.proven(target_bits=230)


def test_root_pows_cache_is_bounded():
    fri._root_pows.cache_clear()
    sizes = [1 << k for k in range(1, fri._ROOT_POW_TABLES + 4)]
    for m in sizes:
        assert fri._root_pows(m) == jfri._root_pows(m)
        assert fri._root_pow_at(m, 3 * m + 1) == jfri._root_pow_at(m, 3 * m + 1)
    info = fri._root_pows.cache_info()
    assert info.maxsize == fri._ROOT_POW_TABLES and info.currsize == fri._ROOT_POW_TABLES


# -- keys and proofs ------------------------------------------------------------------


@pytest.mark.parametrize("circuit", ["tiny", "chain", "tiny zk"])
def test_preprocess_succinct_keys_alike(circuit, tiny_keys, zk_keys):
    if circuit == "chain":
        keys = _both_keys(lambda g: chain(g, [5, 7, 11, 13, 17, 19, 23]), **PARAMS)
    else:
        keys = zk_keys if circuit == "tiny zk" else tiny_keys
    jc, jpk, jvk, c, pk, vk = keys
    assert serialize.vk_to_bytes(vk) == jser.vk_to_bytes(jvk)
    assert (vk.n, vk.omega, vk.n_gates, vk.digest, vk.k_root) == (
        jvk.n, jvk.omega, jvk.n_gates, jvk.digest, jvk.k_root)
    assert len(pk.key_levels) == len(jpk.key_levels)
    assert all(np.array_equal(a, b) for a, b in zip(pk.key_levels, jpk.key_levels))
    assert serialize.vk_from_bytes(jser.vk_to_bytes(jvk)) == vk


def test_prove_succinct_bytes_alike(tiny_keys, tiny_proofs):
    jc, jpk, jvk, c, pk, vk = tiny_keys
    jproof, proof = tiny_proofs
    data = serialize.proof_to_bytes(proof, vk)
    assert data == jser.proof_to_bytes(jproof, jvk)
    back = serialize.proof_from_bytes(data, vk)
    assert serialize.proof_to_bytes(back, vk) == data
    assert fri.verify_succinct(vk, back, _pi(c), PERM)
    assert fri.proof_size_field_elements(proof) == jfri.proof_size_field_elements(jproof)


def test_prove_succinct_of_a_wider_circuit_alike():
    values = [int(v) for v in np.random.default_rng(9).integers(0, 1 << 62, 12)]
    jc, jpk, jvk, c, pk, vk = _both_keys(lambda g: chain(g, values), **PARAMS)
    proof = fri.prove_succinct(c, pk, PERM)
    assert serialize.proof_to_bytes(proof, vk) == jser.proof_to_bytes(
        jfri.prove_succinct(jc, jpk, JPERM), jvk)
    assert fri.verify_succinct(vk, proof, _pi(c), PERM)


@pytest.mark.parametrize("seed", [1, 2])
def test_prove_succinct_zk_bytes_alike_with_a_shared_generator(zk_keys, seed):
    jc, jpk, jvk, c, pk, vk = zk_keys
    proof = fri.prove_succinct(c, pk, PERM, rng=np.random.default_rng(seed))
    jproof = jfri.prove_succinct(jc, jpk, JPERM, rng=np.random.default_rng(seed))
    assert serialize.proof_to_bytes(proof, vk) == jser.proof_to_bytes(jproof, jvk)
    assert fri.verify_succinct(vk, proof, _pi(c), PERM)


def test_unsatisfiable_witness_cannot_prove():
    for g, mod in ((gadget, fri), (jgadget, jfri)):
        c = g.Composer()
        a, b = c.append_witness(3), c.append_witness(5)
        c.append_gate(g.Constraint().mult(1).a(a).b(b).constant(-16))
        pk, _ = mod.preprocess_succinct(c, mod.FriParams(**PARAMS))
        with pytest.raises(ValueError, match="degree bound"):
            mod.prove_succinct(c, pk)


# -- verdicts, tampered proofs included ---------------------------------------------


def _tamper(kind: str, proof, c):
    """One changed thing in a proof (or its statement): (proof, public inputs)."""
    pi = _pi(c)
    if kind == "honest":
        return proof, pi
    if kind == "eval":
        return replace(proof, evals={**proof.evals, "a": (proof.evals["a"] + 1) % P}), pi
    if kind == "opening":
        blocks = {k: [list(b) for b in v] for k, v in proof.open_blocks.items()}
        blocks["z"][0][0] = (blocks["z"][0][0] + 1) % P
        return replace(proof, open_blocks=blocks), pi
    if kind in ("node", "swapped nodes", "short nodes"):
        nodes = np.asarray(proof.open_nodes["w"]).copy()
        if kind == "node":
            nodes[0, 0] ^= 1
        elif kind == "swapped nodes":
            nodes[[0, 1]] = nodes[[1, 0]]
        else:
            nodes = nodes[:-1]
        return replace(proof, open_nodes={**proof.open_nodes, "w": nodes}), pi
    if kind == "nonce":
        return replace(proof, pow_nonce=proof.pow_nonce + 1), pi
    if kind == "final coeffs":
        fc = list(proof.fri.final_coeffs)
        fc[0] = (fc[0] + 1) % P
        return replace(proof, fri=replace(proof.fri, final_coeffs=fc)), pi
    assert kind == "public input"
    pi[-1] = (pi[-1] + 1) % P
    return proof, pi


TAMPERS = ["honest", "eval", "opening", "node", "swapped nodes", "short nodes", "nonce",
           "final coeffs", "public input"]


@pytest.mark.parametrize("kind", TAMPERS)
def test_verify_succinct_verdicts_alike(kind, tiny_keys, tiny_proofs):
    jc, jpk, jvk, c, pk, vk = tiny_keys
    jproof, proof = tiny_proofs
    mine, pi = _tamper(kind, proof, c)
    theirs, jpi = _tamper(kind, jproof, jc)
    got = fri.verify_succinct(vk, mine, pi, PERM)
    assert got == jfri.verify_succinct(jvk, theirs, jpi, JPERM) == (kind == "honest")


def test_statement_substitution_fails_alike(tiny_keys, tiny_proofs):
    jproof, proof = tiny_proofs
    _, _, jvk2, c2, _, vk2 = _both_keys(lambda g: tiny(g, mult=2), **PARAMS)
    assert not fri.verify_succinct(vk2, proof, _pi(c2), PERM)
    assert not jfri.verify_succinct(jvk2, jproof, _pi(c2), JPERM)


def test_verify_succinct_batched_verdicts_alike(zk_keys):
    jc, jpk, jvk, c, pk, vk = zk_keys
    mine, theirs = [], []
    for seed, kind in ((20, "honest"), (21, "eval"), (22, "opening"), (23, "short nodes"),
                       (24, "public input"), (25, "honest")):
        proof = fri.prove_succinct(c, pk, PERM, rng=np.random.default_rng(seed))
        jproof = jfri.prove_succinct(jc, jpk, JPERM, rng=np.random.default_rng(seed))
        mine.append(_tamper(kind, proof, c))
        theirs.append(_tamper(kind, jproof, jc))
    timings = {}
    got = fri.verify_succinct_batched(vk, [p for p, _ in mine], [x for _, x in mine], PERM,
                                      timings=timings)
    want = jfri.verify_succinct_batched(jvk, [p for p, _ in theirs], [x for _, x in theirs],
                                        JPERM)
    assert list(got) == list(want) == [True, False, False, False, False, True]
    assert set(timings) == {"prepare_s", "merkle_s", "algebra_s"}
    with pytest.raises(ValueError, match="one public-input list"):
        fri.verify_succinct_batched(vk, [mine[0][0]], [], PERM)
    assert fri.verify_succinct_batched(vk, [], [], PERM).shape == (0,)


# -- the plain permutation as perm_fn ------------------------------------------------


@pytest.fixture(scope="module")
def ungrinded():
    """Keys and the JAX package's proof at the tests' preset without
    grinding (see the module docstring)."""
    keys = _both_keys(tiny, **{**PARAMS, "pow_bits": 0})
    jc, jpk, jvk = keys[:3]
    return keys, jser.proof_to_bytes(jfri.prove_succinct(jc, jpk, JPERM), jvk)


def test_default_pcs_perm_falls_back_to_the_plain_permutation(monkeypatch, ungrinded):
    (_, _, _, c, pk, vk), want = ungrinded
    monkeypatch.setattr(native, "_BUILD_DIR", Path("/proc/no_such_dir/build"))
    monkeypatch.setattr(plonk, "_TRANSCRIPT_PERM", None)  # the transcripts fall back too
    native._lib.cache_clear()
    try:
        assert not native.available()
        assert fri.default_pcs_perm() is fri._pcs_perm_plain
        proof = fri.prove_succinct(c, pk)  # perm_fn=None: default_pcs_perm()
        assert serialize.proof_to_bytes(proof, vk) == want
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
    assert native.available()


def test_device_pool_perm_on_the_cpu_gives_the_same_proof(ungrinded):
    (_, _, _, c, pk, vk), want = ungrinded
    perm = fri_cuda.device_pool_perm(device="cpu")
    states = ints_to_digits(_ints(15, 600), shape=(3, 5))
    out = perm(states)
    assert out.dtype == np.uint32 and np.array_equal(out, JPERM(states))
    assert serialize.proof_to_bytes(fri.prove_succinct(c, pk, perm), vk) == want
